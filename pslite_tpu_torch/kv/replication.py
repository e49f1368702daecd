"""Chain replication of accepted pushes across servers
(``PS_KV_REPLICATION=k``).

Copy of ``pslite_tpu/kv/replication.py``.  With replication on, every
server forwards each accepted worker push to the next ``k-1`` servers in
rank order (the chain wraps), so a server's key range survives its
death:

- **Forwarding** runs on the server's single request thread, in arrival
  order, into one send lane per replica, so a replica applies the
  primary's stream in the primary's arrival order.  With the apply
  pool's shard affinity (per-key apply order == arrival order) the
  replica's store is bit-exact with the primary's.
- **Failover**: on a ``NODE_FAILURE`` broadcast, workers route the dead
  rank's key range to its first live replica, which already holds the
  data.
- **Dedup**: a forwarded push carries ``OPT_REPLICA`` with the origin
  worker id in ``meta.addr`` and the origin timestamp, so a worker's
  failover retry of a request the primary already forwarded applies
  exactly once.
- **Recovery restore**: a recovered server fetches its ranges' state
  from its chain (``REPLICA_FETCH_CMD``) before serving.

Replicas never re-forward (``OPT_REPLICA`` stops the chain) and never
answer forwarded pushes (``KVServer.response`` suppresses them).
Restore moves the handle's ``store`` (or the pair
``export_range``/``import_range`` when the handle defines them);
``KVServerOptimizerHandle`` packs its momentum/adam slots into the same
records, so replica restores and snapshots carry optimizer state.

Counters and gauges go to the node registry under the JAX package's
names (``replication.forwards``, ``.dedup_hits``, ``.lag``,
``.applied_stamp_lag``); ``forwarded``, ``deduped`` and ``stats`` read
them.  Under elastic
membership chains follow the routing epoch's active ranks
(``active=``): departed ranks drop out and joiners join, and a server
that newly replicates a range backfills it (``backfill_range``).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..base import server_rank_to_id
from ..message import Message, OPT_REPLICA, REPLICA_FETCH_CMD
from ..sarray import SArray
from ..telemetry.metrics import node_registry
from ..telemetry.views import CounterView
from ..utils import logging as log
from ..utils.bounded import BoundedKeySet

__all__ = ["REPLICA_FETCH_CMD", "Replicator", "chain_ranks",
           "export_range", "import_range"]


def chain_ranks(group_rank: int, k: int, num_servers: int,
                active: Optional[List[int]] = None) -> List[int]:
    """The replica chain of a server rank: the next ``k-1`` group ranks
    in rank order, wrapping.  The single source of the chain topology:
    servers pick forward targets from it and workers failover
    destinations.  ``active`` restricts the chain to the live ranks of
    an elastic cluster; ``None`` keeps ``(rank + i) % num_servers``."""
    if active is not None:
        order = sorted(set(active) | {group_rank})
        idx = order.index(group_rank)
        rot = order[idx + 1:] + order[:idx]
        k = min(k, len(order))
        return rot[: max(k - 1, 0)]
    k = min(k, max(num_servers, 1))
    return [
        (group_rank + i) % num_servers
        for i in range(1, k)
        if (group_rank + i) % num_servers != group_rank
    ]


def _snapshot_items(store, begin: int, end: int):
    """A store's (key, value) pairs for ``[begin, end)``: the store's own
    range iterator when it has one (``TieredStore`` reads only that
    range's cold bytes), else ``items()`` under a short retry loop
    (shard threads insert concurrently, and a bare iteration would
    raise ``dictionary changed size``)."""
    ranged = getattr(store, "items_in_range", None)
    if callable(ranged):
        return ranged(begin, end)
    items = None
    for _ in range(100):
        try:
            items = list(store.items())
            break
        except RuntimeError:
            continue
    log.check(items is not None, "could not snapshot the store")
    return items


def export_range(handle, begin: int, end: int):
    """Every stored key of ``handle`` in ``[begin, end)`` as ``(keys,
    flat vals, per-key lens)``, the currency of the replica fetch and
    of snapshots.  Prefers the handle's own ``export_range``."""
    if callable(getattr(handle, "export_range", None)):
        return handle.export_range(begin, end)
    store = getattr(handle, "store", None) or {}
    items = _snapshot_items(store, begin, end)
    pairs = sorted((kk, arr) for kk, arr in items if begin <= kk < end)
    keys = np.asarray([kk for kk, _ in pairs], dtype=np.uint64)
    lens = np.asarray([arr.size for _, arr in pairs], dtype=np.int32)
    vals = (
        np.concatenate([arr.reshape(-1) for _, arr in pairs])
        if pairs else np.empty(0, np.float32)
    )
    return keys, vals, lens


def import_range(handle, keys, vals, lens) -> None:
    """Load an exported range into ``handle`` (the inverse of
    :func:`export_range`; prefers the handle's ``import_range``)."""
    if callable(getattr(handle, "import_range", None)):
        handle.import_range(keys, vals, lens)
        return
    store = getattr(handle, "store", None)
    log.check(store is not None,
              "state import needs a handle with .store or import_range()")
    staged = {}
    off = 0
    for i, key in enumerate(keys):
        # A negative len tags a slot-packed optimizer record (its
        # magnitude is the record length): a plain store cannot unpack
        # it, and storing it whole would serve parameters with optimizer
        # state appended.
        raw = int(lens[i]) if lens is not None else (
            len(vals) // max(len(keys), 1)
        )
        log.check(
            raw >= 0,
            f"key {int(key)}: slot-packed optimizer record cannot "
            f"import into a plain store — use the matching optimizer "
            f"handle",
        )
        staged[int(key)] = vals[off:off + raw].copy()
        off += raw
    # One update: a reader (a snapshot, a test's poll) never sees half a
    # range.
    if isinstance(store, dict):
        store.update(staged)
    else:
        for key, val in staged.items():
            store[key] = val


class Replicator:
    """Per-KVServer replication engine: forwarding, origin dedup, and
    the recovery fetch/restore protocol."""

    def __init__(self, server, k: int):
        self._server = server
        self.po = server.po
        self.k = min(k, max(self.po.num_servers, 1))
        # Origin identities applied here, bounded FIFO:
        # (origin sender, customer, ts, key).
        self._applied = BoundedKeySet(max(
            1024, self.po.env.find_int("PS_REPLICA_DEDUP_CACHE", 65536)
        ))
        self._mu = threading.Lock()
        self._restore_ts: Optional[int] = None
        self._restore_msg: Optional[Message] = None
        # One range-state fetch in flight at a time: the boot restore
        # and the rehab resync share the _restore_ts/_restore_msg slot.
        self._fetch_mu = threading.Lock()
        # Replica-read stamps, keyed by primary node id: the newest
        # forward stamp claimed at intake (pulls answered here advertise
        # it) and the newest whose apply completed (the lag).
        self._claimed: Dict[int, int] = {}
        self._applied_stamps: Dict[int, int] = {}
        # After a range import cut at primary stamp F, forwards stamped
        # <= F are already in the imported state.
        self._import_floor: Dict[int, int] = {}
        reg = node_registry(getattr(self.po, "metrics", None))
        self._c_forwarded = reg.counter("replication.forwards")
        self._c_deduped = reg.counter("replication.dedup_hits")
        reg.gauge("replication.lag", fn=self.pending_forwards)
        reg.gauge("replication.applied_stamp_lag", fn=self.stamp_lag)
        self.stats = CounterView(reg, prefix="replication.")
        # A recovered worker restarts its timestamps at 0: its new
        # pushes must not collide with its dead life's origins.
        self.po.register_node_failure_hook(self._on_node_event)

    @property
    def forwarded(self) -> int:
        return self.stats["forwards"]

    @property
    def deduped(self) -> int:
        return self.stats["dedup_hits"]

    def pending_forwards(self) -> int:
        """Forwards still queued in the van's Python send lanes toward
        this server's replicas (JAX's ``replication.lag`` gauge)."""
        van = self.po.van
        try:
            ids = self.replica_ids()
        except Exception:  # noqa: BLE001 - before bootstrap
            return 0
        return sum(
            len(lane.q) for rid in ids for lane in van._lanes_of(rid)
        )

    def close(self) -> None:
        self.po.unregister_node_failure_hook(self._on_node_event)

    def _on_node_event(self, node_id: int, down: bool) -> None:
        if down:
            return
        with self._mu:
            n = self._applied.discard_where(lambda o: o[0] == node_id)
            # A recovered primary restarts its push-version counter at
            # 1: its dead life's claimed/applied/floor entries would
            # advertise versions the new counter has not reached.
            self._claimed.pop(node_id, None)
            self._applied_stamps.pop(node_id, None)
            self._import_floor.pop(node_id, None)
        if n:
            log.vlog(1, f"purged {n} dedup origins for recovered "
                        f"node {node_id}")

    # -- topology ------------------------------------------------------------

    def replica_ids(self) -> List[int]:
        """Instance ids of my next k-1 chain members, in rank order."""
        gs = self.po.group_size
        my_rank = self.po.my_rank()
        g, idx = my_rank // gs, my_rank % gs
        return [
            server_rank_to_id(r * gs + idx)
            for r in chain_ranks(g, self.k, self.po.num_servers,
                                 active=self.po.active_server_ranks)
        ]

    # -- origin dedup --------------------------------------------------------

    @staticmethod
    def _origin(meta) -> Tuple:
        origin_sender = (meta.addr if meta.option == OPT_REPLICA
                         else meta.sender)
        return (origin_sender, meta.customer_id, meta.timestamp, meta.key)

    def should_apply(self, meta) -> bool:
        """Record a push's origin identity; False when this origin was
        already applied here (a worker's failover retry racing the
        primary's forward, in either order)."""
        origin = self._origin(meta)
        with self._mu:
            if not self._applied.add(origin):
                self._c_deduped.inc()
                return False
        return True

    # -- replica-read stamps -------------------------------------------------

    def note_claimed(self, primary_id: int, stamp: int) -> None:
        """A forward from ``primary_id`` carrying ``stamp`` was taken in
        (request thread, arrival order): later pulls observe its effect
        on every shared key, so their answers may advertise it."""
        if stamp <= 0:
            return
        with self._mu:
            if stamp > self._claimed.get(primary_id, 0):
                self._claimed[primary_id] = stamp

    def note_applied(self, primary_id: int, stamp: int) -> None:
        """A forward's apply completed (shard thread or serial path)."""
        if stamp <= 0:
            return
        with self._mu:
            if stamp > self._applied_stamps.get(primary_id, 0):
                self._applied_stamps[primary_id] = stamp

    def claimed_stamp(self, primary_id: int) -> int:
        """The newest forward stamp taken in from ``primary_id`` (0
        before the first stamped forward or fetch)."""
        with self._mu:
            return self._claimed.get(primary_id, 0)

    def stamp_lag(self) -> int:
        """Max over primaries of (claimed - applied): forwards accepted
        at intake whose apply has not completed yet."""
        with self._mu:
            if not self._claimed:
                return 0
            return max(
                c - self._applied_stamps.get(pid, 0)
                for pid, c in self._claimed.items()
            )

    def set_import_floor(self, primary_id: int, stamp: int) -> None:
        """A range import from ``primary_id`` was cut at ``stamp`` (a
        quiesced export: every forward <= stamp is in the imported
        state): forwards at or below it are acked without applying."""
        if stamp <= 0:
            return
        with self._mu:
            if stamp > self._import_floor.get(primary_id, 0):
                self._import_floor[primary_id] = stamp
            if stamp > self._claimed.get(primary_id, 0):
                self._claimed[primary_id] = stamp
            if stamp > self._applied_stamps.get(primary_id, 0):
                self._applied_stamps[primary_id] = stamp

    def below_import_floor(self, meta) -> bool:
        """True when this forward's effect is already in an import's
        cut (see :meth:`set_import_floor`)."""
        stamp = getattr(meta, "stamp", 0)
        if stamp <= 0:
            return False
        with self._mu:
            return stamp <= self._import_floor.get(meta.sender, 0)

    # -- forwarding (primary side) -------------------------------------------

    def forward(self, meta, kvs, copy: bool = False,
                wire=None) -> List[threading.Event]:
        """Chain-forward an accepted worker push to the next k-1
        servers.  Runs on the server's request thread, so forwards enter
        each replica's lane in arrival order; priority is pinned to one
        level so the lane's FIFO is the arrival order.

        ``copy=True`` snapshots the payload first (vals aliasing a
        registered receive buffer, which the next push overwrites).
        ``wire`` is a codec push's payload as received, ``(codes,
        scales, lens|None, CodecInfo)``: the forward re-sends those bytes
        with ``EXT_CODEC``.  A large forward is chunked again by
        ``van.send`` under this server's transfer ids, while the origin
        identity rides every chunk.  A forward under the chaos van takes
        the Python lanes (the chaos van declines ``_native_submit``).

        Returns each forward's sent event, set once the van has written
        its bytes (or given up on them): ``KVServer`` acknowledges the
        push only after them, so an acknowledged push is never lost with
        a primary that dies holding its forward in a send lane.  JAX
        acknowledges without waiting (ROADMAP Queue 3)."""
        van = self.po.van
        vals = None
        sent: List[threading.Event] = []
        if wire is None:
            vals = kvs.vals.copy() if copy else kvs.vals
        for rid in self.replica_ids():
            if van.is_peer_down(rid):
                continue
            msg = Message()
            m = msg.meta
            m.app_id = self._server._customer.app_id
            m.customer_id = meta.customer_id
            m.request = True
            m.push = True
            m.pull = False
            m.head = meta.cmd
            # The origin identity rides (addr, timestamp, key).
            m.timestamp = meta.timestamp
            m.addr = meta.sender
            m.key = meta.key
            m.option = OPT_REPLICA
            m.recver = rid
            m.priority = 0
            m.trace = getattr(meta, "trace", 0)
            # The originating tenant, so the replica schedules and
            # admits the true tenant's load.
            m.tenant = getattr(meta, "tenant", 0)
            # The push stamp the primary assigned at intake: the replica
            # advertises how much of the primary's stream its pulls
            # cover (0 with stamping off: replica reads stay off).
            m.stamp = getattr(meta, "stamp", 0)
            msg.add_data(SArray(kvs.keys))
            if wire is not None:
                codes, scales, lens_arr, ci = wire
                m.codec = ci
                m.val_len = ci.raw_len
                msg.add_data(codes if isinstance(codes, SArray)
                             else SArray(codes))
                msg.add_data(scales if isinstance(scales, SArray)
                             else SArray(scales))
                if lens_arr is not None:
                    msg.add_data(
                        SArray(np.asarray(lens_arr, dtype=np.int32))
                    )
            else:
                msg.add_data(SArray(vals))
                if kvs.lens is not None:
                    msg.add_data(
                        SArray(np.asarray(kvs.lens, dtype=np.int32))
                    )
            msg._sent_event = threading.Event()
            try:
                van.send(msg)
                self._c_forwarded.inc()
                sent.append(msg._sent_event)
            except Exception as exc:  # noqa: BLE001 - replica may be down
                log.warning(f"replica forward to {rid} failed: {exc!r}")
        return sent

    # -- state fetch (replica side) ------------------------------------------

    def handle_fetch(self, meta, kvs, server) -> None:
        """Serve a range-state fetch: every stored key in [begin, end),
        with per-key lens.  Runs on the request thread; the apply pool
        is quiesced first, so the export is a clean cut and the
        response's stamp (taken at intake) bounds it.

        The port's response carries a fourth segment that JAX's does
        not (JAX's fetch reads three and ignores it): the origins in
        this range's dedup window, ``(sender, customer, ts, key)`` as
        uint64 rows, every push whose effect is in the cut.  The
        fetching server dedups against them, so a push applied here
        before the cut applies there once more neither from a forward
        parked during its restore nor from a worker's retry: dedup
        survives the restart."""
        log.check(len(kvs.keys) >= 2, "replica fetch wants [begin, end)")
        begin, end = int(kvs.keys[0]), int(kvs.keys[1])
        handle = server._handle
        from .kv_app import KVPairs

        pool = getattr(server, "_apply_pool", None)
        if pool is not None:
            tok = pool.submit_token()
            if not pool.quiesce(tok, timeout_s=30.0):
                log.warning("replica fetch: apply pool did not quiesce "
                            "in 30s; exporting anyway (stamp may "
                            "over-claim the cut)")
        keys, vals, lens = export_range(handle, begin, end)
        log.vlog(1, f"replica fetch [{begin}, {end}): {len(keys)} keys")
        if not len(keys):
            server.response(meta, KVPairs(keys=keys, vals=vals, lens=lens))
            return
        with self._mu:
            origins = [o for o in self._applied if begin <= o[3] < end]
        msg = server._response_msg(meta)
        msg.add_data(SArray(keys))
        msg.add_data(SArray(vals))
        msg.add_data(SArray(np.asarray(lens, dtype=np.int32)))
        msg.add_data(SArray(np.asarray(origins, dtype=np.uint64).reshape(-1)))
        server._send_response(msg)

    # -- restore (recovered primary side) ------------------------------------

    def absorb_response(self, msg: Message) -> bool:
        """Take the in-flight fetch's response (KVServer routes every
        response here before discarding it)."""
        if self._restore_ts is None or msg.meta.timestamp != self._restore_ts:
            return False
        self._restore_msg = msg
        return True

    def restore(self, handle, timeout_s: float = 30.0) -> int:
        """Fetch the state of every range this server holds, its own
        (from its chain) and the copies it keeps for the ranks whose
        chains include it (from those primaries first), into
        ``handle``.  Runs before serving.  Returns the keys restored (0
        when nothing is reachable: logged, as in JAX, since an empty
        rejoin is still better than none)."""
        gs = self.po.group_size
        my_rank = self.po.my_rank()
        g, idx = my_rank // gs, my_rank % gs
        num = self.po.num_servers
        active = self.po.active_server_ranks
        ranks = active if active is not None else list(range(num))
        to_id = lambda r: server_rank_to_id(r * gs + idx)  # noqa: E731
        chain = lambda r: chain_ranks(r, self.k, num,  # noqa: E731
                                      active=active)
        total = 0
        for rng in self.po.server_key_ranges_of(g):
            total += self._fetch_range(
                handle, rng, [to_id(r) for r in chain(g)], timeout_s,
            )[0]
        for r in ranks:
            if r == g or g not in chain(r):
                continue
            for rng in self.po.server_key_ranges_of(r):
                n, stamp, src = self._fetch_range(
                    handle, rng,
                    [to_id(r)] + [
                        to_id(c) for c in chain(r) if c != g
                    ],
                    timeout_s,
                )
                total += n
                if src == to_id(r) and stamp > 0:
                    # Fetched from the primary itself: the stamp is in
                    # its currency, so it seeds the claimed stamp and
                    # floors forward re-applies.
                    self.set_import_floor(src, stamp)
        return total

    def backfill_range(self, handle, rng, primary_id: int,
                       timeout_s: float = 30.0) -> int:
        """Backfill one range this server newly replicates from its
        primary: the primary's quiesced export makes the response stamp
        the cut, which becomes the import floor, so forwards racing the
        backfill apply once.  Returns the keys imported (0 on failure,
        logged).  Called by ``KVServer._backfill_replicas`` when an
        elastic epoch puts this server in a new chain."""
        n, stamp, src = self._fetch_range(handle, rng, [primary_id],
                                          timeout_s)
        if src == primary_id and stamp > 0:
            self.set_import_floor(primary_id, stamp)
        return n

    def _fetch_range(self, handle, rng, candidate_ids: List[int],
                     timeout_s: float) -> Tuple[int, int, int]:
        """Fetch one range's state from the first live candidate into
        ``handle``.  Returns ``(keys imported, response stamp, source
        id)``, ``(0, 0, -1)`` on failure (logged).  Serialized by
        ``_fetch_mu``: every fetch shares one interception slot."""
        van = self.po.van
        rid = next(
            (r for r in candidate_ids if not van.is_peer_down(r)), None
        )
        if rid is None:
            log.warning(f"restore of [{rng.begin}, {rng.end}) skipped: "
                        f"no live holder")
            return 0, 0, -1
        with self._fetch_mu:
            customer = self._server._customer
            ts = customer.new_request(rid)
            self._restore_ts = ts
            self._restore_msg = None
            msg = Message()
            m = msg.meta
            m.app_id = customer.app_id
            m.customer_id = customer.customer_id
            m.request = True
            m.pull = True
            m.head = REPLICA_FETCH_CMD
            m.timestamp = ts
            m.recver = rid
            msg.add_data(SArray(np.asarray([rng.begin, rng.end],
                                           dtype=np.uint64)))
            # An empty vals segment: the server's decode fills kvs.keys
            # only when the frame carries both segments.
            msg.add_data(SArray(np.empty(0, np.float32)))
            try:
                van.send(msg)
            except Exception as exc:  # noqa: BLE001 - died in the gap
                log.warning(f"restore fetch to {rid} failed: {exc!r}; "
                            f"[{rng.begin}, {rng.end}) left empty")
                self._restore_ts = None
                return 0, 0, -1
            ok = customer.wait_request(ts, timeout=timeout_s)
            resp, self._restore_msg, self._restore_ts = (
                self._restore_msg, None, None
            )
        if not ok or resp is None:
            log.warning(f"restore from {rid} timed out ({timeout_s}s); "
                        f"[{rng.begin}, {rng.end}) left empty")
            return 0, 0, -1
        stamp = getattr(resp.meta, "stamp", 0)
        if len(resp.data) < 2:
            log.vlog(1, f"restore: [{rng.begin}, {rng.end}) is empty")
            return 0, stamp, rid
        keys = resp.data[0].astype_view(np.uint64).numpy()
        vals = resp.data[1].numpy()
        lens = (resp.data[2].astype_view(np.int32).numpy()
                if len(resp.data) > 2 else None)
        import_range(handle, keys, vals, lens)
        if len(resp.data) > 3:
            # The source's origins of the cut (a port source's fourth
            # segment): dedup them here too.
            origins = resp.data[3].astype_view(np.uint64).numpy()
            with self._mu:
                for o in origins.reshape(-1, 4).tolist():
                    self._applied.add(tuple(o))
        log.vlog(1, f"restored {len(keys)} keys of "
                    f"[{rng.begin}, {rng.end}) from node {rid}")
        return len(keys), stamp, rid
