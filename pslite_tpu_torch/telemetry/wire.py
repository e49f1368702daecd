# The port's copy of pslite_tpu/telemetry/wire.py (it imports nothing
# of JAX); names and numbers match the JAX package's.
"""Wire-plane observatory: syscall / frame / byte / occupancy accounting.

The telemetry plane (ClusterHistory, SLO watchdog, tracing) stops at the
op layer; this module instruments the layer below it — the wire.  Every
van owns a :class:`WireStats` that records, per direction:

- ``wire.tx.ops`` / ``wire.rx.ops`` — logical operations (messages
  entering ``Van.send`` / surfacing from the receive loop),
- ``wire.tx.frames`` / ``wire.rx.frames`` — wire frames (chunks count
  individually, so frames/op exposes chunking amplification),
- ``wire.tx.syscalls`` / ``wire.rx.syscalls`` — kernel entries
  (``sendmsg`` / ``recv_into`` calls; the denominator of the io_uring
  van's "syscalls/op < 0.1" target),
- ``wire.tx.bytes_zc`` vs ``wire.tx.bytes_copy`` — payload bytes handed
  to the kernel as borrowed views vs serialized/copied header+meta
  bytes (same split on rx: scatter-into-destination vs pooled copy),
- ``wire.lane.<peer>.tx.frames`` / ``.tx.bytes`` — per-lane traffic,
  cardinality-capped (see below),
- histogram ``wire.batch_occupancy`` — ops per combiner-emitted frame
  (including singleton runs, so the fill distribution is honest),
- histogram ``wire.lane_residency_s`` — queue wait between lane enqueue
  and dispatch.

The native C++ plane exports the same families under ``wire.native.*``,
synced from the one-struct FFI snapshot (:func:`WireStats.sync_native`).

Cost model — **thread-local shards, flushed off the hot path**:
recording is two int adds and a compare on a per-thread shard object (no
lock, no registry lookup); every ``PS_WIRE_FLUSH_OPS`` (default 64)
records the owning thread folds the shard into the node registry
(counters are bare int adds; histograms merge pre-bucketed arrays under
one lock via ``Histogram.merge_shard``).  ``flush()`` from the snapshot
path drains all shards so ``METRICS_PULL`` never reads a stale plane;
cross-thread drains tolerate the same rare lost increment the metrics
module already documents.

Cardinality: lane labels are bounded at ``PS_WIRE_MAX_LANES`` (default
16) distinct peers per van; traffic beyond the cap aggregates into
``wire.lane.other.*`` so a large cluster cannot explode the registry.

``PS_WIRE_TELEMETRY=0`` (or a disabled node registry) swaps in the
shared :data:`NULL_WIRE` no-op — call sites pay one attribute call on a
do-nothing method and the send path is bit-identical on the wire.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from .. import environment
from .metrics import Registry

# Registry metric-name roots (the catalogue above; docs/observability.md).
_TX = "wire.tx."
_RX = "wire.rx."
_LANE = "wire.lane."
_NATIVE = "wire.native."
OCCUPANCY_HIST = "wire.batch_occupancy"
RESIDENCY_HIST = "wire.lane_residency_s"
_OCC_LO = 1.0       # bucket floor: occupancy is an op count
_RES_LO = 1e-6      # bucket floor: residency is seconds (1 µs)
_NBUCKETS = 64      # must match metrics.Histogram.NBUCKETS

# Native snapshot field -> registry counter suffix (under wire.native.).
_NATIVE_FIELDS = (
    ("tx_syscalls", "tx.syscalls"),
    ("tx_frames", "tx.frames"),
    ("tx_chunks", "tx.chunks"),
    ("tx_bytes", "tx.bytes_zc"),
    ("tx_msgs", "tx.ops"),
    ("rx_syscalls", "rx.syscalls"),
    ("rx_frames", "rx.frames"),
    ("rx_bytes_copy", "rx.bytes_copy"),
    ("rx_bytes_zc", "rx.bytes_zc"),
    ("rx_pool_hits", "rx.pool_hits"),
    ("rx_pool_misses", "rx.pool_misses"),
)


class _ShardHist:
    """Per-thread pre-bucketed histogram half: observes into a private
    ``{bucket: count}`` dict with the same log2 geometry as the registry
    histogram it flushes into."""

    __slots__ = ("lo", "count", "sum", "min", "max", "buckets")

    def __init__(self, lo: float):
        self.lo = lo
        self.reset()

    def reset(self) -> None:
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = 0.0
        self.buckets: Dict[int, int] = {}

    def observe(self, v: float) -> None:
        if v <= self.lo:
            i = 0
        else:
            i = min(_NBUCKETS - 1, int(v / self.lo).bit_length())
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        self.buckets[i] = self.buckets.get(i, 0) + 1


class _Shard:
    """One thread's unflushed wire accounting (plain ints, no lock)."""

    __slots__ = ("pending", "tx_ops", "tx_frames", "tx_syscalls",
                 "tx_bytes_copy", "tx_bytes_zc", "rx_ops", "rx_frames",
                 "rx_syscalls", "rx_bytes_copy", "rx_bytes_zc",
                 "lanes", "lane_id", "lane_ent", "occupancy",
                 "residency")

    def __init__(self):
        self.pending = 0
        self.tx_ops = 0
        self.tx_frames = 0
        self.tx_syscalls = 0
        self.tx_bytes_copy = 0
        self.tx_bytes_zc = 0
        self.rx_ops = 0
        self.rx_frames = 0
        self.rx_syscalls = 0
        self.rx_bytes_copy = 0
        self.rx_bytes_zc = 0
        # peer id -> [frames, bytes] (tx direction; rx lanes would double
        # cardinality for a mirror of sender-side truth).  lane_id/
        # lane_ent memoize the last-hit entry: lane-sender threads are
        # per-peer, so a shard's lane is all but constant.
        self.lanes: Dict[object, list] = {}
        self.lane_id: object = None
        self.lane_ent: Optional[list] = None
        self.occupancy = _ShardHist(_OCC_LO)
        self.residency = _ShardHist(_RES_LO)


class WireStats:
    """Per-van wire accounting; see the module docstring for the metric
    catalogue and cost model.  Construct via :func:`make_wire_stats`."""

    enabled = True

    def __init__(self, registry: Registry, env=None):
        env = env if env is not None else environment.get()
        self._reg = registry
        self.flush_ops = max(1, env.find_int("PS_WIRE_FLUSH_OPS", 64))
        self.max_lanes = max(1, env.find_int("PS_WIRE_MAX_LANES", 16))
        self._tls = threading.local()
        self._mu = threading.Lock()
        self._shards: list = []
        self._lane_ids: set = set()
        # Amortization ledger: records vs flushes (tests + pssoak's
        # telemetry-overhead self-measurement both read these).
        self._c_records = registry.counter("wire.telemetry.records")
        self._c_flushes = registry.counter("wire.telemetry.flushes")
        # Flush targets resolved ONCE: a registry lookup per counter
        # per flush would dominate the amortized per-record cost.
        self._flush_counters = tuple(
            (attr, registry.counter(name)) for attr, name in (
                ("tx_ops", _TX + "ops"), ("tx_frames", _TX + "frames"),
                ("tx_syscalls", _TX + "syscalls"),
                ("tx_bytes_copy", _TX + "bytes_copy"),
                ("tx_bytes_zc", _TX + "bytes_zc"),
                ("rx_ops", _RX + "ops"), ("rx_frames", _RX + "frames"),
                ("rx_syscalls", _RX + "syscalls"),
                ("rx_bytes_copy", _RX + "bytes_copy"),
                ("rx_bytes_zc", _RX + "bytes_zc")))
        self._h_occupancy = registry.histogram(OCCUPANCY_HIST, _OCC_LO)
        self._h_residency = registry.histogram(RESIDENCY_HIST, _RES_LO)
        # Native-plane absolute counters from the last sync.
        self._native_last: Dict[str, int] = {}

    # -- hot-path recording (thread-local shard, no lock) ----------------
    #
    # Each recorder inlines the shard fetch (try/except beats a method
    # call plus 3-arg getattr) and the flush tick: the common case is
    # a handful of int adds and one compare, nothing else.

    def _new_shard(self) -> _Shard:
        s = _Shard()
        self._tls.shard = s
        with self._mu:
            self._shards.append(s)
        return s

    def tx_op(self, n: int = 1) -> None:
        try:
            s = self._tls.shard
        except AttributeError:
            s = self._new_shard()
        s.tx_ops += n
        s.pending += 1
        if s.pending >= self.flush_ops:
            self._flush_shard(s)

    def tx_frame(self, lane, zc_bytes: int, copy_bytes: int = 0,
                 frames: int = 1) -> None:
        try:
            s = self._tls.shard
        except AttributeError:
            s = self._new_shard()
        s.tx_frames += frames
        s.tx_bytes_zc += zc_bytes
        s.tx_bytes_copy += copy_bytes
        if lane is not None:
            if lane == s.lane_id and s.lane_ent is not None:
                ent = s.lane_ent
            else:
                ent = s.lanes.get(lane)
                if ent is None:
                    ent = s.lanes[lane] = [0, 0]
                s.lane_id = lane
                s.lane_ent = ent
            ent[0] += frames
            ent[1] += zc_bytes + copy_bytes
        s.pending += 1
        if s.pending >= self.flush_ops:
            self._flush_shard(s)

    def tx_msg(self, ops: int) -> None:
        """One Python-plane data frame leaving ``Van.send``: logical
        ops AND the combiner-occupancy observation in a single shard
        visit (the two always travel together on this plane)."""
        try:
            s = self._tls.shard
        except AttributeError:
            s = self._new_shard()
        s.tx_ops += ops
        s.occupancy.observe(float(ops))
        s.pending += 1
        if s.pending >= self.flush_ops:
            self._flush_shard(s)

    def tx_syscalls(self, n: int = 1) -> None:
        try:
            s = self._tls.shard
        except AttributeError:
            s = self._new_shard()
        s.tx_syscalls += n
        s.pending += 1
        if s.pending >= self.flush_ops:
            self._flush_shard(s)

    def rx_op(self, n: int = 1) -> None:
        try:
            s = self._tls.shard
        except AttributeError:
            s = self._new_shard()
        s.rx_ops += n
        s.pending += 1
        if s.pending >= self.flush_ops:
            self._flush_shard(s)

    def rx_frame(self, zc_bytes: int, copy_bytes: int = 0,
                 frames: int = 1) -> None:
        try:
            s = self._tls.shard
        except AttributeError:
            s = self._new_shard()
        s.rx_frames += frames
        s.rx_bytes_zc += zc_bytes
        s.rx_bytes_copy += copy_bytes
        s.pending += 1
        if s.pending >= self.flush_ops:
            self._flush_shard(s)

    def rx_msg(self, ops: int, zc_bytes: int,
               copy_bytes: int = 0) -> None:
        """One data message surfacing from the receive pump: logical
        ops and its frame/byte accounting in a single shard visit."""
        try:
            s = self._tls.shard
        except AttributeError:
            s = self._new_shard()
        s.rx_ops += ops
        s.rx_frames += 1
        s.rx_bytes_zc += zc_bytes
        s.rx_bytes_copy += copy_bytes
        s.pending += 1
        if s.pending >= self.flush_ops:
            self._flush_shard(s)

    def rx_syscalls(self, n: int = 1) -> None:
        try:
            s = self._tls.shard
        except AttributeError:
            s = self._new_shard()
        s.rx_syscalls += n
        s.pending += 1
        if s.pending >= self.flush_ops:
            self._flush_shard(s)

    def batch_occupancy(self, ops: int) -> None:
        try:
            s = self._tls.shard
        except AttributeError:
            s = self._new_shard()
        s.occupancy.observe(float(ops))
        s.pending += 1
        if s.pending >= self.flush_ops:
            self._flush_shard(s)

    def lane_residency(self, wait_s: float) -> None:
        try:
            s = self._tls.shard
        except AttributeError:
            s = self._new_shard()
        s.residency.observe(wait_s)
        s.pending += 1
        if s.pending >= self.flush_ops:
            self._flush_shard(s)

    # -- flushing --------------------------------------------------------

    def _lane_key(self, lane) -> str:
        key = str(lane)
        if key in self._lane_ids:
            return key
        with self._mu:
            if key in self._lane_ids:
                return key
            if len(self._lane_ids) < self.max_lanes:
                self._lane_ids.add(key)
                return key
        return "other"

    def _flush_shard(self, s: _Shard) -> None:
        reg = self._reg
        records, s.pending = s.pending, 0
        for attr, counter in self._flush_counters:
            v = getattr(s, attr)
            if v:
                setattr(s, attr, 0)
                counter.inc(v)
        if s.lanes:
            lanes, s.lanes = s.lanes, {}
            for lane, (frames, nbytes) in lanes.items():
                key = self._lane_key(lane)
                reg.counter(f"{_LANE}{key}.tx.frames").inc(frames)
                reg.counter(f"{_LANE}{key}.tx.bytes").inc(nbytes)
        for h, hist in ((s.occupancy, self._h_occupancy),
                        (s.residency, self._h_residency)):
            if h.count:
                hist.merge_shard(h.count, h.sum, h.min, h.max,
                                 h.buckets)
                h.reset()
        self._c_records.inc(records)
        self._c_flushes.inc()

    def flush(self) -> None:
        """Drain every thread's shard into the registry (snapshot path;
        cross-thread, so a racing recorder may lose a rare increment —
        the documented registry-wide trade)."""
        with self._mu:
            shards = list(self._shards)
        for s in shards:
            if s.pending:
                self._flush_shard(s)

    # -- native plane ----------------------------------------------------

    def sync_native(self, stats: Optional[Dict[str, int]]) -> None:
        """Fold a native-core absolute-counter snapshot (the one-struct
        FFI call) into ``wire.native.*`` registry counters as deltas, so
        windowed rates and quantile math treat both planes alike."""
        if not stats:
            return
        last = self._native_last
        for field, suffix in _NATIVE_FIELDS:
            cur = int(stats.get(field, 0))
            prev = last.get(field, 0)
            if cur > prev:
                self._reg.counter(_NATIVE + suffix).inc(cur - prev)
            last[field] = cur


class _NullWireStats:
    """Shared no-op WireStats for ``PS_WIRE_TELEMETRY=0`` / disabled
    registries: one attribute call on a do-nothing method, no state."""

    enabled = False

    def tx_op(self, n: int = 1) -> None:
        pass

    def tx_msg(self, ops: int) -> None:
        pass

    def tx_frame(self, lane, zc_bytes, copy_bytes=0, frames=1) -> None:
        pass

    def tx_syscalls(self, n: int = 1) -> None:
        pass

    def rx_op(self, n: int = 1) -> None:
        pass

    def rx_frame(self, zc_bytes, copy_bytes=0, frames=1) -> None:
        pass

    def rx_msg(self, ops, zc_bytes, copy_bytes=0) -> None:
        pass

    def rx_syscalls(self, n: int = 1) -> None:
        pass

    def batch_occupancy(self, ops: int) -> None:
        pass

    def lane_residency(self, wait_s: float) -> None:
        pass

    def flush(self) -> None:
        pass

    def sync_native(self, stats) -> None:
        pass


NULL_WIRE = _NullWireStats()


def make_wire_stats(registry: Optional[Registry], env=None):
    """The van-side factory: a live :class:`WireStats` on an enabled
    registry with ``PS_WIRE_TELEMETRY`` unset/on, else :data:`NULL_WIRE`."""
    env = env if env is not None else environment.get()
    if registry is None or not getattr(registry, "enabled", False):
        return NULL_WIRE
    if not env.find_bool("PS_WIRE_TELEMETRY", True):
        return NULL_WIRE
    return WireStats(registry, env)
