"""KV app layer: KVPairs, KVWorker, KVServer and the server handles.

Counterpart of ``pslite_tpu/kv/kv_app.py`` (the reference's
``include/ps/kv_app.h``), in two planes that share one timestamp space
per worker customer:

- **Engine path** (ICI van): ``register_dense`` (:833) buckets; a
  push/pull of exactly a registered key set with ``cmd=0`` and no
  ``lens`` rides the van's ``CollectiveEngine`` (``_engine_route``
  :873).  After an op is issued the worker records a CUDA event; one
  completion thread synchronises on it, copies the result into ``out``
  and fires the callback, so callbacks fire without ``wait`` and
  ``wait(ts)`` joins the same future (the timestamp expects no
  response).  On the CPU the op has already run when it returns.
  Beside them the engine's many-op surfaces (``register_pull_buffer``,
  ``coalescer``, ``replay``, ``push_pull_stream``) and sparse tables
  (``push_sparse``/``pull_sparse``, :985-1000).
- **Message path** (every other key, any van): ``push``/``pull``/
  ``push_pull`` (:1172/:1226/:1321) allocate a Customer timestamp,
  slice the sorted keys across the servers' key ranges
  (``default_slicer`` :196, or ``set_slicer``; empty slices are
  pre-credited as responses) and send one message per server group;
  with instance groups worker instance *i* talks to server instance *i*
  of each group.  Pull responses are stashed per timestamp and the last
  one reassembles them, sorted by first key, into the caller's buffer
  (``_finish`` :2505).  ``KVServer`` (:2583) hands the handler
  ``KVMeta`` + ``KVPairs``; the handler calls ``response``.

Zero-copy pulls (``alloc_pull_buffer``, :666-760): on a van with
``alloc_pull_segment`` (shm) the buffer is a shared-memory segment, a
pull of exactly its keys goes out as ``OPT_ZPULL`` with the buffer's id
and this server's offset in ``addr`` (:2032-2040), each server writes
its slice in place and ``_finish`` copies nothing; other vans return
None, as in JAX.  ``KVServer.register_recv_buffer`` also registers the
pair with the van (:3055), which places the push at delivery.

Wire codecs (``ops/codecs.py``): ``register_bucket(keys, codec=)`` (:586) or a
call's ``codec=`` (``compress=`` is its old name; ``"raw"`` forces none)
sends a push's float32 values as ``[keys, codes, scales(, lens)]``, each
slice encoded once with the worker's error-feedback residual toward that
server folded in (``_encode_part`` :635), and asks the servers for codec
pull responses (``CodecInfo`` with ``raw_len=0``, :2042-2047), which the
server encodes with its handle's residual toward that worker
(``KVServer._encode_response`` :3198).  On the engine path a registered
dense bucket ignores the codec, as in JAX.

The apply-shard pool (``kv/apply_shards.py``, ``PS_APPLY_SHARDS``: JAX's
default ``min(8, cores)``, 0 = serial on the customer thread; :2849-2906): requests
split by ``key % shards`` over shard threads, responses in arrival order
per sender.  A fixed-k codec push reaches the pool undecoded
(``KVPairs.enc``) and each shard decodes its own keys.  A chunked push's
``OPT_XFER_PART`` partials stream into the pool as they land
(``KVServer._stream_part`` :4593) and the reassembled message closes the
stream; without the pool (or with a registered receive buffer for the
push) the partials drop and the reassembled message applies whole.
Either way each key's slice is added once, the same ``+=`` of the same
values, so stores are bit-equal to serial ones; only the order of two
senders' adds to one key can follow when each slice completed.

The message-path tiers (as JAX's ``kv_app.py``):

- Small-op batching (``kv/batching.py``, ``PS_BATCH_BYTES``): every
  slice toward a destination that answered the ``BATCH_PROBE_CMD`` probe
  rides the worker's ``OpCombiner`` (``_send`` :2164-2186); a server
  decodes an ``EXT_BATCH`` frame once, runs the per-op intake and fans
  the sub-ops into the pool as a group (``_process_batch`` :4855), and
  answers with one ``response_batch`` frame (:4978).  The server's
  response combiner (``PS_RESP_BATCH_BYTES``) merges independent small
  responses toward senders that proved batch awareness.
- Serving fan-in: ``multi_get``/``pull_multi`` (:1374-1538) pull many key
  lists as one operation, one frame per contacted server each way with
  the combiner on; ``MultiGetHandle`` (:305) joins them.
- The hot-key cache (``kv/hot_cache.py``, ``PS_HOT_CACHE=1``): pulls
  served locally under push-version stamps (``EXT_QOS``), which servers
  stamp only when a QoS feature is configured (``_qos_stamps``), so
  default frames carry no ``EXT_QOS`` tail.  ``fetch_hot_keys`` asks the
  servers for their ``kv.hot_keys`` top-k (``HOT_KEYS_CMD``).
- Tenants (``tenants.py``, ``PS_TENANTS``/``PS_TENANT``, ``tenant=``):
  weighted-fair queues and per-tenant admission control
  (``PS_TENANT_QUEUE_LIMIT``): a shed request answers ``OPT_OVERLOAD``
  and its ``wait`` raises ``OverloadError``.

Host numpy on the message path, as in JAX; the default handle's large
f32/f64 push adds run in the native core (``native.try_iadd``, the bits
of numpy's ``+=``) unless the node's ``PS_NATIVE=0``.

Bounded requests (:480-560, the sweeper :1806-1948): with
``PS_REQUEST_TIMEOUT`` > 0 (seconds; default 0 = off, 10 under replica
reads) every message-path request gets a deadline.  A sweeper thread
retries the unresponded slices of an expired request, attempt *n* after
``timeout * 2**n``, and at once a slice whose send failed or whose
server the failure detector declared dead (``_on_node_event``); each
retry is a new message (a fresh sid) with the slice's encode-once
payload, routed again (``_route``: a dead rank's slice fails over to
the first live member of its replica chain), and the resender forgets
the old one.  The first response per slice counts, later duplicates are
discounted.  After ``PS_REQUEST_RETRIES`` (default 3) the request fails:
``wait(ts)`` raises TimeoutError and its callback never fires.  Without
a timeout a failed send fails the request at once.

Durability (``kv/replication.py``, ``kv/snapshot.py``, ``kv/tiered.py``):
- ``PS_KV_REPLICATION=k``: a server chain-forwards every accepted push
  to the next k-1 servers from its request thread, in arrival order
  (``_intake_replicate``, batched sub-ops too), dedups origins, and a
  recovered server restores its ranges from its chain before serving.
- ``PS_REPLICA_READS=1``: a worker spreads pure pulls over each range's
  live chain (``_route_read``, ``PS_REPLICA_READ_POLICY`` sticky, rr or
  load); a replica answers in the primary's stamp currency, and an
  answer older than a push this worker saw acknowledged is discarded and
  pulled again from the primary.
- ``PS_SNAPSHOT_DIR``: the scheduler's ``Postoffice.snapshot`` fences
  every server through its request queue (``_run_snapshot``) and commits
  a manifest of range segments; ``PS_SNAPSHOT_RESTORE=1`` restores them
  at boot.  ``publish_model``/``rollback_model`` stage a manifest and
  flip it in as a model namespace.
- ``PS_STORE_RAM_MB`` (``PS_STORE_DIR``, ``PS_STORE_SEGMENT_MB``): the
  handle's dict becomes a ``TieredStore``.

Elastic membership (``PS_ELASTIC=1``, ``routing.py``): the worker
slices over the routing table's entries and sends each slice to its
entry's owner (``_route_entries``); a server that does not own a slice's
range answers ``OPT_WRONG_OWNER``, and the sweeper re-slices the slice
under the current table (``_resplit_slice``, a bounce budget apart from
the retries) after pulling a newer table when the bounce names one.
Deadlines default to 10 s, batching is declined with a warning, and
``alloc_pull_buffer`` raises ``ElasticZeroCopyError``.  A server cuts
over to each epoch on its request thread (``_apply_routing_update``):
requests for a range it gained park until the old owner's
``MIGRATE_CMD`` lands (``_import_migration``; ``PS_MIGRATE_TIMEOUT``
falls back to the replica chain), ranges it lost stream out on one
migration thread (``_migrate_out``) and are dropped once acknowledged,
a new replica backfills from its primary (``_note_replicated_ranges``),
and ``decommission`` moves everything out before the rank retires.
Telemetry: the worker tracks every message-path request (``kv.pushes``,
``kv.pulls``, the latency histograms, tail-trace keep decisions at
completion); the server counts requests, sheds and tenants, records
``server_queue``/``apply`` spans and flight events, and answers the
scheduler's ``retune`` op (``_run_retune``).  ``KVWorker.reshard`` recuts the worker's
engines onto a new device group (``IciVan.reshard_engines``).
"""

from __future__ import annotations

import concurrent.futures
import itertools
import json
import os
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import ps as ps_mod
from .. import tenants as tenants_mod
from ..base import (SCHEDULER_ID, SERVER_GROUP, is_server_id,
                    server_rank_to_id)
from ..customer import Customer
from ..message import (
    BatchInfo,
    BatchOp,
    CodecInfo,
    Command,
    Control,
    MIGRATE_CMD,
    MIGRATE_DONE_OPT,
    Message,
    OPT_APPLY_ERROR,
    OPT_OVERLOAD,
    OPT_REPLICA,
    OPT_SEND_FAILED,
    OPT_WRONG_OWNER,
    OPT_XFER_PART,
    OPT_ZPULL,
    REMOVE_DONE_OPT,
    REPLICA_FETCH_CMD,
    ROUTING_LOCAL_CMD,
    Role,
    SNAPSHOT_LOCAL_CMD,
    ZPULL_OFF_BITS,
)
from ..ops import codecs as codecs_mod
from ..range import Range, find_range
from ..sarray import SArray
from ..telemetry.metrics import node_registry
from ..telemetry.views import CounterView
from ..utils import logging as log
from ..utils.bounded import BoundedKeySet
from ..vans import native
from . import snapshot as snapshot_mod
from .apply_shards import ApplyShardPool
from .batching import (BATCH_PROBE_CMD, BATCH_WIRE_VERSION, OpCombiner,
                       split_batch_message)
from .hot_cache import HotKeyCache
from .replication import (Replicator, _snapshot_items, chain_ranks,
                          export_range, import_range)
from .tiered import TieredStore


_ZPULL_SEQ = itertools.count(1)  # process-wide registered pull buffer ids


# meta.head of the hot-key introspection pull: the server answers with
# its kv.hot_keys top-k (keys + counts) before the handler.
HOT_KEYS_CMD = 0x407C


class ElasticZeroCopyError(RuntimeError):
    """Zero-copy registered pull buffers (``alloc_pull_buffer``) are
    incompatible with elastic membership (``PS_ELASTIC=1``): a buffer's
    per-server byte offsets are fixed at registration, and the first
    live range migration would deliver slices at stale offsets.  Pull
    into ordinary arrays instead, or run without ``PS_ELASTIC``."""


class OverloadError(RuntimeError):
    """The server shed this request under per-tenant admission control
    (``OPT_OVERLOAD``): nothing was applied.  Retryable: back off (at
    least ``retry_after_s``) and issue it again."""

    retry_after_s = 0.005


@dataclass
class KVPairs:
    """Sorted unique keys + values (+ optional per-key value lengths)."""

    keys: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint64))
    vals: np.ndarray = field(default_factory=lambda: np.empty(0, np.float32))
    lens: Optional[np.ndarray] = None
    priority: int = 0
    # A codec push not decoded yet: ``vals`` is empty and ``enc = (codes,
    # scales, CodecInfo)``; the apply pool's shards decode their own keys
    # (codecs.decode_key_ranges).
    enc: Optional[tuple] = None

    def empty(self) -> bool:
        return len(self.keys) == 0

    def materialize(self) -> None:
        """Decode a lazy codec payload into ``vals`` (for callers that need
        the whole payload: global ops, plain handlers)."""
        if self.enc is None:
            return
        codes, scales, info = self.enc
        codec = codecs_mod.by_wire_id(info.codec)
        self.vals = codec.decode(codes, scales, info.raw_len // 4,
                                 flags=info.flags)
        self.enc = None


@dataclass
class KVMeta:
    """Request metadata handed to the server handler (kv_app.h:72-96)."""

    cmd: int = 0
    push: bool = False
    pull: bool = False
    sender: int = 0
    timestamp: int = 0
    customer_id: int = 0
    key: int = 0
    addr: int = 0
    val_len: int = 0
    option: int = 0
    priority: int = 0
    # The request's CodecInfo: on a pull request (raw_len == 0) the codec
    # the worker wants the response in; on a push what the payload
    # traveled as.
    codec: object = None
    # The request's trace id (echoed on responses; the port samples
    # none itself), tenant (echoed, scheduled by weight, admission), and
    # hot-cache stamp (a pull's intake-time push version; on a push the
    # one-shot bump as its response leaves).
    trace: int = 0
    tenant: int = 0
    stamp: int = 0
    # A replicated push's forwards (their sent events): the
    # acknowledgement waits for them (``KVServer._await_forwards``).
    forwards: Optional[list] = None


@dataclass
class _EncodedSlice:
    """One slice's codec payload, encoded once at send time: a retry
    carries these exact bytes (encoding again would fold the residual
    twice)."""

    codes: np.ndarray   # uint8
    scales: np.ndarray  # float32 (empty for bf16)
    lens: Optional[np.ndarray]
    info: CodecInfo


@dataclass
class _PendingSlice:
    """One per-server slice of an in-flight bounded request."""

    group_rank: int
    part: KVPairs
    dest: int
    sent_msg: Optional[Message] = None  # what the resender must forget
    responded: bool = False
    enc: Optional[_EncodedSlice] = None  # codec payload (encode-once)
    # This slice's delivery is known failed (its send raised, or the
    # van answered OPT_SEND_FAILED): the sweeper retries it at once, and
    # only it, never its healthy siblings.
    retry_now: bool = False
    # The destination answered OPT_WRONG_OWNER: the sweeper re-slices
    # the part under the current routing table before routing it again
    # (a range split mid-flight divides one slice over two owners).
    wrong_owner: bool = False
    # A pure pull spread to a chain member (PS_REPLICA_READS): its
    # answer is checked for staleness; every retry goes to the primary.
    replica_read: bool = False


@dataclass
class _PendingReq:
    """Deadline bookkeeping of one timestamp (``PS_REQUEST_TIMEOUT``):
    the sweeper retries unresponded slices with exponential backoff, and
    after ``PS_REQUEST_RETRIES`` fails the request, so ``wait(ts)``
    raises TimeoutError instead of hanging."""

    ts: int
    push: bool
    pull: bool
    cmd: int
    deadline: float
    attempt: int = 0
    # Wrong-owner re-routes, counted apart from ``attempt``: a bounce
    # answers at once, so a few ms of routing-table lag would otherwise
    # spend the retry budget without one real failure.
    bounces: int = 0
    slices: List[_PendingSlice] = field(default_factory=list)
    val_nbytes: int = 0
    codec: Optional[str] = None
    zpull: Optional[dict] = None
    tenant: int = 0
    trace: int = 0


def default_slicer(kvs: KVPairs,
                   ranges: List[Range]) -> List[Optional[KVPairs]]:
    """Partition sorted keys over server key ranges (kv_app.h:566-621)."""
    out: List[Optional[KVPairs]] = [None] * len(ranges)
    if kvs.empty():
        return out
    keys = kvs.keys
    if kvs.lens is not None:
        log.check_eq(len(kvs.lens), len(keys), "lens/keys size mismatch")
        val_offsets = np.concatenate(
            ([0], np.cumsum(np.asarray(kvs.lens, dtype=np.int64))))
        k = None
    else:
        log.check(len(kvs.vals) % len(keys) == 0,
                  "vals not divisible by keys")
        k = len(kvs.vals) // len(keys)
    for i, rng in enumerate(ranges):
        pos = find_range(keys, rng.begin, rng.end)
        if pos.size() == 0:
            continue
        if k is not None:
            vb, ve, lens = pos.begin * k, pos.end * k, None
        else:
            vb, ve = int(val_offsets[pos.begin]), int(val_offsets[pos.end])
            lens = kvs.lens[pos.begin: pos.end]
        out[i] = KVPairs(keys=keys[pos.begin: pos.end], vals=kvs.vals[vb:ve],
                         lens=lens, priority=kvs.priority)
    return out


def _as_kvs(keys, vals, lens, priority: int) -> KVPairs:
    keys = np.ascontiguousarray(np.asarray(keys, dtype=np.uint64))
    vals = np.ascontiguousarray(np.asarray(vals))
    lens_arr = None if lens is None else np.asarray(lens, dtype=np.int32)
    return KVPairs(keys=keys, vals=vals, lens=lens_arr, priority=priority)


class MultiGetHandle:
    """Completion handle of one :meth:`KVWorker.multi_get` fan-out:
    ``wait()`` joins every sub-get (those served from the hot cache are
    complete already), records each failure in ``errors`` (index ->
    exception) and raises the first only after every sibling finished,
    so a shed sub-get never strands or aborts the others."""

    __slots__ = ("_worker", "timestamps", "outs", "errors", "cached")

    def __init__(self, worker: "KVWorker", n: int):
        self._worker = worker
        # Per-sub-get timestamp; None = answered from the hot cache.
        self.timestamps: List[Optional[int]] = [None] * n
        self.outs: List[Optional[np.ndarray]] = [None] * n
        self.errors: Dict[int, Exception] = {}
        self.cached = 0  # sub-gets served wholly from the hot cache

    def __len__(self) -> int:
        return len(self.timestamps)

    def wait(self) -> List[Optional[np.ndarray]]:
        """Join every in-flight sub-get; return the destination buffers,
        or raise the first recorded failure once all completed."""
        first: Optional[Exception] = None
        for i, ts in enumerate(self.timestamps):
            if ts is None:
                continue
            try:
                self._worker.wait(ts)
            except Exception as exc:  # noqa: BLE001 - re-raised below
                self.errors[i] = exc
                if first is None:
                    first = exc
        if first is not None:
            raise first
        return self.outs


class KVWorker:
    """Client of the KV store (kv_app.h:134-300)."""

    _MAX_DEVICE_RESULTS = 8
    # Wrong-owner re-routes per request before it is abandoned: each
    # bounce is a live server answering, and the table pull converges in
    # a round trip, so this is a deep safety net.
    _MAX_WRONG_OWNER_BOUNCES = 50

    def __init__(self, app_id: int, customer_id: int = 0, postoffice=None):
        self.po = postoffice or ps_mod.postoffice(Role.WORKER)
        env = self.po.env
        # One handler thread at most: _process's last-response detection
        # and _finish's reassembly assume responses run one at a time.
        self._customer = Customer(
            app_id, customer_id, self._process, self.po,
            executor_workers=min(
                1, self.po.env.find_int("PS_CUSTOMER_EXECUTOR", 0)),
        )
        self._mu = threading.Lock()
        self._callbacks: Dict[int, Callable[[], None]] = {}
        self._recv_kvs: Dict[int, List[KVPairs]] = {}
        self._pull_dst: Dict[int, Tuple[np.ndarray, np.ndarray,
                                        Optional[np.ndarray]]] = {}
        self._slicer = default_slicer
        # Timestamps whose server handler raised (OPT_APPLY_ERROR) or
        # whose delivery failed: wait(ts) raises, callbacks are skipped.
        self._error_ts = BoundedKeySet(4096)
        self._timeout_ts = BoundedKeySet(4096)
        # Shed by admission control (OPT_OVERLOAD): wait raises the
        # retryable OverloadError.
        self._overload_ts = BoundedKeySet(4096)
        # Tenants: this worker's default (PS_TENANT; per-op tenant=
        # overrides) and the shared table.
        self.tenants = tenants_mod.table_for(env)
        self._tenant = self.tenants.resolve(env.find("PS_TENANT") or None)
        # The hot-key pull cache (PS_HOT_CACHE=1).
        self._hot_cache: Optional[HotKeyCache] = None
        if env.find_int("PS_HOT_CACHE", 0):
            self._hot_cache = HotKeyCache(
                max_bytes=int(env.find_float("PS_HOT_CACHE_MB", 64.0)
                              * (1 << 20)),
                ttl_s=env.find_float("PS_HOT_CACHE_TTL_S", 1.0),
                metrics=node_registry(getattr(self.po, "metrics", None)))
        # Raw-response timestamps (fetch_hot_keys): _finish keeps the
        # per-server KVPairs instead of scattering them.
        self._raw_ts: set = set()
        self._raw_results: Dict[int, List[KVPairs]] = {}
        # Small-op batching (PS_BATCH_BYTES > 0): the per-(destination,
        # tenant, priority) combiner; 0 bypasses the plane and every
        # frame is byte-identical to an unbatched build.  Capability per
        # destination: None while the probe is out (ops pass through
        # unbatched), then True/False; PS_BATCH_NEGOTIATE=0 asserts a
        # homogeneous cluster and skips the probe.
        self._batch_bytes = max(0, env.find_int("PS_BATCH_BYTES", 0))
        if self._batch_bytes > 0 and self.po.elastic:
            # Declined under elastic membership, as JAX does: the
            # wrong-owner re-slice is per sub-op machinery a batched
            # frame does not carry.
            log.warning("PS_BATCH_BYTES set but PS_ELASTIC is active; "
                        "small-op batching disabled")
            self._batch_bytes = 0
        self._batch_caps: Dict[int, bool] = {}
        self._batch_probe_ts: Dict[int, int] = {}
        self._batch_probing: set = set()
        self._batch_negotiate = bool(env.find_int("PS_BATCH_NEGOTIATE", 1))
        self._combiner: Optional[OpCombiner] = None
        if self._batch_bytes > 0:
            self._combiner = OpCombiner(
                lambda m: self.po.van.send(m), self._batch_send_failed,
                on_sent=self._batch_sent,
                max_bytes=self._batch_bytes,
                window_us=env.find_float("PS_BATCH_WINDOW_US", 0.0),
                min_ops=env.find_int("PS_BATCH_MIN_OPS", 32),
                hold_max_us=env.find_float("PS_BATCH_HOLD_US", 2000.0),
                tracer=self.po.tracer)
        self._dense_routes: Dict[tuple, str] = {}
        self._device_results: Dict[int, torch.Tensor] = {}
        self._engine_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        # Completion of the last pull of each registered-buffer bucket.
        self._pinned_pull_futs: Dict[str, Callable[[], None]] = {}
        # Zero-copy pull buffers by key signature, and the timestamps
        # that pulled into one.
        self._zpull_bufs: Dict[Tuple[int, int, int], dict] = {}
        self._zpull_ts: set = set()
        self.zpull_hits = 0  # pulls completed without reassembly
        # Wire codecs: per key set (signature -> (keys, codec name)), and
        # the push residuals per (server, slice).
        self._bucket_codecs: Dict[Tuple[int, int, int], tuple] = {}
        self._codec_ef = (
            codecs_mod.ErrorFeedback(codecs_mod.ef_slots(self.po.env),
                                     metrics=getattr(self.po, "metrics",
                                                     None))
            if codecs_mod.ef_enabled(self.po.env) else None)
        metrics = node_registry(getattr(self.po, "metrics", None))
        self._c_codec_raw = metrics.counter("codec.raw_bytes")
        self._c_codec_wire = metrics.counter("codec.wire_bytes")
        # Bounded requests: PS_REQUEST_TIMEOUT (s, 0 = off; 10 under
        # replica reads, whose stale-answer fallback is a sweeper retry,
        # and under elastic membership, whose wrong-owner re-slice is
        # one) deadlines every message-path request, the sweeper retries
        # expired slices (failing over down the replica chain) and after
        # PS_REQUEST_RETRIES fails the request.  _down_servers mirrors
        # the failure detector's NODE_FAILURE broadcasts.
        replica_reads = bool(env.find_int("PS_REPLICA_READS", 0))
        self._req_timeout = env.find_float(
            "PS_REQUEST_TIMEOUT",
            10.0 if (replica_reads or self.po.elastic) else 0.0)
        self._req_retries = env.find_int("PS_REQUEST_RETRIES", 3)
        self._replication = env.find_int("PS_KV_REPLICATION", 1)
        # Replica reads: pure pulls spread over each range's live chain,
        # checked against the newest push stamp this worker saw
        # acknowledged per primary (_seen_stamps).
        self._replica_reads = (replica_reads and self._replication >= 2
                               and self.po.num_servers >= 2
                               and self._req_timeout > 0)
        self._read_policy = (env.find("PS_REPLICA_READ_POLICY")
                             or "sticky").strip().lower()
        self._rr_counter = itertools.count()
        self._seen_stamps: Dict[int, int] = {}
        self._read_share: Dict[int, int] = {}  # dest -> spread pulls
        # The load read policy's cluster truth (attach_history).
        self._cluster_history = None
        reg = node_registry(getattr(self.po, "metrics", None))
        self._c_replica_reads = reg.counter("replica_read.spread")
        self._c_replica_fallbacks = reg.counter("replica_read.fallbacks")
        self._c_overloads = reg.counter("kv.overloads")
        # Request latency (send to last response), the failure paths,
        # and per-ts trace bookkeeping.
        self._c_pushes = reg.counter("kv.pushes")
        self._c_pulls = reg.counter("kv.pulls")
        self._h_push_lat = reg.histogram("kv.push_latency_s")
        self._h_pull_lat = reg.histogram("kv.pull_latency_s")
        self._c_timeouts = reg.counter("kv.timeouts")
        self._c_failovers = reg.counter("kv.failovers")
        self._c_retries = reg.counter("kv.retries")
        self._c_wrong_owner = reg.counter("kv.wrong_owner_bounces")
        # The counters older callers read: stats["failovers"],
        # stats["wrong_owner_bounces"], stats["replica_read.spread"].
        self.stats = CounterView(reg, names={
            "failovers": "kv.failovers",
            "wrong_owner_bounces": "kv.wrong_owner_bounces"})
        # ts -> (monotonic start, pull?, trace id, wall-aligned start us,
        # parent trace id: a multi_get's sub-gets link to its fan-out).
        self._req_track: Dict[int, Tuple[float, bool, int, float,
                                         int]] = {}
        # ts -> failure outcome ("error", "shed", "timeout", "retry",
        # "wrong_owner", "replica_stale"), read by the tail-keep
        # decision at completion: a failed request's trace is kept.
        self._req_outcome: Dict[int, str] = {}
        # Tail tracing: the rolling slow threshold falls back to these
        # local histograms while no TRACE_PULL hint is fresh.
        if getattr(self.po.tracer, "tail", None) is not None:
            self.po.tracer.set_tail_source("push", self._h_push_lat)
            self.po.tracer.set_tail_source("pull", self._h_pull_lat)
        # Dead primaries whose failover was flight-recorded (one event
        # per outage, re-armed when the rank recovers).
        self._failover_logged: set = set()
        self._fallback_logged = 0.0
        self._down_servers: set = set()
        self._pending: Dict[int, _PendingReq] = {}
        self._sweep_thread: Optional[threading.Thread] = None
        self._sweep_cv = threading.Condition()
        self._sweep_stop = False
        self.po.register_node_failure_hook(self._on_node_event)
        # Elastic routing: the slicing plan of a static cluster (cached:
        # its split never changes), throttled table pulls after a
        # bounce, and the hook that drops migrated ranges' cache fills.
        self._static_entries: Optional[List[Tuple[Range, int]]] = None
        self._last_routing_pull = 0.0
        self.po.register_routing_hook(self._on_routing)

    @property
    def engine(self):
        """The collective engine of the worker's ICI van (None on other
        vans and before the van starts)."""
        return getattr(self.po.van, "engine", None)

    def set_slicer(self, slicer) -> None:
        """Custom slicer hook (kv_app.h:256-265):
        ``slicer(kvs, ranges) -> [KVPairs or None per range]``."""
        self._slicer = slicer

    # -- registration / routing ----------------------------------------------

    def register_dense(self, name: str, keys, val_len: int, dtype=None,
                       init=None):
        """Register a dense bucket on the engine; push/pull of exactly
        these keys then ride the collective data plane."""
        log.check(self.engine is not None,
                  "register_dense requires a started ici van")
        keys = np.ascontiguousarray(np.asarray(keys, dtype=np.uint64))
        bucket = self.engine.register_dense(name, keys, val_len, dtype=dtype,
                                            init=init)
        self._dense_routes[(len(keys), int(keys[0]), int(keys[-1]))] = name
        return bucket

    def register_bucket(self, keys, codec: Optional[str] = None) -> None:
        """Register a default wire codec for exactly these keys: every
        ``push``/``pull`` of this key set then travels encoded
        (``'int8'``, ``'fp8_e4m3'``, ``'bf16'``) unless the call says
        otherwise (``codec='raw'`` forces none).  ``codec=None``
        unregisters.  The message path only: a registered dense bucket
        on the engine ignores it."""
        keys = np.ascontiguousarray(np.asarray(keys, dtype=np.uint64))
        log.check(len(keys) > 0, "register_bucket: empty key set")
        if codec is not None:
            codecs_mod.get_codec(codec)  # unknown names fail here
        sig = (len(keys), int(keys[0]), int(keys[-1]))
        with self._mu:
            if codec is None:
                self._bucket_codecs.pop(sig, None)
            else:
                self._bucket_codecs[sig] = (keys, codec)

    def _resolve_tenant(self, tenant) -> int:
        """One op's tenant id: ``tenant=`` (name or id) when given, else
        this worker's ``PS_TENANT``."""
        if tenant is None:
            return self._tenant
        return self.tenants.resolve(tenant)

    def _resolve_codec(self, keys: np.ndarray, codec: Optional[str],
                       compress: Optional[str]) -> Optional[str]:
        """The op's codec: ``codec=`` (or its old name ``compress=``),
        else the registered bucket's; ``'raw'`` forces none."""
        if codec is None:
            codec = compress
        if codec == "raw":
            return None
        if codec is not None:
            codecs_mod.get_codec(codec)
            return codec
        if not self._bucket_codecs or len(keys) == 0:
            return None
        with self._mu:
            ent = self._bucket_codecs.get((len(keys), int(keys[0]),
                                           int(keys[-1])))
        if ent is not None and np.array_equal(ent[0], keys):
            return ent[1]
        return None

    def _encode_part(self, codec_name: str, group_rank: int,
                     part: KVPairs) -> _EncodedSlice:
        """Encode one slice's payload (once), folding in the residual
        toward this (server, slice).  The slot is keyed by the server's
        group rank, the first key, a crc32 of the keys and the size, so
        two buckets that share a first key and size never share a
        residual."""
        codec = codecs_mod.get_codec(codec_name)
        lens = (None if part.lens is None
                else np.asarray(part.lens, dtype=np.int64))
        if self._codec_ef is not None:
            key = (group_rank, int(part.keys[0]), zlib.crc32(part.keys),
                   int(part.vals.size))
            resid, lock = self._codec_ef.slot(key, int(part.vals.size))
            with lock:
                codes, scales, flags = codec.encode(part.vals, lens=lens,
                                                    resid=resid)
        else:
            codes, scales, flags = codec.encode(part.vals, lens=lens)
        self._c_codec_raw.inc(part.vals.nbytes)
        self._c_codec_wire.inc(codes.nbytes + scales.nbytes)
        info = CodecInfo(codec=codec.wire_id, raw_len=part.vals.nbytes,
                         block=codec.block, flags=flags)
        return _EncodedSlice(codes=codes, scales=scales, lens=part.lens,
                             info=info)

    def reshard(self, group) -> None:
        """Coordinated elastic recut of the worker's engines onto a new
        device group: every worker of the cluster calls it with the same
        group (``_IciDataPlane.reshard_engines``).  Registered bucket and
        table names stay valid; grads take the new worker count from the
        next op."""
        hook = getattr(self.po.van, "reshard_engines", None)
        log.check(hook is not None,
                  "reshard requires an ICI van (collective data plane)")
        hook(group, customer_id=self._customer.customer_id)

    def register_pull_buffer(self, name: str) -> torch.Tensor:
        """Register a persistent pull buffer for a registered dense
        bucket: every ``pull`` of the bucket then lands in this one
        buffer (``push_pull`` keeps its fresh results), and the engine's
        handle of it from the previous pull goes stale.  A pull waits for
        the previous pull of the bucket to complete (one outstanding per
        registered buffer).  Returns the first handle; see
        ``CollectiveEngine.register_pull_buffer``."""
        log.check(self.engine is not None,
                  "register_pull_buffer requires a started ici van")
        return self.engine.register_pull_buffer(name)

    def _engine_route(self, keys, cmd: int = 0, lens=None) -> Optional[str]:
        """Bucket name iff these exact keys are registered and the request
        carries nothing the collective path cannot express."""
        if self.engine is None or len(keys) == 0:
            return None
        if cmd != 0 or lens is not None:
            return None
        name = self._dense_routes.get((len(keys), int(keys[0]),
                                       int(keys[-1])))
        if name is None:
            return None
        if not np.array_equal(self.engine.bucket(name).keys, keys):
            return None  # same signature, different key set
        return name

    # -- zero-copy pull (is_worker_zpull_) -----------------------------------

    def alloc_pull_buffer(self, keys, val_len: int, dtype=np.float32):
        """A transport-backed pull destination for exactly these keys
        (``val_len`` values each): pulls of them into the returned array
        are written in place by the servers (kv_app.h:727-792).  None
        when the van cannot back it (no ``alloc_pull_segment``: only shm
        can) or a custom slicer is set.  One outstanding pull per
        buffer.  Raises ``ElasticZeroCopyError`` under elastic
        membership."""
        if self.po.elastic:
            raise ElasticZeroCopyError(
                "alloc_pull_buffer (zero-copy pull buffers) is "
                "incompatible with elastic membership: PS_ELASTIC=1 "
                "migrates key ranges live, which would invalidate the "
                "buffer's fixed per-server offsets.  Pull into ordinary "
                "arrays instead, or disable PS_ELASTIC for this cluster.")
        alloc = getattr(self.po.van, "alloc_pull_segment", None)
        if alloc is None:
            return None
        if self._slicer is not default_slicer:
            log.warning("alloc_pull_buffer: custom slicer set; zero-copy "
                        "pull disabled for this worker")
            return None
        keys = np.ascontiguousarray(np.asarray(keys, dtype=np.uint64))
        log.check(len(keys) > 0, "empty key set")
        sig = (len(keys), int(keys[0]), int(keys[-1]))
        with self._mu:
            old = self._zpull_bufs.get(sig)
        # Another key set of the same signature would free a live buffer.
        log.check(old is None or np.array_equal(old["keys"], keys),
                  "alloc_pull_buffer: a different key set with the same "
                  "signature is already registered; free_pull_buffer it "
                  "first")
        itemsize = np.dtype(dtype).itemsize
        total = len(keys) * val_len * itemsize
        buf_id = next(_ZPULL_SEQ)
        raw = alloc(buf_id, total)
        vals = raw[:total].view(np.dtype(dtype))
        # Each server's byte offset in the buffer (fixed k, the default
        # slicer's key ranges).
        offsets, off = {}, 0
        for rank, rng in enumerate(self.po.get_server_key_ranges()):
            offsets[rank] = off
            off += (find_range(keys, rng.begin, rng.end).size()
                    * val_len * itemsize)
        with self._mu:
            old = self._zpull_bufs.get(sig)
            self._zpull_bufs[sig] = {"buf_id": buf_id, "keys": keys,
                                     "vals": vals, "offsets": offsets}
        if old is not None:
            self.po.van.free_pull_segment(old["buf_id"])
        return vals

    def free_pull_buffer(self, keys) -> None:
        """Release a registered pull buffer and its segment."""
        keys = np.ascontiguousarray(np.asarray(keys, dtype=np.uint64))
        with self._mu:
            reg = self._zpull_bufs.pop((len(keys), int(keys[0]),
                                        int(keys[-1])), None)
        if reg is not None:
            self.po.van.free_pull_segment(reg["buf_id"])

    def _zpull_lookup(self, keys: np.ndarray, vals) -> Optional[dict]:
        """The registered buffer these keys pull into, if ``vals`` is it
        (or a view of it)."""
        if self._slicer is not default_slicer or not len(keys):
            return None
        with self._mu:
            reg = self._zpull_bufs.get((len(keys), int(keys[0]),
                                        int(keys[-1])))
        if reg is None or not isinstance(vals, np.ndarray):
            return None
        if vals is not reg["vals"] and not (
                vals.base is not None and np.shares_memory(vals,
                                                           reg["vals"])):
            return None
        if not np.array_equal(reg["keys"], keys):
            return None
        return reg

    # -- hot-key cache --------------------------------------------------------

    @property
    def hot_cache(self) -> Optional[HotKeyCache]:
        """The worker's hot-key pull cache (None unless PS_HOT_CACHE=1)."""
        return self._hot_cache

    def fetch_hot_keys(self, k: int = 16,
                       timeout: Optional[float] = None) -> np.ndarray:
        """Ask every server for its ``kv.hot_keys`` top-k (one tiny pull
        each, ``cmd=HOT_KEYS_CMD``) and seed the hot cache's admission
        set with the union.  Returns the keys, range by range.  One
        request per entry of the slicing plan, to the entry's owner:
        under elastic membership an entry's index is not its owner's
        rank."""
        entries = self._route_entries()
        ts = self._customer.new_request(SERVER_GROUP,
                                        num_responses=len(entries))
        with self._mu:
            self._raw_ts.add(ts)
        try:
            for rng, owner in entries:
                msg = Message()
                m = msg.meta
                m.app_id = self._customer.app_id
                m.customer_id = self._customer.customer_id
                m.request = True
                m.pull = True
                m.head = HOT_KEYS_CMD
                m.timestamp = ts
                m.recver = self._route(owner)
                m.val_len = int(k)  # how many hot keys to send back
                m.key = int(rng.begin)
                msg.add_data(SArray(np.array([rng.begin], dtype=np.uint64)))
                msg.add_data(SArray(np.empty(0, np.float32)))
                self.po.van.send(msg)
            self._customer.wait_request(ts, timeout)
        finally:
            with self._mu:
                chunks = self._raw_results.pop(ts, [])
                self._raw_ts.discard(ts)
        keys = (np.concatenate([c.keys for c in chunks])
                if chunks else np.empty(0, np.uint64))
        if self._hot_cache is not None and len(keys):
            self._hot_cache.seed(keys)
        return keys

    def seed_hot_cache(self, k: int = 16) -> np.ndarray:
        """Fetch the servers' hot keys into the cache's admission set;
        the caller's first pulls of them fill it."""
        return self.fetch_hot_keys(k=k)

    # -- small-op batching ----------------------------------------------------

    @property
    def combiner(self) -> Optional[OpCombiner]:
        """The worker's op combiner (None unless PS_BATCH_BYTES > 0)."""
        return self._combiner

    def _batch_capable(self, dest: int) -> bool:
        """May ``dest`` receive EXT_BATCH frames?  Until its probe
        answers, ops pass through unbatched (never queued)."""
        if not self._batch_negotiate:
            return True
        cap = self._batch_caps.get(dest)  # None -> bool only, GIL-atomic
        if cap is not None:
            return cap
        self._probe_batch_cap(dest)
        return False

    def _probe_batch_cap(self, dest: int) -> None:
        """One-shot capability probe: a tiny ``BATCH_PROBE_CMD`` pull the
        server answers before its handler with its batch wire version
        (``val_len`` declares ours).  An error answer (a build without
        the plane routing the cmd into its handler) marks the peer
        incapable."""
        with self._mu:
            if dest in self._batch_caps or dest in self._batch_probing:
                return
            self._batch_probing.add(dest)
        ts = self._customer.new_request(dest)  # a node id: expects 1
        with self._mu:
            self._batch_probe_ts[ts] = dest
        msg = Message()
        m = msg.meta
        m.app_id = self._customer.app_id
        m.customer_id = self._customer.customer_id
        m.request = True
        m.pull = True
        m.head = BATCH_PROBE_CMD
        m.timestamp = ts
        m.recver = dest
        m.val_len = BATCH_WIRE_VERSION
        msg.add_data(SArray(np.zeros(1, np.uint64)))
        msg.add_data(SArray(np.empty(0, np.float32)))
        try:
            self.po.van.send(msg)
        except Exception as exc:  # noqa: BLE001 - probed again later
            log.warning(f"batch capability probe to {dest} failed: "
                        f"{exc!r}")
            with self._mu:
                self._batch_probe_ts.pop(ts, None)
                self._batch_probing.discard(dest)
            self._customer.add_response(ts, 1)

    def _batch_sent(self, msgs, wire_msg: Message) -> None:
        """Combiner sent hook: the frame that left (for a merged frame
        the envelope) is what a retry makes the resender forget."""
        for m in msgs:
            sl = getattr(m, "_batch_sl", None)
            if sl is not None:
                sl.sent_msg = wire_msg

    def _batch_send_failed(self, msgs, exc: Exception) -> None:
        """Combiner error hook: a flush's send raised off the caller's
        thread; fail each member op as an inline send failure would."""
        for m in msgs:
            self._slice_send_failed(m.meta.timestamp,
                                    getattr(m, "_batch_sl", None), exc)

    def _slice_send_failed(self, ts: int, sl: Optional[_PendingSlice],
                           exc: Exception) -> None:
        """One slice's send raised.  With deadlines on (``sl`` given) the
        sweeper retries that slice at once; without, no response will
        come, so the request fails and ``wait(ts)`` raises TimeoutError
        instead of hanging."""
        if sl is not None:
            log.warning(f"send ts={ts} failed ({exc!r}); handing it to "
                        f"the deadline sweeper")
            with self._mu:
                sl.retry_now = True
            self._wake_sweeper()
            return
        log.warning(f"send ts={ts} failed ({exc!r}); failing the request "
                    f"(PS_REQUEST_TIMEOUT off)")
        with self._mu:
            self._mark_timed_out(ts)
        self._customer.add_response(ts, 1)

    def _mark_timed_out(self, ts: int) -> None:
        """Fail an abandoned request (caller holds ``_mu``): ``wait(ts)``
        raises TimeoutError, its callback is dropped, and its pull state
        goes (no response will trigger ``_finish``)."""
        self._timeout_ts.add(ts)
        self._recv_kvs.pop(ts, None)
        self._pull_dst.pop(ts, None)
        self._callbacks.pop(ts, None)
        self._zpull_ts.discard(ts)
        self._c_timeouts.inc()
        # No _finish will run: the tail-keep decision is made here (a
        # timeout is what the tail plane keeps).
        track = self._req_track.pop(ts, None)
        outcome = self._req_outcome.pop(ts, None) or "timeout"
        if track is not None:
            t0, was_pull, trace, t0_us, parent = track
            if trace:
                self._finish_trace(ts, trace, was_pull,
                                   time.monotonic() - t0, t0_us, parent,
                                   outcome if outcome != "retry"
                                   else "timeout", observed=False)

    # -- telemetry -----------------------------------------------------------

    def _track_request(self, ts: int, pull: bool, parent: int = 0) -> int:
        """Start latency tracking of a message-path timestamp and mint
        its trace id: every request under tail capture
        (``PS_TRACE_TAIL``, kept or dropped at completion), else
        head-sampled (``PS_TRACE_SAMPLE``).  Returns the id (0 =
        untraced); ``parent`` links a multi_get sub-get to its
        fan-out."""
        (self._c_pulls if pull else self._c_pushes).inc()
        trace = self.po.tracer.begin_request()
        t0_us = self.po.tracer.now_us() if trace else 0.0
        with self._mu:
            self._req_track[ts] = (time.monotonic(), pull, trace, t0_us,
                                   parent)
        return trace

    def _finish_trace(self, ts: int, trace: int, pull: bool, dur: float,
                      t0_us: float, parent: int,
                      outcome: Optional[str],
                      observed: bool = True) -> None:
        """The tail-keep decision: a failure, a request slower than the
        rolling per-path quantile, or the uniform floor keeps its trace,
        which gets its ``request`` root span and, when the histogram
        observed the duration, an exemplar on its latency bucket."""
        tracer = self.po.tracer
        reason = tracer.tail_keep(dur, "pull" if pull else "push", outcome)
        if reason is None:
            return
        args = {"ts": ts, "pull": pull, "keep": reason}
        if outcome:
            args["outcome"] = outcome
        if parent:
            args["parent"] = f"{parent:x}"
        tracer.span(trace, "request", t0_us, dur * 1e6, args=args)
        tracer.instant(trace, "complete", args={"ts": ts})
        if observed:
            (self._h_pull_lat if pull else self._h_push_lat
             ).attach_exemplar(dur, trace)

    # -- engine-path completion ----------------------------------------------

    def _engine_dispatch(self, result: torch.Tensor, out=None,
                         callback: Optional[Callable[[], None]] = None,
                         keep_result: bool = False,
                         fut_out: Optional[list] = None) -> int:
        """Timestamp (expecting no response) + asynchronous completion of
        an issued op (``fut_out`` receives the completion's ``result``
        callable)."""
        event = None
        if result.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(result.device))
        ts = self._customer.new_request(SERVER_GROUP, num_responses=0)
        with self._mu:
            if self._engine_pool is None:
                self._engine_pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="kv-engine-complete"
                )
            if keep_result:
                self._device_results[ts] = result
                while len(self._device_results) > self._MAX_DEVICE_RESULTS:
                    self._device_results.pop(next(iter(self._device_results)))
        fut = self._engine_pool.submit(self._engine_complete, result, event,
                                       out, callback)
        if fut_out is not None:
            fut_out.append(fut.result)
        self._customer.add_wait_hook(ts, fut.result)
        return ts

    @staticmethod
    def _engine_complete(result, event, out, callback) -> None:
        if event is not None:
            event.synchronize()
        if out is not None:
            flat = result.reshape(-1)
            if isinstance(out, torch.Tensor):
                dst = out.view(-1)
                dst.copy_(flat[: dst.numel()])
            else:
                host = flat.detach().cpu()
                if host.dtype == torch.bfloat16:
                    host = host.float()
                np.copyto(out.reshape(-1),
                          host.numpy()[: out.size].astype(out.dtype))
        if callback is not None:
            callback()

    def get_pulled(self, ts: int):
        """Device-resident pull result of a recent engine timestamp
        (bounded window of the last few results)."""
        with self._mu:
            return self._device_results.get(ts)

    # -- ops -----------------------------------------------------------------

    def push(self, keys, vals, lens=None, cmd: int = 0,
             callback: Optional[Callable[[], None]] = None,
             priority: int = 0, compress: Optional[str] = None,
             codec: Optional[str] = None, tenant=None) -> int:
        """Push ``vals`` (kv_app.h:210-231); the caller must not mutate
        them until ``wait(ts)``.  ``codec=`` (``compress=``) or the
        bucket's registered codec sends float32 values encoded;
        ``tenant=`` (a ``PS_TENANTS`` name or id) labels the request,
        by default this worker's ``PS_TENANT``."""
        route = self._engine_route(np.asarray(keys, dtype=np.uint64), cmd,
                                   lens)
        if route is not None:
            token = self.engine.push(route, vals)
            return self._engine_dispatch(token, callback=callback)
        kvs = _as_kvs(keys, vals, lens, priority)
        codec = self._checked_codec(kvs.keys, kvs.vals, codec, compress)
        tid = self._resolve_tenant(tenant)
        ts = self._new_message_request(callback)
        trace = self._track_request(ts, pull=False)
        self._send(ts, push=True, pull=False, cmd=cmd, kvs=kvs, codec=codec,
                   tenant=tid, trace=trace)
        return ts

    def _checked_codec(self, keys, vals, codec, compress) -> Optional[str]:
        codec = self._resolve_codec(keys, codec, compress)
        if codec is not None:
            log.check(vals.dtype == np.float32,
                      f"codec {codec!r} requires float32 values, got "
                      f"{vals.dtype}")
        return codec

    def pull(self, keys, vals, lens: Optional[np.ndarray] = None,
             cmd: int = 0, callback: Optional[Callable[[], None]] = None,
             priority: int = 0, compress: Optional[str] = None,
             codec: Optional[str] = None, tenant=None,
             _batch_sink: Optional[List[Message]] = None,
             _trace_parent: int = 0) -> int:
        """Pull into ``vals`` (kv_app.h:241-247, 727-792): a numpy array
        on the message path; on the engine path also a tensor.  With
        ``lens``, the per-key lengths land there.  ``codec=``
        (``compress=``) or the bucket's registered codec asks each server
        for an encoded response (float32 only; not into a registered
        zero-copy buffer).  With the hot cache on, a plain fixed-k pull
        whose every key is cached fresh is answered here: no message
        leaves, and the returned timestamp is complete."""
        keys = np.ascontiguousarray(np.asarray(keys, dtype=np.uint64))
        route = self._engine_route(keys, cmd, lens)
        if route is not None:
            return self._engine_pull(route, vals, callback)
        codec = self._checked_codec(keys, vals, codec, compress)
        tid = self._resolve_tenant(tenant)
        if (self._hot_cache is not None and lens is None and codec is None
                and cmd == 0 and isinstance(vals, np.ndarray)
                and self._hot_cache.serve(keys, vals)):
            ts = self._customer.new_request(SERVER_GROUP, num_responses=0)
            self._c_pulls.inc()
            self._h_pull_lat.observe(0.0)
            if callback is not None:
                callback()
            return ts
        ts = self._new_message_request(callback)
        trace = self._track_request(ts, pull=True, parent=_trace_parent)
        zpull = (self._zpull_lookup(keys, vals)
                 if lens is None and codec is None else None)
        with self._mu:
            self._pull_dst[ts] = (keys, vals, lens)
            if zpull is not None:
                self._zpull_ts.add(ts)
        kvs = KVPairs(keys=keys, vals=np.empty(0, vals.dtype),
                      priority=priority)
        self._send(ts, push=False, pull=True, cmd=cmd, kvs=kvs,
                   val_nbytes=vals.nbytes, zpull=zpull, codec=codec,
                   tenant=tid, batch_sink=_batch_sink, trace=trace)
        return ts

    def _engine_pull(self, route: str, vals, callback) -> int:
        pinned = self.engine.pinned_pull_buffer(route) is not None
        if pinned:
            # One outstanding pull per registered buffer: the next pull
            # overwrites the buffer the completion thread may still copy.
            prev = self._pinned_pull_futs.get(route)
            if prev is not None:
                prev()
        result = self.engine.pull(route)
        # A registered buffer's result is not kept for get_pulled: the
        # next pull overwrites it.
        holder: list = []
        ts = self._engine_dispatch(result, out=vals, callback=callback,
                                   keep_result=not pinned,
                                   fut_out=holder if pinned else None)
        if pinned:
            self._pinned_pull_futs[route] = holder[0]
        return ts

    def push_pull(self, keys, vals, outs, lens=None, cmd: int = 0,
                  callback: Optional[Callable[[], None]] = None,
                  priority: int = 0, compress: Optional[str] = None,
                  codec: Optional[str] = None, tenant=None) -> int:
        """Fused push + pull round trip (the benchmark hot path).  The
        push takes the codec as ``push`` does; the response travels raw
        (it may land in a registered buffer in place)."""
        route = self._engine_route(np.asarray(keys, dtype=np.uint64), cmd,
                                   lens)
        if route is not None:
            result = self.engine.push_pull(route, vals)
            return self._engine_dispatch(result, out=outs, callback=callback,
                                         keep_result=True)
        kvs = _as_kvs(keys, vals, lens, priority)
        codec = self._checked_codec(kvs.keys, kvs.vals, codec, compress)
        tid = self._resolve_tenant(tenant)
        ts = self._new_message_request(callback)
        trace = self._track_request(ts, pull=True)
        zpull = self._zpull_lookup(kvs.keys, outs) if lens is None else None
        with self._mu:
            self._pull_dst[ts] = (kvs.keys, outs, lens)
            if zpull is not None:
                self._zpull_ts.add(ts)
        self._send(ts, push=True, pull=True, cmd=cmd, kvs=kvs, zpull=zpull,
                   codec=codec, tenant=tid, trace=trace)
        return ts

    def multi_get(self, key_lists, outs: Optional[List[np.ndarray]] = None,
                  val_len: Optional[int] = None, dtype=np.float32,
                  cmd: int = 0, priority: int = 0,
                  compress: Optional[str] = None,
                  codec: Optional[str] = None, tenant=None,
                  callbacks: Optional[List[Callable[[], None]]] = None,
                  callback: Optional[Callable[[], None]] = None
                  ) -> MultiGetHandle:
        """Serving fan-in: pull N independent sorted key lists (a
        serving request's embedding lookups) as one operation.

        ``key_lists[i]``'s values land in ``outs[i]`` (or a new
        ``len(keys) * val_len`` array of ``dtype``).  Each sub-get is
        sliced like :meth:`pull`; with the combiner on, the whole
        fan-out's slices enter it at once (``submit_many``), so each
        contacted server gets one ``EXT_BATCH`` frame and answers with
        one ``response_batch`` frame.  With the hot cache, sub-gets whose
        every key is cached fresh are answered here and partial hits
        fetch only the misses.  ``callbacks[i]`` fires as sub-get i
        completes (not on its failure); ``callback`` once after the last
        succeeded.  A failure (shed, apply error, send failure) fails
        only its sub-get.  ``codec=None`` resolves each list's
        registered bucket codec."""
        n = len(key_lists)
        log.check(outs is not None or val_len is not None,
                  "multi_get needs outs= or val_len=")
        if outs is not None:
            log.check(len(outs) == n, "multi_get: len(outs) != len(key_lists)")
        if callbacks is not None:
            log.check(len(callbacks) == n,
                      "multi_get: len(callbacks) != len(key_lists)")
        handle = MultiGetHandle(self, n)
        sink: Optional[List[Message]] = (
            [] if self._combiner is not None else None)
        agg_mu = threading.Lock()
        agg_left = [n]

        def _complete(i: int) -> None:
            if callbacks is not None and callbacks[i] is not None:
                callbacks[i]()
            if callback is not None:
                with agg_mu:
                    agg_left[0] -= 1
                    fire = agg_left[0] == 0
                if fire:
                    callback()

        want_cb = callbacks is not None or callback is not None
        # One parent trace id spans the fan-out; each sub-get mints its
        # own and records the parent on its root span.
        tracer = self.po.tracer
        parent = tracer.begin_request() if tracer.active else 0
        if parent:
            tracer.instant(parent, "multi_get", args={"subs": n})
        try:
            self._multi_get_issue(key_lists, outs, val_len, dtype, cmd,
                                  priority, compress, codec, tenant, handle,
                                  sink, want_cb, _complete, parent)
        finally:
            if sink:
                # The whole fan-out enters the combiner at once: one frame
                # per contacted server at the next pickup (in a finally,
                # so a raise part way never strands queued sub-gets).
                self._combiner.submit_many(sink)
        return handle

    def _multi_get_issue(self, key_lists, outs, val_len, dtype, cmd,
                         priority, compress, codec, tenant, handle, sink,
                         want_cb, _complete, parent: int = 0) -> None:
        hc = self._hot_cache
        for i, keys in enumerate(key_lists):
            keys = np.ascontiguousarray(np.asarray(keys, dtype=np.uint64))
            out = (outs[i] if outs is not None
                   else np.empty(len(keys) * val_len, dtype))
            handle.outs[i] = out
            codec_i = self._resolve_codec(keys, codec, compress)
            mask = None
            if (hc is not None and cmd == 0 and codec_i is None
                    and len(keys) and isinstance(out, np.ndarray)):
                mask = hc.serve_mask(keys, out)
            if mask is not None and mask.all():
                handle.cached += 1
                self._c_pulls.inc()
                self._h_pull_lat.observe(0.0)
                _complete(i)
                continue
            if mask is not None and mask.any():
                # Partial hit: fetch only the misses into a staging
                # buffer, scattered into their rows on completion.
                miss = np.flatnonzero(~mask)
                k = out.reshape(-1).size // len(keys)
                tmp = np.empty(len(miss) * k, out.dtype)

                def _scatter(i=i, out=out, tmp=tmp, miss=miss, k=k):
                    flat = out.reshape(-1)
                    for j, pos in enumerate(miss):
                        flat[pos * k:(pos + 1) * k] = tmp[j * k:(j + 1) * k]
                    _complete(i)

                handle.timestamps[i] = self.pull(
                    keys[miss], tmp, cmd=cmd, priority=priority,
                    tenant=tenant, callback=_scatter, _batch_sink=sink,
                    _trace_parent=parent)
                continue
            handle.timestamps[i] = self.pull(
                keys, out, cmd=cmd, priority=priority, codec=codec_i,
                tenant=tenant,
                callback=(lambda i=i: _complete(i)) if want_cb else None,
                _batch_sink=sink, _trace_parent=parent)

    def pull_multi(self, key_lists, outs: Optional[List[np.ndarray]] = None,
                   **kw) -> MultiGetHandle:
        """:meth:`multi_get` spelled for registered buckets: each key list
        resolves its own bucket codec."""
        return self.multi_get(key_lists, outs=outs, **kw)

    def coalescer(self, handle=None, **kw):
        """Coalescing dispatcher over the worker's engine: per-op
        ``push_pull(name, grads)`` tickets run as groups (see
        ``parallel/coalesce.py``)."""
        log.check(self.engine is not None,
                  "coalescer requires a started ici van")
        return self.engine.coalescer(handle=handle, **kw)

    def replay(self, name: str, grads_seq, keep: str = "all"):
        """T push_pull steps of a registered dense bucket in one call
        (``engine.replay``): ``[T, total]`` for ``keep="all"``,
        ``[total]`` for ``keep="last"``, on the device."""
        log.check(self.engine is not None, "replay requires a started ici van")
        return self.engine.replay(name, grads_seq, keep=keep)

    def push_pull_stream(self, name: str, grads_iter, depth: int = 2):
        """Host-origin push_pulls of a registered dense bucket, with the
        host-to-device staging pipelined against the reductions
        (``engine.push_pull_stream``).  Yields device results."""
        log.check(self.engine is not None,
                  "push_pull_stream requires a started ici van")
        return self.engine.push_pull_stream(name, grads_iter, depth=depth)

    @property
    def sparse_engine(self):
        """The sparse-table engine of the worker's ICI van (None before
        the van starts)."""
        return getattr(self.po.van, "sparse_engine", None)

    def push_sparse(self, name: str, indices, grads,
                    callback: Optional[Callable[[], None]] = None,
                    handle: Optional[str] = None) -> int:
        """Sparse push: ``[W, n]`` rows + ``[W, n, d]`` grads scatter-added
        into the sharded table (the aggregation server handle), or the
        sparse engine's ``handle``; the caller must not mutate the inputs
        until ``wait(ts)``."""
        eng = self.sparse_engine
        log.check(eng is not None, "push_sparse requires the ici van")
        token = eng.push(name, indices, grads, handle=handle)
        return self._engine_dispatch(token, callback=callback)

    def pull_sparse(self, name: str, indices, out=None,
                    callback: Optional[Callable[[], None]] = None) -> int:
        """Sparse pull of ``[W, n]`` rows into ``out`` (``[W, n, d]``, numpy
        or tensor) when given; the device result stays reachable through
        ``get_pulled``."""
        eng = self.sparse_engine
        log.check(eng is not None, "pull_sparse requires the ici van")
        result = eng.pull(name, indices)
        return self._engine_dispatch(result, out=out, callback=callback,
                                     keep_result=True)

    def wait(self, timestamp: int) -> None:
        """Block until the request completed; raise if a server handler
        raised on it (RuntimeError) or its delivery failed
        (TimeoutError)."""
        self._customer.wait_request(timestamp)
        if not (self._timeout_ts or self._error_ts or self._overload_ts):
            return
        with self._mu:
            timed_out = self._timeout_ts.discard(timestamp)
            failed = self._error_ts.discard(timestamp)
            shed = self._overload_ts.discard(timestamp)
        if shed:
            raise OverloadError(
                f"request {timestamp} was shed by the server under "
                f"per-tenant admission control (OPT_OVERLOAD); back off "
                f"and retry")
        if timed_out:
            raise TimeoutError(
                f"request {timestamp} was abandoned: its delivery failed, "
                f"or no response came within PS_REQUEST_TIMEOUT across "
                f"{self._req_retries} retries")
        if failed:
            raise RuntimeError(f"request {timestamp} failed server-side "
                               f"(handler raised while applying; see the "
                               f"server's log for the traceback)")

    # aliases of the reference's spelling
    ZPush = push
    ZPull = pull
    ZPushPull = push_pull
    Wait = wait

    def stop(self) -> None:
        """Retire the combiner (its queued ops go out: their waits expect
        responses), the deadline sweeper, the receive pump and the
        engine completion thread."""
        self.po.unregister_node_failure_hook(self._on_node_event)
        self.po.unregister_routing_hook(self._on_routing)
        if self._combiner is not None:
            self._combiner.stop()
        with self._sweep_cv:
            self._sweep_stop = True
            self._sweep_cv.notify_all()
        if self._sweep_thread is not None:
            self._sweep_thread.join(timeout=5)
            self._sweep_thread = None
        self._customer.stop()
        with self._mu:
            pool, self._engine_pool = self._engine_pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    # -- message path --------------------------------------------------------

    def _new_message_request(self, callback) -> int:
        if not self.po.van.control_plane:
            raise RuntimeError(
                "this key set is not a registered bucket, and the message "
                "path needs a cluster: this worker runs the data plane "
                "alone (DMLC_PS_ROOT_URI unset)")
        ts = self._customer.new_request(SERVER_GROUP)
        if callback is not None:
            with self._mu:
                self._callbacks[ts] = callback
        return ts

    def _slice_msg(self, ts: int, push: bool, pull: bool, cmd: int,
                   part: KVPairs, dest: int, val_nbytes: int,
                   zpull: Optional[dict] = None, rank: int = 0,
                   codec: Optional[str] = None,
                   enc: Optional[_EncodedSlice] = None,
                   tenant: int = 0, trace: int = 0) -> Message:
        """One per-server slice message (``rank``: the server's group
        rank, whose offset a zero-copy pull names; ``enc``: the slice's
        encoded push payload; ``codec``: the response codec a pull asks
        for)."""
        msg = Message()
        m = msg.meta
        m.priority = part.priority
        m.tenant = tenant
        m.app_id = self._customer.app_id
        m.customer_id = self._customer.customer_id
        m.request = True
        m.push = push
        m.pull = pull
        m.head = cmd
        m.timestamp = ts
        m.recver = dest
        m.trace = trace
        m.key = int(part.keys[0]) if len(part.keys) else 0
        m.val_len = val_nbytes if pull and not push else part.vals.nbytes
        if zpull is not None:
            # The server writes its slice at (buf_id, offset).
            m.option = OPT_ZPULL
            m.addr = (zpull["buf_id"] << ZPULL_OFF_BITS) | zpull["offsets"][
                rank]
        elif codec is not None and pull and not push:
            # raw_len=0 marks the request: "encode your response so".
            c = codecs_mod.get_codec(codec)
            m.codec = CodecInfo(codec=c.wire_id, raw_len=0, block=c.block)
        msg.add_data(SArray(part.keys))
        if enc is not None and push:
            # val_len keeps the raw byte count; the codec rides EXT_CODEC.
            m.codec = enc.info
            msg.add_data(SArray(enc.codes))
            msg.add_data(SArray(enc.scales))
            if enc.lens is not None:
                msg.add_data(SArray(np.asarray(enc.lens, dtype=np.int32)))
            return msg
        msg.add_data(SArray(part.vals))
        if part.lens is not None:
            msg.add_data(SArray(np.asarray(part.lens, dtype=np.int32)))
        return msg

    def _send(self, ts: int, push: bool, pull: bool, cmd: int, kvs: KVPairs,
              val_nbytes: int = 0, zpull: Optional[dict] = None,
              codec: Optional[str] = None, tenant: int = 0,
              batch_sink: Optional[List[Message]] = None,
              trace: int = 0) -> None:
        entries = self._route_entries()
        ranges = [rng for rng, _owner in entries]
        sliced = (self._slicer(kvs, ranges)
                  if len(ranges) > 1 or self._slicer is not default_slicer
                  else [kvs])
        # (owner rank, part): under elastic routing an owner is not the
        # entry's index, and one owner may hold several entries.
        live = [(entries[i][1], part) for i, part in enumerate(sliced)
                if part is not None and not part.empty()]
        # Square the response count with what is sent: the servers that
        # get no slice are pre-credited, and an owner of several entries
        # raises the bar (a negative credit).
        credit = self._customer.num_expected(ts) - len(live)
        if credit:
            self._customer.add_response(ts, credit)
        if not live:
            self._finish(ts)
            return
        # Encode every slice once, before any send can fail: a retry
        # resends these bytes (encoding again would fold the
        # error-feedback residual twice).
        encs = [self._encode_part(codec, rank, part)
                if codec is not None and push else None
                for rank, part in live]
        if (self._replica_reads and pull and not push and cmd == 0
                and zpull is None and codec is None):
            # Pure pulls spread over each range's live chain members;
            # _process checks the answer's stamp before accepting it.
            # Zero-copy and codec responses stay with the primary.
            routed = [self._route_read(rank, trace) for rank, _part in live]
        else:
            routed = [(self._route(rank, trace=trace), False)
                      for rank, _part in live]
        dests = [dest for dest, _rr in routed]
        req: Optional[_PendingReq] = None
        if self._req_timeout > 0:
            # Complete before it is published: a sweep racing this send
            # must never see a half-built slice list.
            req = _PendingReq(
                ts=ts, push=push, pull=pull, cmd=cmd,
                deadline=time.monotonic() + self._req_timeout,
                slices=[_PendingSlice(group_rank=rank, part=part, dest=dest,
                                      enc=enc, replica_read=rr)
                        for (rank, part), (dest, rr), enc in zip(
                            live, routed, encs)],
                val_nbytes=val_nbytes, codec=codec, zpull=zpull,
                tenant=tenant, trace=trace)
            with self._mu:
                self._pending[ts] = req
            self._ensure_sweeper()
        for idx, ((rank, part), dest, enc) in enumerate(zip(live, dests,
                                                            encs)):
            sl = req.slices[idx] if req is not None else None
            msg = self._slice_msg(ts, push, pull, cmd, part, dest,
                                  val_nbytes, zpull, rank, codec, enc,
                                  tenant, trace)
            if self._combiner is not None and self._batch_capable(dest):
                msg._batch_sl = sl
                # Every slice toward a batch-capable destination rides the
                # combiner's per-(dest, tenant, priority) stream: small
                # compatible ops merge into EXT_BATCH frames, the rest go
                # alone in position, so batching never reorders a lane.
                if batch_sink is not None:
                    batch_sink.append(msg)  # multi_get: submitted at once
                else:
                    self._combiner.submit(msg)
                continue
            try:
                self.po.van.send(msg)
                if sl is not None:
                    sl.sent_msg = msg
            except Exception as exc:  # noqa: BLE001 - PeerDeadError & co
                self._slice_send_failed(ts, sl, exc)

    def _process(self, msg: Message) -> None:
        if msg.meta.request:
            return  # workers only receive responses
        if msg.meta.batch is not None:
            self._process_batched_response(msg)
            return
        ts = msg.meta.timestamp
        if self._batch_probe_ts:  # unlocked probe: empty almost always
            with self._mu:
                probe_dest = self._batch_probe_ts.pop(ts, None)
            if probe_dest is not None:
                # A clean answer carrying at least our wire version marks
                # the peer capable; an error answer, incapable.
                ok = False
                if msg.meta.option == 0 and len(msg.data) >= 2:
                    vals = msg.data[1].numpy().reshape(-1)
                    ok = vals.size >= 1 and int(vals[0]) >= BATCH_WIRE_VERSION
                with self._mu:
                    self._batch_caps[probe_dest] = ok
                    self._batch_probing.discard(probe_dest)
                return
        cache_ident = msg.meta.sender
        if self._req_timeout > 0:
            discount, primary = self._pending_response(msg)
            if discount:
                # Pre-compensate the +1 the Customer adds after this
                # handle.
                self._customer.add_response(ts, -1)
                return
            if primary is not None:
                # A replica-served pull: its stamp is in the primary's
                # counter domain, so the cache files it under the
                # primary's identity.
                cache_ident = primary
        option = msg.meta.option
        if option == OPT_SEND_FAILED:
            with self._mu:
                self._timeout_ts.add(ts)
                if ts in self._req_track:
                    self._req_outcome[ts] = "send_failed"
        elif option == OPT_APPLY_ERROR:
            with self._mu:
                self._error_ts.add(ts)
                if ts in self._req_track:
                    self._req_outcome[ts] = "error"
        elif option == OPT_OVERLOAD:
            # Shed by the server's admission control: the request
            # completes fast and wait(ts) raises OverloadError.
            self._c_overloads.inc()
            with self._mu:
                self._overload_ts.add(ts)
                if ts in self._req_track:
                    self._req_outcome[ts] = "shed"
        elif option == OPT_WRONG_OWNER:
            # A bounce past the bounce budget, or one without deadlines
            # to re-route it: the request fails.
            with self._mu:
                self._timeout_ts.add(ts)
        if self._replica_reads and msg.meta.push and msg.meta.stamp:
            # An acknowledged push raises this worker's read-your-writes
            # floor for the acking server.
            with self._mu:
                if msg.meta.stamp > self._seen_stamps.get(msg.meta.sender,
                                                          0):
                    self._seen_stamps[msg.meta.sender] = msg.meta.stamp
        hc = self._hot_cache
        if hc is not None and msg.meta.stamp:
            # Every stamped response advances its server's newest known
            # version, invalidating older fills.
            hc.observe(cache_ident, msg.meta.stamp)
        if msg.meta.pull and len(msg.data) >= 2:
            ci = msg.meta.codec
            if ci is not None and ci.raw_len > 0 and len(msg.data) >= 3:
                # An encoded response: raw_len sizes the decode, data[3]
                # holds per-key lens of a ragged payload.
                codec = codecs_mod.by_wire_id(ci.codec)
                codecs_mod.check_block(ci)
                lens = (msg.data[3].astype_view(np.int32).numpy()
                        if len(msg.data) > 3 else None)
                kvs = KVPairs(
                    keys=msg.data[0].astype_view(np.uint64).numpy(),
                    vals=codec.decode(
                        msg.data[1].astype_view(np.uint8).numpy(),
                        msg.data[2].astype_view(np.float32).numpy(),
                        ci.raw_len // 4, lens=lens, flags=ci.flags),
                    lens=lens)
            else:
                kvs = KVPairs(
                    keys=msg.data[0].astype_view(np.uint64).numpy(),
                    vals=msg.data[1].numpy(),
                    lens=(msg.data[2].astype_view(np.int32).numpy()
                          if len(msg.data) > 2 else None),
                )
            with self._mu:
                self._recv_kvs.setdefault(ts, []).append(kvs)
                zp = ts in self._zpull_ts
            if (not zp and hc is not None and msg.meta.stamp
                    and option == 0 and msg.meta.head == 0
                    and kvs.lens is None and len(kvs.keys)
                    and len(kvs.vals) % len(kvs.keys) == 0):
                # The fill stamp was read at the server's intake, so it
                # never claims more than the values saw (copied: response
                # buffers recycle).
                hc.fill(cache_ident, msg.meta.stamp, kvs.keys, kvs.vals)
        # The Customer counts this response *after* the handle, so the
        # last response is expected - 1 (reference: kv_app.h:686-710).
        if (self._customer.num_response(ts) + 1
                >= self._customer.num_expected(ts)):
            self._finish(ts)

    # -- bounded requests -----------------------------------------------------

    @staticmethod
    def _slice_of(req: _PendingReq, key: int) -> Optional[_PendingSlice]:
        """The slice a response answers (responses echo its first key)."""
        return next((s for s in req.slices
                     if len(s.part.keys) and int(s.part.keys[0]) == key),
                    None)

    def _slice_answered(self, ts: int, key: int) -> bool:
        """Mark the slice of (ts, key) answered; True for a duplicate (a
        slow original answering after its retry did: the first counts)."""
        with self._mu:
            req = self._pending.get(ts)
            sl = None if req is None else self._slice_of(req, key)
            if sl is None:
                return False
            if sl.responded:
                return True
            sl.responded = True
            return False

    def _pending_response(self, msg: Message) -> Tuple[bool, Optional[int]]:
        """Deadline bookkeeping of one response: ``(discount, primary)``.
        Discounted are a duplicate, a send failure the sweeper retries,
        a stale give-up of a request that completed or was abandoned,
        and a replica's answer older than a push this worker saw
        acknowledged (the sweeper pulls it again from the primary).
        ``primary`` is the primary's id when a replica answered a
        spread pull, else None."""
        ts = msg.meta.timestamp
        if msg.meta.option == OPT_WRONG_OWNER:
            return self._wrong_owner_response(msg), None
        if msg.meta.option != OPT_SEND_FAILED:
            if not self._replica_reads:
                return self._slice_answered(ts, msg.meta.key), None
            return self._replica_answer(msg)
        return self._send_failed_response(msg), None

    def _wrong_owner_response(self, msg: Message) -> bool:
        """``_pending_response`` of an ``OPT_WRONG_OWNER`` bounce: the
        server does not own the slice's range under its epoch and
        applied nothing.  With bounce budget left the sweeper re-slices
        the slice under the current table (discounted, so the re-routed
        slices' answers complete the count); a stale bounce of a request
        that completed or was abandoned is discounted too.  The bounce
        carries the server's epoch: a newer one than ours pulls the
        table from the scheduler."""
        ts = msg.meta.timestamp
        self._c_wrong_owner.inc()
        discount = True
        with self._mu:
            if ts in self._req_track:
                self._req_outcome[ts] = "wrong_owner"
            req = self._pending.get(ts)
            if req is not None:
                sl = self._slice_of(req, msg.meta.key)
                if req.bounces < self._MAX_WRONG_OWNER_BOUNCES:
                    if sl is not None:
                        sl.retry_now = True
                        sl.wrong_owner = True
                    else:
                        req.deadline = 0.0  # unmatched: expire them all
                else:
                    discount = False
                    self._mark_timed_out(ts)
                    if sl is not None:
                        sl.responded = True
        self._maybe_pull_routing(int(msg.meta.val_len))
        if discount and req is not None:
            self._wake_sweeper()
        return discount

    def _replica_answer(self, msg: Message) -> Tuple[bool, Optional[int]]:
        """``_pending_response`` of a normal response under replica
        reads: the first answer per slice counts, unless it is a stale
        replica answer."""
        ts = msg.meta.timestamp
        stale = False
        with self._mu:
            req = self._pending.get(ts)
            sl = None if req is None else self._slice_of(req, msg.meta.key)
            if sl is None:
                return False, None
            if sl.responded:
                return True, None
            primary = None
            if sl.replica_read:
                pid = server_rank_to_id(sl.group_rank * self.po.group_size
                                        + self.po.instance_idx)
                if msg.meta.sender != pid:
                    primary = pid
                    stale = (msg.meta.stamp
                             < self._seen_stamps.get(pid, 0))
            if stale:
                sl.retry_now = True
                sl.replica_read = False  # the sweeper -> the primary
                self._c_replica_fallbacks.inc()
                if ts in self._req_track:
                    self._req_outcome[ts] = "replica_stale"
            else:
                sl.responded = True
        if stale:
            now = time.monotonic()
            if now - self._fallback_logged > 1.0:
                # Throttled: a lagging replica under a read storm would
                # wrap the flight ring.
                self._fallback_logged = now
                self.po.flight.record(
                    "replica_stale_fallback", severity="warn",
                    replica=msg.meta.sender, primary=pid,
                    stamp=msg.meta.stamp,
                    seen=self._seen_stamps.get(pid, 0))
            self._wake_sweeper()
            return True, None
        return False, primary

    def _send_failed_response(self, msg: Message) -> bool:
        """``_pending_response`` of an ``OPT_SEND_FAILED`` give-up: True
        (discount) while the sweeper retries the slice, or for a stale
        give-up."""
        ts = msg.meta.timestamp
        retry = False
        with self._mu:
            req = self._pending.get(ts)
            if req is None:
                return True
            sl = self._slice_of(req, msg.meta.key)
            if req.attempt < self._req_retries:
                retry = True
                if sl is not None:
                    sl.retry_now = True
                else:
                    req.deadline = 0.0  # unmatched: expire every slice
            else:
                self._mark_timed_out(ts)
                if sl is not None:
                    sl.responded = True
        if retry:
            self._wake_sweeper()
        return retry

    def _on_node_event(self, node_id: int, down: bool) -> None:
        """Node-failure hook: track dead servers; a death wakes the
        sweeper, so requests toward the dead rank retry (and, with no
        replica to fail over to, exhaust) without waiting out their
        deadlines."""
        if not is_server_id(node_id):
            return
        with self._mu:
            if down:
                self._down_servers.add(node_id)
            else:
                self._down_servers.discard(node_id)
                self._failover_logged.discard(node_id)
                # A recovered server restarts its push stamps: the old
                # floor would brand every replica answer stale.
                self._seen_stamps.pop(node_id, None)
                self._read_share.pop(node_id, None)
        if down:
            self._wake_sweeper()

    def _on_routing(self, table) -> None:
        """Routing hook: a new epoch landed.  Cache fills of every range
        that changed hands go (their stamps were minted by the old
        owner, whose counter the new owner's can never supersede), and
        the sweeper wakes, so bounced slices re-route at once."""
        if self._hot_cache is not None:
            for e in table.entries:
                if e.prev not in (-1, e.owner):
                    self._hot_cache.invalidate_range(e.begin, e.end)
        self._wake_sweeper()

    def _route_entries(self) -> List[Tuple[Range, int]]:
        """The slicing plan, ``(key range, owner rank)``: under elastic
        membership the routing table's entries (owners are not the entry
        index once ranges migrate), else the static split, entry i owned
        by rank i (cached: it never changes, and this runs on every op's
        issue path without the routing lock)."""
        if not self.po.elastic:
            if self._static_entries is None:
                self._static_entries = [
                    (rng, i)
                    for i, rng in enumerate(self.po.get_server_key_ranges())]
            return self._static_entries
        rt = self.po.current_routing()
        if rt is not None:
            return [(Range(e.begin, e.end), e.owner) for e in rt.entries]
        return [(rng, i)
                for i, rng in enumerate(self.po.get_server_key_ranges())]

    def _maybe_pull_routing(self, seen_epoch: int) -> None:
        """A server bounced a slice with an epoch ahead of ours: pull the
        table from the scheduler (one pull per 0.2 s window, not one per
        bounced slice)."""
        rt = self.po.current_routing()
        if seen_epoch <= (rt.epoch if rt is not None else -1):
            return
        now = time.monotonic()
        with self._mu:
            if now - self._last_routing_pull < 0.2:
                return
            self._last_routing_pull = now
        self.po.van._pull_routing()

    def _hold(self, sl: _PendingSlice) -> bool:
        """Whether a slice whose send failed waits for its deadline
        instead of a retry at once: under replication, while its route
        has not changed.  A server that died breaks its connections
        before the detector declares it; retrying there at once would
        spend the retries in milliseconds, before the failover the
        declaration brings (JAX's van reports such failures later, so
        its sweeper never meets this)."""
        return (self._replication > 1
                and self._route(sl.group_rank, count=False) == sl.dest)

    def _route(self, group_rank: int, count: bool = True,
               trace: int = 0) -> int:
        """A slice's destination: its owner rank's instance, or, when it
        is down and replication is on, the first live member of its
        replica chain (``chain_ranks``, the servers' own topology).  The
        first failover of an outage is flight-recorded, with the trace
        id in scope."""
        gs = self.po.group_size
        base = server_rank_to_id(group_rank * gs + self.po.instance_idx)
        if base not in self._down_servers:
            return base
        for rank in chain_ranks(group_rank, self._replication,
                                self.po.num_servers,
                                active=self.po.active_server_ranks):
            cand = server_rank_to_id(rank * gs + self.po.instance_idx)
            if cand not in self._down_servers:
                if count:
                    self._c_failovers.inc()
                    if base not in self._failover_logged:
                        self._failover_logged.add(base)
                        detail = {"trace": f"{trace:x}"} if trace else {}
                        self.po.flight.record("failover", severity="warn",
                                              dead=base, replica=cand,
                                              **detail)
                return cand
        return base

    def _route_read(self, group_rank: int,
                    trace: int = 0) -> Tuple[int, bool]:
        """Destination of a pure pull slice under replica reads: a live
        member of the range's chain, picked by
        ``PS_REPLICA_READ_POLICY``: ``sticky`` (default) pins this
        worker's reads of the range to one member by worker rank, ``rr``
        rotates per pull, ``load`` takes the member this worker has sent
        the fewest reads.  Returns ``(dest, is_replica)``; with one live
        member, or the primary down, plain primary routing."""
        gs = self.po.group_size
        base = server_rank_to_id(group_rank * gs + self.po.instance_idx)
        members = [] if base in self._down_servers else [base]
        for rank in chain_ranks(group_rank, self._replication,
                                self.po.num_servers,
                                active=self.po.active_server_ranks):
            cand = server_rank_to_id(rank * gs + self.po.instance_idx)
            if cand not in self._down_servers:
                members.append(cand)
        if len(members) <= 1 or base in self._down_servers:
            return self._route(group_rank, trace=trace), False
        if self._read_policy == "load":
            dest = self._least_loaded_member(members)
        elif self._read_policy == "rr":
            dest = members[next(self._rr_counter) % len(members)]
        else:
            # Deterministic rotation by worker rank, offset by the range
            # rank, so one worker's reads of different ranges land on
            # different members.
            dest = members[(self.po.my_rank() + group_rank)
                           % len(members)]
        self._read_share[dest] = self._read_share.get(dest, 0) + 1
        if dest != base:
            self._c_replica_reads.inc()
        return dest, dest != base

    def attach_history(self, history) -> None:
        """Give the ``load`` read policy cluster truth: rank the spread
        set by ``history``'s windowed per-server pull rates (every
        worker's traffic); ``None`` reverts to local send counts."""
        self._cluster_history = history

    def _least_loaded_member(self, members) -> int:
        """``load`` policy: the member with the lowest windowed
        ``kv.server_pull_requests`` rate in the attached history (local
        send counts break ties and rank the members it has not rated);
        local counts alone without a history."""
        hist = self._cluster_history
        if hist is not None:
            rated = {}
            for d in members:
                r = hist.rate(d, "kv.server_pull_requests")
                if r is not None:
                    rated[d] = r
            if rated:
                return min(members, key=lambda d: (
                    rated.get(d, 0.0), self._read_share.get(d, 0)))
        return min(members, key=lambda d: self._read_share.get(d, 0))

    def _ensure_sweeper(self) -> None:
        if self._sweep_thread is not None and self._sweep_thread.is_alive():
            return
        with self._sweep_cv:
            if self._sweep_stop or (self._sweep_thread is not None
                                    and self._sweep_thread.is_alive()):
                return
            self._sweep_thread = threading.Thread(
                target=self._sweep_loop, name="kv-deadline-sweeper",
                daemon=True)
            self._sweep_thread.start()

    def _wake_sweeper(self) -> None:
        with self._sweep_cv:
            self._sweep_cv.notify_all()

    def _sweep_loop(self) -> None:
        period = max(0.02, min(self._req_timeout / 4.0, 0.5))
        while True:
            with self._sweep_cv:
                if self._sweep_stop:
                    return
                self._sweep_cv.wait(period)
                if self._sweep_stop:
                    return
            try:
                self._sweep_once()
            except Exception as exc:  # noqa: BLE001 - the sweeper survives
                log.warning(f"deadline sweeper error: {exc!r}")

    def _sweep_once(self) -> None:
        now = time.monotonic()
        retries: List[Tuple[_PendingReq, List[_PendingSlice]]] = []
        failures: List[Tuple[int, int]] = []
        with self._mu:
            for ts, req in list(self._pending.items()):
                unresp = [s for s in req.slices if not s.responded]
                if not unresp:
                    self._pending.pop(ts)
                    continue
                # Retried: every unresponded slice once the deadline
                # passed, else only those known failed or toward a dead
                # server (never healthy siblings: their sends would
                # duplicate).
                expired = now >= req.deadline
                troubled = [s for s in unresp
                            if expired or s.dest in self._down_servers
                            or (s.retry_now and (s.wrong_owner
                                                 or not self._hold(s)))]
                if not troubled:
                    continue
                # A pass of wrong-owner bounces only charges the bounce
                # budget, not the retry budget.
                bounce_only = not expired and all(s.wrong_owner
                                                  for s in troubled)
                if (req.bounces >= self._MAX_WRONG_OWNER_BOUNCES
                        if bounce_only
                        else req.attempt >= self._req_retries):
                    self._pending.pop(ts)
                    self._mark_timed_out(ts)
                    failures.append((ts, len(unresp)))
                    continue
                if bounce_only:
                    req.bounces += 1
                    req.deadline = max(req.deadline,
                                       now + self._req_timeout)
                else:
                    req.attempt += 1
                    # Exponential backoff: each attempt doubles the
                    # window.
                    req.deadline = now + self._req_timeout * (
                        2 ** req.attempt)
                    # A retried request's trace is kept even when the
                    # retry succeeds: it shows why the first was lost.
                    self._req_outcome.setdefault(ts, "retry")
                for sl in troubled:
                    sl.retry_now = False
                self._c_retries.inc(len(troubled))
                retries.append((req, troubled))
        resender = self.po.van.resender
        for req, slices in retries:
            for sl in slices:
                subs = [sl]
                if sl.wrong_owner:
                    # Re-sliced under the current table: a split that
                    # landed inside the range divides this slice.
                    sl.wrong_owner = False
                    subs = self._resplit_slice(req, sl)
                for sub in subs:
                    self._resend_slice(req, sub, resender)
        for ts, deficit in failures:
            log.warning(f"request ts={ts} abandoned after "
                        f"{self._req_retries} retries; failing wait()")
            # Square the response ledger: wait(ts) unblocks and raises.
            self._customer.add_response(ts, deficit)

    def _resend_slice(self, req: _PendingReq, sl: _PendingSlice,
                      resender) -> None:
        """One retry of a slice: a new message (a fresh sid at dispatch,
        so the receiver's dedup keeps it) to the slice's route."""
        old = sl.sent_msg
        if old is not None and resender is not None:
            # The retry supersedes it: retransmitting the old one would
            # end in a give-up that fails a request its retry completed.
            resender.forget(old.meta.control.msg_sig)
        # Retries go to the primary (or its failover): a spread pull that
        # timed out or answered stale gets no second replica.
        sl.replica_read = False
        sl.dest = self._route(sl.group_rank, trace=req.trace)
        log.vlog(1, f"retry ts={req.ts} slice rank={sl.group_rank} -> "
                    f"node {sl.dest} (attempt {req.attempt}, bounces "
                    f"{req.bounces})")
        msg = self._slice_msg(req.ts, req.push, req.pull, req.cmd, sl.part,
                              sl.dest, req.val_nbytes, req.zpull,
                              sl.group_rank, req.codec, sl.enc, req.tenant,
                              req.trace)
        try:
            self.po.van.send(msg)
            sl.sent_msg = msg
        except Exception as exc:  # noqa: BLE001 - the next sweep
            log.warning(f"retry send ts={req.ts} to {sl.dest} failed: "
                        f"{exc!r}")

    def _resplit_slice(self, req: _PendingReq,
                       sl: _PendingSlice) -> List[_PendingSlice]:
        """A bounced slice's keys sliced again under the current routing
        table.  One owner: the slice itself, retargeted.  Several: the
        sub-slices replace it in the request's list and raise the
        expected response count by the extra ones.  A codec push encodes
        each sub-slice afresh (the first encoding's residual stays with
        the abandoned destination's slot: one step of residual in a
        migration window, not a loss)."""
        entries = self._route_entries()
        parts = self._slicer(sl.part, [rng for rng, _owner in entries])
        live = [(entries[i][1], p) for i, p in enumerate(parts)
                if p is not None and not p.empty()]
        if len(live) <= 1:
            if live:
                sl.group_rank = live[0][0]
            return [sl]
        subs = [_PendingSlice(group_rank=owner, part=p, dest=-1)
                for owner, p in live]
        if req.codec is not None and req.push:
            for sub in subs:
                sub.enc = self._encode_part(req.codec, sub.group_rank,
                                            sub.part)
        with self._mu:
            try:
                idx = req.slices.index(sl)
            except ValueError:
                return [sl]  # replaced or retired meanwhile
            req.slices[idx:idx + 1] = subs
        # Each sub-slice draws its own response.
        self._customer.add_response(req.ts, -(len(subs) - 1))
        log.vlog(1, f"re-sliced ts={req.ts} over "
                    f"{[s.group_rank for s in subs]} (routing change)")
        return subs

    def _process_batched_response(self, msg: Message) -> None:
        """One response frame of N sub-ops: each sub-op is processed and
        counted here (the Customer skips a batch envelope's count)."""
        info = msg.meta.batch
        if not msg.data and all(op.option == 0 and not op.pull
                                for op in info.ops):
            # All push acks (a storm's return traffic): account per op
            # without building per-op messages.
            sender = msg.meta.sender
            hc = self._hot_cache
            tracer = self.po.tracer
            tr_active = tracer.active
            for op in info.ops:
                ts = op.timestamp
                discount = False
                if tr_active and op.trace:
                    # The envelope carries no trace id: the per-op
                    # arrival instant bounds the response_wire stage.
                    tracer.instant(op.trace, "recv",
                                   args={"from": sender, "request": False})
                try:
                    if self._req_timeout > 0:
                        discount = self._slice_answered(ts, op.key)
                    if self._replica_reads and op.stamp:
                        # Batched push acks raise the read-your-writes
                        # floor too (every op here is a push).
                        with self._mu:
                            if op.stamp > self._seen_stamps.get(sender, 0):
                                self._seen_stamps[sender] = op.stamp
                    if hc is not None and op.stamp:
                        hc.observe(sender, op.stamp)
                    if discount:
                        continue
                    if (self._customer.num_response(ts) + 1
                            >= self._customer.num_expected(ts)):
                        self._finish(ts)
                except Exception as exc:  # noqa: BLE001 - count it anyway
                    log.warning(f"batched sub-op ts={ts} response "
                                f"handling failed: {exc!r}")
                finally:
                    if not discount:
                        self._customer.add_response(ts)
            return
        tracer = self.po.tracer
        for sub in split_batch_message(msg):
            if tracer.active and sub.meta.trace:
                tracer.instant(sub.meta.trace, "recv",
                               args={"from": msg.meta.sender,
                                     "request": False})
            try:
                self._process(sub)
            except Exception as exc:  # noqa: BLE001 - count it anyway
                log.warning(f"batched sub-op ts={sub.meta.timestamp} "
                            f"response handling failed: {exc!r}")
            finally:
                self._customer.add_response(sub.meta.timestamp)

    def _finish(self, ts: int) -> None:
        with self._mu:
            self._pending.pop(ts, None)  # no more deadline to keep
            chunks = self._recv_kvs.pop(ts, [])
            dst = self._pull_dst.pop(ts, None)
            zpull = ts in self._zpull_ts
            self._zpull_ts.discard(ts)
            track = self._req_track.pop(ts, None)
            if ts in self._raw_ts:
                # fetch_hot_keys: the caller takes the per-server KVPairs.
                self._raw_ts.discard(ts)
                self._raw_results[ts] = chunks
                chunks = []
        if track is not None:
            t0, was_pull, trace, t0_us, parent = track
            dur = time.monotonic() - t0
            (self._h_pull_lat if was_pull else self._h_push_lat).observe(dur)
            with self._mu:
                outcome = self._req_outcome.pop(ts, None)
            if trace:
                self._finish_trace(ts, trace, was_pull, dur, t0_us,
                                   parent, outcome)
        if zpull and chunks and dst is not None and all(
                np.shares_memory(c.vals, dst[1]) for c in chunks):
            # Every slice was written in place: nothing to reassemble.
            self.zpull_hits += 1
            self._run_callback(ts)
            return
        if dst is not None and chunks:
            _keys, vals_out, lens_out = dst
            chunks.sort(key=lambda kv: int(kv.keys[0]) if len(kv.keys) else 0)
            total = sum(c.vals.nbytes for c in chunks)
            log.check(total <= vals_out.nbytes,
                      f"pull response too large: {total} > "
                      f"{vals_out.nbytes}")
            flat = vals_out.reshape(-1).view(np.uint8)
            off = 0
            for c in chunks:
                raw = c.vals.reshape(-1).view(np.uint8)
                flat[off: off + raw.nbytes] = raw
                off += raw.nbytes
            if lens_out is not None:
                loff = 0
                for c in chunks:
                    if c.lens is not None:
                        lens_out[loff: loff + len(c.lens)] = c.lens
                        loff += len(c.lens)
        self._run_callback(ts)

    def _run_callback(self, ts: int) -> None:
        with self._mu:
            cb = self._callbacks.pop(ts, None)
            # A failed request's data never (fully) landed: no callback.
            failed = (ts in self._error_ts or ts in self._timeout_ts
                      or ts in self._overload_ts)
        if cb is not None and not failed:
            cb()


class KVServer:
    """Holder of a key-range shard of the store (kv_app.h:304-420).

    A handle with ``apply_shard`` (both handles below) applies on the
    apply-shard pool (``PS_APPLY_SHARDS``, default ``min(8, cores)``);
    with ``PS_APPLY_SHARDS=0``, or any other handle, requests apply
    serially on the customer thread in arrival order.  Codec pushes are
    decoded before the handler sees them (by the pool's shards where they
    can be), and pull responses are encoded as the request asks.

    An ``EXT_BATCH`` request runs the same per-op intake as a single one
    (stamps, hot-key counts, decode, admission, replication) and enters
    the pool as a group; ``BATCH_PROBE_CMD`` and ``HOT_KEYS_CMD`` pulls
    are answered before the handler.

    Durability: under ``PS_KV_REPLICATION`` >= 2 a ``Replicator``
    forwards accepted pushes and serves ``REPLICA_FETCH_CMD``; a
    recovered server (``po.is_recovery``) restores from its chain, and
    with ``PS_SNAPSHOT_RESTORE=1`` from the committed snapshot, in
    ``set_request_handle`` before serving (requests arriving meanwhile
    park and replay in arrival order).  ``Command.SNAPSHOT`` requests
    (cuts and namespace ops) run on the request thread
    (``_run_snapshot``)."""

    _MAX_STREAMS = 64  # open streamed pushes; the oldest is aborted
    _HANDLE_WAIT_S = 30.0  # a request's wait for set_request_handle
    _FORWARD_WAIT_S = 30.0  # an acknowledgement's wait for its forwards

    def __init__(self, app_id: int, postoffice=None):
        self.po = postoffice or ps_mod.postoffice(Role.SERVER)
        env = self.po.env
        resp_bytes = max(0, env.find_int(
            "PS_RESP_BATCH_BYTES", max(0, env.find_int("PS_BATCH_BYTES", 0))))
        self._handle: Optional[Callable[[KVMeta, KVPairs, "KVServer"],
                                        None]] = None
        # Set once set_request_handle has installed the handle and its
        # pool: the customer receives from construction on, and a
        # request that raced the app's set_request_handle waits for it.
        self._handle_set = threading.Event()
        self._recv_buffers: Dict[Tuple[int, int], np.ndarray] = {}
        self.delivered_in_place = 0  # pushes the van placed in a buffer
        self.streams_opened = 0  # chunked pushes applied as they landed
        self._apply_shards = self._resolve_apply_shards()
        self._apply_pool: Optional[ApplyShardPool] = None
        # Streamed chunked pushes by the van's (sender, xfer) key; the
        # reassembled message closes its stream.  TTL as the assembler's.
        self._streams_mu = threading.Lock()
        self._streams: Dict[Tuple[int, int], object] = {}
        self._stream_ttl = self.po.env.find_float("PS_XFER_TIMEOUT", 120.0)
        self._stream_ticks = 0
        # Pull responses are encoded here, with residuals per (worker,
        # slice) on the handle (``ef_bank``, made at first use).
        self._codec_ef_enabled = codecs_mod.ef_enabled(self.po.env)
        metrics = node_registry(getattr(self.po, "metrics", None))
        self._c_codec_raw = metrics.counter("codec.raw_bytes")
        self._c_codec_wire = metrics.counter("codec.wire_bytes")
        # The bounded hot-key tracker HOT_KEYS_CMD answers from.
        self._hot_keys = metrics.topk("kv.hot_keys")
        self._c_push_reqs = metrics.counter("kv.server_push_requests")
        self._c_pull_reqs = metrics.counter("kv.server_pull_requests")
        self._h_serial_apply = metrics.histogram("apply.latency_s")
        self._c_shed = metrics.counter("qos.shed_requests")
        # Per-tenant request/shed counters, and per tenant [last
        # overload_shed flight event, suppressed count].
        self._tenant_counters: Dict[int, tuple] = {}
        self._shed_flight: Dict[int, list] = {}
        self._c_wrong_owner = metrics.counter("kv.wrong_owner")
        self._c_migrated_out = metrics.counter("kv.migrated_keys_out")
        self._c_migrated_in = metrics.counter("kv.migrated_keys_in")
        self._c_parked = metrics.counter("kv.parked_requests")
        self._h_snapshot = metrics.histogram("snapshot.duration_s")
        # Tenants and admission: a tenant whose apply backlog reaches
        # PS_TENANT_QUEUE_LIMIT (default 1024 with PS_TENANTS, else off)
        # gets OPT_OVERLOAD instead of unbounded queueing.
        self.tenants = tenants_mod.table_for(env)
        self._admit_limit = env.find_int(
            "PS_TENANT_QUEUE_LIMIT", 1024 if self.tenants.enabled else 0)
        # The push-version stamp of the hot cache: bumped after a push
        # applied (as its response leaves), read at pull intake; it
        # starts at 1 (0 means unstamped).  Stamping engages only with a
        # QoS feature configured, so default frames carry no EXT_QOS.
        self._qos_mu = threading.Lock()
        self._push_version = 1
        self._qos_stamps = bool(self.tenants.enabled
                                or env.find_int("PS_HOT_CACHE", 0)
                                or env.find_int("PS_QOS_STAMPS", 0))
        # The response combiner (PS_RESP_BATCH_BYTES, by default
        # PS_BATCH_BYTES): small responses toward one (sender, tenant,
        # priority) lane merge into EXT_BATCH frames, but only toward
        # senders that proved batch awareness (a probe or an EXT_BATCH
        # frame), and traced ones only toward v2 decoders.
        self._batch_senders: set = set()
        self._batch_senders_v2: set = set()
        self._resp_combiner: Optional[OpCombiner] = None
        if resp_bytes > 0:
            self._resp_combiner = OpCombiner(
                lambda m: self.po.van.send(m), self._resp_send_failed,
                max_bytes=resp_bytes,
                window_us=env.find_float("PS_RESP_BATCH_WINDOW_US", 0.0),
                min_ops=env.find_int("PS_RESP_BATCH_MIN_OPS", 32),
                hold_max_us=env.find_float("PS_RESP_BATCH_HOLD_US", 2000.0),
                response=True, tracer=self.po.tracer)
        # Elastic membership: ownership and parking.  ``_owned`` is None
        # until a routing table lands (static: every request is ours);
        # then a request with a key outside it bounces OPT_WRONG_OWNER,
        # and one for a range gained but not yet migrated parks until
        # the handoff lands.
        self._elastic_mu = threading.Lock()
        self._owned: Optional[List[Range]] = None
        self._table = None  # the applied RoutingTable
        self._routing_epoch = -1
        # (owner, begin, end) of the ranges this server replicated under
        # the previous epoch: the diff against a new table's chains
        # names the ranges to backfill.  None until the first table.
        self._replicated_prev: Optional[set] = None
        # range begin -> {"range", "frm", "epoch", "parked", "timer"}
        self._pending_ranges: Dict[int, dict] = {}
        # Migrations that landed before their table (begin -> epoch).
        self._arrived_migrations: Dict[int, int] = {}
        self._migrate_timeout = env.find_float("PS_MIGRATE_TIMEOUT", 30.0)
        # Migration acks that came back error-marked: the old owner
        # keeps its copy.
        self._migrate_nacks = BoundedKeySet(256)
        # Outbound migrations run one batch at a time on one thread: a
        # second epoch mid-handoff neither starts a second exporter nor
        # lets a leaver report REMOVE_DONE early.
        self._migrate_q: List[tuple] = []
        self._migrating = False
        # stats["wrong_owner"], stats["migrated_keys_in"], ...: the kv.*
        # counters above.
        self.stats = CounterView(metrics, prefix="kv.")
        if self.po.elastic:
            # Ownership from the node's current table before the
            # customer delivers any parked request: a joiner that
            # applied early requests tableless would have them
            # overwritten by the migration import.  A joiner whose first
            # broadcast is still in flight owns nothing yet (it bounces).
            table = self.po.current_routing()
            if table is not None:
                self._apply_routing_update(table)
            elif self.po.elastic_join:
                self._owned = []
        self._customer = Customer(
            app_id, app_id, self._process, self.po,
            on_request_error=self._request_error,
            executor_workers=min(
                1, self.po.env.find_int("PS_CUSTOMER_EXECUTOR", 0)),
        )
        self.po.register_node_failure_hook(self._on_stream_peer_event)
        # Chain replication: a recovered server restores its ranges
        # from its chain before serving.  While it restores (from the
        # replicas or a snapshot), requests park in _restore_buffer and
        # replay in arrival order afterwards (None: not restoring).
        self._replicator: Optional[Replicator] = None
        self._restored = False
        self._restore_mu = threading.Lock()
        self._restore_buffer: Optional[List[Message]] = None
        # The buffer belongs to a replica backfill (not a restore): this
        # server's own ranges are whole, so range fetches are served
        # meanwhile (``_process``).
        self._backfilling = False
        # Replica reads: a replica answers pulls of another rank's range
        # in that primary's stamp currency (stamping engages).
        self._replica_reads = bool(env.find_int("PS_REPLICA_READS", 0))
        self._qos_stamps = self._qos_stamps or self._replica_reads
        # Coordinated snapshots and restore on boot.
        self._snapshot_dir = self.po.snapshot_dir
        self._snapshot_quiesce_s = env.find_float("PS_SNAPSHOT_QUIESCE_S",
                                                  30.0)
        self._snapshotting = False
        self._snap_restored = False
        # Model namespaces: a published manifest staged as a store of
        # its own, flipped in on the request thread; the displaced store
        # stays for rollback.
        self._ns_staged: Optional[tuple] = None   # (name, version, store)
        self._ns_prev: Optional[tuple] = None     # (name, version, store)
        self._ns_current: Tuple[str, str] = ("live", "")
        self._ns_staging = False
        self.po.register_snapshot_hook(self._on_snapshot_request)
        if self._snapshot_dir:
            # Sampled at METRICS_PULL: the watchdog's snapshot_age rule
            # reads it.
            metrics.gauge("snapshot.age_s",
                          fn=lambda d=self._snapshot_dir:
                          snapshot_mod.manifest_age_s(d))
        rep = env.find_int("PS_KV_REPLICATION", 1)
        if rep >= 2 and self.po.num_servers >= 2:
            self._replicator = Replicator(self, rep)
            # A server falsely declared dead and then forgiven missed
            # every write that failed over meanwhile: it resyncs.
            self.po.register_node_failure_hook(self._on_self_rehab)
        if self.po.elastic:
            # Later epochs reach the request thread through the request
            # queue (the cutover serializes against every earlier
            # request); the registration's replay of the current table
            # is discarded by the epoch guard.
            self.po.register_routing_hook(self._on_routing)

    def _resolve_apply_shards(self) -> int:
        try:
            # A container pinned to few cores gets few shard threads.
            n_cores = len(os.sched_getaffinity(0))
        except (AttributeError, OSError):
            n_cores = os.cpu_count() or 1
        return self.po.env.find_int("PS_APPLY_SHARDS", min(8, n_cores))

    def set_request_handle(
            self, handle: Callable[[KVMeta, KVPairs, "KVServer"], None]
    ) -> None:
        """Install the handle (and the apply pool for one with
        ``apply_shard``).  Under ``PS_STORE_RAM_MB`` the handle's dict
        store becomes a ``TieredStore`` first.  A recovered replicated
        server, or any server under ``PS_SNAPSHOT_RESTORE=1``, restores
        here before serving: the snapshot first, then the replicas
        (whose newer state overwrites it); a failed snapshot restore
        raises."""
        if self._apply_pool is not None:
            self._abort_streams()  # their handles hold the old pool
            self._apply_pool.stop()
            self._apply_pool = None
        if self._handle is not None and handle is not self._handle:
            # The displaced handle's tiered store releases its files.
            old_store = getattr(self._handle, "store", None)
            if callable(getattr(old_store, "close", None)):
                old_store.close()
        self._handle = handle
        if hasattr(handle, "apply_shard"):
            # Its native add honours this node's PS_NATIVE.
            handle._env = self.po.env
        pool_eligible = self._apply_shards > 0 and callable(
            getattr(handle, "apply_shard", None))
        env = self.po.env
        ram_mb = env.find_float("PS_STORE_RAM_MB", 0.0)
        if ram_mb > 0 and isinstance(getattr(handle, "store", None), dict):
            # Before the pool starts, so every apply, restore and import
            # goes through the tier.  Eviction classes are the pool's
            # shard modulus, which keeps the tier bit-exact with RAM.
            handle.store = TieredStore(
                ram_bytes=int(ram_mb * (1 << 20)),
                directory=env.find("PS_STORE_DIR") or None,
                shards=self._apply_shards if pool_eligible else 1,
                hot_fn=lambda k=64: [kk for kk, _ in self._hot_keys.top(k)],
                metrics=self.po.metrics, flight=self.po.flight,
                segment_mb=env.find_float("PS_STORE_SEGMENT_MB", 64.0))
        if pool_eligible:
            self._apply_pool = ApplyShardPool(handle, self._apply_shards,
                                              self)
        # An elastic joiner's state arrives by range migration: neither
        # the (stale) manifest nor a replica restore runs for it.
        joiner = self.po.elastic_join
        want_snap = (env.find_int("PS_SNAPSHOT_RESTORE", 0) != 0
                     and bool(self._snapshot_dir) and not self._snap_restored
                     and not joiner)
        want_repl = (self._replicator is not None and self.po.is_recovery
                     and not joiner and not self._restored)
        if not (want_snap or want_repl):
            self._handle_set.set()
            self._kick_replica_backfill()
            return
        # Requests arriving during either restore park, and replay after
        # the last import: applied in between, the replica fetch would
        # overwrite them.  The buffer exists before the handle is
        # published, so a request released by _handle_set parks too.
        with self._restore_mu:
            if self._restore_buffer is None:
                self._restore_buffer = []
        self._handle_set.set()
        # A tiered store keeps its budget during the imports (nothing
        # else runs then), not only on the next get.
        tier_mode = getattr(getattr(handle, "store", None),
                            "set_evict_on_insert", None)
        try:
            if callable(tier_mode):
                tier_mode(True)
            if want_snap:
                self._snap_restored = True
                self._restore_from_snapshot(handle)
            if want_repl:
                self._restored = True
                self._replicator.restore(handle)
        finally:
            if callable(tier_mode):
                tier_mode(False)
            self._drain_restore_buffer()
        self._kick_replica_backfill()

    def _kick_replica_backfill(self) -> None:
        """An elastic joiner's first table was applied before its handle
        existed, so the replica backfill it owes waited: run the diff
        now that the store can take imports."""
        with self._elastic_mu:
            table = self._table
        if table is not None:
            self._note_replicated_ranges(table, self.po.my_group_rank())

    def _restore_from_snapshot(self, handle) -> None:
        """Boot-time restore from the committed manifest
        (``PS_SNAPSHOT_RESTORE=1``): digest-verified import of every
        manifest range this server owns.  A digest mismatch or a missing
        segment raises; a missing manifest is a logged cold start."""
        t0 = time.monotonic()
        self.po.flight.record("restore_begin", severity="info",
                              dir=self._snapshot_dir)
        manifest = snapshot_mod.load_manifest(self._snapshot_dir)
        if manifest is None:
            log.warning(
                f"PS_SNAPSHOT_RESTORE=1 but no committed manifest under "
                f"{self._snapshot_dir!r}; starting with an empty store")
            self.po.flight.record("restore_end", severity="warn",
                                  keys=0, reason="no manifest")
            return
        owned = self.po.server_key_ranges_of(self.po.my_group_rank())
        try:
            n_keys, n_bytes = snapshot_mod.restore_into(
                handle, self._snapshot_dir, owned, manifest=manifest)
        except Exception:
            self.po.flight.record("restore_end", severity="crit",
                                  keys=0, reason="restore failed")
            raise
        dur = time.monotonic() - t0
        self.po.metrics.histogram("snapshot.restore_s").observe(dur)
        self.po.flight.record("restore_end", severity="info", keys=n_keys,
                              bytes=n_bytes, epoch=manifest.get("epoch"),
                              duration_s=round(dur, 3))
        log.vlog(1, f"snapshot restore: {n_keys} keys "
                    f"({n_bytes >> 20} MiB) from epoch "
                    f"{manifest.get('epoch')} in {dur:.2f}s")

    def _on_self_rehab(self, node_id: int, down: bool) -> None:
        if down or node_id != self.po.van.my_node.id:
            return
        if self._handle is None or self._replicator is None:
            return
        # Off the van's pump, which must deliver the fetch responses.
        threading.Thread(target=self._resync_from_replica,
                         name="kv-rehab-resync", daemon=True).start()

    def _resync_from_replica(self) -> None:
        with self._restore_mu:
            if self._restore_buffer is not None:
                return  # a restore or resync is already running
            self._restore_buffer = []
        log.warning("rehabilitated after a false death declaration; "
                    "resyncing ranges from replicas")
        try:
            self._replicator.restore(self._handle)
        except Exception as exc:  # noqa: BLE001 - keep serving regardless
            log.warning(f"rehab resync failed: {exc!r}")
        finally:
            self._drain_restore_buffer()

    def _drain_restore_buffer(self) -> None:
        """Replay the requests parked during a restore, in arrival order;
        arrivals keep parking until the buffer drains dry."""
        while True:
            with self._restore_mu:
                batch = self._restore_buffer
                if not batch:
                    self._restore_buffer = None
                    return
                self._restore_buffer = []
            for msg in batch:
                # _process_request, not _process: a replayed request must
                # not park again on the still-active buffer.
                try:
                    self._process_request(msg)
                except Exception as exc:  # noqa: BLE001
                    log.warning(f"replayed request failed: {exc!r}")
                    try:
                        self._request_error(msg, exc)
                    except Exception:  # noqa: BLE001
                        pass

    def register_recv_buffer(self, sender_id: int, key: int,
                             buffer: np.ndarray) -> None:
        """Pre-pin the receive buffer for (worker, key): pushes for that
        key land in exactly this buffer (kv_app.h:396-403, 457-496),
        placed by the van at delivery where it can (tcp, shm)."""
        self._recv_buffers[(sender_id, key)] = buffer
        hook = getattr(self.po.van, "register_recv_buffer", None)
        if hook is not None:
            hook(sender_id, key, buffer)

    def _response_msg(self, req: KVMeta) -> Message:
        """Response skeleton echoing the request's routing fields
        (kv_app.h:536-564)."""
        msg = Message()
        m = msg.meta
        m.app_id = self._customer.app_id
        m.customer_id = req.customer_id
        m.request = False
        m.push = req.push
        m.pull = req.pull
        m.head = req.cmd
        m.timestamp = req.timestamp
        m.recver = req.sender
        m.key = req.key
        m.addr = req.addr
        m.val_len = req.val_len
        m.option = req.option
        m.priority = req.priority  # the pull's bytes travel back here
        m.tenant = req.tenant  # weighted shares hold on the way back
        m.stamp = req.stamp
        m.trace = req.trace
        if req.trace and self.po.tracer.active:
            self.po.tracer.instant(req.trace, "respond",
                                   args={"to": req.sender,
                                         "ts": req.timestamp})
        return msg

    def _resp_send_failed(self, msgs, exc: Exception) -> None:
        """Response-combiner error hook: nothing to repair here (the
        waiting workers own retry), but it must be loud."""
        log.warning(f"response flush of {len(msgs)} frame(s) failed: "
                    f"{exc!r}")

    def _send_response(self, msg: Message) -> None:
        """Send one response, on the response combiner's lane when the
        plane is on and the sender proved batch awareness (mergeable
        small results coalesce, the rest go alone in position); else
        directly."""
        m = msg.meta
        if (self._resp_combiner is not None and m.head == 0
                and m.control.empty() and not m.shm_data
                and m.recver in self._batch_senders
                and (m.trace == 0 or m.recver in self._batch_senders_v2)):
            self._resp_combiner.submit(msg)
            return
        self.po.van.send(msg)

    def _qos_push_done(self, req) -> None:
        """One-shot push-version bump as an applied push's response
        leaves (and for an aborted stream): the response carries it, so
        a worker that saw this push can never serve an older fill."""
        if not self._qos_stamps:
            return
        if req.push and req.stamp == 0:
            with self._qos_mu:
                self._push_version += 1
                req.stamp = self._push_version

    def response(self, req: KVMeta, res: Optional[KVPairs] = None) -> None:
        """Reply to a request (kv_app.h:536-564).  A pull that asked for a
        codec (``req.codec`` with ``raw_len == 0``) gets float32 values
        encoded; other values travel raw.  A replica-forwarded push gets
        no response (its stamp is marked applied)."""
        self._qos_push_done(req)
        if req.option == OPT_REPLICA:
            if self._replicator is not None and req.stamp:
                self._replicator.note_applied(req.sender, req.stamp)
            return
        self._await_forwards(req)
        msg = self._response_msg(req)
        if res is not None and not res.empty():
            ci = getattr(req, "codec", None)
            enc = None
            if (req.pull and ci is not None and ci.raw_len == 0
                    and isinstance(res.vals, np.ndarray)
                    and res.vals.dtype == np.float32 and res.vals.size > 0):
                enc = self._encode_response(ci, req, res)
            msg.add_data(SArray(res.keys))
            if enc is not None:
                codes, scales, info = enc
                msg.meta.codec = info
                msg.meta.val_len = res.vals.nbytes
                msg.add_data(SArray(codes))
                msg.add_data(SArray(scales))
            else:
                msg.add_data(SArray(res.vals))
            if res.lens is not None:
                msg.add_data(SArray(np.asarray(res.lens, dtype=np.int32)))
        self._send_response(msg)

    def _encode_response(self, ci, req: KVMeta, res: KVPairs):
        """(codes, scales, CodecInfo) of a pull response in the request's
        codec, with the handle's residual toward this (worker, slice)
        folded in; None for an unknown codec id (the response then
        travels raw)."""
        try:
            codec = codecs_mod.by_wire_id(ci.codec)
        except log.CheckError:
            log.warning(f"pull requested unknown codec id {ci.codec}; "
                        f"responding uncompressed")
            return None
        lens = (None if res.lens is None
                else np.asarray(res.lens, dtype=np.int64))
        resid = lock = None
        if self._codec_ef_enabled and self._handle is not None:
            bank = getattr(self._handle, "ef_bank", None)
            if bank is None:
                try:
                    bank = codecs_mod.ErrorFeedback(
                        codecs_mod.ef_slots(self.po.env),
                        metrics=getattr(self.po, "metrics", None))
                    self._handle.ef_bank = bank
                except (AttributeError, TypeError):
                    bank = None  # the handle takes no attributes: no EF
            if bank is not None:
                # (sender, first key, crc32 of the keys, size), as the
                # worker keys its residuals.
                key = (req.sender,
                       int(res.keys[0]) if len(res.keys) else req.key,
                       zlib.crc32(np.ascontiguousarray(res.keys)),
                       int(res.vals.size))
                resid, lock = bank.slot(key, int(res.vals.size))
        if lock is not None:
            with lock:
                codes, scales, flags = codec.encode(res.vals, lens=lens,
                                                    resid=resid)
        else:
            codes, scales, flags = codec.encode(res.vals, lens=lens)
        self._c_codec_raw.inc(res.vals.nbytes)
        self._c_codec_wire.inc(codes.nbytes + scales.nbytes)
        return codes, scales, CodecInfo(codec=codec.wire_id,
                                        raw_len=res.vals.nbytes,
                                        block=codec.block, flags=flags)

    def response_error(self, req: KVMeta) -> None:
        """Empty ``OPT_APPLY_ERROR`` response: the waiting worker gets
        its response counted, and its ``wait`` raises.  A failed push may
        have applied in part: the push version moves on anyway.  A
        failed forward apply gets no response either, but counts as
        applied (the lag measures backlog, not success)."""
        self._qos_push_done(req)
        if req.option == OPT_REPLICA:
            if self._replicator is not None and req.stamp:
                self._replicator.note_applied(req.sender, req.stamp)
            return
        msg = self._response_msg(req)
        msg.meta.option = OPT_APPLY_ERROR
        msg.meta.addr = 0
        msg.meta.val_len = 0
        # Never merges (option != 0), but keeps its place in the lane.
        self._send_response(msg)

    def response_overload(self, req: KVMeta) -> None:
        """Empty ``OPT_OVERLOAD`` response: the request was shed under
        per-tenant admission control, nothing applied (no version bump),
        and the worker's ``wait`` raises ``OverloadError``.  It rides the
        express band: a shed must not queue behind the backlog it
        reports."""
        if req.option == OPT_REPLICA:
            return  # the replication plane never sheds
        msg = self._response_msg(req)
        msg.meta.option = OPT_OVERLOAD
        msg.meta.addr = 0
        msg.meta.val_len = 0
        msg.meta.priority = max(msg.meta.priority, 1)
        self.po.van.send(msg)

    def _request_error(self, msg: Message, exc: Exception) -> None:
        """Customer hook: the handler raised on a request."""
        if msg.meta.simple_app or not msg.meta.request:
            return
        m = msg.meta
        if m.batch is not None:
            # A batched frame failed at intake: fail every sub-op's
            # waiter, each under its own timestamp.
            try:
                metas = [KVMeta(cmd=s.meta.head, push=s.meta.push,
                                pull=s.meta.pull, sender=m.sender,
                                timestamp=s.meta.timestamp,
                                customer_id=m.customer_id, key=s.meta.key,
                                trace=s.meta.trace)
                         for s in split_batch_message(msg)]
                env = KVMeta(sender=m.sender, customer_id=m.customer_id,
                             priority=m.priority, tenant=m.tenant)
                self.response_batch(env, metas, [("error",)] * len(metas))
            except Exception as be:  # noqa: BLE001 - best effort
                log.warning(f"batched request-error response failed: "
                            f"{be!r}")
            return
        self.response_error(KVMeta(
            cmd=m.head, push=m.push, pull=m.pull, sender=m.sender,
            timestamp=m.timestamp, customer_id=m.customer_id, key=m.key,
            option=m.option))

    def stop(self) -> None:
        self._handle_set.set()  # release a request still waiting for it
        self._customer.stop()
        self.po.unregister_node_failure_hook(self._on_stream_peer_event)
        self.po.unregister_snapshot_hook(self._on_snapshot_request)
        self.po.unregister_routing_hook(self._on_routing)
        with self._elastic_mu:
            pend = list(self._pending_ranges.values())
            self._pending_ranges.clear()
        for ent in pend:
            if ent.get("timer") is not None:
                ent["timer"].cancel()
        self._abort_streams()
        if self._apply_pool is not None:
            self._apply_pool.stop()
            self._apply_pool = None
        # After the pool, whose shards may still read or evict through
        # the tiered store: release its segment files.
        store = getattr(self._handle, "store", None)
        if callable(getattr(store, "close", None)):
            store.close()
        if self._resp_combiner is not None:
            # After the pool: its stop path still sends stranded
            # responses through _send_response.
            self._resp_combiner.stop()
        if self._replicator is not None:
            self.po.unregister_node_failure_hook(self._on_self_rehab)
            self._replicator.close()

    # -- elastic membership ---------------------------------------------------

    _MAX_PARKED = 4096  # per pending range; beyond it requests are shed

    def response_wrong_owner(self, req: KVMeta, epoch: int) -> None:
        """Empty ``OPT_WRONG_OWNER`` response: this server does not own
        the request's range under its epoch, and applied nothing.
        ``val_len`` carries the epoch, so a stale worker pulls a newer
        table, and its sweeper re-slices and re-routes."""
        if req.option == OPT_REPLICA:
            return
        msg = self._response_msg(req)
        msg.meta.option = OPT_WRONG_OWNER
        msg.meta.addr = 0
        msg.meta.val_len = max(int(epoch), 0)
        # A re-route signal rides the express band, as a shed does.
        msg.meta.priority = max(msg.meta.priority, 1)
        self.po.van.send(msg)

    def _on_routing(self, table) -> None:
        """Routing hook (van pump): post the table through the request
        queue, so the cutover runs on the request thread.  Every request
        queued before it applies under the old epoch, everything after
        parks or bounces: with the apply pool's quiesce token taken at
        the cutover, the migration's export is a consistent cut."""
        marker = Message()
        marker.meta.request = True
        marker.meta.app_id = self._customer.app_id
        marker.meta.customer_id = self._customer.customer_id
        marker.meta.head = ROUTING_LOCAL_CMD
        marker._routing_table = table
        self._customer.accept(marker)

    def _apply_routing_update(self, table) -> None:
        """The cutover to a new routing epoch (request thread only):
        ownership, the ranges gained that must wait for their data
        (each with a ``PS_MIGRATE_TIMEOUT`` timer), the replica
        backfill debt, and the ranges lost, queued for the migration
        thread.  A leaver with nothing (left) to move reports done."""
        if table is None:
            return
        my = self.po.my_group_rank()
        new_pending = []
        with self._elastic_mu:
            if table.epoch <= self._routing_epoch:
                return
            self._routing_epoch = table.epoch
            self._table = table
            self._owned = [Range(e.begin, e.end) for e in table.entries
                           if e.owner == my]
            losses = [e for e in table.entries
                      if e.prev == my and e.owner != my]
            for e in table.entries:
                if e.owner != my or e.prev in (-1, my):
                    continue
                if self._arrived_migrations.pop(e.begin, None) is not None:
                    continue  # the data beat the table here
                if e.begin in self._pending_ranges:
                    continue
                ent = {"range": Range(e.begin, e.end), "frm": e.prev,
                       "epoch": table.epoch, "parked": [], "timer": None}
                self._pending_ranges[e.begin] = ent
                new_pending.append(ent)
        for ent in new_pending:
            t = threading.Timer(self._migrate_timeout, self._pending_timeout,
                                args=(ent["range"].begin, ent["epoch"]))
            t.daemon = True
            ent["timer"] = t
            t.start()
        self._note_replicated_ranges(table, my)
        if losses:
            if self._handle is None:
                log.warning("routing update assigns migrations but no "
                            "handle is set; ranges stay put")
                return
            # The quiesce token is taken here, on the request thread:
            # what was submitted so far is what the export waits for.
            token = (self._apply_pool.submit_token()
                     if self._apply_pool is not None else None)
            with self._elastic_mu:
                self._migrate_q.append((losses, table, token))
                spawn = not self._migrating
                if spawn:
                    self._migrating = True
            if spawn:
                threading.Thread(target=self._migrate_out,
                                 name="kv-migrate-out", daemon=True).start()
            return
        with self._elastic_mu:
            migrating = self._migrating
        if my in table.leaving and not migrating:
            # With a migration in flight its thread reports when it
            # drains: a leaver is never retired mid-handoff.
            self._send_remove_done()

    def _note_replicated_ranges(self, table, my: int) -> None:
        """The replica backfill debt: the ranges this rank replicates
        (another rank owns them, this one is in their chain) diffed
        across epochs, and those newly gained backfilled from their
        primaries, or a new replica would hold only the pushes after
        the change.  Returns before recording the set while the handle
        or the replicator is missing: a joiner's first table arrives
        before its handle, and ``_kick_replica_backfill`` runs this
        again."""
        # getattr: the constructor's cutover runs before the replicator
        # exists.
        replicator = getattr(self, "_replicator", None)
        if replicator is None or self._handle is None:
            return
        active = list(table.active)
        repl_now = set()
        for e in table.entries:
            if e.owner == my:
                continue
            if my in chain_ranks(e.owner, replicator.k,
                                 self.po.num_servers, active=active):
                repl_now.add((e.owner, e.begin, e.end))
        prev = self._replicated_prev
        self._replicated_prev = repl_now
        if prev is None:
            # At boot everyone starts empty together: no backfill.  A
            # live joiner enters chains that already hold state.
            if not self.po.elastic_join:
                return
            gained = repl_now
        else:
            gained = repl_now - prev
        if gained:
            threading.Thread(target=self._backfill_replicas,
                             args=(sorted(gained),),
                             name="kv-replica-backfill", daemon=True).start()

    def _backfill_replicas(self, gained) -> None:
        """Background half of the backfill: new arrivals park (the
        restore buffer), each newly replicated range is fetched from its
        primary (``Replicator.backfill_range``: a quiesced cut whose
        stamp floors forward re-applies), then the parked replay."""
        with self._restore_mu:
            if self._restore_buffer is not None:
                return  # a restore or resync covers this window
            self._restore_buffer = []
            # Range fetches are served meanwhile (a departure from JAX,
            # whose backfill parks them): after a join every server may
            # backfill from the joiner while the joiner backfills from
            # them, and parked fetches would wait each other out.
            self._backfilling = True
        total = 0
        try:
            for owner, begin, end in gained:
                oid = server_rank_to_id(owner * self.po.group_size
                                        + self.po.instance_idx)
                if self.po.van.is_peer_down(oid):
                    continue  # a dead primary's recovery restores it
                total += self._replicator.backfill_range(
                    self._handle, Range(begin, end), oid)
            # (A port counter: made at the first backfill, so a
            # cluster without one exports JAX's metric names.)
            self.po.metrics.counter("kv.replica_backfill_keys").inc(total)
            self.po.flight.record("replica_backfill", severity="info",
                                  ranges=len(gained), keys=total)
        except Exception as exc:  # noqa: BLE001 - keep serving
            log.warning(f"replica backfill failed: {exc!r}")
        finally:
            self._drain_restore_buffer()
            self._backfilling = False

    def _elastic_gate(self, msg: Message) -> bool:
        """The ownership check at intake (request thread), for plain KV
        requests only.  True when the request was consumed: parked at a
        range whose migration is in flight, shed when that park is full,
        or bounced ``OPT_WRONG_OWNER``.  Every key must fall in a range
        this server may take: one it owns, or one whose owner is down
        with this server in its chain (the failover routes it here, and
        the table knows nothing of crashes), or, under replica reads, a
        pull of a live owner's range in whose chain it sits."""
        m = msg.meta
        if (not m.request or m.simple_app or m.head != 0
                or m.option in (OPT_REPLICA, OPT_XFER_PART)
                or not msg.data):
            return False
        keys = msg.data[0].astype_view(np.uint64).numpy()
        if len(keys) == 0:
            return False
        park_full = False
        with self._elastic_mu:
            epoch = self._routing_epoch
            for ent in self._pending_ranges.values():
                r = ent["range"]
                if find_range(keys, r.begin, r.end).size() > 0:  # a key in the pending range parks it whole
                    if len(ent["parked"]) >= self._MAX_PARKED:
                        park_full = True
                        break
                    ent["parked"].append(msg)
                    self._c_parked.inc()
                    return True
            if not park_full:
                table = self._table
                my = self.po.my_group_rank()
                n_in = 0
                for e in (table.entries if table is not None else ()):
                    n = find_range(keys, e.begin, e.end).size()
                    if n <= 0:
                        continue
                    if e.owner == my:
                        n_in += n
                    elif self._replicator is not None:
                        oid = server_rank_to_id(e.owner * self.po.group_size
                                                + self.po.instance_idx)
                        in_chain = my in chain_ranks(
                            e.owner, self._replicator.k,
                            self.po.num_servers,
                            active=self.po.active_server_ranks)
                        if in_chain and (self.po.van.is_peer_down(oid)
                                         or (self._replica_reads
                                             and m.pull and not m.push)):
                            n_in += n
                if n_in == len(keys):
                    return False
        meta = KVMeta(cmd=m.head, push=m.push, pull=m.pull, sender=m.sender,
                      timestamp=m.timestamp, customer_id=m.customer_id,
                      key=m.key, option=m.option, priority=m.priority,
                      trace=m.trace, tenant=m.tenant)
        if park_full:
            # Shed retryably rather than queue unbounded memory behind a
            # slow handoff.
            log.warning(f"migration park buffer full: shedding ts="
                        f"{m.timestamp} from {m.sender}")
            self.response_overload(meta)
            return True
        self._c_wrong_owner.inc()
        self.response_wrong_owner(meta, epoch)
        return True

    def _import_migration(self, msg: Message) -> None:
        """A range handoff landed (``MIGRATE_CMD`` from the old owner):
        import it, release the pending range, acknowledge, tell the
        scheduler, and replay the parked requests in arrival order (on
        the request thread: no new arrival interleaves).  Not
        chain-forwarded: an import is set semantics, which the
        replicas' ordered ``+=`` cannot carry; the old owner's chain
        still holds the range's state."""
        m = msg.meta
        if self._handle is None:
            # The app has not installed its handle yet: requeue, since an
            # error answer would read as an ack at the old owner, which
            # would drop the only copy.
            time.sleep(0.002)
            self._customer.accept(msg)
            return
        keys = (msg.data[0].astype_view(np.uint64).numpy()
                if len(msg.data) >= 1 else np.empty(0, np.uint64))
        vals = (msg.data[1].numpy() if len(msg.data) >= 2
                else np.empty(0, np.float32))
        lens = (msg.data[2].astype_view(np.int32).numpy()
                if len(msg.data) > 2 else None)
        if len(keys):
            import_range(self._handle, keys, vals, lens)
            self._c_migrated_in.inc(len(keys))
        with self._elastic_mu:
            ent = self._pending_ranges.pop(m.key, None)
            if ent is None:
                # The data raced ahead of the routing broadcast: the
                # table's application skips parking this range.
                self._arrived_migrations[m.key] = int(m.addr)
                while len(self._arrived_migrations) > 64:
                    self._arrived_migrations.pop(
                        next(iter(self._arrived_migrations)))
        if ent is not None and ent.get("timer") is not None:
            ent["timer"].cancel()
        log.vlog(1, f"imported {len(keys)} migrated keys at {m.key} "
                    f"(epoch {m.addr})")
        self.response(KVMeta(cmd=m.head, push=True, pull=False,
                             sender=m.sender, timestamp=m.timestamp,
                             customer_id=m.customer_id, key=m.key,
                             addr=m.addr))
        self._notify_migrate_done(int(m.addr), int(m.key))
        if ent is not None:
            for parked in ent["parked"]:
                try:
                    self._process_request(parked)
                except Exception as exc:  # noqa: BLE001
                    log.warning(f"parked request replay failed: {exc!r}")
                    try:
                        self._request_error(parked, exc)
                    except Exception:  # noqa: BLE001
                        pass

    def _migrate_out(self) -> None:
        """The migration thread: queued batches in epoch order, each
        after every apply submitted before its cutover finished (the
        quiesce token), each lost range streamed to its new owner.  A
        leaver reports REMOVE_DONE only once the queue is dry, judged by
        the current table."""
        while True:
            with self._elastic_mu:
                if not self._migrate_q:
                    self._migrating = False
                    table = self._table
                    break
                losses, table, token = self._migrate_q.pop(0)
            if self._apply_pool is not None and token is not None:
                if not self._apply_pool.quiesce(
                        token, timeout_s=self._migrate_timeout):
                    log.warning("migrate: apply pool did not quiesce in "
                                "time; exporting anyway")
            for e in losses:
                try:
                    self._migrate_range(e, table)
                except Exception as exc:  # noqa: BLE001
                    log.warning(f"migration of [{e.begin}, {e.end}) -> "
                                f"rank {e.owner} failed: {exc!r}")
        if table is not None and self.po.my_group_rank() in table.leaving:
            self._send_remove_done()

    def _migrate_range(self, e, table) -> None:
        """Export one lost range and push it to its new owner
        (``MIGRATE_CMD``; a large one travels in chunks).  The local copy
        goes only after the new owner acknowledged the import."""
        keys, vals, lens = export_range(self._handle, e.begin, e.end)
        dest = server_rank_to_id(e.owner * self.po.group_size
                                 + self.po.instance_idx)
        ts = self._customer.new_request(dest)
        msg = Message()
        m = msg.meta
        m.app_id = self._customer.app_id
        m.customer_id = self._customer.customer_id
        m.request = True
        m.push = True
        m.head = MIGRATE_CMD
        m.timestamp = ts
        m.recver = dest
        m.key = int(e.begin)
        m.addr = int(table.epoch)
        m.val_len = vals.nbytes
        msg.add_data(SArray(keys))
        msg.add_data(SArray(vals))
        msg.add_data(SArray(np.asarray(lens, dtype=np.int32)))
        self.po.van.send(msg)
        ok = self._customer.wait_request(ts, timeout=self._migrate_timeout)
        if not ok or self._migrate_nacks.discard(ts):
            log.warning(f"migration of [{e.begin}, {e.end}) to rank "
                        f"{e.owner} "
                        f"{'failed at the importer' if ok else 'unacked'}"
                        f"; keeping the local copy")
            return
        self._drop_keys(keys)
        self._c_migrated_out.inc(len(keys))
        log.vlog(1, f"migrated {len(keys)} keys of [{e.begin}, {e.end}) "
                    f"-> rank {e.owner}")

    def _drop_keys(self, keys) -> None:
        handle = self._handle
        if callable(getattr(handle, "drop_keys", None)):
            handle.drop_keys(keys)
            return
        store = getattr(handle, "store", None)
        if store is None:
            return
        drop = _store_drop_fn(store)
        for k in keys.tolist():
            drop(int(k))

    def _pending_timeout(self, begin: int, epoch: int) -> None:
        """A gained range's data never came (its source died
        mid-handoff?): try the old owner's replica chain, then unpark;
        parked waiters complete or fail, never hang."""
        with self._elastic_mu:
            ent = self._pending_ranges.get(begin)
            if ent is None or ent["epoch"] != epoch:
                return
            rng, frm = ent["range"], ent["frm"]
        log.warning(f"migration of [{rng.begin}, {rng.end}) from rank "
                    f"{frm} overdue; trying replica fallback")
        if self._replicator is not None and self._handle is not None:
            gs = self.po.group_size
            to_id = lambda r: server_rank_to_id(  # noqa: E731
                r * gs + self.po.instance_idx)
            cands = [to_id(frm)] + [
                to_id(r) for r in chain_ranks(
                    frm, self._replicator.k, self.po.num_servers,
                    active=self.po.active_server_ranks)]
            try:
                self._replicator._fetch_range(self._handle, rng, cands,
                                              timeout_s=10.0)
            except Exception as exc:  # noqa: BLE001
                log.warning(f"replica fallback for [{rng.begin}, "
                            f"{rng.end}) failed: {exc!r}")
        with self._elastic_mu:
            ent = self._pending_ranges.pop(begin, None)
        if ent is None:
            return  # the handoff landed while this fetched
        # The range is live (degraded) from here: the scheduler's ledger
        # releases, so snapshots stop waiting.
        self._notify_migrate_done(epoch, begin)
        for parked in ent["parked"]:
            # Through the intake queue: this is a timer thread, and
            # requests are processed on one thread.
            self._customer.accept(parked)

    def _control_to_scheduler(self, cmd: Command, option: int,
                              body: dict, what: str) -> None:
        msg = Message()
        msg.meta.recver = SCHEDULER_ID
        msg.meta.request = True
        msg.meta.option = option
        msg.meta.body = json.dumps(body).encode()
        msg.meta.control = Control(cmd=cmd)
        msg.meta.timestamp = self.po.van.next_timestamp()
        try:
            self.po.van.send(msg)
        except Exception as exc:  # noqa: BLE001 - the scheduler's ledger
            log.warning(f"{what} failed: {exc!r}")  # expires / times out

    def _notify_migrate_done(self, epoch: int, begin: int) -> None:
        """Tell the scheduler a handoff landed here (``MIGRATE_DONE_OPT``
        on a ROUTING request): its ledger holds snapshot cuts."""
        self._control_to_scheduler(
            Command.ROUTING, MIGRATE_DONE_OPT,
            {"epoch": int(epoch), "begin": int(begin),
             "rank": self.po.my_group_rank()}, "MIGRATE_DONE note")

    def _send_remove_done(self) -> None:
        """Tell the scheduler this leaver migrated everything
        (``REMOVE_DONE_OPT`` on REMOVE_NODE): it may retire the rank."""
        self._control_to_scheduler(
            Command.REMOVE_NODE, REMOVE_DONE_OPT,
            {"rank": self.po.my_group_rank()}, "REMOVE_DONE send")

    def decommission(self, timeout_s: float = 60.0) -> None:
        """Leave the running cluster: the scheduler reassigns this
        server's ranges, this server migrates them live, and the rank
        retires, with no restart and no dropped request.  Then
        ``stop()`` the server and ``finalize(do_barrier=False)`` its
        Postoffice (a retired node counts in no barrier)."""
        self.po.request_decommission(timeout_s)

    # -- coordinated snapshots ------------------------------------------------

    def _on_snapshot_request(self, msg: Message) -> bool:
        """Postoffice snapshot hook (van pump): post the scheduler's
        SNAPSHOT request through the request queue, so the fence runs on
        the request thread: every request queued before it lands in the
        cut, everything after applies once the in-memory export is
        done."""
        marker = Message()
        marker.meta.request = True
        marker.meta.app_id = self._customer.app_id
        marker.meta.customer_id = self._customer.customer_id
        marker.meta.head = SNAPSHOT_LOCAL_CMD
        marker._snapshot_ctl = (msg.meta.sender, msg.meta.timestamp,
                                msg.meta.body)
        self._customer.accept(marker)
        return True

    def _run_snapshot(self, msg: Message) -> None:
        """The consistent cut (request thread): quiesce every apply
        submitted so far, export the owned ranges in memory, then hand
        the segment writes and the reply to a background thread, so
        serving resumes while the files are written.  Refused (an error
        reply, which vetoes the commit): no handle, no directory, a
        snapshot already running, instance groups, a pool that does not
        quiesce, a failed export."""
        sender, token, body = msg._snapshot_ctl
        try:
            req = json.loads(body.decode()) if body else {}
        except Exception:  # noqa: BLE001 - a corrupt body vetoes below
            req = {}
        op = req.get("op")
        if op in ("publish", "flip", "rollback"):
            # Model-namespace ops ride the same fence.
            self._run_namespace(sender, token, op, req)
            return
        if op == "retune":
            self._run_retune(sender, token, req)
            return
        directory = req.get("dir") or self._snapshot_dir
        with self._elastic_mu:
            migrating = (bool(self._pending_ranges) or self._migrating
                         or bool(self._migrate_q))
        err = None
        if op is not None:
            err = f"unknown snapshot-channel op {op!r}"
        elif self._handle is None:
            err = "no request handle set"
        elif not directory:
            err = "no snapshot directory (PS_SNAPSHOT_DIR unset)"
        elif self._snapshotting:
            err = "a snapshot is already in progress"
        elif migrating:
            # Behind the scheduler's own wait: a cut mid-handoff would
            # commit a range split across its old and new owner.
            err = "range migration in flight — refusing a mid-handoff cut"
        elif self.po.group_size > 1:
            # Every instance of a group rank owns the same range with a
            # store of its own: their segment files would clobber each
            # other.
            err = ("snapshots do not support instance groups "
                   "(DMLC_GROUP_SIZE > 1)")
        if err is not None:
            self._snapshot_reply(sender, token, {"error": err})
            return
        self._snapshotting = True
        t0 = time.monotonic()
        self.po.flight.record("snapshot_begin", severity="info",
                              dir=directory)
        err = self._quiesce_applies("a torn cut")
        if err is not None:
            # Exporting while shard threads still mutate arrays in place
            # would commit torn values under a digest that verifies them.
            self._snapshotting = False
            log.warning(f"snapshot: {err}")
            self.po.flight.record("snapshot_end", severity="warn",
                                  ok=False, error=err)
            self._snapshot_reply(sender, token, {"error": err})
            return
        with self._streams_mu:
            open_streams = len(self._streams)
        if open_streams:
            self.po.flight.record("snapshot_open_streams",
                                  severity="warn", streams=open_streams)
            # A chunked push mid-streaming-apply straddles the fence: its
            # fed prefix is in the cut, its tail is not.  It is still
            # unacked (its close has not been processed), so no
            # acknowledged write is torn.
            log.warning(f"snapshot cut with {open_streams} open streamed "
                        f"push(es): their fed prefixes are in the cut")
        exported = []
        try:
            for rng in self.po.server_key_ranges_of(
                    self.po.my_group_rank()):
                keys, vals, lens = export_range(self._handle, rng.begin,
                                                rng.end)
                exported.append((rng, keys, vals,
                                 None if lens is None else np.asarray(lens)))
        except Exception as exc:  # noqa: BLE001 - veto the commit
            self._snapshotting = False
            self.po.flight.record("snapshot_end", severity="warn",
                                  ok=False, error=repr(exc)[:200])
            self._snapshot_reply(sender, token,
                                 {"error": f"export failed: {exc!r}"})
            return
        epoch = int(req.get("epoch", -1))
        uid = str(req.get("uid", ""))
        fmt = self.po.env.find("PS_SNAPSHOT_FORMAT") or "npz"
        threading.Thread(
            target=self._write_snapshot,
            args=(sender, token, directory, epoch, fmt, uid, exported, t0),
            name="kv-snapshot-write", daemon=True).start()

    def _write_snapshot(self, sender: int, token: int, directory: str,
                        epoch: int, fmt: str, uid: str, exported: list,
                        t0: float) -> None:
        """Background half of the cut: write the exported ranges into
        segment files named with the scheduler's attempt uid, and reply
        with their digests (the scheduler commits only after every
        server answered clean)."""
        try:
            entries = [snapshot_mod.write_range_segment(
                directory, rng.begin, rng.end, keys, vals, lens,
                fmt=fmt, uid=uid)
                for rng, keys, vals, lens in exported]
            dur = time.monotonic() - t0
            self._h_snapshot.observe(dur)
            self.po.flight.record(
                "snapshot_end", severity="info", ok=True,
                keys=sum(e["keys"] for e in entries),
                bytes=sum(e["nbytes"] for e in entries),
                duration_s=round(dur, 3))
            self._snapshot_reply(sender, token, {
                "rank": self.po.my_group_rank(),
                "epoch": epoch,
                "ranges": entries,
                "duration_s": round(dur, 3),
            })
        except Exception as exc:  # noqa: BLE001 - veto the commit
            self.po.flight.record("snapshot_end", severity="warn",
                                  ok=False, error=repr(exc)[:200])
            self._snapshot_reply(
                sender, token, {"error": f"segment write failed: {exc!r}"})
        finally:
            self._snapshotting = False

    def _run_retune(self, sender: int, token: int, req: dict) -> None:
        """Live knob retune on the request thread, behind the snapshot
        fence.  The one knob is the apply task quantum (the autopilot's
        apply_wait actuator); a server without an apply pool answers
        clean with nothing applied."""
        applied = {}
        tb = req.get("apply_task_bytes")
        if tb is not None and self._apply_pool is not None:
            applied["apply_task_bytes"] = \
                self._apply_pool.set_task_bytes(int(tb))
            self.po.flight.record("apply_retune", severity="info",
                                  task_bytes=applied["apply_task_bytes"])
        self._snapshot_reply(sender, token, {
            "rank": self.po.my_group_rank(), "applied": applied})

    def _snapshot_reply(self, dest: int, token: int, payload: dict) -> None:
        msg = Message()
        msg.meta.recver = dest
        msg.meta.sender = self.po.van.my_node.id
        msg.meta.request = False
        msg.meta.timestamp = token  # the scheduler's gather token
        msg.meta.control = Control(cmd=Command.SNAPSHOT)
        msg.meta.body = json.dumps(payload).encode()
        try:
            self.po.van.send(msg)
        except Exception as exc:  # noqa: BLE001 - the scheduler times out
            log.warning(f"snapshot reply to {dest} failed: {exc!r}")

    # -- model namespaces -----------------------------------------------------

    def _run_namespace(self, sender: int, token: int, op: str,
                       req: dict) -> None:
        """Namespace ops on the request thread, behind the fence:
        ``publish`` stages a committed manifest into an off-line store
        on a background thread (serving goes on), ``flip`` swaps the
        staged store in (pool quiesced, one assignment), ``rollback``
        swaps the displaced one back."""
        handle = self._handle
        if handle is None:
            self._snapshot_reply(sender, token,
                                 {"error": "no request handle set"})
            return
        if not isinstance(getattr(handle, "store", None), dict):
            # A tiered or custom store keeps state outside a plain dict:
            # a store swap would strand it.
            self._snapshot_reply(sender, token, {
                "error": "model namespaces need a plain dict store "
                         "(tiered/custom handles decline)"})
            return
        if op == "publish":
            directory = req.get("dir") or self._snapshot_dir
            if not directory:
                self._snapshot_reply(sender, token, {
                    "error": "publish needs a snapshot directory"})
                return
            if self._ns_staging:
                self._snapshot_reply(sender, token, {
                    "error": "a namespace stage is already in progress"})
                return
            self._ns_staging = True
            threading.Thread(
                target=self._stage_namespace,
                args=(sender, token, directory,
                      str(req.get("namespace", "model")),
                      str(req.get("version", ""))),
                name="kv-ns-stage", daemon=True).start()
            return
        if op == "flip":
            staged = self._ns_staged
            if staged is None:
                self._snapshot_reply(sender, token, {
                    "error": "flip without a staged namespace "
                             "(publish first)"})
                return
            err = self._quiesce_applies("namespace flip")
            if err is not None:
                self._snapshot_reply(sender, token, {"error": err})
                return
            name, version, new_store = staged
            self._ns_prev = (*self._ns_current, handle.store)
            handle.store = new_store
            self._ns_current = (name, version)
            self._ns_staged = None
            kind = "namespace_flip"
        else:  # rollback
            prev = self._ns_prev
            if prev is None:
                self._snapshot_reply(sender, token, {
                    "error": "rollback without a previous namespace"})
                return
            err = self._quiesce_applies("namespace rollback")
            if err is not None:
                self._snapshot_reply(sender, token, {"error": err})
                return
            name, version, old_store = prev
            self._ns_prev = (*self._ns_current, handle.store)
            handle.store = old_store
            self._ns_current = (name, version)
            kind = "namespace_rollback"
        self._after_namespace_swap(kind, name, version)
        self._snapshot_reply(sender, token, {
            "rank": self.po.my_group_rank(),
            "namespace": name, "version": version,
            "keys": len(handle.store),
        })

    def _quiesce_applies(self, what: str) -> Optional[str]:
        """Drain every apply submitted so far (request thread only); an
        error string when the pool did not quiesce within
        ``PS_SNAPSHOT_QUIESCE_S``, which vetoes ``what``."""
        if self._apply_pool is None:
            return None
        tok = self._apply_pool.submit_token()
        if not self._apply_pool.quiesce(
                tok, timeout_s=self._snapshot_quiesce_s):
            return (f"apply pool did not quiesce within "
                    f"{self._snapshot_quiesce_s}s — refusing {what}")
        return None

    def _after_namespace_swap(self, kind: str, name: str,
                              version: str) -> None:
        if self._qos_stamps:
            # Every hot-cache fill of the displaced namespace fails its
            # next check.
            with self._qos_mu:
                self._push_version += 1
        self.po.model_namespace = {"name": name, "version": version}
        self.po.flight.record(kind, severity="info", namespace=name,
                              version=version)

    def _serving_ranges(self) -> list:
        """Every range this server answers reads for: its own, plus,
        under replication, every range whose chain it is in."""
        my = self.po.my_group_rank()
        with self._elastic_mu:
            owned = self._owned
            repl = list(self._replicated_prev or ())
        if owned is not None:
            return list(owned) + [Range(b, e) for _, b, e in repl]
        ranges = list(self.po.server_key_ranges_of(my))
        if self._replicator is not None and self._replicator.k > 1:
            for o in range(self.po.num_servers):
                if o != my and my in chain_ranks(
                        o, self._replicator.k, self.po.num_servers):
                    ranges.extend(self.po.server_key_ranges_of(o))
        return ranges

    def _stage_namespace(self, sender: int, token: int, directory: str,
                         name: str, version: str) -> None:
        """Background half of publish: restore the manifest into an
        off-line store while the live one serves; ``flip`` swaps it in."""
        t0 = time.monotonic()
        try:
            manifest = snapshot_mod.load_manifest(directory)
            if manifest is None:
                raise RuntimeError(f"no committed manifest in {directory!r}")
            shim = _StagingStore()
            keys, nbytes = snapshot_mod.restore_into(
                shim, directory, self._serving_ranges(), manifest)
            self._ns_staged = (name, version, shim.store)
            self.po.flight.record(
                "namespace_stage", severity="info", namespace=name,
                version=version, keys=keys,
                duration_s=round(time.monotonic() - t0, 3))
            self._snapshot_reply(sender, token, {
                "rank": self.po.my_group_rank(), "staged": name,
                "version": version, "keys": keys, "bytes": nbytes,
            })
        except Exception as exc:  # noqa: BLE001 - veto the publish
            self._snapshot_reply(sender, token, {
                "error": f"namespace stage failed: {exc!r}"})
        finally:
            self._ns_staging = False

    # -- streamed chunked pushes ---------------------------------------------

    def _abort_streams(self) -> None:
        with self._streams_mu:
            handles = list(self._streams.values())
            self._streams.clear()
        for h in handles:
            h.close(respond=False)

    def _sweep_stale_streams(self) -> None:
        """Reclaim streams idle past the TTL: their transfer died at the
        assembler, so no reassembled message will close them."""
        now = time.monotonic()
        with self._streams_mu:
            stale = [k for k, h in self._streams.items()
                     if now - h.t_last > self._stream_ttl]
            handles = [self._streams.pop(k) for k in stale]
        for k, h in zip(stale, handles):
            log.warning(f"reclaiming stalled stream {k} (idle > "
                        f"{self._stream_ttl:.0f}s)")
            h.close(respond=False)

    def _on_stream_peer_event(self, node_id: int, down: bool) -> None:
        """Node-failure hook: a dead worker's open streams never close;
        reclaim them without a response."""
        if not down:
            return
        with self._streams_mu:
            stale = [k for k in self._streams if k[0] == node_id]
            handles = [self._streams.pop(k) for k in stale]
        for h in handles:
            log.warning(f"reclaiming open stream from dead node {node_id}")
            h.close(respond=False)

    def _stream_eligible(self, m) -> bool:
        """Streamed apply needs the pool, no replication (a forward must
        see the complete payload at its arrival-order slot), no
        registered receive buffer for this (sender, key) (those apply
        synchronously from the buffer), and a live sender (a partial
        straggling in after its sender was declared dead must not reopen
        a reclaimed stream), and static routing: under elastic routing a
        stream opened before a cutover would have applied keys that the
        bounced and re-routed message then applies again at the new
        owner, so the reassembled message takes the gated path."""
        return (self._apply_pool is not None
                and self._replicator is None
                and self._owned is None
                and (m.sender, m.key) not in self._recv_buffers
                and not self.po.van.is_peer_down(m.sender))

    def _stream_part(self, msg: Message) -> None:
        """One ``OPT_XFER_PART`` partial: feed its whole keys to the
        transfer's stream (opened on first touch), or drop it when not
        eligible (the reassembled message follows and applies whole)."""
        key = getattr(msg, "_xfer_key", None)
        if key is None or len(msg.data) < 2:
            return
        self._stream_ticks += 1
        if self._stream_ticks % 64 == 0:
            self._sweep_stale_streams()
        with self._streams_mu:
            h = self._streams.get(key)
        if h is None:
            m = msg.meta
            if not self._stream_eligible(m):
                return
            if m.head == 0 and self._admission_overloaded(m.tenant):
                # Over the tenant's bound: the partials drop and the
                # reassembled message sheds whole at admission.
                return
            h = self._apply_pool.begin_stream(KVMeta(
                cmd=m.head, push=True, pull=False, sender=m.sender,
                timestamp=m.timestamp, customer_id=m.customer_id, key=m.key,
                addr=m.addr, val_len=m.val_len, option=0,
                priority=m.priority, trace=m.trace, tenant=m.tenant))
            self.streams_opened += 1
            evicted = None
            with self._streams_mu:
                if len(self._streams) >= self._MAX_STREAMS:
                    victim = next(iter(self._streams))
                    evicted = self._streams.pop(victim)
                    log.warning(f"stream table full: aborting transfer "
                                f"{victim}")
                self._streams[key] = h
            if evicted is not None:
                evicted.close(respond=False)
        kvs = KVPairs(keys=msg.data[0].astype_view(np.uint64).numpy(),
                      vals=msg.data[1].numpy())
        if len(kvs.keys):
            self._hot_keys.add(int(kvs.keys[0]), len(kvs.keys))
        h.feed(kvs)

    # -- per-op intake (shared by single and batched requests) ----------------

    def _admission_overloaded(self, tenant: int, extra: int = 0) -> bool:
        """Per-tenant admission probe: the pool's in-flight backlog plus
        the tenant's open streams (a streamed push holds capacity from
        its first partial) plus ``extra``, the slots a batched frame's
        earlier sub-ops took."""
        if self._admit_limit <= 0 or self._apply_pool is None:
            return False
        n = self._apply_pool.tenant_backlog(tenant) + extra
        if n < self._admit_limit:
            with self._streams_mu:
                n += sum(1 for h in self._streams.values()
                         if h.pending.meta.tenant == tenant)
        return n >= self._admit_limit

    def _intake_admission(self, meta: KVMeta, extra: int = 0) -> bool:
        """True when this request (or batched sub-op) must be shed.  A
        replica forward never is."""
        if not (self._admit_limit > 0 and self._apply_pool is not None
                and meta.option != OPT_REPLICA and meta.cmd == 0):
            return False
        self._tenant_counter(meta.tenant, "requests").inc()
        if self._admission_overloaded(meta.tenant, extra=extra):
            self._c_shed.inc()
            self._tenant_counter(meta.tenant, "shed").inc()
            # Sheds are the watchdog's overload signal.
            self._record_shed_flight(meta.tenant, meta.sender,
                                     meta.timestamp, trace=meta.trace)
            return True
        return False

    def _tenant_counter(self, tid: int, kind: str):
        """``tenant.<name>.requests`` / ``.shed``, made at first use."""
        ent = self._tenant_counters.get(tid)
        if ent is None:
            name = self.tenants.name(tid)
            ent = self._tenant_counters[tid] = (
                self.po.metrics.counter(f"tenant.{name}.requests"),
                self.po.metrics.counter(f"tenant.{name}.shed"))
        return ent[0] if kind == "requests" else ent[1]

    # Coalescing window of overload_shed flight events (seconds).
    _SHED_FLIGHT_WINDOW_S = 0.5

    def _record_shed_flight(self, tenant_id: int, sender: int, ts: int,
                            trace: int = 0) -> None:
        """One overload_shed flight event per tenant per window, with
        the count it suppressed (sheds come at request rate under a
        storm and would wrap the ring).  The processing thread only."""
        ent = self._shed_flight.setdefault(tenant_id, [0.0, 0])
        now = time.monotonic()
        if now - ent[0] >= self._SHED_FLIGHT_WINDOW_S:
            detail = {"trace": f"{trace:x}"} if trace else {}
            self.po.flight.record(
                "overload_shed", severity="warn",
                tenant=self.tenants.name(tenant_id), sender=sender, ts=ts,
                coalesced=ent[1], **detail)
            ent[0] = now
            ent[1] = 0
        else:
            ent[1] += 1

    def _intake_pull_stamp(self, meta: KVMeta) -> None:
        """A pull's hot-cache stamp, taken at intake: every push counted
        before now has applied, so the shards' snapshot includes it.

        Under replica reads a pull of a range whose live owner is
        another rank is answered in that primary's currency, the newest
        forward stamp claimed at intake (1 before the first: the
        primary's initial version).  A down owner's range is answered
        with this server's own counter, as its acting truth."""
        if not (self._qos_stamps and meta.pull and not meta.push):
            return
        if (self._replica_reads and self._replicator is not None
                and meta.cmd == 0):
            owner = self._owner_rank_of(int(meta.key))
            if owner is not None and owner != self.po.my_group_rank():
                oid = server_rank_to_id(owner * self.po.group_size
                                        + self.po.instance_idx)
                if not self.po.van.is_peer_down(oid):
                    meta.stamp = self._replicator.claimed_stamp(oid) or 1
                    return
        with self._qos_mu:
            meta.stamp = self._push_version

    def _owner_rank_of(self, key: int) -> Optional[int]:
        """The group rank owning ``key``: under the applied routing table
        once one is, else under the static split."""
        if self._owned is not None:
            with self._elastic_mu:
                table = self._table
            if table is not None:
                for e in table.entries:
                    if e.begin <= key < e.end:
                        return e.owner
            return None
        for i, rng in enumerate(self.po.get_server_key_ranges()):
            if rng.begin <= key < rng.end:
                return i
        return None

    def _intake_hot_keys(self, keys: np.ndarray) -> None:
        """Hot-key counts: per key for small key sets; a bulk slice
        charges its first key with the whole weight."""
        if not len(keys):
            return
        if len(keys) <= 64:
            for k in keys.tolist():
                self._hot_keys.add(int(k))
        else:
            self._hot_keys.add(int(keys[0]), len(keys))

    def _intake_decode(self, meta: KVMeta, data,
                       lazy_ok: bool = True
                       ) -> Tuple[KVPairs, Optional[tuple]]:
        """A request's data as ``(KVPairs, wire payload)``.  A codec push
        is decoded here, or left encoded (``kvs.enc``) for the pool's
        shards when ``lazy_ok`` and it is a fixed-k push-only payload of
        a range-decodable codec with no registered receive buffer
        (batched sub-ops are small and decode here).  The wire payload,
        ``(codes, scales, lens|None, CodecInfo)`` of a codec push, else
        None, is what a replication forward re-sends."""
        kvs = KVPairs()
        if len(data) < 2:
            return kvs, None
        kvs.keys = data[0].astype_view(np.uint64).numpy()
        ci = meta.codec
        if not (ci is not None and ci.raw_len > 0 and meta.push
                and len(data) >= 3):
            kvs.vals = data[1].numpy()
            if len(data) > 2:
                kvs.lens = data[2].astype_view(np.int32).numpy()
            return kvs, None
        codec = codecs_mod.by_wire_id(ci.codec)
        codecs_mod.check_block(ci)
        codes = data[1].astype_view(np.uint8).numpy()
        scales = data[2].astype_view(np.float32).numpy()
        kvs.lens = (data[3].astype_view(np.int32).numpy()
                    if len(data) > 3 else None)
        wire = (data[1], data[2], kvs.lens, ci)
        n_el = ci.raw_len // 4
        if (lazy_ok and kvs.lens is None and not meta.pull
                and self._apply_pool is not None and codec.range_decode
                and len(kvs.keys) > 0 and n_el % len(kvs.keys) == 0
                and (meta.sender, int(kvs.keys[0]))
                not in self._recv_buffers):
            kvs.enc = (codes, scales, ci)
        else:
            t0 = time.monotonic()
            kvs.vals = codec.decode(codes, scales, n_el, lens=kvs.lens,
                                    flags=ci.flags)
            if meta.trace and self.po.tracer.active:
                dur = time.monotonic() - t0
                now = self.po.tracer.now_us()
                self.po.tracer.span(
                    meta.trace, "codec_decode", now - dur * 1e6, dur * 1e6,
                    args={"codec": codec.name,
                          "raw_mb": round(ci.raw_len / 2**20, 1)})
        return kvs, wire

    def _intake_replicate(self, meta: KVMeta, kvs: KVPairs,
                          wire_payload, copy: bool = False) -> bool:
        """Chain-replication intake of one push: dedup a duplicate
        origin (a worker's failover retry racing the primary's forward,
        in either order) and chain-forward accepted worker pushes in
        arrival order on the request thread.  True when the op is a
        pure-push duplicate (apply nothing, just ack); a duplicate with a
        pull half loses its push half, so the pull still serves."""
        if (self._replicator is None or not meta.push
                or not len(kvs.keys)):
            return False
        if meta.option == OPT_REPLICA:
            # Replica side: claim the forward's stamp at intake, before
            # the dedup check (a dedup hit means its effect is in).
            if meta.stamp:
                self._replicator.note_claimed(meta.sender, meta.stamp)
                if self._replicator.below_import_floor(meta):
                    # An import's cut already holds this forward: record
                    # its origin (a failover retry still dedups) and
                    # skip the apply, which would add twice.
                    self._replicator.should_apply(meta)
                    self._replicator.note_applied(meta.sender, meta.stamp)
                    return True
            return not self._replicator.should_apply(meta)
        if not self._replicator.should_apply(meta):
            # The original apply already took a push version: ack with
            # the current one, no bump (the replicas would lag forever
            # behind a version no forward carries).
            if self._qos_stamps:
                with self._qos_mu:
                    meta.stamp = self._push_version
            if meta.pull:
                meta.push = False
                kvs.vals = np.empty(0, kvs.vals.dtype)
                kvs.enc = None
                return False
            return True
        if self._qos_stamps:
            # The push version is assigned at intake (arrival order ==
            # forward order), so the forward carries it; _qos_push_done
            # then leaves it and the response carries it.
            with self._qos_mu:
                self._push_version += 1
                meta.stamp = self._push_version
        meta.forwards = self._replicator.forward(meta, kvs, copy=copy,
                                                 wire=wire_payload)
        return False

    def _await_forwards(self, req) -> None:
        """Hold a replicated push's acknowledgement until its forwards'
        bytes are written (the sent events of ``Replicator.forward``),
        for at most ``_FORWARD_WAIT_S``: an acknowledged push then
        survives the primary's death."""
        events = req.forwards
        if not events:
            return
        req.forwards = None
        end = time.monotonic() + self._FORWARD_WAIT_S
        for ev in events:
            if not ev.wait(max(0.0, end - time.monotonic())):
                log.warning(f"push ts={req.timestamp} from {req.sender}: "
                            f"a forward was not written within "
                            f"{self._FORWARD_WAIT_S}s; acknowledging "
                            f"anyway")
                return

    def _process(self, msg: Message) -> None:
        if msg.meta.simple_app:
            return
        if not msg.meta.request:
            # A response must never run the request handler.  Servers
            # receive two kinds: a range fetch's, under replication, and
            # a migration's acknowledgement (an error-marked one means
            # the import raised: the old owner keeps its copy).
            if msg.meta.option == OPT_APPLY_ERROR:
                self._migrate_nacks.add(msg.meta.timestamp)
            if self._replicator is not None:
                self._replicator.absorb_response(msg)
            return
        if (not self._handle_set.is_set()
                and msg.meta.head not in (SNAPSHOT_LOCAL_CMD,
                                          ROUTING_LOCAL_CMD)):
            # The request (parked until this server's customer existed)
            # raced set_request_handle: wait for the handle and its pool,
            # or a chunked push's first partial would find no pool and
            # its reassembled message no handle.  A snapshot fence does
            # not wait: without a handle it answers an error.
            self._handle_set.wait(self._HANDLE_WAIT_S)
        if self._restore_buffer is not None:  # unlocked fast-path probe
            with self._restore_mu:
                if self._restore_buffer is not None and not (
                        self._backfilling
                        and msg.meta.head == REPLICA_FETCH_CMD):
                    self._restore_buffer.append(msg)
                    return
        self._process_request(msg)

    def _process_request(self, msg: Message) -> None:
        if (msg.meta.head == ROUTING_LOCAL_CMD
                and hasattr(msg, "_routing_table")):
            # The local cutover: the ownership flip serializes against
            # every earlier queued request.
            self._apply_routing_update(msg._routing_table)
            return
        if (msg.meta.head == SNAPSHOT_LOCAL_CMD
                and hasattr(msg, "_snapshot_ctl")):
            # The local snapshot fence: on this thread the cut
            # serializes against every earlier queued request.
            self._run_snapshot(msg)
            return
        if msg.meta.option == OPT_XFER_PART:
            self._stream_part(msg)
            return
        if msg.meta.batch is not None:
            self._process_batch(msg)
            return
        if (msg.meta.head == MIGRATE_CMD and msg.meta.push
                and msg.meta.option != OPT_REPLICA):
            self._import_migration(msg)
            return
        if self._owned is not None and self._elastic_gate(msg):
            return  # parked at a pending range, or bounced
        xfer = getattr(msg, "_xfer_key", None)
        if xfer is not None:
            with self._streams_mu:
                h = self._streams.pop(xfer, None)
            if h is not None:
                # Every key was fed from the partials: closing releases
                # the response once the last fed slice has applied.
                h.close()
                return
        m = msg.meta
        meta = KVMeta(cmd=m.head, push=m.push, pull=m.pull, sender=m.sender,
                      timestamp=m.timestamp, customer_id=m.customer_id,
                      key=m.key, addr=m.addr, val_len=m.val_len,
                      option=m.option, priority=m.priority, codec=m.codec,
                      trace=m.trace, tenant=m.tenant, stamp=m.stamp)
        if meta.trace and self.po.tracer.active:
            recv_us = getattr(msg, "_recv_us", None)
            if recv_us is not None:
                # Wire arrival to this request thread: the customer
                # queue's wait (the critical path's server_queue).
                self.po.tracer.span(meta.trace, "server_queue", recv_us,
                                    args={"ts": meta.timestamp,
                                          "push": meta.push})
        self._intake_pull_stamp(meta)
        if meta.cmd == BATCH_PROBE_CMD and meta.pull:
            # The batch capability probe, answered before the handler
            # with this build's wire version; it also proves the sender
            # decodes batched frames (val_len: its version).
            self._batch_senders.add(meta.sender)
            if meta.val_len >= 2:
                self._batch_senders_v2.add(meta.sender)
            self.response(meta, KVPairs(
                keys=np.array([1], dtype=np.uint64),
                vals=np.array([BATCH_WIRE_VERSION], dtype=np.float32)))
            return
        if meta.cmd == HOT_KEYS_CMD and meta.pull:
            # The kv.hot_keys top-k (keys and counts), before the handler.
            top = self._hot_keys.top(max(1, min(meta.val_len or 16, 128)))
            self.response(meta, KVPairs(
                keys=np.array([k for k, _ in top], dtype=np.uint64),
                vals=np.array([n for _, n in top], dtype=np.float32)))
            return
        if meta.option == OPT_REPLICA and self.tenants.enabled:
            # A forward carries its origin tenant: the replica's rollup
            # attributes the apply load to it.
            self._tenant_counter(meta.tenant, "requests").inc()
        if self._intake_admission(meta):
            # The tenant's bounded queue is full: shed before any apply,
            # so the request is all or nothing.
            self.response_overload(meta)
            return
        if meta.push:
            self._c_push_reqs.inc()
        if meta.pull:
            self._c_pull_reqs.inc()
        kvs, wire_payload = self._intake_decode(meta, msg.data, lazy_ok=True)
        self._intake_hot_keys(kvs.keys)
        reg = None
        if meta.push and len(kvs.keys):
            reg = self._recv_buffers.get((meta.sender, int(kvs.keys[0])))
            if reg is not None and np.shares_memory(kvs.vals, reg):
                # The van placed it already: alias only.
                self.delivered_in_place += 1
                kvs.vals = kvs.vals.view(reg.dtype)
            elif reg is not None:
                # Copy into the pre-registered buffer and alias it, so the
                # reference benchmark's address-identity check
                # (test_benchmark.cc:169-181) holds.
                raw = kvs.vals.reshape(-1).view(np.uint8)
                reg.reshape(-1).view(np.uint8)[: raw.nbytes] = raw
                kvs.vals = reg.reshape(-1)[: raw.nbytes // reg.itemsize]
        log.check(self._handle is not None, "KVServer handle not set")
        if self._replicator is not None and meta.cmd == REPLICA_FETCH_CMD:
            # A recovered server fetching a range's state.
            self._replicator.handle_fetch(meta, kvs, self)
            return
        if self._intake_replicate(meta, kvs, wire_payload,
                                  copy=reg is not None):
            # A pure-push duplicate origin: apply nothing, still ack.
            self.response(meta)
            return
        if self._apply_pool is not None:
            # A registered-buffer push applies before the next message:
            # the pump overwrites the buffer with the sender's next push.
            self._apply_pool.submit(meta, kvs, wait=reg is not None)
            return
        t0 = time.monotonic()
        self._handle(meta, kvs, self)
        dur = time.monotonic() - t0
        self._h_serial_apply.observe(dur)
        if meta.trace and self.po.tracer.active:
            now = self.po.tracer.now_us()
            self.po.tracer.span(meta.trace, "apply", now - dur * 1e6,
                                dur * 1e6, args={"keys": len(kvs.keys),
                                                 "push": meta.push})

    # -- batched frames -------------------------------------------------------

    def _process_batch(self, msg: Message) -> None:
        """One EXT_BATCH frame: per-op intake (admission sheds per
        sub-op, per-op stamps), then the admitted ops into the pool as a
        group, answered by one batched response."""
        env = msg.meta
        # A batched frame proves its sender decodes them (this covers
        # PS_BATCH_NEGOTIATE=0 clusters, which never probe); one with
        # per-op traces proves the v2 table.
        self._batch_senders.add(env.sender)
        if any(op.trace for op in env.batch.ops):
            self._batch_senders_v2.add(env.sender)
        subs = split_batch_message(msg)
        if not subs:
            return
        # The elastic ownership gate and registered receive buffers are
        # per-op machinery the group apply does not carry.
        fallback = self._owned is not None
        for sub in subs:
            if self._recv_buffers and sub.meta.push and sub.data:
                k0 = sub.data[0].astype_view(np.uint64).numpy()
                if len(k0) and (env.sender, int(k0[0])) in self._recv_buffers:
                    fallback = True
                    break
        if fallback:
            # Run each sub-op alone (per-op responses; the worker takes
            # both shapes).
            for sub in subs:
                self._process_request(sub)
            return
        env_meta = KVMeta(cmd=0, push=env.push, pull=env.pull,
                          sender=env.sender,
                          timestamp=subs[0].meta.timestamp,
                          customer_id=env.customer_id, key=subs[0].meta.key,
                          priority=env.priority, tenant=env.tenant)
        metas: List[KVMeta] = []
        kvss: List[KVPairs] = []
        results: List[Optional[tuple]] = []
        admitted = 0
        recv_us = getattr(msg, "_recv_us", None)
        tracer = self.po.tracer
        for sub in subs:
            sm = sub.meta
            meta = KVMeta(cmd=0, push=sm.push, pull=sm.pull,
                          sender=env.sender, timestamp=sm.timestamp,
                          customer_id=env.customer_id, key=sm.key,
                          val_len=sm.val_len, option=0,
                          priority=env.priority, codec=sm.codec,
                          tenant=env.tenant, trace=sm.trace, stamp=sm.stamp)
            if sm.trace and tracer.active and recv_us is not None:
                # Off the envelope's arrival: each traced member
                # attributes the frame's one wait.
                tracer.span(sm.trace, "server_queue", recv_us,
                            args={"ts": sm.timestamp, "push": sm.push})
            kvs, wire_payload = self._intake_decode(meta, sub.data,
                                                    lazy_ok=False)
            self._intake_pull_stamp(meta)
            self._intake_hot_keys(kvs.keys)
            result = None
            if self._intake_admission(meta, extra=admitted):
                # Sheds are per sub-op: this op fails, its siblings apply.
                result = ("overload",)
            else:
                if meta.push:
                    self._c_push_reqs.inc()
                if meta.pull:
                    self._c_pull_reqs.inc()
                if self._intake_replicate(meta, kvs, wire_payload):
                    # Forwards and dedup per sub-op, in op order on this
                    # thread, each with its own origin (ts, key).
                    result = ("ok", None)  # a pure-push duplicate: ack
                else:
                    admitted += 1
            metas.append(meta)
            kvss.append(kvs)
            results.append(result)
        log.check(self._handle is not None, "KVServer handle not set")
        if self._apply_pool is not None:
            self._apply_pool.submit_batch(env_meta, metas, kvss, results)
            return
        # Serial path: apply each admitted op inline, capture its
        # response, and send one batched frame.
        for i, (meta, kvs) in enumerate(zip(metas, kvss)):
            if results[i] is not None:
                continue
            cap = _OpCapture(self)
            t0 = time.monotonic()
            try:
                self._handle(meta, kvs, cap)
                results[i] = cap.result
            except Exception as exc:  # noqa: BLE001 - fails this op only
                log.warning(f"batched apply failed for ts={meta.timestamp} "
                            f"from {meta.sender}: {exc!r}")
                results[i] = ("error",)
            self._h_serial_apply.observe(time.monotonic() - t0)
        self.response_batch(env_meta, metas, results)

    def response_batch(self, env: KVMeta, metas, results) -> None:
        """One response frame for a batched request: per-op result
        segments in op order, per-op error/overload codes and stamps in
        the EXT_BATCH table.  Push sub-ops bump the push version as
        their results leave, as single responses do; pull sub-ops carry
        the stamp taken at intake."""
        msg = Message()
        m = msg.meta
        m.app_id = self._customer.app_id
        m.customer_id = env.customer_id
        m.request = False
        m.head = 0  # batched ops are plain-cmd by construction
        m.timestamp = metas[0].timestamp
        m.recver = env.sender
        m.key = metas[0].key
        m.priority = env.priority
        m.tenant = env.tenant
        tracer = self.po.tracer
        tr_active = tracer.active
        ops = []
        for meta, result in zip(metas, results):
            kind = result[0] if result is not None else "ok"
            option = 0
            codec_info = None
            nseg = 0
            if kind == "overload":
                option = OPT_OVERLOAD  # nothing applied: no bump
            elif kind == "error":
                self._qos_push_done(meta)  # may have applied in part
                option = OPT_APPLY_ERROR
            else:
                self._qos_push_done(meta)
                res = result[1] if kind == "res" else None
                if meta.pull and res is not None and not res.empty():
                    ci = meta.codec
                    enc = None
                    if (ci is not None and ci.raw_len == 0
                            and isinstance(res.vals, np.ndarray)
                            and res.vals.dtype == np.float32
                            and res.vals.size > 0):
                        enc = self._encode_response(ci, meta, res)
                    msg.add_data(SArray(res.keys))
                    if enc is not None:
                        codes, scales, codec_info = enc
                        msg.add_data(SArray(codes))
                        msg.add_data(SArray(scales))
                        nseg = 3
                    else:
                        msg.add_data(SArray(res.vals))
                        nseg = 2
                    if res.lens is not None:
                        msg.add_data(SArray(np.asarray(res.lens,
                                                       dtype=np.int32)))
                        nseg += 1
            self._await_forwards(meta)
            if meta.trace and tr_active:
                # The batched analog of a single response's respond
                # instant.
                tracer.instant(meta.trace, "respond",
                               args={"to": env.sender,
                                     "ts": meta.timestamp})
            m.push = m.push or meta.push
            m.pull = m.pull or meta.pull
            ops.append(BatchOp(push=meta.push, pull=meta.pull,
                               timestamp=meta.timestamp, key=meta.key,
                               val_len=meta.val_len, option=option,
                               stamp=meta.stamp, nseg=nseg,
                               codec=codec_info, trace=meta.trace))
        m.batch = BatchInfo(ops=tuple(ops))
        # One frame already, but it rides the sender's response lane for
        # order with interleaved single responses.
        self._send_response(msg)


class _StagingStore:
    """Plain-dict handle stand-in that ``snapshot.restore_into`` fills
    while the live store serves (model-namespace publish)."""

    def __init__(self):
        self.store: dict = {}


class _OpCapture:
    """The server as a serial-path batched sub-op's handler sees it:
    ``response`` is captured into ``result`` (the frame answers once);
    everything else is the real server's."""

    __slots__ = ("_server", "result")

    def __init__(self, server: KVServer):
        self._server = server
        self.result = ("ok", None)

    def response(self, req, res=None) -> None:
        self.result = ("res", res) if res is not None else ("ok", None)

    def response_error(self, req) -> None:
        self.result = ("error",)

    def __getattr__(self, name):
        return getattr(self._server, name)


# -- server handles -----------------------------------------------------------

def _push_segs(meta: KVMeta, all_keys: np.ndarray, vals: np.ndarray,
               positions=None) -> List[np.ndarray]:
    """Per-key value views of a fixed-k push payload (zero copy), the
    currency of ``apply_shard``; ``positions`` picks a shard's keys
    (indices into the request's keys), None all of them in order."""
    n = len(all_keys)
    if not meta.push or n == 0:
        return []
    log.check(len(vals) % n == 0, "bad push shape")
    k = len(vals) // n
    if positions is None:
        return [vals[i * k:(i + 1) * k] for i in range(n)]
    return [vals[int(p) * k:(int(p) + 1) * k] for p in positions]


def _pack_pull_vals(parts: List[np.ndarray],
                    val_len: Optional[int] = None) -> np.ndarray:
    """Gather per-key store arrays into one response buffer (promoting
    mixed per-key dtypes like ``np.concatenate``); with ``val_len`` each
    key's length is checked."""
    if not parts:
        return np.empty(0, np.float32)
    if val_len is not None:
        for p in parts:
            log.check(p.size == val_len,
                      f"stored value length {p.size} != registered "
                      f"val_len {val_len}")
    return np.concatenate([p.reshape(-1) for p in parts])


def _gather(store: Dict[int, np.ndarray], keys) -> List[np.ndarray]:
    parts = []
    for key in keys:
        arr = store.get(int(key))
        # A missing key must fail loudly: a zero-length chunk would
        # shift later keys' values in the caller's buffer.
        log.check(arr is not None, f"pull of unknown key {key}")
        parts.append(arr)
    return parts


class KVServerDefaultHandle:
    """push => store[key] += vals; pull => store[key] (kv_app.h:430-452).

    Pushes apply in place into an owned per-key array; ``val_len``
    (optional) registers a fixed per-key value count, checked on pull."""

    def __init__(self, val_len: Optional[int] = None):
        self.store: Dict[int, np.ndarray] = {}
        self.val_len = val_len

    def apply_shard(self, meta: KVMeta, keys: np.ndarray,
                    segs) -> Optional[List[np.ndarray]]:
        """Apply a push (``segs``: one value segment per key, a view of
        the payload or a shard's decode of a codec payload, which may be
        a recycled buffer: stored by copy) and/or gather pull refs for
        exactly ``keys``.  Each key reaches one shard thread only, so
        per-key state takes no lock."""
        store = self.store
        if meta.push:
            for key, seg in zip(keys, segs):
                key = int(key)
                cur = store.get(key)
                if cur is None:
                    store[key] = seg.copy()  # owned: later += is in place
                else:
                    # A key's dtype is fixed by its first push.
                    log.check(cur.dtype == seg.dtype,
                              f"push dtype {seg.dtype} != stored dtype "
                              f"{cur.dtype} for key {key}")
                    # Large adds without the GIL, beside the receive
                    # pump (_env: set_request_handle's node env).
                    if not native.try_iadd(cur, seg,
                                           env=getattr(self, "_env", None)):
                        cur += seg
        return _gather(store, keys) if meta.pull else None

    def __call__(self, req_meta: KVMeta, req_data: KVPairs,
                 server: KVServer):
        parts = self.apply_shard(
            req_meta, req_data.keys,
            _push_segs(req_meta, req_data.keys, req_data.vals))
        if req_meta.pull:
            server.response(req_meta, KVPairs(
                keys=req_data.keys, vals=_pack_pull_vals(parts, self.val_len)))
        else:
            server.response(req_meta)


class KVServerOptimizerHandle:
    """Server-side optimizer of the async-PS pattern: workers push
    gradients with no barrier, the server applies each push as it
    arrives, pulls return the current parameters.

    push => params[key] = update(params[key], grad); pull => params[key].
    ``kind``: "sgd" | "sgd_momentum" | "adam", host numpy as in
    ``pslite_tpu/kv/kv_app.py:5228-5350``, updating in place.  Unknown
    keys start at zeros on their first push (or seed with ``init``).
    ``export_range``/``import_range`` pack the momentum/adam slots into
    the records replica fetches and snapshots move."""

    def __init__(self, kind: str = "sgd", lr: float = 0.01,
                 momentum: float = 0.9, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        log.check(kind in ("sgd", "sgd_momentum", "adam"),
                  f"unknown optimizer {kind!r}")
        self.kind = kind
        self.lr = lr
        self.momentum = momentum
        self.betas = betas
        self.eps = eps
        self.store: Dict[int, np.ndarray] = {}
        self._m: Dict[int, np.ndarray] = {}
        self._v: Dict[int, np.ndarray] = {}
        self._t: Dict[int, int] = {}

    def init(self, key: int, value: np.ndarray) -> None:
        self.store[int(key)] = np.asarray(value, np.float32).copy()

    def _slot(self, slots: Dict[int, np.ndarray], key: int,
              like: np.ndarray) -> np.ndarray:
        s = slots.get(key)
        if s is None:
            s = slots[key] = np.zeros_like(like)
        return s

    def _apply(self, key: int, grad: np.ndarray) -> None:
        p = self._slot(self.store, key, grad)
        if self.kind == "sgd":
            p -= self.lr * grad
        elif self.kind == "sgd_momentum":
            m = self._slot(self._m, key, grad)
            m *= self.momentum
            m += grad
            p -= self.lr * m
        else:  # adam
            b1, b2 = self.betas
            t = self._t.get(key, 0) + 1
            self._t[key] = t
            m = self._slot(self._m, key, grad)
            v = self._slot(self._v, key, grad)
            m *= b1
            m += (1 - b1) * grad
            v *= b2
            v += (1 - b2) * grad * grad
            mhat = m / (1 - b1 ** t)
            vhat = v / (1 - b2 ** t)
            p -= self.lr * mhat / (np.sqrt(vhat) + self.eps)

    def apply_shard(self, meta: KVMeta, keys: np.ndarray,
                    segs) -> Optional[List[np.ndarray]]:
        """As ``KVServerDefaultHandle.apply_shard``; the gradient segments
        are read, never kept."""
        if meta.push:
            for key, seg in zip(keys, segs):
                self._apply(int(key), seg.astype(np.float32, copy=False))
        return _gather(self.store, keys) if meta.pull else None

    # -- state iterator ------------------------------------------------------
    #
    # The export_range/import_range currency is (keys, flat vals,
    # per-key lens): the replica fetch and cluster snapshots move state
    # through it.  The optimizer handle packs its slots into the same
    # per-key record, so both carry them (JAX's layout, so records move
    # between the packages):
    #
    #   sgd           [param]                         (len n)
    #   sgd_momentum  [param, m, kind_bits]           (len 2n + 1)
    #   adam          [param, m, v, t_bits, kind_bits] (len 3n + 2)
    #
    # Missing slots export as zeros — bit-identical to the lazy
    # zeros-on-first-push initialization, so a restored handle's next
    # update is bit-exact vs an uninterrupted one.  The adam step
    # count travels as the int32 BIT PATTERN viewed as float32 (this
    # plane is never codec-quantized), so it round-trips exactly.
    #
    # Slot-carrying records are tagged TWICE — an explicit layout
    # marker, not a length heuristic: (1) a NEGATIVE per-key len (the
    # magnitude is still the record length; a params-only source —
    # plain-dict peer, a DefaultHandle-written snapshot — always
    # exports positive lens, so a parameter row can never be mistaken
    # for a packed record, and the generic dict-store import refuses
    # packed records loudly), and (2) a trailing kind_bits element
    # (the _KIND_CODES int32 bit pattern as float32) inside the
    # record, so a record packed by a DIFFERENT optimizer kind
    # refuses loudly even when the lengths happen to collide
    # (momentum n=2 and adam n=1 both pack to 4 floats without it).
    # Every consumer of this currency (generic import, snapshot range
    # filtering) reads lens through abs(); the files/wire carry
    # int32, so the sign survives the whole journey.

    _KIND_CODES = {"sgd_momentum": 0x70731, "adam": 0x70732}

    def export_range(self, begin: int, end: int):
        """Snapshot params + optimizer slots for keys in [begin, end)."""
        items = _snapshot_items(self.store, begin, end)
        pairs = sorted((k, p) for k, p in items if begin <= k < end)
        keys = np.asarray([k for k, _ in pairs], dtype=np.uint64)
        recs: List[np.ndarray] = []
        lens: List[int] = []
        for k, p in pairs:
            p = np.asarray(p, dtype=np.float32).reshape(-1)
            rec = [p]
            if self.kind in ("sgd_momentum", "adam"):
                m = self._m.get(k)
                rec.append(np.zeros_like(p) if m is None
                           else np.asarray(m, np.float32).reshape(-1))
            if self.kind == "adam":
                v = self._v.get(k)
                rec.append(np.zeros_like(p) if v is None
                           else np.asarray(v, np.float32).reshape(-1))
                rec.append(np.asarray([self._t.get(k, 0)],
                                      dtype=np.int32).view(np.float32))
            if self.kind != "sgd":
                rec.append(np.asarray([self._KIND_CODES[self.kind]],
                                      dtype=np.int32).view(np.float32))
            recs.append(np.concatenate(rec))
            # Negative len == "this record carries slots" (see the
            # layout comment above); plain sgd records are just the
            # params and stay positive.
            lens.append(-recs[-1].size if self.kind != "sgd"
                        else recs[-1].size)
        vals = (np.concatenate(recs) if recs
                else np.empty(0, np.float32))
        return keys, vals, np.asarray(lens, dtype=np.int32)

    def import_range(self, keys, vals, lens) -> None:
        """Load records written by :meth:`export_range` (same ``kind``
        on both sides — the cluster runs one handle type).  A record
        tagged slot-packed (negative len) whose length does not match
        THIS kind's packing fails loudly — silently mis-splitting it
        would corrupt the key.  Untagged (positive-len) records are a
        params-only source (plain-dict peer, a DefaultHandle-written
        snapshot) and import as params with fresh slots, exactly like
        a first push would initialize them."""
        off = 0
        n_keys = len(keys)
        for i, key in enumerate(keys):
            key = int(key)
            raw_len = (int(lens[i]) if lens is not None
                       else len(vals) // max(n_keys, 1))
            rec_len = abs(raw_len)
            rec = np.asarray(vals[off:off + rec_len], dtype=np.float32)
            off += rec_len
            if raw_len >= 0:
                # Params-only source: fresh slots, like a first push.
                self.store[key] = rec.copy()
                continue
            # Slot-packed: the trailing kind_bits element names the
            # WRITER's kind — refuse a mismatch loudly even when the
            # record lengths collide (see the layout comment).
            log.check(
                self.kind != "sgd",
                f"slot-packed record for key {key} but this handle "
                f"is kind='sgd' — mixed optimizer kinds cannot share "
                f"state",
            )
            src_code = (int(rec[-1:].view(np.int32)[0])
                        if rec_len > 0 else -1)
            log.check(
                src_code == self._KIND_CODES[self.kind],
                f"slot-packed record for key {key} was written by a "
                f"different optimizer kind (code {src_code:#x}, this "
                f"handle wants "
                f"{self._KIND_CODES[self.kind]:#x}/{self.kind}) — "
                f"mixed optimizer kinds cannot share state",
            )
            body = rec_len - 1  # sans kind_bits
            if self.kind == "adam":
                log.check(
                    body > 1 and (body - 1) % 3 == 0,
                    f"slot-packed record of length {rec_len} for key "
                    f"{key} does not match the adam [p,m,v,t] layout",
                )
                n = (body - 1) // 3
                self.store[key] = rec[:n].copy()
                self._m[key] = rec[n:2 * n].copy()
                self._v[key] = rec[2 * n:3 * n].copy()
                self._t[key] = int(
                    rec[3 * n:3 * n + 1].view(np.int32)[0])
            else:  # sgd_momentum (the only other slot-packing kind)
                log.check(
                    body > 0 and body % 2 == 0,
                    f"slot-packed record of length {rec_len} for key "
                    f"{key} does not match the sgd_momentum [p,m] "
                    f"layout",
                )
                n = body // 2
                self.store[key] = rec[:n].copy()
                self._m[key] = rec[n:2 * n].copy()

    def drop_keys(self, keys) -> None:
        """Migration drop: params AND slots leave together (a stranded
        slot would silently corrupt the key if the range ever migrated
        back).  A tiered param store drops cold keys O(1) via
        ``discard`` instead of deserializing bytes nobody reads."""
        drop = _store_drop_fn(self.store)
        for k in np.asarray(keys).reshape(-1).tolist():
            k = int(k)
            drop(k)
            self._m.pop(k, None)
            self._v.pop(k, None)
            self._t.pop(k, None)

    def __call__(self, req_meta: KVMeta, req_data: KVPairs,
                 server: KVServer):
        parts = self.apply_shard(
            req_meta, req_data.keys,
            _push_segs(req_meta, req_data.keys, req_data.vals))
        if req_meta.pull:
            server.response(req_meta, KVPairs(keys=req_data.keys,
                                              vals=_pack_pull_vals(parts)))
        else:
            server.response(req_meta)


def _store_drop_fn(store):
    """Key-drop callable of a handle's store: a tiered store's
    ``discard`` drops cold keys without reading them; plain dicts
    ``pop``."""
    drop = getattr(store, "discard", None)
    if callable(drop):
        return drop
    return lambda k: store.pop(k, None)
