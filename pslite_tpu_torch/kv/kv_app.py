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
of numpy's ``+=``) unless the node's ``PS_NATIVE=0``.  Not here, each
raising where a JAX caller would reach it: request deadlines and
failover, replication (and so batching under
``PS_KV_REPLICATION`` > 1), elastic routing (``PS_ELASTIC`` with
batching, and the wrong-owner re-slice of a sub-get), snapshots, the
tiered store and namespaces (item 8).
``KVWorker.reshard`` recuts the worker's engines onto a new device group
(``IciVan.reshard_engines``).
"""

from __future__ import annotations

import concurrent.futures
import itertools
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
from ..base import SERVER_GROUP, server_rank_to_id
from ..customer import Customer
from ..message import (
    BatchInfo,
    BatchOp,
    CodecInfo,
    Message,
    OPT_APPLY_ERROR,
    OPT_OVERLOAD,
    OPT_SEND_FAILED,
    OPT_WRONG_OWNER,
    OPT_XFER_PART,
    OPT_ZPULL,
    Role,
    ZPULL_OFF_BITS,
)
from ..ops import codecs as codecs_mod
from ..range import Range, find_range
from ..sarray import SArray
from ..telemetry import node_registry
from ..utils import logging as log
from ..utils.bounded import BoundedKeySet
from ..vans import native
from .apply_shards import ApplyShardPool
from .batching import (BATCH_PROBE_CMD, BATCH_WIRE_VERSION, OpCombiner,
                       split_batch_message)
from .hot_cache import HotKeyCache


_ZPULL_SEQ = itertools.count(1)  # process-wide registered pull buffer ids


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not yet ported to pslite_tpu_torch (ROADMAP Queue 1 "
        f"item {item})")


# meta.head of the hot-key introspection pull: the server answers with
# its kv.hot_keys top-k (keys + counts) before the handler.
HOT_KEYS_CMD = 0x407C


def _refuse_batching_with(env, batch_bytes: int) -> None:
    """Batching under what the port does not run yet: JAX forwards and
    dedups batched sub-ops down a replica chain, and declines batching
    under elastic membership."""
    if batch_bytes <= 0:
        return
    if env.find_int("PS_KV_REPLICATION", 1) > 1:
        raise _not_ported("small-op batching under replication "
                          "(PS_KV_REPLICATION > 1)", "8(b)")
    if env.find_int("PS_ELASTIC", 0):
        raise _not_ported("elastic membership (PS_ELASTIC), under which "
                          "JAX declines batching", "8")


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


@dataclass
class _EncodedSlice:
    """One slice's codec payload, encoded once at send time: a resend
    carries these exact bytes (encoding again would fold the residual
    twice)."""

    codes: np.ndarray   # uint8
    scales: np.ndarray  # float32 (empty for bf16)
    lens: Optional[np.ndarray]
    info: CodecInfo


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

    def __init__(self, app_id: int, customer_id: int = 0, postoffice=None):
        self.po = postoffice or ps_mod.postoffice(Role.WORKER)
        env = self.po.env
        _refuse_batching_with(env, env.find_int("PS_BATCH_BYTES", 0))
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
        # Bounced by a server that no longer owns the range
        # (OPT_WRONG_OWNER, an elastic JAX server): the re-slice needs
        # routing epochs, so wait raises naming item 8(b).
        self._wrong_owner_ts = BoundedKeySet(4096)
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
        self._batch_caps: Dict[int, bool] = {}
        self._batch_probe_ts: Dict[int, int] = {}
        self._batch_probing: set = set()
        self._batch_negotiate = bool(env.find_int("PS_BATCH_NEGOTIATE", 1))
        self._combiner: Optional[OpCombiner] = None
        if self._batch_bytes > 0:
            self._combiner = OpCombiner(
                lambda m: self.po.van.send(m), self._batch_send_failed,
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
        buffer."""
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
            off += int(np.searchsorted(keys, rng.end)
                       - np.searchsorted(keys, rng.begin)) * val_len * itemsize
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
        set with the union.  Returns the keys, server by server."""
        ranges = self.po.get_server_key_ranges()
        ts = self._customer.new_request(SERVER_GROUP,
                                        num_responses=len(ranges))
        with self._mu:
            self._raw_ts.add(ts)
        gs = self.po.group_size
        try:
            for rank, rng in enumerate(ranges):
                msg = Message()
                m = msg.meta
                m.app_id = self._customer.app_id
                m.customer_id = self._customer.customer_id
                m.request = True
                m.pull = True
                m.head = HOT_KEYS_CMD
                m.timestamp = ts
                m.recver = server_rank_to_id(rank * gs + self.po.instance_idx)
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

    def _batch_send_failed(self, msgs, exc: Exception) -> None:
        """Combiner error hook: a flush's send raised off the caller's
        thread; fail each member op as an inline send failure would."""
        for m in msgs:
            self._slice_send_failed(m.meta.timestamp, exc)

    def _slice_send_failed(self, ts: int, exc: Exception) -> None:
        """No response will come for this slice: fail the request so
        ``wait(ts)`` raises TimeoutError instead of hanging."""
        log.warning(f"send ts={ts} failed ({exc!r}); failing the request")
        with self._mu:
            self._timeout_ts.add(ts)
            self._recv_kvs.pop(ts, None)
            self._pull_dst.pop(ts, None)
            self._callbacks.pop(ts, None)
            self._zpull_ts.discard(ts)
        self._customer.add_response(ts, 1)

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
        self._send(ts, push=True, pull=False, cmd=cmd, kvs=kvs, codec=codec,
                   tenant=tid)
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
             _batch_sink: Optional[List[Message]] = None) -> int:
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
            if callback is not None:
                callback()
            return ts
        ts = self._new_message_request(callback)
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
                   tenant=tid, batch_sink=_batch_sink)
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
        zpull = self._zpull_lookup(kvs.keys, outs) if lens is None else None
        with self._mu:
            self._pull_dst[ts] = (kvs.keys, outs, lens)
            if zpull is not None:
                self._zpull_ts.add(ts)
        self._send(ts, push=True, pull=True, cmd=cmd, kvs=kvs, zpull=zpull,
                   codec=codec, tenant=tid)
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
        try:
            self._multi_get_issue(key_lists, outs, val_len, dtype, cmd,
                                  priority, compress, codec, tenant, handle,
                                  sink, want_cb, _complete)
        finally:
            if sink:
                # The whole fan-out enters the combiner at once: one frame
                # per contacted server at the next pickup (in a finally,
                # so a raise part way never strands queued sub-gets).
                self._combiner.submit_many(sink)
        return handle

    def _multi_get_issue(self, key_lists, outs, val_len, dtype, cmd,
                         priority, compress, codec, tenant, handle, sink,
                         want_cb, _complete) -> None:
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
                    tenant=tenant, callback=_scatter, _batch_sink=sink)
                continue
            handle.timestamps[i] = self.pull(
                keys, out, cmd=cmd, priority=priority, codec=codec_i,
                tenant=tenant,
                callback=(lambda i=i: _complete(i)) if want_cb else None,
                _batch_sink=sink)

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
        if not (self._timeout_ts or self._error_ts or self._overload_ts
                or self._wrong_owner_ts):
            return
        with self._mu:
            timed_out = self._timeout_ts.discard(timestamp)
            failed = self._error_ts.discard(timestamp)
            shed = self._overload_ts.discard(timestamp)
            bounced = self._wrong_owner_ts.discard(timestamp)
        if bounced:
            raise _not_ported(
                f"request {timestamp}: the re-slice of a slice bounced "
                f"OPT_WRONG_OWNER (routing epochs)", "8(b)")
        if shed:
            raise OverloadError(
                f"request {timestamp} was shed by the server under "
                f"per-tenant admission control (OPT_OVERLOAD); back off "
                f"and retry")
        if timed_out:
            raise TimeoutError(f"request {timestamp} was abandoned: its "
                               f"delivery failed")
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
        responses), the receive pump and the engine completion thread."""
        if self._combiner is not None:
            self._combiner.stop()
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
                   tenant: int = 0) -> Message:
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
              batch_sink: Optional[List[Message]] = None) -> None:
        ranges = self.po.get_server_key_ranges()
        sliced = (self._slicer(kvs, ranges)
                  if len(ranges) > 1 or self._slicer is not default_slicer
                  else [kvs])
        live = [(rank, part) for rank, part in enumerate(sliced)
                if part is not None and not part.empty()]
        # Pre-credit the servers that get no slice.
        credit = self._customer.num_expected(ts) - len(live)
        if credit:
            self._customer.add_response(ts, credit)
        if not live:
            self._finish(ts)
            return
        # Encode every slice before any send can fail, once.
        encs = [self._encode_part(codec, rank, part)
                if codec is not None and push else None
                for rank, part in live]
        gs = self.po.group_size
        for (rank, part), enc in zip(live, encs):
            dest = server_rank_to_id(rank * gs + self.po.instance_idx)
            msg = self._slice_msg(ts, push, pull, cmd, part, dest,
                                  val_nbytes, zpull, rank, codec, enc,
                                  tenant)
            if self._combiner is not None and self._batch_capable(dest):
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
            except Exception as exc:  # noqa: BLE001 - PeerDeadError & co
                self._slice_send_failed(ts, exc)

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
        option = msg.meta.option
        if option == OPT_SEND_FAILED:
            with self._mu:
                self._timeout_ts.add(ts)
        elif option == OPT_APPLY_ERROR:
            with self._mu:
                self._error_ts.add(ts)
        elif option == OPT_OVERLOAD:
            with self._mu:
                self._overload_ts.add(ts)
        elif option == OPT_WRONG_OWNER:
            with self._mu:
                self._wrong_owner_ts.add(ts)
        hc = self._hot_cache
        if hc is not None and msg.meta.stamp:
            # Every stamped response advances its server's newest known
            # version, invalidating older fills.
            hc.observe(msg.meta.sender, msg.meta.stamp)
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
                hc.fill(msg.meta.sender, msg.meta.stamp, kvs.keys, kvs.vals)
        # The Customer counts this response *after* the handle, so the
        # last response is expected - 1 (reference: kv_app.h:686-710).
        if (self._customer.num_response(ts) + 1
                >= self._customer.num_expected(ts)):
            self._finish(ts)

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
            for op in info.ops:
                ts = op.timestamp
                try:
                    if hc is not None and op.stamp:
                        hc.observe(sender, op.stamp)
                    if (self._customer.num_response(ts) + 1
                            >= self._customer.num_expected(ts)):
                        self._finish(ts)
                except Exception as exc:  # noqa: BLE001 - count it anyway
                    log.warning(f"batched sub-op ts={ts} response "
                                f"handling failed: {exc!r}")
                finally:
                    self._customer.add_response(ts)
            return
        for sub in split_batch_message(msg):
            try:
                self._process(sub)
            except Exception as exc:  # noqa: BLE001 - count it anyway
                log.warning(f"batched sub-op ts={sub.meta.timestamp} "
                            f"response handling failed: {exc!r}")
            finally:
                self._customer.add_response(sub.meta.timestamp)

    def _finish(self, ts: int) -> None:
        with self._mu:
            chunks = self._recv_kvs.pop(ts, [])
            dst = self._pull_dst.pop(ts, None)
            zpull = ts in self._zpull_ts
            self._zpull_ts.discard(ts)
            if ts in self._raw_ts:
                # fetch_hot_keys: the caller takes the per-server KVPairs.
                self._raw_ts.discard(ts)
                self._raw_results[ts] = chunks
                chunks = []
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
                      or ts in self._overload_ts
                      or ts in self._wrong_owner_ts)
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
    (stamps, hot-key counts, decode, admission) and enters the pool as a
    group; ``BATCH_PROBE_CMD`` and ``HOT_KEYS_CMD`` pulls are answered
    before the handler."""

    _MAX_STREAMS = 64  # open streamed pushes; the oldest is aborted

    def __init__(self, app_id: int, postoffice=None):
        self.po = postoffice or ps_mod.postoffice(Role.SERVER)
        env = self.po.env
        resp_bytes = max(0, env.find_int(
            "PS_RESP_BATCH_BYTES", max(0, env.find_int("PS_BATCH_BYTES", 0))))
        _refuse_batching_with(env, resp_bytes)
        self._handle: Optional[Callable[[KVMeta, KVPairs, "KVServer"],
                                        None]] = None
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
        self._customer = Customer(
            app_id, app_id, self._process, self.po,
            on_request_error=self._request_error,
            executor_workers=min(
                1, self.po.env.find_int("PS_CUSTOMER_EXECUTOR", 0)),
        )
        self.po.register_node_failure_hook(self._on_stream_peer_event)

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
        if self._apply_pool is not None:
            self._abort_streams()  # their handles hold the old pool
            self._apply_pool.stop()
            self._apply_pool = None
        self._handle = handle
        if hasattr(handle, "apply_shard"):
            # Its native add honours this node's PS_NATIVE.
            handle._env = self.po.env
        if self._apply_shards > 0 and callable(getattr(handle, "apply_shard",
                                                       None)):
            self._apply_pool = ApplyShardPool(handle, self._apply_shards,
                                              self)

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
        encoded; other values travel raw."""
        self._qos_push_done(req)
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
        have applied in part: the push version moves on anyway."""
        self._qos_push_done(req)
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
        self._customer.stop()
        self.po.unregister_node_failure_hook(self._on_stream_peer_event)
        self._abort_streams()
        if self._apply_pool is not None:
            self._apply_pool.stop()
            self._apply_pool = None
        if self._resp_combiner is not None:
            # After the pool: its stop path still sends stranded
            # responses through _send_response.
            self._resp_combiner.stop()

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
        """Streamed apply needs the pool, no registered receive buffer
        for this (sender, key) (those apply synchronously from the
        buffer), and a live sender (a partial straggling in after its
        sender was declared dead must not reopen a reclaimed stream).
        JAX's replication and ownership terms always hold here: the port
        has neither."""
        return (self._apply_pool is not None
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
        """True when this request (or batched sub-op) must be shed."""
        if not (self._admit_limit > 0 and self._apply_pool is not None
                and meta.cmd == 0):
            return False
        return self._admission_overloaded(meta.tenant, extra=extra)

    def _intake_pull_stamp(self, meta: KVMeta) -> None:
        """A pull's hot-cache stamp, taken at intake: every push counted
        before now has applied, so the shards' snapshot includes it."""
        if self._qos_stamps and meta.pull and not meta.push:
            with self._qos_mu:
                meta.stamp = self._push_version

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
                       lazy_ok: bool = True) -> KVPairs:
        """A request's data as KVPairs.  A codec push is decoded here, or
        left encoded (``kvs.enc``) for the pool's shards when ``lazy_ok``
        and it is a fixed-k push-only payload of a range-decodable codec
        with no registered receive buffer (batched sub-ops are small and
        decode here)."""
        kvs = KVPairs()
        if len(data) < 2:
            return kvs
        kvs.keys = data[0].astype_view(np.uint64).numpy()
        ci = meta.codec
        if not (ci is not None and ci.raw_len > 0 and meta.push
                and len(data) >= 3):
            kvs.vals = data[1].numpy()
            if len(data) > 2:
                kvs.lens = data[2].astype_view(np.int32).numpy()
            return kvs
        codec = codecs_mod.by_wire_id(ci.codec)
        codecs_mod.check_block(ci)
        codes = data[1].astype_view(np.uint8).numpy()
        scales = data[2].astype_view(np.float32).numpy()
        kvs.lens = (data[3].astype_view(np.int32).numpy()
                    if len(data) > 3 else None)
        n_el = ci.raw_len // 4
        if (lazy_ok and kvs.lens is None and not meta.pull
                and self._apply_pool is not None and codec.range_decode
                and len(kvs.keys) > 0 and n_el % len(kvs.keys) == 0
                and (meta.sender, int(kvs.keys[0]))
                not in self._recv_buffers):
            kvs.enc = (codes, scales, ci)
        else:
            kvs.vals = codec.decode(codes, scales, n_el, lens=kvs.lens,
                                    flags=ci.flags)
        return kvs

    def _process(self, msg: Message) -> None:
        if msg.meta.simple_app or not msg.meta.request:
            return  # a response must never run the request handler
        if msg.meta.option == OPT_XFER_PART:
            self._stream_part(msg)
            return
        if msg.meta.batch is not None:
            self._process_batch(msg)
            return
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
        if self._intake_admission(meta):
            # The tenant's bounded queue is full: shed before any apply,
            # so the request is all or nothing.
            self.response_overload(meta)
            return
        kvs = self._intake_decode(meta, msg.data, lazy_ok=True)
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
        if self._apply_pool is not None:
            # A registered-buffer push applies before the next message:
            # the pump overwrites the buffer with the sender's next push.
            self._apply_pool.submit(meta, kvs, wait=reg is not None)
            return
        self._handle(meta, kvs, self)

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
        fallback = False
        for sub in subs:
            if self._recv_buffers and sub.meta.push and sub.data:
                k0 = sub.data[0].astype_view(np.uint64).numpy()
                if len(k0) and (env.sender, int(k0[0])) in self._recv_buffers:
                    fallback = True
                    break
        if fallback:
            # A registered receive buffer is per-op machinery the group
            # apply does not carry: run each sub-op alone (per-op
            # responses; the worker takes both shapes).
            for sub in subs:
                self._process(sub)
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
        for sub in subs:
            sm = sub.meta
            meta = KVMeta(cmd=0, push=sm.push, pull=sm.pull,
                          sender=env.sender, timestamp=sm.timestamp,
                          customer_id=env.customer_id, key=sm.key,
                          val_len=sm.val_len, option=0,
                          priority=env.priority, codec=sm.codec,
                          tenant=env.tenant, trace=sm.trace, stamp=sm.stamp)
            kvs = self._intake_decode(meta, sub.data, lazy_ok=False)
            self._intake_pull_stamp(meta)
            self._intake_hot_keys(kvs.keys)
            result = None
            if self._intake_admission(meta, extra=admitted):
                # Sheds are per sub-op: this op fails, its siblings apply.
                result = ("overload",)
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
            try:
                self._handle(meta, kvs, cap)
                results[i] = cap.result
            except Exception as exc:  # noqa: BLE001 - fails this op only
                log.warning(f"batched apply failed for ts={meta.timestamp} "
                            f"from {meta.sender}: {exc!r}")
                results[i] = ("error",)
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
    The state export/import of replication and snapshots is ROADMAP
    Queue 1 item 8."""

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
