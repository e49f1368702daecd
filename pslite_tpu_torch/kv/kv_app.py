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

Host numpy on the message path, as in JAX.  Not here, each raising where
a JAX caller would reach it: wire codecs (``codec=``/``compress=`` other
than ``"raw"``), tenants, the apply-shard pool, small-op batching,
``multi_get`` and the hot-key cache (ROADMAP Queue 1 item 6); request
deadlines and failover, replication, elastic routing, snapshots and
namespaces (item 8).  ``KVWorker.reshard`` recuts the worker's engines
onto a new device group (``IciVan.reshard_engines``).  Apply is serial on the
server's customer thread, which gives the same stores as the JAX shard
pool (its contract is serial bit-exactness).

Streamed apply of chunked pushes: the van delivers a chunked push's
``OPT_XFER_PART`` partials before the reassembled message.  JAX's
``KVServer`` feeds partials to its apply-shard pool (:4594) and, without
a pool (``PS_APPLY_SHARDS=0``), drops them (``_stream_eligible`` :4299):
the reassembled message always follows and applies whole.  The port's
server is serial, so it drops partials too (item 6 brings the pool).
The stores stay bit-equal to JAX's: each key's slice is added once, the
same ``+=`` of the same values, whether streamed or whole; only the
order of two senders' adds to one key can differ (by when each slice,
or each whole message, completed), which changes nothing for exact sums
such as integer values.
"""

from __future__ import annotations

import concurrent.futures
import itertools
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import ps as ps_mod
from ..base import SERVER_GROUP, server_rank_to_id
from ..customer import Customer
from ..message import (
    Message,
    OPT_APPLY_ERROR,
    OPT_SEND_FAILED,
    OPT_XFER_PART,
    OPT_ZPULL,
    Role,
    ZPULL_OFF_BITS,
)
from ..range import Range, find_range
from ..sarray import SArray
from ..utils import logging as log
from ..utils.bounded import BoundedKeySet


_ZPULL_SEQ = itertools.count(1)  # process-wide registered pull buffer ids


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not yet ported to pslite_tpu_torch (ROADMAP Queue 1 "
        f"item {item})")


def _check_codec(codec: Optional[str], compress: Optional[str]) -> None:
    """Only uncompressed messages are ported: ``codec``/``compress`` may
    be None or ``"raw"``."""
    for c in (codec, compress):
        if c not in (None, "raw"):
            raise _not_ported(f"wire codec {c!r} (ops/codecs.py)", 6)


@dataclass
class KVPairs:
    """Sorted unique keys + values (+ optional per-key value lengths)."""

    keys: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint64))
    vals: np.ndarray = field(default_factory=lambda: np.empty(0, np.float32))
    lens: Optional[np.ndarray] = None
    priority: int = 0

    def empty(self) -> bool:
        return len(self.keys) == 0


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


class KVWorker:
    """Client of the KV store (kv_app.h:134-300)."""

    _MAX_DEVICE_RESULTS = 8

    def __init__(self, app_id: int, customer_id: int = 0, postoffice=None):
        self.po = postoffice or ps_mod.postoffice(Role.WORKER)
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
             codec: Optional[str] = None) -> int:
        """Push ``vals`` (kv_app.h:210-231); the caller must not mutate
        them until ``wait(ts)``."""
        route = self._engine_route(np.asarray(keys, dtype=np.uint64), cmd,
                                   lens)
        if route is not None:
            token = self.engine.push(route, vals)
            return self._engine_dispatch(token, callback=callback)
        _check_codec(codec, compress)
        kvs = _as_kvs(keys, vals, lens, priority)
        ts = self._new_message_request(callback)
        self._send(ts, push=True, pull=False, cmd=cmd, kvs=kvs)
        return ts

    def pull(self, keys, vals, lens: Optional[np.ndarray] = None,
             cmd: int = 0, callback: Optional[Callable[[], None]] = None,
             priority: int = 0, compress: Optional[str] = None,
             codec: Optional[str] = None) -> int:
        """Pull into ``vals`` (kv_app.h:241-247, 727-792): a numpy array
        on the message path; on the engine path also a tensor.  With
        ``lens``, the per-key lengths land there."""
        keys = np.ascontiguousarray(np.asarray(keys, dtype=np.uint64))
        route = self._engine_route(keys, cmd, lens)
        if route is not None:
            return self._engine_pull(route, vals, callback)
        _check_codec(codec, compress)
        ts = self._new_message_request(callback)
        zpull = self._zpull_lookup(keys, vals) if lens is None else None
        with self._mu:
            self._pull_dst[ts] = (keys, vals, lens)
            if zpull is not None:
                self._zpull_ts.add(ts)
        kvs = KVPairs(keys=keys, vals=np.empty(0, vals.dtype),
                      priority=priority)
        self._send(ts, push=False, pull=True, cmd=cmd, kvs=kvs,
                   val_nbytes=vals.nbytes, zpull=zpull)
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
                  codec: Optional[str] = None) -> int:
        """Fused push + pull round trip (the benchmark hot path)."""
        route = self._engine_route(np.asarray(keys, dtype=np.uint64), cmd,
                                   lens)
        if route is not None:
            result = self.engine.push_pull(route, vals)
            return self._engine_dispatch(result, out=outs, callback=callback,
                                         keep_result=True)
        _check_codec(codec, compress)
        kvs = _as_kvs(keys, vals, lens, priority)
        ts = self._new_message_request(callback)
        zpull = self._zpull_lookup(kvs.keys, outs) if lens is None else None
        with self._mu:
            self._pull_dst[ts] = (kvs.keys, outs, lens)
            if zpull is not None:
                self._zpull_ts.add(ts)
        self._send(ts, push=True, pull=True, cmd=cmd, kvs=kvs, zpull=zpull)
        return ts

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
        if not (self._timeout_ts or self._error_ts):
            return
        with self._mu:
            timed_out = self._timeout_ts.discard(timestamp)
            failed = self._error_ts.discard(timestamp)
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
        """Retire the receive pump and the engine completion thread."""
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
                   zpull: Optional[dict] = None,
                   rank: int = 0) -> Message:
        """One per-server slice message (``rank``: the server's group
        rank, whose offset a zero-copy pull names)."""
        msg = Message()
        m = msg.meta
        m.priority = part.priority
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
        msg.add_data(SArray(part.keys))
        msg.add_data(SArray(part.vals))
        if part.lens is not None:
            msg.add_data(SArray(np.asarray(part.lens, dtype=np.int32)))
        return msg

    def _send(self, ts: int, push: bool, pull: bool, cmd: int, kvs: KVPairs,
              val_nbytes: int = 0, zpull: Optional[dict] = None) -> None:
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
        gs = self.po.group_size
        for rank, part in live:
            dest = server_rank_to_id(rank * gs + self.po.instance_idx)
            msg = self._slice_msg(ts, push, pull, cmd, part, dest,
                                  val_nbytes, zpull, rank)
            try:
                self.po.van.send(msg)
            except Exception as exc:  # noqa: BLE001 - PeerDeadError & co
                # No response will come for this slice: fail the request
                # so wait(ts) raises instead of hanging.
                log.warning(f"send ts={ts} failed ({exc!r}); failing the "
                            f"request")
                with self._mu:
                    self._timeout_ts.add(ts)
                    self._recv_kvs.pop(ts, None)
                    self._pull_dst.pop(ts, None)
                    self._callbacks.pop(ts, None)
                self._customer.add_response(ts, 1)

    def _process(self, msg: Message) -> None:
        if msg.meta.request:
            return  # workers only receive responses
        ts = msg.meta.timestamp
        if msg.meta.option == OPT_SEND_FAILED:
            with self._mu:
                self._timeout_ts.add(ts)
        elif msg.meta.option == OPT_APPLY_ERROR:
            with self._mu:
                self._error_ts.add(ts)
        if msg.meta.pull and len(msg.data) >= 2:
            kvs = KVPairs(
                keys=msg.data[0].astype_view(np.uint64).numpy(),
                vals=msg.data[1].numpy(),
                lens=(msg.data[2].astype_view(np.int32).numpy()
                      if len(msg.data) > 2 else None),
            )
            with self._mu:
                self._recv_kvs.setdefault(ts, []).append(kvs)
        # The Customer counts this response *after* the handle, so the
        # last response is expected - 1 (reference: kv_app.h:686-710).
        if (self._customer.num_response(ts) + 1
                >= self._customer.num_expected(ts)):
            self._finish(ts)

    def _finish(self, ts: int) -> None:
        with self._mu:
            chunks = self._recv_kvs.pop(ts, [])
            dst = self._pull_dst.pop(ts, None)
            zpull = ts in self._zpull_ts
            self._zpull_ts.discard(ts)
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
            failed = ts in self._error_ts or ts in self._timeout_ts
        if cb is not None and not failed:
            cb()


class KVServer:
    """Holder of a key-range shard of the store (kv_app.h:304-420).

    Requests apply serially on the customer's thread, in arrival order.
    ``PS_APPLY_SHARDS`` above 1 (the JAX shard pool) raises."""

    def __init__(self, app_id: int, postoffice=None):
        self.po = postoffice or ps_mod.postoffice(Role.SERVER)
        if self.po.env.find_int("PS_APPLY_SHARDS", 1) > 1:
            raise _not_ported("the apply-shard pool (PS_APPLY_SHARDS > 1)",
                              6)
        self._handle: Optional[Callable[[KVMeta, KVPairs, "KVServer"],
                                        None]] = None
        self._recv_buffers: Dict[Tuple[int, int], np.ndarray] = {}
        self.delivered_in_place = 0  # pushes the van placed in a buffer
        self._customer = Customer(
            app_id, app_id, self._process, self.po,
            on_request_error=self._request_error,
            executor_workers=min(
                1, self.po.env.find_int("PS_CUSTOMER_EXECUTOR", 0)),
        )

    def set_request_handle(
            self, handle: Callable[[KVMeta, KVPairs, "KVServer"], None]
    ) -> None:
        self._handle = handle

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
        return msg

    def response(self, req: KVMeta, res: Optional[KVPairs] = None) -> None:
        """Reply to a request (kv_app.h:536-564)."""
        msg = self._response_msg(req)
        if res is not None and not res.empty():
            msg.add_data(SArray(res.keys))
            msg.add_data(SArray(res.vals))
            if res.lens is not None:
                msg.add_data(SArray(np.asarray(res.lens, dtype=np.int32)))
        self.po.van.send(msg)

    def response_error(self, req: KVMeta) -> None:
        """Empty ``OPT_APPLY_ERROR`` response: the waiting worker gets
        its response counted, and its ``wait`` raises."""
        msg = self._response_msg(req)
        msg.meta.option = OPT_APPLY_ERROR
        msg.meta.addr = 0
        msg.meta.val_len = 0
        self.po.van.send(msg)

    def _request_error(self, msg: Message, exc: Exception) -> None:
        """Customer hook: the handler raised on a request."""
        if msg.meta.simple_app or not msg.meta.request:
            return
        m = msg.meta
        self.response_error(KVMeta(
            cmd=m.head, push=m.push, pull=m.pull, sender=m.sender,
            timestamp=m.timestamp, customer_id=m.customer_id, key=m.key,
            option=m.option))

    def stop(self) -> None:
        self._customer.stop()

    def _process(self, msg: Message) -> None:
        if msg.meta.simple_app or not msg.meta.request:
            return  # a response must never run the request handler
        if msg.meta.option == OPT_XFER_PART:
            return  # serial apply: the reassembled push follows (above)
        m = msg.meta
        if m.codec is not None:
            raise _not_ported("a codec-encoded request (EXT_CODEC)", 6)
        meta = KVMeta(cmd=m.head, push=m.push, pull=m.pull, sender=m.sender,
                      timestamp=m.timestamp, customer_id=m.customer_id,
                      key=m.key, addr=m.addr, val_len=m.val_len,
                      option=m.option, priority=m.priority)
        kvs = KVPairs()
        if len(msg.data) >= 2:
            kvs.keys = msg.data[0].astype_view(np.uint64).numpy()
            kvs.vals = msg.data[1].numpy()
            if len(msg.data) > 2:
                kvs.lens = msg.data[2].astype_view(np.int32).numpy()
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
        self._handle(meta, kvs, self)


# -- server handles -------------------------------------------------------------

def _push_segs(meta: KVMeta, keys: np.ndarray,
               vals: np.ndarray) -> List[np.ndarray]:
    """Per-key value views of a fixed-k push payload (zero copy)."""
    n = len(keys)
    if not meta.push or n == 0:
        return []
    log.check(len(vals) % n == 0, "bad push shape")
    k = len(vals) // n
    return [vals[i * k:(i + 1) * k] for i in range(n)]


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
        """Apply a push (``segs``: one value view per key) and/or gather
        pull refs for exactly ``keys``."""
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
