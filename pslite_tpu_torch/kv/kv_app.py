"""KVWorker — the worker API over the dense collective data plane.

Counterpart of ``pslite_tpu/kv/kv_app.py``'s KVWorker engine path:
``register_dense`` (:833), the route of exactly-registered keys to the
engine (``_engine_route`` :873), ``push``/``pull``/``push_pull``
(:1203-1207, :1263-1284, :1342-1347), ``wait`` (:1540) and
``get_pulled`` (:951).

Beside them, the engine's many-op surfaces (:860-871, :957-983):
``register_pull_buffer`` (every ``pull`` of the bucket lands in one
registered tensor: at most one such pull is outstanding per bucket, and
its result is not kept for ``get_pulled``, :1263-1285), ``coalescer``,
``replay`` and ``push_pull_stream``.

Sparse tables (:985-1000): ``push_sparse``/``pull_sparse`` ride the van's
``sparse_engine`` (``parallel/sparse.py``) and complete like the dense
ops.  ``push_sparse`` also takes the sparse engine's ``handle``
(``"row_adagrad:lr,eps"``), which JAX callers reach through
``van.sparse_engine.push``.

Completion: after an op is issued the worker records a CUDA event on
the current stream; one completion thread synchronises on that event,
copies the result into ``out`` and fires the callback, so callbacks fire
without ``wait`` and ``wait(ts)`` joins the same future.  On the CPU the
op has already run when it returns.

Still missing: the message path (unregistered keys, custom ``cmd``,
variable ``lens``), which needs the message control plane (ROADMAP
Queue 1); such calls raise ``NotImplementedError``.  ``reshard`` is not
here either.
"""

from __future__ import annotations

import concurrent.futures
import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import ps as ps_mod
from ..customer import Customer
from ..utils import logging as log

_NOT_PORTED = "message path not yet ported"


class KVWorker:
    _MAX_DEVICE_RESULTS = 8

    def __init__(self, app_id: int, customer_id: int = 0, postoffice=None):
        self.po = postoffice or ps_mod.postoffice("worker")
        self._customer = Customer(app_id, customer_id)
        self._mu = threading.Lock()
        self._dense_routes: Dict[tuple, str] = {}
        self._device_results: Dict[int, torch.Tensor] = {}
        self._engine_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        # Completion of the last pull of each registered-buffer bucket.
        self._pinned_pull_futs: Dict[str, Callable[[], None]] = {}

    @property
    def engine(self):
        """The collective engine of the worker's ICI van (None before
        the van starts)."""
        return getattr(self.po.van, "engine", None)

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

    def _route_or_raise(self, keys, cmd, lens) -> str:
        route = self._engine_route(np.asarray(keys, dtype=np.uint64), cmd,
                                   lens)
        if route is None:
            raise NotImplementedError(
                f"{_NOT_PORTED}: only registered dense buckets (cmd=0, no "
                f"lens) run in pslite_tpu_torch"
            )
        return route

    # -- completion ----------------------------------------------------------

    def _engine_dispatch(self, result: torch.Tensor, out=None,
                         callback: Optional[Callable[[], None]] = None,
                         keep_result: bool = False,
                         fut_out: Optional[list] = None) -> int:
        """Timestamp + asynchronous completion of an issued op
        (``fut_out`` receives the completion's ``result`` callable)."""
        event = None
        if result.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(result.device))
        ts = self._customer.new_request()
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
        """Device-resident pull result of a recent timestamp (bounded
        window of the last few results)."""
        with self._mu:
            return self._device_results.get(ts)

    # -- ops -----------------------------------------------------------------

    def push(self, keys, vals, lens=None, cmd: int = 0,
             callback: Optional[Callable[[], None]] = None) -> int:
        """Push ``vals`` to a registered bucket; the caller must not
        mutate ``vals`` until ``wait(ts)``."""
        route = self._route_or_raise(keys, cmd, lens)
        token = self.engine.push(route, vals)
        return self._engine_dispatch(token, callback=callback)

    def pull(self, keys, vals, lens=None, cmd: int = 0,
             callback: Optional[Callable[[], None]] = None) -> int:
        """Pull a registered bucket into ``vals``."""
        route = self._route_or_raise(keys, cmd, lens)
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
                  callback: Optional[Callable[[], None]] = None) -> int:
        """Fused push + pull round trip (the benchmark hot path)."""
        route = self._route_or_raise(keys, cmd, lens)
        result = self.engine.push_pull(route, vals)
        return self._engine_dispatch(result, out=outs, callback=callback,
                                     keep_result=True)

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
        self._customer.wait_request(timestamp)

    def stop(self) -> None:
        """Finish pending completions and retire the completion thread."""
        with self._mu:
            pool, self._engine_pool = self._engine_pool, None
        if pool is not None:
            pool.shutdown(wait=True)
