"""Cross-slice (DCN) tier: hierarchical dense push/pull.

Counterpart of ``pslite_tpu/parallel/dcn.py``.  A slice is one device
group (a card's ranks, driven by one slice-leader process); slices talk
to each other over the ordinary KV message path.  The two tiers compose
the two data planes:

1. **Slice tier**: intra-slice aggregation, one K4 ring push_pull on the
   slice's :class:`CollectiveEngine` with the ``assign`` handle, so the
   engine store is scratch holding the slice-local sum.
2. **DCN tier**: each slice's leader pushes its slice sum through its
   :class:`KVWorker` over a socket van; the default slicer shards the
   keys across the servers (key-range partitioned like MultiVan's
   rails), whose handle applies the update (sum / optimizer).
3. **Redistribute**: the pulled global aggregate, placed on the slice
   group's device for its ranks (:meth:`DcnKVWorker.to_device`).

The leader barriers on the worker group between push and pull, so every
slice's contribution lands before any slice reads the aggregate, and
again after the pull, so no slice's next push lands before a slow slice
has read this round's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..base import WORKER_GROUP
from ..utils import logging as log


class DcnKVWorker:
    """Hierarchical dense push/pull: slice group (K4) + KV messages (DCN).

    ``kv_worker`` is this slice leader's :class:`KVWorker` on a socket
    van connecting the slices; ``slice_engine`` is the slice's
    :class:`CollectiveEngine`.  One instance per slice leader process.
    """

    def __init__(self, kv_worker, slice_engine, barrier=True,
                 compress: Optional[str] = None):
        """``compress='int8'`` quantizes both DCN directions (push and
        pull) blockwise, 4x fewer bytes on the inter-slice link; the
        slice tier stays full precision."""
        self.kv = kv_worker
        self.engine = slice_engine
        self._barrier = barrier
        self._compress = compress
        self._keys: dict = {}

    def register_dense(self, name: str, keys, val_len: int,
                       dtype=None) -> None:
        """Register the bucket on both tiers (engine scratch + KV keys)."""
        keys = np.ascontiguousarray(np.asarray(keys, dtype=np.uint64))
        self.engine.register_dense(name, keys, val_len, dtype=dtype)
        self._keys[name] = keys

    def push_pull(self, name: str, grads, out: Optional[np.ndarray] = None):
        """grads: this slice's worker rows (``[W_slice, total]`` or
        ``[total]``).  Returns the global (all-slice) aggregate as a host
        array, also written to ``out`` when given.  Synchronous across
        slices."""
        (out,) = self.push_pull_group([name], [grads], outs=[out])
        return out

    def push_pull_group(self, names, grads_list, outs=None):
        """Overlapped multi-bucket round: every slice sum dispatched on
        the slice tier before the first DCN push blocks on its result;
        each bucket pushed as its device result lands, ONE barrier, pull
        all, wait all, one closing barrier."""
        log.check(len(names) == len(grads_list),
                  "names/grads length mismatch")
        log.check(len(set(names)) == len(names),
                  "duplicate bucket in group")
        for name in names:
            log.check(name in self._keys, f"bucket {name!r} not registered")
        if outs is None:
            outs = [None] * len(names)
        log.check(len(outs) == len(names), "names/outs length mismatch")
        # Slice tier: the slice-local all-reduce of every bucket, enqueued
        # on the device before any DCN push waits on one.
        device_sums = [
            self.engine.push_pull(name, grads, handle="assign")
            for name, grads in zip(names, grads_list)
        ]
        # DCN tier: key-range-sharded pushes to the servers (each host
        # copy waits only for ITS bucket), then one barrier so every
        # slice's pushes are applied before any pull.
        cust = self.kv._customer.customer_id
        push_ts = [
            self.kv.push(self._keys[name], _host(dev),
                         compress=self._compress)
            for name, dev in zip(names, device_sums)
        ]
        for ts in push_ts:
            self.kv.wait(ts)
        if self._barrier:
            self.kv.po.barrier(cust, WORKER_GROUP)
        results = []
        pull_ts = []
        for name, out in zip(names, outs):
            bucket = self.engine.bucket(name)
            if out is None:
                out = np.empty(bucket.total_len,
                               dtype=_np_dtype(bucket.dtype))
            results.append(out)
            pull_ts.append(
                self.kv.pull(self._keys[name], out,
                             compress=self._compress)
            )
        for ts in pull_ts:
            self.kv.wait(ts)
        if self._barrier:
            # Post-pull barrier: without it a fast slice's NEXT-round push
            # could land at the sum-accumulating servers before a slow
            # slice finishes reading THIS round's aggregate.
            self.kv.po.barrier(cust, WORKER_GROUP)
        return results

    def to_device(self, name: str, host_aggregate) -> torch.Tensor:
        """The pulled aggregate as a tensor on the slice group's device
        (the intra-slice redistribution: every rank of the slice reads
        the one copy)."""
        bucket = self.engine.bucket(name)
        value = torch.as_tensor(np.asarray(host_aggregate)).reshape(-1)
        return value.to(device=self.engine.device, dtype=bucket.dtype)


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _host(value) -> np.ndarray:
    """A device result as a host array (waits for its bucket only)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)
