"""Sparse KV tables — embedding-style push/pull over a device group.

Counterpart of ``pslite_tpu/parallel/sparse.py``.  The JAX engine shards
a table's rows over the ``kv`` mesh axis (global row r on shard ``r %
S``, which load-balances skewed keys by construction) and runs push and
pull as collectives: push all-gathers every worker's (indices, rows) and
each shard scatter-adds the rows it owns; pull gathers the owned rows of
every worker's index list and a ``psum_scatter`` routes each worker its
batch.  Here the S virtual ranks of a
:class:`~pslite_tpu_torch.parallel.mesh.DeviceGroup` share one device, so
a table is ONE contiguous ``[rows_per_shard * S, dim]`` tensor (shard s
owns flat rows ``[s*rps, (s+1)*rps)``; global row r sits at flat row
``(r % S) * rps + r // S``): byte for byte the JAX package's logical
layout (``store_array``).  The all-gather is the flat update list in
worker order, and the pull is a gather (``ops/sparse_rows.py``: the
scatter-add, row-wise Adagrad and gather kernels).

``rows_per_shard`` is rounded to the JAX package's lane-packing factor
(``pack = 128 // dim`` for dims dividing 128), so ``store_array`` and
``acc_array`` shapes, and checkpoints, match.  The packing itself is a
TPU tiling workaround (a ``[rows, dim < 128]`` table has no good TPU
layout); the port stores rows unpacked.

The store and the row-wise Adagrad accumulator are updated IN PLACE,
where the JAX programs donate them; every result handed out (``pull``,
``pull_group``, ``push``'s token, the snapshots) is a fresh tensor.

Not in this slice: ``reshard``/``reshard_staged`` (ROADMAP Queue 1 item
7), multi-process groups, and ``store_raw``/``store_spec`` (they serve
only orbax checkpoints, which the port does not read).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..ops import sparse_rows
from ..utils import logging as log
from .engine import to_tensor, torch_dtype
from .mesh import DeviceGroup, default_group

_NOT_PORTED = "not yet ported to pslite_tpu_torch"


@dataclass
class SparseTable:
    name: str
    num_rows: int  # global rows
    dim: int
    rows_per_shard: int
    dtype: torch.dtype
    # The JAX package's lane-packing factor (pack*dim = 128 lanes there);
    # here it only rounds rows_per_shard, the store is unpacked.
    pack: int = 1

    @property
    def phys_rows(self) -> int:
        """Physical store rows per shard in the JAX package's packed
        layout."""
        return self.rows_per_shard // self.pack


def _interleave_rows(glob, num_rows: int, rps: int, S: int, dtype):
    """Global-order rows -> the sharded store layout: global row r
    lives on shard r % S at local row r // S.  ``glob`` is [num_rows]
    or [num_rows, dim]; returns the flat interleaved array of
    rps*S (x dim) entries."""
    glob = np.asarray(glob, dtype=np.dtype(dtype))
    shape = (rps * S,) + glob.shape[1:]
    arr = np.zeros(shape, dtype=np.dtype(dtype))
    arr[:num_rows] = glob
    if arr.ndim == 1:
        return arr.reshape(rps, S).transpose(1, 0).reshape(-1)
    return arr.reshape(rps, S, -1).transpose(1, 0, 2).reshape(
        -1, arr.shape[1]
    )


def _deinterleave_rows(inter, num_rows: int, rps: int, S: int):
    """Inverse of :func:`_interleave_rows`: the sharded store layout
    back to global row order ([num_rows] or [num_rows, dim])."""
    inter = np.asarray(inter)
    if inter.ndim == 1:
        return inter.reshape(S, rps).transpose(1, 0).reshape(
            -1
        )[:num_rows].copy()
    return inter.reshape(S, rps, -1).transpose(1, 0, 2).reshape(
        -1, inter.shape[1]
    )[:num_rows].copy()


def _pack_host(inter, rps: int, S: int, pack: int, dim: int):
    """Shard-interleaved LOGICAL rows [rps*S, dim] -> the JAX package's
    PHYSICAL packed store [phys*S, pack*dim] (pure contiguous
    reshapes)."""
    if pack == 1:
        return inter
    inter = np.ascontiguousarray(inter)
    return inter.reshape(S, rps // pack, pack * dim).reshape(
        S * (rps // pack), pack * dim
    )


def _unpack_host(phys, rps: int, S: int, pack: int, dim: int):
    """Inverse of :func:`_pack_host`."""
    if pack == 1:
        return np.asarray(phys)
    return np.ascontiguousarray(phys).reshape(
        S, rps, dim
    ).reshape(S * rps, dim)


def _interleave_device(glob: torch.Tensor, num_rows: int, rps: int,
                       S: int) -> torch.Tensor:
    """:func:`_interleave_rows` on the device: global rows ``[num_rows]``
    or ``[num_rows, dim]`` -> the store layout (a fresh tensor)."""
    shape = (rps * S,) + tuple(glob.shape[1:])
    arr = torch.zeros(shape, dtype=glob.dtype, device=glob.device)
    arr[:num_rows] = glob
    inner = tuple(glob.shape[1:])
    return arr.reshape((rps, S) + inner).transpose(0, 1).reshape(
        shape).contiguous()


def _deinterleave_device(inter: torch.Tensor, num_rows: int, rps: int,
                         S: int) -> torch.Tensor:
    """:func:`_deinterleave_rows` on the device (a fresh tensor)."""
    inner = tuple(inter.shape[1:])
    return inter.reshape((S, rps) + inner).transpose(0, 1).reshape(
        (rps * S,) + inner)[:num_rows].clone()


class SparseEngine:
    """Sparse tables on the ranks of one device group (the ``kv`` axis:
    W workers = S shards, the colocated layout)."""

    def __init__(self, group: Optional[DeviceGroup] = None,
                 axis_name: str = "kv"):
        self.group = group if group is not None else default_group(axis_name)
        log.check(axis_name in self.group.axis_names,
                  f"axis {axis_name!r} not in the device group")
        self.axis = axis_name
        self.device = self.group.device
        self.num_shards = int(self.group.shape[axis_name])
        # Application-payload bytes (the van's send/recv counters).
        self.push_bytes = 0
        self.pull_bytes = 0
        self._counter_mu = threading.Lock()
        self._tables: Dict[str, SparseTable] = {}
        self._stores: Dict[str, torch.Tensor] = {}
        # Row-wise Adagrad accumulators ([rps*S] f32, the table's row
        # layout), created lazily by push(handle="row_adagrad:...").
        self._acc: Dict[str, torch.Tensor] = {}
        self._mu = threading.Lock()
        # Per-table locks: push updates the store in place, so one
        # table's ops must not interleave.
        self._table_mu: Dict[str, threading.Lock] = {}

    # -- registration --------------------------------------------------------

    def register_sparse(self, name: str, num_rows: int, dim: int, dtype=None,
                        init=None) -> SparseTable:
        """Register a table of ``num_rows`` x ``dim`` and allocate its
        store (zeros, or ``init`` in global row order)."""
        dt = torch_dtype(dtype)
        log.check(dt in (torch.float32, torch.bfloat16),
                  f"sparse tables take float32 or bfloat16, got {dt}")
        pack = 128 // dim if (dim < 128 and 128 % dim == 0) else 1
        rps = -(-num_rows // self.num_shards)
        # Round to the JAX package's packing factor (see SparseTable.pack).
        rps = -(-rps // pack) * pack
        table = SparseTable(name, num_rows, dim, rps, dt, pack=pack)
        S = self.num_shards
        if init is not None:
            store = _interleave_device(
                to_tensor(init, dt, self.device).reshape(num_rows, dim),
                num_rows, rps, S)
        else:
            store = torch.zeros((rps * S, dim), dtype=dt, device=self.device)
        with self._mu:
            self._tables[name] = table
            self._stores[name] = store
            self._acc.pop(name, None)
            self._table_mu.setdefault(name, threading.Lock())
        return table

    def table(self, name: str) -> SparseTable:
        return self._tables[name]

    # -- ops -----------------------------------------------------------------

    def _prep(self, table: SparseTable, indices, grads=None):
        """``[W, n]`` int32 indices (and ``[W, n, d]`` rows of the table's
        dtype) on the group's device, contiguous."""
        idx = to_tensor(indices, torch.int32, self.device).contiguous()
        log.check(idx.dim() == 2, "indices are [workers, n]")
        log.check_eq(int(idx.shape[0]), self.num_shards, "bad worker dim")
        if grads is None:
            return idx, None
        g = to_tensor(grads, table.dtype, self.device).contiguous()
        log.check_eq(tuple(g.shape), tuple(idx.shape) + (table.dim,),
                     "bad grads shape")
        return idx, g

    def _observe(self, op: str, table: SparseTable, batch: int) -> None:
        payload = self.num_shards * batch * table.dim * table.dtype.itemsize
        with self._counter_mu:
            if op == "push":
                self.push_bytes += payload
            else:
                self.pull_bytes += payload

    def _ensure_acc(self, name: str, table: SparseTable) -> None:
        if name not in self._acc:
            self._acc[name] = torch.zeros(
                table.rows_per_shard * self.num_shards, dtype=torch.float32,
                device=self.device)

    @staticmethod
    def _parse_handle(handle: str) -> tuple:
        kind, _, rest = handle.partition(":")
        log.check(kind == "row_adagrad", f"unknown sparse handle {kind!r}")
        lr, eps = 0.01, 1e-8
        if rest:
            parts = rest.split(",")
            lr = float(parts[0])
            if len(parts) > 1:
                eps = float(parts[1])
        return kind, (lr, eps)

    def _push_locked(self, name: str, table: SparseTable, idx, g,
                     handle: Optional[str]) -> None:
        """One table's push; call with its lock held."""
        S, rps = self.num_shards, table.rows_per_shard
        if handle is None:
            sparse_rows.scatter_add(self._stores[name], idx, g, S, rps)
            return
        _, (lr, eps) = self._parse_handle(handle)
        self._ensure_acc(name, table)
        sparse_rows.row_adagrad(self._stores[name], self._acc[name], idx, g,
                                S, rps, lr, eps)

    def push(self, name: str, indices, grads, handle: Optional[str] = None):
        """indices: [W, n] int rows per worker; grads: [W, n, d].
        Duplicate rows (within or across workers) accumulate — the
        aggregation contract of the default server handle.

        ``handle="row_adagrad:lr,eps"`` instead applies the DLRM-standard
        row-wise Adagrad: the row's summed gradient G updates a per-row
        accumulator (``acc += mean(G**2)``) and the row steps by ``-lr *
        G / (sqrt(acc) + eps)``.  Returns a tiny completion token (a fresh
        tensor written after the update)."""
        table = self._tables[name]
        idx, g = self._prep(table, indices, grads)
        with self._table_mu[name]:
            self._push_locked(name, table, idx, g, handle)
            token = self._stores[name][:1, :1].clone()
        self._observe("push", table, int(idx.shape[1]))
        return token

    def pull(self, name: str, indices) -> torch.Tensor:
        """indices: [W, n] -> [W, n, d] rows, each worker receiving its own
        batch (a fresh tensor; zeros for out-of-range indices)."""
        table = self._tables[name]
        idx, _ = self._prep(table, indices)
        with self._table_mu[name]:
            out = sparse_rows.gather_rows(self._stores[name], idx,
                                          self.num_shards,
                                          table.rows_per_shard)
        self._observe("pull", table, int(idx.shape[1]))
        return out

    def _lock_tables(self, names):
        ordered = sorted(set(names))
        for n in ordered:
            self._table_mu[n].acquire()
        return ordered

    def _unlock_tables(self, ordered) -> None:
        for n in reversed(ordered):
            self._table_mu[n].release()

    def push_group(self, names, indices_list, grads_list,
                   handle: Optional[str] = None):
        """Push several tables in one call; same semantics per table as
        :meth:`push` (``handle`` applies to all).  In this slice each
        table still takes its own kernel launch."""
        log.check(len(names) == len(indices_list) == len(grads_list),
                  "group length mismatch")
        log.check(len(set(names)) == len(names), "duplicate table in group")
        tables = [self._tables[n] for n in names]
        prepped = [self._prep(t, i, g)
                   for t, i, g in zip(tables, indices_list, grads_list)]
        ordered = self._lock_tables(names)
        try:
            for n, t, (idx, g) in zip(names, tables, prepped):
                self._push_locked(n, t, idx, g, handle)
            token = self._stores[names[0]][:1, :1].clone()
        finally:
            self._unlock_tables(ordered)
        for t, (idx, _) in zip(tables, prepped):
            self._observe("push", t, int(idx.shape[1]))
        return token

    def pull_group(self, names, indices_list):
        """Pull several tables in one call; returns the list of
        ``[W, n_i, d_i]`` tensors in ``names`` order."""
        log.check(len(names) == len(indices_list), "group length mismatch")
        tables = [self._tables[n] for n in names]
        idxs = [self._prep(t, i)[0] for t, i in zip(tables, indices_list)]
        ordered = self._lock_tables(names)
        try:
            outs = [sparse_rows.gather_rows(self._stores[n], idx,
                                            self.num_shards,
                                            t.rows_per_shard)
                    for n, t, idx in zip(names, tables, idxs)]
        finally:
            self._unlock_tables(ordered)
        for t, idx in zip(tables, idxs):
            self._observe("pull", t, int(idx.shape[1]))
        return outs

    # -- state ---------------------------------------------------------------

    def ensure_acc(self, name: str) -> None:
        """Create the (zero) Adagrad accumulator of a registered table."""
        with self._table_mu[name]:
            self._ensure_acc(name, self._tables[name])

    def store_array(self, name: str) -> torch.Tensor:
        """A copy of the table in the shard-interleaved layout
        ``[rps*S, dim]`` (the JAX package's logical ``store_array``)."""
        with self._table_mu[name]:
            return self._stores[name].clone()

    def acc_array(self, name: str) -> torch.Tensor:
        """A copy of the Adagrad accumulator ``[rps*S]``, row-interleaved
        like the table."""
        with self._table_mu[name]:
            log.check(name in self._acc, f"no accumulator for {name!r}")
            return self._acc[name].clone()

    def store_global_device(self, name: str) -> torch.Tensor:
        """The table in GLOBAL row order ``[num_rows, dim]`` (a fresh
        tensor on the device)."""
        with self._table_mu[name]:
            t = self._tables[name]
            return _deinterleave_device(self._stores[name], t.num_rows,
                                        t.rows_per_shard, self.num_shards)

    def acc_global_device(self, name: str) -> torch.Tensor:
        """The accumulator in global row order ``[num_rows]``."""
        with self._table_mu[name]:
            t = self._tables[name]
            log.check(name in self._acc, f"no accumulator for {name!r}")
            return _deinterleave_device(self._acc[name], t.num_rows,
                                        t.rows_per_shard, self.num_shards)

    def _restore(self, name: str, value, global_rows: bool, inner: tuple,
                 dtype: torch.dtype) -> torch.Tensor:
        """``value`` as a fresh store-layout tensor: global rows
        ``[num_rows, *inner]`` are interleaved, interleaved values must be
        ``[rps*S, *inner]``."""
        log.check(name in self._tables, f"table {name!r} not registered")
        t = self._tables[name]
        S, rps = self.num_shards, t.rows_per_shard
        v = to_tensor(value, dtype, self.device)
        if global_rows:
            log.check_eq(tuple(v.shape), (t.num_rows,) + inner,
                         "bad global-rows restore shape")
            return _interleave_device(v, t.num_rows, rps, S)
        log.check_eq(tuple(v.shape), (rps * S,) + inner, "bad restore shape")
        return v.clone().contiguous()

    def set_store_array(self, name: str, value,
                        global_rows: bool = False) -> None:
        """Restore a table (checkpoint resume).  ``global_rows=True``
        takes the fleet-size-portable global row order ``[num_rows,
        dim]`` and interleaves it for this engine's shard count; otherwise
        the value is in the layout ``store_array`` gives."""
        t = self._tables[name]
        store = self._restore(name, value, global_rows, (t.dim,), t.dtype)
        with self._table_mu[name]:
            self._stores[name] = store

    def set_acc_array(self, name: str, value,
                      global_rows: bool = False) -> None:
        """Restore the Adagrad accumulator (``[num_rows]`` with
        ``global_rows``, else ``[rps*S]``)."""
        acc = self._restore(name, value, global_rows, (), torch.float32)
        with self._table_mu[name]:
            self._acc[name] = acc

    def block(self, name: Optional[str] = None) -> None:
        """Wait for outstanding device work without copying a table."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- not in this slice ----------------------------------------------------

    def reshard(self, group, axis_name: Optional[str] = None) -> None:
        raise NotImplementedError(
            f"SparseEngine.reshard is {_NOT_PORTED} (ROADMAP Queue 1 item 7)")

    def reshard_staged(self, group, axis_name: Optional[str] = None):
        raise NotImplementedError(
            f"SparseEngine.reshard_staged is {_NOT_PORTED} (ROADMAP Queue 1 "
            f"item 7)")

    def store_raw(self, name: str):
        raise NotImplementedError(
            f"store_raw serves orbax checkpoints, which pslite_tpu_torch "
            f"does not read; use store_array (ROADMAP Queue 1 item 5)")

    def store_spec(self, name: str):
        raise NotImplementedError(
            f"store_spec serves orbax checkpoints, which pslite_tpu_torch "
            f"does not read; use store_array (ROADMAP Queue 1 item 5)")
