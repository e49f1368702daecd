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

``reshard``/``reshard_staged`` recut the live tables (and accumulators)
for another group's shard count.

A group spanning worker processes (``distributed.global_group``; the
JAX engine on a ``PS_ICI_MULTIHOST=1`` mesh) holds in each process the
rows of its own ranks' shards, ``[L*rps, dim]`` for its L ranks, and
takes that process's input rows (``[L, n]`` indices, ``[L, n, d]``
grads), one per rank.  On an N-D group the table shards over the kv axis
and is replicated over the others, as JAX's ``P(axis, None)`` specs
place it (``placement.shard_replicas``): rank r holds shard s(r) of its
replica g(r), and the S ranks of a replica push to and pull from that
replica's table, in shard order.  A push gathers every process's
(indices, grads) in global rank order and each process runs S1/S2 over
the rows it owns (the rows of other processes and other replicas masked
out of range), so duplicates add in the single-process order; a pull
gathers the indices, runs S3 on the owned rows and sends each process
its rows back.  On the card the inputs travel through a
:class:`~pslite_tpu_torch.parallel.peers.PeerSlab` every peer maps, with
a host barrier after the writes and after the reads; on a CPU group
through gloo.  ``store_array``/``acc_array`` and recuts gather the
whole table with ``peers.gather_global`` (device to device on the card,
``placement.to_host_global`` on a CPU group).

Not in this slice: ``store_raw``/``store_spec`` (they serve only orbax
checkpoints, which the port does not read).
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..ops import sparse_rows
from ..utils import logging as log
from . import distributed, placement
from .engine import to_tensor, torch_dtype
from .mesh import DeviceGroup, default_group
from .peers import PeerSlab, Retired, align, gather_global


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


def _rows_per_shard(num_rows: int, shards: int, pack: int) -> int:
    """Rows per shard, rounded up to the JAX package's packing factor
    (see :attr:`SparseTable.pack`)."""
    rps = -(-num_rows // shards)
    return -(-rps // pack) * pack


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


def _interleave_padded(arr: torch.Tensor, rps: int, S: int) -> torch.Tensor:
    """A fresh tensor of global rows zero-padded to ``[rps*S, ...]`` ->
    the store layout (a copy, or ``arr`` itself when S or rps is 1)."""
    inner = tuple(arr.shape[1:])
    return arr.reshape((rps, S) + inner).transpose(0, 1).reshape(arr.shape)


def _interleave_device(glob: torch.Tensor, num_rows: int, rps: int,
                       S: int) -> torch.Tensor:
    """:func:`_interleave_rows` on the device: global rows ``[num_rows]``
    or ``[num_rows, dim]`` -> the store layout (a fresh tensor)."""
    arr = torch.zeros((rps * S,) + tuple(glob.shape[1:]), dtype=glob.dtype,
                      device=glob.device)
    arr[:num_rows] = glob
    return _interleave_padded(arr, rps, S)


def _deinterleave_device(inter: torch.Tensor, num_rows: int, rps: int,
                         S: int) -> torch.Tensor:
    """:func:`_deinterleave_rows` on the device (a fresh tensor)."""
    inner = tuple(inter.shape[1:])
    out = inter.reshape((S, rps) + inner).transpose(0, 1).reshape(
        (rps * S,) + inner)[:num_rows]
    # The reshape copies unless S or rps is 1, when it is a view.
    return out.clone() if out.data_ptr() == inter.data_ptr() else out


class SparseEngine:
    """Sparse tables on the ranks of one device group (the ``kv`` axis:
    W workers = S shards, the colocated layout)."""

    def __init__(self, group: Optional[DeviceGroup] = None,
                 axis_name: str = "kv", profiler=None):
        self.group = group if group is not None else default_group(axis_name)
        log.check(axis_name in self.group.axis_names,
                  f"axis {axis_name!r} not in the device group")
        self.axis = axis_name
        self.device = self.group.device
        self.num_shards = int(self.group.shape[axis_name])
        self._mp = self.group.is_multiprocess
        # Across processes on the card: the inputs' exchange memory.
        self._xslab: Optional[PeerSlab] = None
        self._retired = Retired()
        # Application-payload bytes (the van's send/recv counters).
        self.push_bytes = 0
        self.pull_bytes = 0
        self._counter_mu = threading.Lock()
        # The van's event Profiler (ENABLE_PROFILING).
        self.profiler = profiler
        self._tables: Dict[str, SparseTable] = {}
        self._stores: Dict[str, torch.Tensor] = {}
        # Row-wise Adagrad accumulators ([rps*S] f32, the table's row
        # layout), created lazily by push(handle="row_adagrad:...").
        self._acc: Dict[str, torch.Tensor] = {}
        self._mu = threading.Lock()
        # Per-table locks: push updates the store in place, so one
        # table's ops must not interleave.
        self._table_mu: Dict[str, threading.Lock] = {}

    def _local_shards(self, group=None, axis=None) -> list:
        """The shard each of this process's ranks holds on ``group``'s
        ``axis`` (this engine's by default), in rank order (on a
        single-process group every shard once)."""
        group, axis = group or self.group, axis or self.axis
        if not group.is_multiprocess:
            return list(range(int(group.shape[axis])))
        shard, _ = placement.shard_replicas(group, (axis,))
        return [int(shard[r]) for r in group.local_ranks]

    def _local_of(self, table: SparseTable, inter: torch.Tensor,
                  group=None, axis=None) -> torch.Tensor:
        """This process's rows of a whole table-layout value ``[rps*S,
        ...]``: its ranks' shards back to back (the value itself, or a
        contiguous slice of it, on a 1-D group)."""
        rps = table.rows_per_shard
        shards = self._local_shards(group, axis)
        if shards == list(range(shards[0], shards[0] + len(shards))):
            return inter[shards[0] * rps:(shards[-1] + 1) * rps]
        return torch.cat([inter[s * rps:(s + 1) * rps] for s in shards])

    def _replicas(self):
        """``(replica of each rank, local position of each (replica,
        shard) or -1, owner process of each (replica, shard))``, the two
        tables ``[G, S]`` int64 on the device."""
        g = self.group
        shard, replica = placement.shard_replicas(g, (self.axis,))
        G, S = int(replica.max()) + 1, self.num_shards
        pos = np.full((G, S), -1, dtype=np.int64)
        owner = np.zeros((G, S), dtype=np.int64)
        for r in range(g.num_ranks):
            owner[replica[r], shard[r]] = g.process_of(r)
        for j, r in enumerate(g.local_ranks):
            pos[replica[r], shard[r]] = j
        dev = self.device
        return (torch.as_tensor(replica, device=dev),
                torch.as_tensor(pos, device=dev),
                torch.as_tensor(owner, device=dev))

    # -- across processes -----------------------------------------------------

    def _share(self, parts, per_rank: bool = True):
        """Every process's ``parts`` (a collective), in process order: a
        list per process of tensors shaped like ``parts``, whose leading
        dim is that process's rank count when ``per_rank``.  On the card
        they are views of the processes' exchange slabs, valid until
        :meth:`_release`; on a CPU group copies through gloo."""
        parts = [p.contiguous() for p in parts]
        g = self.group
        if self.device.type != "cuda":
            return [[torch.as_tensor(x) for x in got]
                    for got in distributed.allgather_object(parts)]

        def shapes(proc):
            lead = len(g.ranks_of(proc))
            return [((lead,) + tuple(p.shape[1:])) if per_rank
                    else tuple(p.shape) for p in parts]

        def need(proc):
            return sum(align(int(np.prod(sh)) * p.element_size())
                       for sh, p in zip(shapes(proc), parts))

        slab = self._xslab
        if slab is None or any(need(p) > slab.sizes[p] for p in g.processes):
            # Every process takes the same decision: the shapes are known
            # everywhere (SPMD lockstep), so all of them reallocate.
            self._retired.retire(slab)
            slab = self._xslab = PeerSlab(g, 2 * need(g.process_index))
        off = 0
        for p in parts:
            slab.view(slab.me, off, tuple(p.shape), p.dtype).copy_(p)
            off += align(p.numel() * p.element_size())
        self._release()
        out = []
        for proc in g.processes:
            views, off = [], 0
            for sh, p in zip(shapes(proc), parts):
                views.append(slab.view(proc, off, sh, p.dtype))
                off += align(int(np.prod(sh)) * p.element_size())
            out.append(views)
        return out

    def _release(self) -> None:
        """Sync and a host barrier: every process's reads of the slabs
        are done (on the card; nothing to wait for on a CPU group)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self._retired.barrier()

    def _owned_indices(self, table: SparseTable, idx: torch.Tensor):
        """Every rank's global rows ``[R, n]`` -> this process's local
        table of L shards: row r of rank q is owned here when the rank of
        q's replica holding shard ``r % S`` is this process's j-th rank,
        and is then ``(r // S) * L + j``, which the row kernels place at
        its flat row here; others become -1 (out of range: dropped by a
        push, zeros in a pull)."""
        S, L = self.num_shards, len(self.group.local_ranks)
        replica, pos, _ = self._replicas()
        i = idx.to(torch.int64)
        local = torch.div(i, S, rounding_mode="floor")
        j = pos[replica[:, None].expand_as(i), torch.remainder(i, S)]
        owned = (i >= 0) & (local < table.rows_per_shard) & (j >= 0)
        return torch.where(owned, local * L + j, -1).to(torch.int32)

    def _mp_push(self, name: str, table: SparseTable, idx, g,
                 handle: Optional[str]) -> None:
        got = self._share([idx, g])
        idx_all = torch.cat([p[0] for p in got])
        g_all = torch.cat([p[1] for p in got])
        self._release()
        self._push_locked(name, table, self._owned_indices(table, idx_all),
                          g_all, handle, len(self.group.local_ranks))

    def _mp_pull(self, name: str, table: SparseTable, idx) -> torch.Tensor:
        got = self._share([idx])
        idx_all = torch.cat([p[0] for p in got])
        self._release()
        partial = sparse_rows.gather_rows(
            self._stores[name], self._owned_indices(table, idx_all),
            len(self.group.local_ranks), table.rows_per_shard)
        ranks = self.group.local_ranks
        mine = slice(ranks[0], ranks[-1] + 1)
        # The owner process of each of this process's indices: the one of
        # the rank of its replica holding the index's shard.
        S = self.num_shards
        replica, _, owners = self._replicas()
        i = idx.to(torch.int64)
        inr = (i >= 0) & (torch.div(i, S, rounding_mode="floor")
                          < table.rows_per_shard)
        owner = torch.where(inr, owners[replica[mine, None].expand_as(i),
                                        torch.remainder(i, S)], -1)
        out = torch.zeros(tuple(idx.shape) + (table.dim,), dtype=table.dtype,
                          device=self.device)
        for proc, (part,) in zip(self.group.processes,
                                 self._share([partial], per_rank=False)):
            out = torch.where((owner == proc)[..., None], part[mine], out)
        self._release()
        return out

    def close(self) -> None:
        """Release the exchange memory of a group spanning processes (a
        collective: every process closes its engine)."""
        slab, self._xslab = self._xslab, None
        if slab is None:
            return
        slab.close_peers()
        self._retired.barrier()
        slab.free()

    # -- registration --------------------------------------------------------

    def register_sparse(self, name: str, num_rows: int, dim: int, dtype=None,
                        init=None) -> SparseTable:
        """Register a table of ``num_rows`` x ``dim`` and allocate its
        store (zeros, or ``init`` in global row order)."""
        dt = torch_dtype(dtype)
        log.check(dt in (torch.float32, torch.bfloat16),
                  f"sparse tables take float32 or bfloat16, got {dt}")
        pack = 128 // dim if (dim < 128 and 128 % dim == 0) else 1
        rps = _rows_per_shard(num_rows, self.num_shards, pack)
        table = SparseTable(name, num_rows, dim, rps, dt, pack=pack)
        S = self.num_shards
        if init is not None:
            store = self._local_of(table, _interleave_device(
                to_tensor(init, dt, self.device).reshape(num_rows, dim),
                num_rows, rps, S)).clone()
        else:
            store = torch.zeros((len(self._local_shards()) * rps, dim),
                                dtype=dt, device=self.device)
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
        if self._mp:
            log.check_eq(int(idx.shape[0]), len(self.group.local_ranks),
                         "bad local worker dim (rows = this process's "
                         "devices on a multi-process mesh)")
        else:
            log.check_eq(int(idx.shape[0]), self.num_shards, "bad worker dim")
        if grads is None:
            return idx, None
        g = to_tensor(grads, table.dtype, self.device).contiguous()
        log.check_eq(tuple(g.shape), tuple(idx.shape) + (table.dim,),
                     "bad grads shape")
        return idx, g

    def _observe(self, name: str, op: str, table: SparseTable, batch: int,
                 t0: float) -> None:
        """Byte counters, and the ``sparse_<op>`` profiler event
        (dispatch latency, as the dense engine's)."""
        payload = self.num_shards * batch * table.dim * table.dtype.itemsize
        with self._counter_mu:
            if op == "push":
                self.push_bytes += payload
            else:
                self.pull_bytes += payload
        if self.profiler is not None and getattr(self.profiler, "enabled",
                                                 False):
            dur_us = int((time.perf_counter() - t0) * 1e6)
            self.profiler.record_engine(name, f"sparse_{op}", payload,
                                        dur_us)

    def _ensure_acc(self, name: str, table: SparseTable) -> None:
        if name not in self._acc:
            self._acc[name] = torch.zeros(
                len(self._local_shards()) * table.rows_per_shard,
                dtype=torch.float32, device=self.device)

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
                     handle: Optional[str],
                     shards: Optional[int] = None) -> None:
        """One table's push; call with its lock held.  ``shards``: the
        shards of the local table the indices address (all of them on a
        single-process group)."""
        S, rps = shards or self.num_shards, table.rows_per_shard
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
        t0 = time.perf_counter()
        table = self._tables[name]
        idx, g = self._prep(table, indices, grads)
        with self._table_mu[name]:
            if self._mp:
                self._mp_push(name, table, idx, g, handle)
            else:
                self._push_locked(name, table, idx, g, handle)
            token = self._stores[name][:1, :1].clone()
        self._observe(name, "push", table, int(idx.shape[1]), t0)
        return token

    def pull(self, name: str, indices) -> torch.Tensor:
        """indices: [W, n] -> [W, n, d] rows, each worker receiving its own
        batch (a fresh tensor; zeros for out-of-range indices)."""
        t0 = time.perf_counter()
        table = self._tables[name]
        idx, _ = self._prep(table, indices)
        with self._table_mu[name]:
            if self._mp:
                out = self._mp_pull(name, table, idx)
            else:
                out = sparse_rows.gather_rows(self._stores[name], idx,
                                              self.num_shards,
                                              table.rows_per_shard)
        self._observe(name, "pull", table, int(idx.shape[1]), t0)
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
        t0 = time.perf_counter()
        log.check(len(names) == len(indices_list) == len(grads_list),
                  "group length mismatch")
        log.check(len(set(names)) == len(names), "duplicate table in group")
        if self._mp:  # one collective push per table, in the order given
            tokens = [self.push(n, i, g, handle=handle) for n, i, g in
                      zip(names, indices_list, grads_list)]
            return tokens[0]
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
        for i, (n, t, (idx, _)) in enumerate(zip(names, tables, prepped)):
            self._observe(n, "push", t, int(idx.shape[1]),
                          t0 if i == 0 else time.perf_counter())
        return token

    def pull_group(self, names, indices_list):
        """Pull several tables in one call; returns the list of
        ``[W, n_i, d_i]`` tensors in ``names`` order."""
        t0 = time.perf_counter()
        log.check(len(names) == len(indices_list), "group length mismatch")
        if self._mp:  # one collective pull per table, in the order given
            return [self.pull(n, i) for n, i in zip(names, indices_list)]
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
        for i, (n, t, idx) in enumerate(zip(names, tables, idxs)):
            self._observe(n, "pull", t, int(idx.shape[1]),
                          t0 if i == 0 else time.perf_counter())
        return outs

    # -- state ---------------------------------------------------------------

    def ensure_acc(self, name: str) -> None:
        """Create the (zero) Adagrad accumulator of a registered table."""
        with self._table_mu[name]:
            self._ensure_acc(name, self._tables[name])

    def _whole(self, t: torch.Tensor) -> torch.Tensor:
        """The whole table-layout value of a local one: itself (a copy),
        or across processes the collective ``peers.gather_global`` (every
        rank's shard, in rank order), read as this process's replica."""
        if not self._mp:
            return t.clone()
        joined = gather_global(t, self.group)
        per = t.shape[0] // len(self.group.local_ranks)
        shard, replica = placement.shard_replicas(self.group, (self.axis,))
        mine = replica[self.group.local_ranks[0]]
        ranks = [int(np.flatnonzero((shard == s) & (replica == mine))[0])
                 for s in range(self.num_shards)]
        if ranks == list(range(self.num_shards)):
            return joined
        return torch.cat([joined[r * per:(r + 1) * per] for r in ranks])

    def store_array(self, name: str) -> torch.Tensor:
        """A copy of the table in the shard-interleaved layout
        ``[rps*S, dim]`` (the JAX package's logical ``store_array``);
        across processes a collective."""
        with self._table_mu[name]:
            return self._whole(self._stores[name])

    def acc_array(self, name: str) -> torch.Tensor:
        """A copy of the Adagrad accumulator ``[rps*S]``, row-interleaved
        like the table; across processes a collective."""
        with self._table_mu[name]:
            log.check(name in self._acc, f"no accumulator for {name!r}")
            return self._whole(self._acc[name])

    def store_global_device(self, name: str) -> torch.Tensor:
        """The table in GLOBAL row order ``[num_rows, dim]`` (a fresh
        tensor on the device)."""
        with self._table_mu[name]:
            t = self._tables[name]
            whole = (self._whole(self._stores[name]) if self._mp
                     else self._stores[name])
            return _deinterleave_device(whole, t.num_rows,
                                        t.rows_per_shard, self.num_shards)

    def acc_global_device(self, name: str) -> torch.Tensor:
        """The accumulator in global row order ``[num_rows]``."""
        with self._table_mu[name]:
            t = self._tables[name]
            log.check(name in self._acc, f"no accumulator for {name!r}")
            whole = (self._whole(self._acc[name]) if self._mp
                     else self._acc[name])
            return _deinterleave_device(whole, t.num_rows,
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
            return self._local_of(t, _interleave_device(
                v, t.num_rows, rps, S)).clone()
        log.check_eq(tuple(v.shape), (rps * S,) + inner, "bad restore shape")
        return self._local_of(t, v).clone().contiguous()

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

    # -- elastic tier ------------------------------------------------------------

    def reshard(self, group: DeviceGroup, axis_name: Optional[str] = None
                ) -> None:
        """Re-lay every registered table onto a new device group: the
        sparse half of the elastic tier (JAX ``SparseEngine.reshard``).
        Rows go to global order, the row-to-shard mapping is recut for
        the new shard count (global row r on shard ``r % S``),
        ``rows_per_shard`` is recomputed with the lane-packing rounding,
        and the Adagrad accumulator moves with its table.  See
        :meth:`reshard_staged`."""
        with self.reshard_staged(group, axis_name) as commit:
            commit()

    @contextlib.contextmanager
    def reshard_staged(self, group: DeviceGroup,
                       axis_name: Optional[str] = None):
        """Stage a table recut and yield its commit closure, with the
        contract of ``CollectiveEngine.reshard_staged``: everything that
        can fail runs on entry with every table lock held (sorted order),
        each new table and accumulator built through
        :func:`placement.place`; ``commit()`` assigns only."""
        axis = axis_name or self.axis
        log.check(axis in group.axis_names,
                  f"axis {axis!r} not in the new device group")
        new_shards = int(group.shape[axis])
        dev = group.device
        new_mp = group.is_multiprocess
        with self._mu:
            ordered = sorted(self._tables)
        for n in ordered:
            self._table_mu[n].acquire()
        try:
            S = self.num_shards
            staged = {}
            for n in ordered:
                t = self._tables[n]
                rps = _rows_per_shard(t.num_rows, new_shards, t.pack)

                def recut(inter, t=t, rps=rps):
                    # Global order, zero-padded for the new shard count on
                    # the new device, then interleaved: three copies.
                    # Across processes the old value is gathered first, and
                    # each process keeps its new shards' rows.
                    whole = (gather_global(inter, self.group).to(dev)
                             if self._mp else inter)
                    new = _interleave_padded(placement.place(
                        _deinterleave_device(whole, t.num_rows,
                                             t.rows_per_shard, S),
                        dev, rps * new_shards), rps, new_shards)
                    if not new_mp:
                        return new
                    return placement.place(self._local_of(
                        SparseTable(n, t.num_rows, t.dim, rps, t.dtype),
                        new, group, axis), dev)

                staged[n] = (
                    SparseTable(n, t.num_rows, t.dim, rps, t.dtype,
                                pack=t.pack),
                    recut(self._stores[n]),
                    recut(self._acc[n]) if n in self._acc else None,
                )

            def commit() -> None:
                self.group = group
                self.axis = axis
                self.device = dev
                self.num_shards = new_shards
                self._mp = new_mp
                self._retired.retire(self._xslab)
                self._xslab = None
                for n in ordered:
                    table, store, acc = staged[n]
                    self._tables[n] = table
                    self._stores[n] = store
                    if acc is not None:
                        self._acc[n] = acc

            yield commit
        finally:
            for n in reversed(ordered):
                self._table_mu[n].release()

    # -- orbax (not read by this package) ---------------------------------------

    def store_raw(self, name: str):
        raise NotImplementedError(
            "store_raw serves orbax checkpoints, which pslite_tpu_torch "
            "does not read; use store_array")

    def store_spec(self, name: str):
        raise NotImplementedError(
            "store_spec serves orbax checkpoints, which pslite_tpu_torch "
            "does not read; use store_array")
