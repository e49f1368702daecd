"""Row kernels of the sparse tables: scatter-add, row-wise Adagrad, gather.

Counterparts of the device programs of ``pslite_tpu/parallel/sparse.py``:
``_scatter_rows`` (:137, the sum-handle push), ``_adagrad_sparse`` (:179,
the ``row_adagrad`` push) and ``_pull_rows`` (:246, the pull).  They are
XLA programs in a ``shard_map`` there, not Pallas kernels; here each is a
CUDA kernel in ``csrc/sparse_rows.cu``, whose header says what bounds
them and how.

Layout.  A table is one contiguous ``[rows_per_shard * S, dim]`` tensor:
virtual shard ``s`` owns the flat rows ``[s*rps, (s+1)*rps)``, and global
row ``r`` lives at flat row ``(r % S) * rps + r // S``.  Updates arrive
as the all-gathered list of every worker's indices ``[W, n]`` (int32)
and rows ``[W, n, dim]``, flattened to ``m = W*n`` entries in worker
order: the order of the JAX package's ``all_gather``.

Out-of-range indices.  An index ``i`` is taken only if ``0 <= i`` and
``i // S < rows_per_shard``; otherwise a push drops its update and a pull
returns zeros.  (The JAX package's behaviour there depends on clamped
gathers and the lane packing, so it is no contract to copy.)

Order of arithmetic, which decides the bits:

- sum push: for each touched row, ``store[r] = ((store[r] + u_a) + u_b)
  + ...`` over that row's updates in list order, rounding to the table's
  dtype after each add.  XLA's CPU scatter adds in exactly that order, so
  f32 and bf16 tables equal the JAX package bit for bit.
- ``row_adagrad``: per touched row, ``G`` is the in-order sum of its
  updates from zero (in the table's dtype, as ``zeros.at[seg].add`` over
  a stable argsort); then, in f32, ``g2 = sum(G*G) / dim`` (the kernel
  sums the squares in a fixed tree order, XLA in its own: the one
  source of difference, hence rtol 1e-5 / atol 1e-6 against JAX),
  ``acc[r] += g2`` and ``store[r] += -(lr*G / (sqrt(acc[r]) + eps))``,
  the step rounded to the table's dtype before the add.
- pull: a copy of the owned row, or zeros: exact.

Groups.  ``scatter_add_group``, ``row_adagrad_group`` and
``gather_rows_group`` run the same functions over several tables at
once, the counterpart of ``_sparse_group_program`` (:670, one XLA program
over the k tables of ``push_group``/``pull_group``): a group push is three
launches per dtype present (the sorts, the long runs, the short runs),
whatever k is, and a group pull one.  The tables are disjoint, so each
table's bits are those of its own push or pull.

On a CPU tensor each function runs its plain PyTorch version
(``*_reference``), which writes the order out (rounds of ``index_add_``
by occurrence rank: no row appears twice in a round); on a CUDA tensor it
launches the kernel, or raises.  ``launches`` counts kernel launches per
function, and nothing else: one per push (three kernels) or pull of one
table, and for a group every kernel launched (three per push chain, one
per pull).  The push functions update the store (and accumulator) IN
PLACE, where the JAX programs donate them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..utils import logging as log
from . import _native

launches: Dict[str, int] = {
    "sparse_scatter_add": 0, "sparse_row_adagrad": 0,
    "sparse_gather_rows": 0, "sparse_scatter_add_group": 0,
    "sparse_row_adagrad_group": 0, "sparse_gather_rows_group": 0,
}

# Tables of one group launch: the kernels take them by value
# (csrc/sparse_rows.cu kMaxTables); a longer group takes a chain per 48.
MAX_GROUP = 48

# Widest row of a row-wise Adagrad push on the card: its long-run kernel
# keeps the row's summed gradient in 48 KB of shared memory beside its
# ring (the sum push and the pull take any width).
MAX_ADAGRAD_DIM = 12_288

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _on_cuda(store, indices, rows=None, acc=None) -> bool:
    """Validate the operands: a contiguous 2-D store of f32 or bf16,
    int32 indices, ``rows`` ``[*indices.shape, dim]`` of the store's
    dtype and an f32 accumulator of one value per store row, all
    contiguous on one device.  True when they live on a CUDA device.
    (Each message is built only on a failure: a group validates every
    table on each call.)"""
    if store.dim() != 2:
        log.check(False, "the store is [rows, dim]")
    if store.dtype not in _DTYPE_CODES:
        log.check(False, f"sparse tables take float32 or bfloat16, got "
                         f"{store.dtype}")
    if indices.dtype != torch.int32:
        log.check(False, "indices must be int32")
    operands = [store, indices]
    if rows is not None:
        if rows.dtype != store.dtype:
            log.check(False, "rows and store dtypes differ")
        if tuple(rows.shape) != tuple(indices.shape) + (store.shape[1],):
            log.check(False, f"rows {tuple(rows.shape)} do not match "
                             f"indices {tuple(indices.shape)} x dim "
                             f"{store.shape[1]}")
        operands.append(rows)
    if acc is not None:
        if acc.dtype != torch.float32:
            log.check(False, "the accumulator is float32")
        if tuple(acc.shape) != (store.shape[0],):
            log.check(False, "one accumulator value per store row")
        operands.append(acc)
    dev = store.device
    for t in operands:
        if t.device != dev:
            log.check(False, "operands on different devices")
        if not t.is_contiguous():
            log.check(False, "operands must be contiguous")
    if not (store.shape[0] < 2 ** 31 - 1 and indices.numel() < 2 ** 31):
        log.check(False, "more rows or updates than int32 indexes")
    if dev.type == "cuda":
        return True
    if dev.type != "cpu":
        log.check(False, f"unsupported device {dev}")
    return False


def _check_layout(store, num_shards: int, rows_per_shard: int) -> None:
    log.check(num_shards >= 1 and rows_per_shard >= 1, "bad table layout")
    log.check_eq(int(store.shape[0]), num_shards * rows_per_shard,
                 "store rows != num_shards * rows_per_shard")


# -- plain versions ------------------------------------------------------------

def target_rows(indices, num_shards: int, rows_per_shard: int):
    """The flat store row of each index (int64, the shape of
    ``indices``), or -1 where the index is out of range."""
    i = indices.to(torch.int64)
    local = torch.div(i, num_shards, rounding_mode="floor")
    flat = torch.remainder(i, num_shards) * rows_per_shard + local
    return torch.where((i >= 0) & (local < rows_per_shard), flat, -1)


def _runs(indices, num_shards: int, rows_per_shard: int):
    """The in-range updates grouped by target row, in list order within
    each row: (positions in the list, their target rows, occurrence rank
    of each within its row, run id of each, the distinct rows)."""
    t = target_rows(indices.reshape(-1), num_shards, rows_per_shard)
    pos = torch.nonzero(t >= 0).reshape(-1)
    t = t[pos]
    order = torch.sort(t, stable=True).indices
    pos, t = pos[order], t[order]
    k = t.numel()
    head = torch.ones(k, dtype=torch.bool, device=t.device)
    head[1:] = t[1:] != t[:-1]
    ar = torch.arange(k, device=t.device)
    start = torch.cummax(torch.where(head, ar, 0), 0).values
    run = torch.cumsum(head.to(torch.int64), 0) - 1
    return pos, t, ar - start, run, t[head]


def _rounds(rank):
    """The masks of the occurrence ranks, round k first."""
    n = int(rank.max()) + 1 if rank.numel() else 0
    for k in range(n):
        yield rank == k


def scatter_add_reference(store, indices, rows, num_shards: int,
                          rows_per_shard: int):
    """Sum push, in place: each in-range update added to its row, the
    updates of one row in list order (round k adds every row's k-th
    update; a round holds each row once, so ``index_add_`` adds no two
    values to one element)."""
    _check_layout(store, num_shards, rows_per_shard)
    pos, t, rank, _, _ = _runs(indices, num_shards, rows_per_shard)
    flat = rows.reshape(-1, store.shape[1])
    for sel in _rounds(rank):
        store.index_add_(0, t[sel], flat[pos[sel]])
    return store


def row_adagrad_reference(store, acc, indices, rows, num_shards: int,
                          rows_per_shard: int, lr: float, eps: float):
    """Row-wise Adagrad push, in place (see the module docstring for the
    order of arithmetic)."""
    _check_layout(store, num_shards, rows_per_shard)
    pos, _, rank, run, touched = _runs(indices, num_shards, rows_per_shard)
    flat = rows.reshape(-1, store.shape[1])
    G = torch.zeros((touched.numel(), store.shape[1]), dtype=store.dtype,
                    device=store.device)
    for sel in _rounds(rank):
        G.index_add_(0, run[sel], flat[pos[sel]])
    G = G.to(torch.float32)
    a = acc[touched] + (G * G).sum(1) / store.shape[1]
    acc[touched] = a
    step = (lr * G) / (torch.sqrt(a)[:, None] + eps)
    store[touched] = store[touched] + (-step).to(store.dtype)
    return store, acc


def gather_rows_reference(store, indices, num_shards: int,
                          rows_per_shard: int):
    """Pull: ``out[..., :] = store[flat row of index]``, zeros where the
    index is out of range; ``out`` is ``[*indices.shape, dim]``."""
    _check_layout(store, num_shards, rows_per_shard)
    t = target_rows(indices.reshape(-1), num_shards, rows_per_shard)
    got = store.index_select(0, t.clamp(min=0))
    out = torch.where((t >= 0)[:, None], got, torch.zeros_like(got))
    return out.reshape(*indices.shape, store.shape[1])


# -- kernels ---------------------------------------------------------------------

def _sorted_runs(indices, num_shards: int, rows_per_shard: int):
    """The sort of a push (``pstt_sparse_sort``, one cluster launch, no
    library sort): each update's flat target row (out of range: the
    sentinel ``S * rps``, which sorts last), sorted stably by a radix sort
    written for the card, and the run lists the push kernels walk.
    Returns the scratch they read (9m + 3 int32; its layout is the
    ``Work`` struct of ``csrc/sparse_rows.cu``)."""
    m = indices.numel()
    work = torch.empty(9 * m + 3, dtype=torch.int32, device=indices.device)
    _native.call("pstt_sparse_sort", indices.data_ptr(), work.data_ptr(), m,
                 num_shards, rows_per_shard,
                 _native.stream_ptr(indices.device))
    return work


def scatter_add(store, indices, rows, num_shards: int, rows_per_shard: int):
    """Sum push of ``rows`` ``[*indices.shape, dim]`` into ``store``, in
    place; the CUDA kernels on the card (the sort, then the long and short
    runs: three launches)."""
    if not _on_cuda(store, indices, rows):
        return scatter_add_reference(store, indices, rows, num_shards,
                                     rows_per_shard)
    _check_layout(store, num_shards, rows_per_shard)
    m, dim = indices.numel(), store.shape[1]
    if m == 0:
        return store
    work = _sorted_runs(indices, num_shards, rows_per_shard)
    _native.call("pstt_sparse_scatter_add", store.data_ptr(),
                 rows.data_ptr(), work.data_ptr(), m, dim,
                 _DTYPE_CODES[store.dtype], _native.stream_ptr(store.device))
    launches["sparse_scatter_add"] += 1
    return store


def row_adagrad(store, acc, indices, rows, num_shards: int,
                rows_per_shard: int, lr: float, eps: float):
    """Row-wise Adagrad push into ``store``/``acc``, in place; the CUDA
    kernels on the card.  ``lr`` and ``eps`` are kernel arguments, so every
    step of a schedule reuses one launch configuration."""
    if not _on_cuda(store, indices, rows, acc):
        return row_adagrad_reference(store, acc, indices, rows, num_shards,
                                     rows_per_shard, lr, eps)
    _check_layout(store, num_shards, rows_per_shard)
    m, dim = indices.numel(), store.shape[1]
    log.check(dim <= MAX_ADAGRAD_DIM,
              f"row_adagrad on the card takes dim <= {MAX_ADAGRAD_DIM}, "
              f"got {dim}")
    if m == 0:
        return store, acc
    work = _sorted_runs(indices, num_shards, rows_per_shard)
    _native.call("pstt_sparse_row_adagrad", store.data_ptr(),
                 acc.data_ptr(), rows.data_ptr(), work.data_ptr(), m, dim,
                 lr, eps, _DTYPE_CODES[store.dtype],
                 _native.stream_ptr(store.device))
    launches["sparse_row_adagrad"] += 1
    return store, acc


def gather_rows(store, indices, num_shards: int, rows_per_shard: int):
    """Pull: a fresh ``[*indices.shape, dim]`` tensor of the indexed rows
    (zeros out of range); the CUDA kernel on the card."""
    if not _on_cuda(store, indices):
        return gather_rows_reference(store, indices, num_shards,
                                     rows_per_shard)
    _check_layout(store, num_shards, rows_per_shard)
    out = torch.empty(tuple(indices.shape) + (store.shape[1],),
                      dtype=store.dtype, device=store.device)
    if indices.numel() == 0:
        return out
    _native.call("pstt_sparse_gather_rows", store.data_ptr(),
                 indices.data_ptr(), out.data_ptr(), indices.numel(),
                 store.shape[1] * store.element_size(), num_shards,
                 rows_per_shard, _native.stream_ptr(store.device))
    launches["sparse_gather_rows"] += 1
    return out


# -- groups ----------------------------------------------------------------------

def _group_args(stores, indices_list, rows_list=None, accs=None) -> bool:
    """Validate a group's operands table by table (as the single
    functions do), on one device, and for a push (``rows_list`` given) no
    store twice.  True on a CUDA device."""
    k = len(stores)
    log.check(len(indices_list) == k, "group length mismatch")
    log.check(rows_list is None or len(rows_list) == k,
              "group length mismatch")
    log.check(accs is None or len(accs) == k, "group length mismatch")
    cuda = [_on_cuda(stores[i], indices_list[i],
                     None if rows_list is None else rows_list[i],
                     None if accs is None else accs[i]) for i in range(k)]
    log.check(len({s.device for s in stores}) <= 1,
              "a group's tables on different devices")
    log.check(rows_list is None or len({s.data_ptr() for s in stores}) == k,
              "a store twice in one group push")
    return bool(cuda) and cuda[0]


def _chains(stores, indices_list):
    """The tables a group push launches, as chains of at most MAX_GROUP
    table positions of one dtype (tables without updates left out)."""
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, (s, ix) in enumerate(zip(stores, indices_list)):
        if ix.numel():
            by_dtype.setdefault(s.dtype, []).append(i)
    for dt, pos in by_dtype.items():
        for c in range(0, len(pos), MAX_GROUP):
            yield dt, pos[c:c + MAX_GROUP]


def _work_offsets(ms: Sequence[int]):
    """Each table's scratch offset (ints) in one allocation: a Work of its
    own m (9m + 3 ints), rounded to 4 ints so every table's entry buffers
    are 16-byte aligned; and the total."""
    offs, at = [], 0
    for m in ms:
        offs.append(at)
        at += (9 * m + 3 + 3) & ~3
    return offs, at


def _push_group(stores, accs, indices_list, rows_list, num_shards: int,
                rps_list, adagrad: bool, lr: float, eps: float,
                counter: str) -> None:
    dev = stores[0].device
    stream = _native.stream_ptr(dev)
    for dt, pos in _chains(stores, indices_list):
        ms = [indices_list[i].numel() for i in pos]
        offs, total = _work_offsets(ms)
        work = torch.empty(total, dtype=torch.int32, device=dev)
        base = work.data_ptr()
        table = np.array([[
            stores[i].data_ptr(), accs[i].data_ptr() if adagrad else 0,
            rows_list[i].data_ptr(), indices_list[i].data_ptr(),
            base + 4 * off, m, stores[i].shape[1], num_shards, rps_list[i]]
            for i, off, m in zip(pos, offs, ms)], dtype=np.int64)
        _native.call("pstt_sparse_sort_group", table.ctypes.data, len(pos),
                     stream)
        launches[counter] += 1
        _native.call("pstt_sparse_push_group", table.ctypes.data, len(pos),
                     _DTYPE_CODES[dt], int(adagrad), lr, eps, stream)
        launches[counter] += 2


def scatter_add_group_reference(stores, indices_list, rows_list,
                                num_shards: int, rps_list):
    """Plain version of :func:`scatter_add_group`: each table's plain sum
    push in turn."""
    for s, ix, r, rps in zip(stores, indices_list, rows_list, rps_list):
        scatter_add_reference(s, ix, r, num_shards, rps)
    return stores


def scatter_add_group(stores, indices_list, rows_list, num_shards: int,
                      rps_list):
    """Sum push of several tables (``rows_list[i]`` into ``stores[i]``, in
    place; ``num_shards`` shards of ``rps_list[i]`` rows each); on the
    card the sorts, long runs and short runs of every table of a dtype in
    three launches."""
    if not _group_args(stores, indices_list, rows_list):
        return scatter_add_group_reference(stores, indices_list, rows_list,
                                           num_shards, rps_list)
    for s, rps in zip(stores, rps_list):
        _check_layout(s, num_shards, rps)
    _push_group(stores, None, indices_list, rows_list, num_shards, rps_list,
                False, 0.0, 0.0, "sparse_scatter_add_group")
    return stores


def row_adagrad_group_reference(stores, accs, indices_list, rows_list,
                                num_shards: int, rps_list, lr: float,
                                eps: float):
    """Plain version of :func:`row_adagrad_group`: each table's plain
    row-wise Adagrad push in turn."""
    for s, a, ix, r, rps in zip(stores, accs, indices_list, rows_list,
                                rps_list):
        row_adagrad_reference(s, a, ix, r, num_shards, rps, lr, eps)
    return stores, accs


def row_adagrad_group(stores, accs, indices_list, rows_list, num_shards: int,
                      rps_list, lr: float, eps: float):
    """Row-wise Adagrad push of several tables, in place; on the card
    three launches per dtype.  Each table's dim is checked against
    ``MAX_ADAGRAD_DIM`` as a single push checks it."""
    if not _group_args(stores, indices_list, rows_list, accs):
        return row_adagrad_group_reference(stores, accs, indices_list,
                                           rows_list, num_shards, rps_list,
                                           lr, eps)
    for s, rps in zip(stores, rps_list):
        _check_layout(s, num_shards, rps)
        log.check(s.shape[1] <= MAX_ADAGRAD_DIM,
                  f"row_adagrad on the card takes dim <= {MAX_ADAGRAD_DIM}, "
                  f"got {s.shape[1]}")
    _push_group(stores, accs, indices_list, rows_list, num_shards, rps_list,
                True, lr, eps, "sparse_row_adagrad_group")
    return stores, accs


def gather_rows_group_reference(stores, indices_list, num_shards: int,
                                rps_list):
    """Plain version of :func:`gather_rows_group`: each table's plain
    pull."""
    return [gather_rows_reference(s, ix, num_shards, rps)
            for s, ix, rps in zip(stores, indices_list, rps_list)]


def gather_rows_group(stores, indices_list, num_shards: int, rps_list):
    """Pull of several tables: a fresh ``[*indices_list[i].shape, dim_i]``
    tensor per table; on the card one launch for every table (per
    ``MAX_GROUP`` tables)."""
    if not _group_args(stores, indices_list):
        return gather_rows_group_reference(stores, indices_list, num_shards,
                                           rps_list)
    outs = []
    for s, ix, rps in zip(stores, indices_list, rps_list):
        _check_layout(s, num_shards, rps)
        outs.append(torch.empty(tuple(ix.shape) + (s.shape[1],),
                                dtype=s.dtype, device=s.device))
    live = [i for i, ix in enumerate(indices_list) if ix.numel()]
    for c in range(0, len(live), MAX_GROUP):
        pos = live[c:c + MAX_GROUP]
        table = np.array([[
            stores[i].data_ptr(), indices_list[i].data_ptr(),
            outs[i].data_ptr(), indices_list[i].numel(),
            stores[i].shape[1] * stores[i].element_size(), num_shards,
            rps_list[i]] for i in pos], dtype=np.int64)
        _native.call("pstt_sparse_gather_group", table.ctypes.data, len(pos),
                     _native.stream_ptr(stores[0].device))
        launches["sparse_gather_rows_group"] += 1
    return outs
