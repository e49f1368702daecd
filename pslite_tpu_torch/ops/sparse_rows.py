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

On a CPU tensor each function runs its plain PyTorch version
(``*_reference``), which writes the order out (rounds of ``index_add_``
by occurrence rank: no row appears twice in a round); on a CUDA tensor it
launches the kernel, or raises.  ``launches`` counts kernel launches per
function, and nothing else.  The push functions update the store (and
accumulator) IN PLACE, where the JAX programs donate them.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..utils import logging as log
from . import _native

launches: Dict[str, int] = {
    "sparse_scatter_add": 0, "sparse_row_adagrad": 0,
    "sparse_gather_rows": 0,
}

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
    contiguous on one device.  True when they live on a CUDA device."""
    log.check(store.dim() == 2, "the store is [rows, dim]")
    log.check(store.dtype in _DTYPE_CODES,
              f"sparse tables take float32 or bfloat16, got {store.dtype}")
    log.check(indices.dtype == torch.int32, "indices must be int32")
    operands = [store, indices]
    if rows is not None:
        log.check(rows.dtype == store.dtype, "rows and store dtypes differ")
        log.check(tuple(rows.shape) == tuple(indices.shape) + (store.shape[1],),
                  f"rows {tuple(rows.shape)} do not match indices "
                  f"{tuple(indices.shape)} x dim {store.shape[1]}")
        operands.append(rows)
    if acc is not None:
        log.check(acc.dtype == torch.float32, "the accumulator is float32")
        log.check(tuple(acc.shape) == (store.shape[0],),
                  "one accumulator value per store row")
        operands.append(acc)
    for t in operands:
        log.check(t.device == store.device, "operands on different devices")
        log.check(t.is_contiguous(), "operands must be contiguous")
    log.check(store.shape[0] < 2 ** 31 - 1 and indices.numel() < 2 ** 31,
              "more rows or updates than int32 indexes")
    if store.device.type == "cuda":
        return True
    log.check(store.device.type == "cpu", f"unsupported device {store.device}")
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
