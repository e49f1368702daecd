"""The dense engine's reduce programs: D1 and D2.

Counterparts of the XLA programs of ``pslite_tpu/parallel/engine.py`` that
run the dense data plane off the ring: ``_program`` (:408, the default
``xla`` impl, whose ``_rs_update_ag`` :97-109 reduces with ``_aggregate``
:84, applies the elementwise handle and all-gathers), its group form
``_group_program`` (:1333) and ``_stateful_program`` (:754, the reduction
fused with the K1/K2/K3 optimizer pass).  The CUDA kernels are
``csrc/reduce_update.cu``; its header says what bounds them (HBM bytes:
(W+3)*b per element for a push_pull, (W+7)*b for adam) and how.

- **D1** (:func:`reduce_apply`, :func:`reduce_group`,
  :func:`rank_order_sum`): the W worker rows added left to right in f32
  (``rows[0] + rows[1] + ... + rows[W-1]``, the JAX CPU mesh's
  psum_scatter order; a 2-byte dtype rounds once at the end), then the
  handle ``sum``, ``assign`` or ``sgd[:lr]`` on the store, in place, and the
  pulled copy when asked; or (:func:`rank_order_sum`) the reduction alone,
  for a callable handle.  Bit-exact with the plain version.
- **D2** (:func:`reduce_update`): the same reduction, then the
  ``sgd_momentum``/``adagrad``/``adam`` step of ``ops/fused_update.py`` on
  the store and its state in place, and the pulled copy, in one pass.  The
  bits of the reduction followed by a K1-K3 launch.

One launch takes a table of segments (``csrc/reduce_update.cu``: up to
``MAX_SEGS`` segments and ``MAX_ADDRS`` row addresses; longer tables take
several launches): a ``[W, n]`` rows tensor is one segment, a group one
segment per bucket (:func:`reduce_group`), and the pieces a process owns of
a group spanning processes one segment each, their rows given by address
(:func:`reduce_peers`, the peers' rows mapped through CUDA IPC).

On a CPU tensor each function runs its plain version
(``rank_order_sum_reference``, ``reduce_apply_reference``,
``reduce_update_reference``: today's composition of the reduction, the
handle or K1-K3's plain versions, then the copy); on a CUDA tensor it
launches the kernel, or raises.  ``launches`` counts kernel launches per
variant and dtype (``reduce_push_pull``, ``reduce_push``, ``reduce_sum``,
``reduce_push_pull_group``, ``reduce_<optimizer>``), and nothing else.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..utils import logging as log
from . import _native
from . import fused_update as fu
from . import ring_collective
from .ring_collective import ring_handle

MAX_SEGS = 40     # csrc/reduce_update.cu kMaxSegs
MAX_ADDRS = 128   # csrc/reduce_update.cu kMaxAddrs

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# Kernel modes: 0-2 the elementwise handles (``ring_handle``'s codes: sum,
# assign, sgd), 3 the reduction alone, 4-6 the optimizers.
_NONE = 3
_MODES = {"sgd_momentum": 4, "adagrad": 5, "adam": 6}
OPTIMIZERS = tuple(_MODES)


def _name(dtype) -> str:
    return str(dtype).replace("torch.", "")


launches: Dict[str, int] = {
    **{f"reduce_{op}[{_name(dt)}]": 0
       for op in ("push_pull", "push", "sum", "push_pull_group")
       for dt in _DTYPE_CODES},
    **{f"reduce_{kind}[{_name(dt)}]": 0
       for kind in OPTIMIZERS for dt in (torch.float32, torch.bfloat16)},
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# -- operands ----------------------------------------------------------------------

def _rows_shape(rows) -> tuple:
    """``(W, n, dtype, device)`` of ``rows``: a ``[W, n]`` tensor whose
    rows are contiguous, or a sequence of W ``[n]`` tensors of one dtype
    and device."""
    if isinstance(rows, torch.Tensor):
        log.check(rows.dim() == 2 and rows.shape[0] >= 1,
                  "rows must be [W, n] or a sequence of W [n] tensors")
        log.check(rows.shape[1] <= 1 or rows.stride(1) == 1,
                  "each row must be contiguous")
        return int(rows.shape[0]), int(rows.shape[1]), rows.dtype, \
            rows.device
    log.check(len(rows) >= 1, "no rows")
    first = rows[0]
    for r in rows:
        log.check(r.dim() == 1 and r.is_contiguous(),
                  "each row must be a contiguous [n] tensor")
        log.check(r.dtype == first.dtype, "rows of different dtypes")
        log.check(r.device == first.device, "rows on different devices")
        log.check(r.numel() == first.numel(), "row lengths differ")
    return len(rows), first.numel(), first.dtype, first.device


def _check_vec(t: torch.Tensor, n: int, dtype, device, what: str) -> None:
    if (t.dim() == 1 and t.is_contiguous() and t.dtype == dtype
            and t.device == device and t.numel() == n):
        return  # the messages below are built only for a refusal
    log.check(t.dim() == 1 and t.is_contiguous(),
              f"{what} must be a contiguous 1-D tensor")
    log.check(t.dtype == dtype, f"{what} is {t.dtype}, the rows {dtype}")
    log.check(t.device == device, f"{what} and the rows on different "
                                  f"devices")
    log.check(t.numel() == n, f"{what} has {t.numel()} values, the rows {n}")


def _on_cuda(device, dtype, dtypes=tuple(_DTYPE_CODES)) -> bool:
    """True when the operands (checked alike) live on a CUDA device, whose
    kernel takes ``dtype``; False on the CPU."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        log.check(False, f"unsupported device {device}")
    if dtype not in dtypes:
        log.check(False, f"the reduce kernels take "
                         f"{[_name(d) for d in dtypes]}, got {_name(dtype)}")
    return True


def _check_state(kind: str, state, alpha, n: int, dtype, device) -> None:
    log.check(kind in OPTIMIZERS, f"not an optimizer: {kind!r}")
    log.check(len(state) == (2 if kind == "adam" else 1),
              f"{kind} takes {2 if kind == 'adam' else 1} state tensors")
    for t in state:
        _check_vec(t, n, dtype, device, f"{kind} state")
    if kind == "adam":
        log.check(alpha is not None and alpha.dtype == torch.float32
                  and alpha.numel() == 1 and alpha.device == device,
                  "adam takes alpha, one float32 beside the store")


# -- plain versions ----------------------------------------------------------------

def rank_order_sum_reference(rows) -> torch.Tensor:
    """``rows[0] + rows[1] + ... + rows[W-1]``, left to right, a fresh
    tensor: psum_scatter's order on the JAX CPU mesh, where 2-byte floats
    accumulate in f32 and round to the dtype once, at the end."""
    acc = rows[0].to(torch.float32, copy=True)
    for w in range(1, len(rows)):
        acc += rows[w]
    return acc.to(rows[0].dtype)


def reduce_apply_reference(rows, store, handle="sum", pulled=None):
    """Plain version of :func:`reduce_apply`: the reduction, the handle
    on ``store`` in place, then the pulled copy."""
    mode, lr = ring_handle(handle)
    agg = rank_order_sum_reference(rows)
    if mode == 0:
        store.add_(agg)
    elif mode == 1:
        store.copy_(agg)
    else:
        store.sub_(lr * agg)
    if pulled is not None:
        pulled.copy_(store)
    return store


def reduce_update_reference(rows, store, state, kind: str, params,
                            alpha=None, pulled=None, fused: bool = False):
    """Plain version of :func:`reduce_update`: the reduction, K1-K3's
    plain versions (``fused=True``: ``ops/fused_update.py``'s wrappers,
    which launch K1-K3 on a CUDA tensor: the engine's composition before
    D2, which D2 equals bit for bit), then the pulled copy."""
    agg = rank_order_sum_reference(rows)
    if kind == "sgd_momentum":
        step = fu.sgd_update if fused else fu.sgd_update_reference
        step(store, state[0], agg, *params)
    elif kind == "adagrad":
        step = fu.adagrad_update if fused else fu.adagrad_update_reference
        step(store, state[0], agg, *params)
    else:
        step = (fu.adam_update_with_alpha if fused
                else fu.adam_update_reference)
        step(store, state[0], state[1], agg, alpha, *params)
    if pulled is not None:
        pulled.copy_(store)
    return store


# -- kernels -------------------------------------------------------------------------

def _or0(t):
    return t if t is not None else 0


def _seg(rows, n: int, b: int, store=0, pulled=0, aux0=0, aux1=0,
         offset: int = 0) -> tuple:
    """One segment of a launch: ``(row 0, row stride in bytes, row
    addresses or None, length, store, pulled, aux0, aux1, W)``.  Tensors
    (the rows too) give their address ``offset`` elements in; integers
    are addresses already (0: none)."""
    def ptr(t):
        return t.data_ptr() + offset * b if isinstance(t, torch.Tensor) \
            else t

    if isinstance(rows, torch.Tensor):
        row0, stride, addrs = rows.data_ptr(), rows.stride(0) * b, None
        W = int(rows.shape[0])
    else:
        row0, stride, addrs = 0, 0, [ptr(r) for r in rows]
        W = len(addrs)
    return (row0 + offset * b if addrs is None else 0, stride, addrs, n,
            ptr(store), ptr(pulled), ptr(aux0), ptr(aux1), W)


def _launch(segs, dtype, mode: int, device, consts=(), alpha=None) -> int:
    """Launch ``pstt_reduce_update`` over ``segs`` (:func:`_seg`), as many
    times as the tables take; returns the launches made."""
    p = [float(c) for c in consts] + [0.0] * (5 - len(consts))
    alpha_ptr = alpha.data_ptr() if alpha is not None else None
    stream = _native.stream_ptr(device)
    segs = [s for s in segs if s[3] > 0]
    made, i = 0, 0
    while i < len(segs):
        table: List[tuple] = []
        addrs: List[int] = []
        while i < len(segs) and len(table) < MAX_SEGS:
            row0, stride, rows, n, store, pulled, aux0, aux1, W = segs[i]
            at = -1
            if rows is not None:
                log.check(W <= MAX_ADDRS, f"at most {MAX_ADDRS} rows by "
                                          f"address, got {W}")
                if len(addrs) + W > MAX_ADDRS:
                    break
                at = len(addrs)
                addrs += rows
            table.append((row0, stride, n, store, pulled, aux0, aux1, W, at))
            i += 1
        seg_arr = np.asarray(table, dtype=np.int64).reshape(-1, 9)
        addr_arr = np.asarray(addrs or [0], dtype=np.int64)
        _native.call("pstt_reduce_update", seg_arr.ctypes.data, len(table),
                     addr_arr.ctypes.data, len(addrs), _DTYPE_CODES[dtype],
                     mode, *p, alpha_ptr, stream)
        made += 1
    return made


def rank_order_sum(rows) -> torch.Tensor:
    """The reduction alone, a fresh ``[n]`` tensor (D1 in mode ``none``):
    ``rows`` is ``[W, n]`` or a sequence of W ``[n]`` tensors."""
    W, n, dtype, dev = _rows_shape(rows)
    if not _on_cuda(dev, dtype):
        return rank_order_sum_reference(rows)
    out = torch.empty(n, dtype=dtype, device=dev)
    launches[f"reduce_sum[{_name(dtype)}]"] += _launch(
        [_seg(rows, n, dtype.itemsize, aux0=out)], dtype, _NONE, dev)
    return out


def reduce_apply(rows, store, handle="sum", pulled=None):
    """D1: reduce ``rows`` (``[W, n]`` or W ``[n]`` tensors), apply the
    elementwise ``handle`` to ``store`` in place, and write the new store
    into ``pulled`` when given.  Returns ``store``.  A row may be the
    store itself."""
    mode, lr = ring_handle(handle)
    W, n, dtype, dev = _rows_shape(rows)
    _check_vec(store, n, dtype, dev, "store")
    if pulled is not None:
        _check_vec(pulled, n, dtype, dev, "pulled")
    if not _on_cuda(dev, dtype):
        return reduce_apply_reference(rows, store, handle, pulled)
    op = "push_pull" if pulled is not None else "push"
    launches[f"reduce_{op}[{_name(dtype)}]"] += _launch(
        [_seg(rows, n, dtype.itemsize, store, _or0(pulled))], dtype, mode,
        dev, (lr,))
    return store


def _d2_consts(kind: str, params, dtype) -> tuple:
    """The kernel's constants of an optimizer step, as its dtype's
    arithmetic sees them (``fused_update._consts``)."""
    if kind == "adam":
        b1, b2, eps = params
        return fu._consts(dtype, b1, b2, 1 - b1, 1 - b2, eps)
    return fu._consts(dtype, *params)


def reduce_update(rows, store, state, kind: str, params, alpha=None,
                  pulled=None):
    """D2: reduce ``rows``, then one ``kind`` optimizer step on ``store``
    and ``state`` in place (``sgd_momentum``: state ``(mom,)``, params
    ``(lr, momentum)``; ``adagrad``: ``(acc,)``, ``(lr, eps)``; ``adam``:
    ``(m, v)``, ``(beta1, beta2, eps)`` and ``alpha``, the 1-element f32
    step size of ``fused_update.adam_alpha``), and write the new store
    into ``pulled`` when given.  Returns ``store``."""
    W, n, dtype, dev = _rows_shape(rows)
    _check_vec(store, n, dtype, dev, "store")
    _check_state(kind, state, alpha, n, dtype, dev)
    if pulled is not None:
        _check_vec(pulled, n, dtype, dev, "pulled")
    if not _on_cuda(dev, dtype, (torch.float32, torch.bfloat16)):
        return reduce_update_reference(rows, store, state, kind, params,
                                       alpha, pulled)
    aux1 = state[1] if kind == "adam" else 0
    launches[f"reduce_{kind}[{_name(dtype)}]"] += _launch(
        [_seg(rows, n, dtype.itemsize, store, _or0(pulled), state[0], aux1)],
        dtype, _MODES[kind], dev, _d2_consts(kind, params, dtype), alpha)
    return store


def _group_operands(rows_list, stores) -> torch.device:
    log.check(len(rows_list) == len(stores), "rows/stores count differ")
    dev = stores[0].device
    for rows, s in zip(rows_list, stores):
        W, n, dtype, d = _rows_shape(rows)
        _check_vec(s, n, dtype, d, "store")
        log.check(d == dev, "group buckets on different devices")
    return dev


def _slots(stores) -> list:
    """The pulled tensors of a group: one allocation per dtype, each slot
    16-byte aligned so its segment takes vectors
    (``ring_collective._slots``)."""
    out: list = [None] * len(stores)
    for dtype in dict.fromkeys(s.dtype for s in stores):
        idx = [i for i, s in enumerate(stores) if s.dtype == dtype]
        for i, p in zip(idx, ring_collective._slots(
                [stores[i] for i in idx], [True] * len(idx), dtype,
                stores[0].device)):
            out[i] = p if p is not None else torch.empty_like(stores[i])
    return out


def reduce_group(rows_list, stores, handle="sum") -> list:
    """D1 over k buckets in one launch per dtype (the JAX engine's
    ``_group_program`` off the ring): ``rows_list[i]`` reduces into
    ``stores[i]`` in place under ``handle``.  Returns the k pulled
    tensors (fresh), bit-identical to k :func:`reduce_apply` calls."""
    if not stores:
        return []
    mode, lr = ring_handle(handle)
    dev = _group_operands(rows_list, stores)
    pulled = _slots(stores)
    dtypes = list(dict.fromkeys(s.dtype for s in stores))
    if not all([_on_cuda(dev, dtype) for dtype in dtypes]):
        for r, s, p in zip(rows_list, stores, pulled):
            reduce_apply_reference(r, s, handle, p)
        return pulled
    for dtype in dtypes:
        segs = [_seg(r, s.numel(), dtype.itemsize, s, p)
                for r, s, p in zip(rows_list, stores, pulled)
                if s.dtype == dtype]
        launches[f"reduce_push_pull_group[{_name(dtype)}]"] += _launch(
            segs, dtype, mode, dev, (lr,))
    return pulled


# -- across processes ------------------------------------------------------------------

def reduce_peers(pieces, store: torch.Tensor, handle="sum", state=(),
                 params=(), alpha=None) -> torch.Tensor:
    """D1 (``handle`` elementwise) or D2 (``handle`` one of
    ``OPTIMIZERS``, with ``state``, ``params`` and ``alpha`` as
    :func:`reduce_update` takes them) over the pieces of ``store`` that
    this process owns on a group spanning processes: each piece
    ``(row addresses, store offset, length)`` names the device address of
    each of its W rows at the piece's first element (a peer's row mapped
    through CUDA IPC), in rank order.  One launch per table; CUDA only (a
    CPU group takes the plain versions over gloo).  Returns ``store``."""
    log.check(store.dim() == 1 and store.is_contiguous(),
              "store must be a contiguous 1-D tensor")
    dtype, dev, b = store.dtype, store.device, store.element_size()
    stateful = handle in OPTIMIZERS
    log.check(_on_cuda(dev, dtype, (torch.float32, torch.bfloat16)
                       if stateful else tuple(_DTYPE_CODES)),
              "reduce_peers runs on the card (a CPU group takes the plain "
              "versions)")
    for addrs, off, n in pieces:
        log.check(len(addrs) >= 1 and 0 <= off and off + n <= store.numel(),
                  "a piece falls outside the store")
    if stateful:
        _check_state(handle, state, alpha, store.numel(), dtype, dev)
        mode, consts = _MODES[handle], _d2_consts(handle, params, dtype)
        key = f"reduce_{handle}[{_name(dtype)}]"
        aux = (state[0], state[1] if handle == "adam" else 0)
    else:
        mode, lr = ring_handle(handle)
        consts, key, aux = (lr,), f"reduce_push[{_name(dtype)}]", (0, 0)
    segs = [_seg(list(addrs), n, b, store, 0, *aux, offset=off)
            for addrs, off, n in pieces]
    launches[key] += _launch(segs, dtype, mode, dev, consts, alpha)
    return store


def reduce_peers_reference(pieces, store: torch.Tensor, handle="sum",
                           state=(), params=(), alpha=None) -> torch.Tensor:
    """Plain version of :func:`reduce_peers` on the card: each piece's
    rows read through their addresses, then ``reduce_apply_reference`` or
    ``reduce_update_reference`` on its slice of the store (and state)."""
    from .ring_collective import device_view

    for addrs, off, n in pieces:
        rows = [device_view(a, (n,), store.dtype, store.device)
                for a in addrs]
        sl = slice(off, off + n)
        if handle in OPTIMIZERS:
            reduce_update_reference(rows, store[sl], [t[sl] for t in state],
                                    handle, params, alpha)
        else:
            reduce_apply_reference(rows, store[sl], handle)
    return store

