"""Fused optimizer updates: SGD with momentum, Adagrad, Adam.

Counterparts of the Pallas kernels in ``pslite_tpu/ops/fused_update.py``
(``sgd_update`` :51, ``adagrad_update`` :86, ``adam_update`` :128).  The
CUDA kernels are in ``csrc/fused_update.cu``; its header says what bounds
them and how.  Their per-element arithmetic is ``csrc/fused_update.cuh``,
which D2 (``ops/reduce_update.py``) shares.  Each public function updates ``store`` and the optimizer
state IN PLACE (where the JAX kernels alias their outputs to donated
inputs) and returns them.

Store and state are float32, or bfloat16 as the JAX engine keeps a bf16
bucket's (adam's step counter and step size stay float32).  In bf16 every
operation rounds to bf16 and the constants are rounded to bf16 first, as
XLA's CPU backend evaluates the JAX kernels (bit-exact for sgd_momentum
and adagrad); adam, which the JAX kernel refuses in bf16, subtracts its
f32 step and rounds once into the store (see ``csrc/fused_update.cu``).

On a CPU tensor each function runs its plain PyTorch version
(``*_reference``); on a CUDA tensor it launches the kernel, or raises.
``launches`` counts kernel launches per function and dtype (``*_bf16``),
and nothing else.
"""

from __future__ import annotations

import struct
from typing import Dict

import torch

from ..utils import logging as log
from . import _native

launches: Dict[str, int] = {
    "sgd_update": 0, "adagrad_update": 0, "adam_update": 0,
    "sgd_update_bf16": 0, "adagrad_update_bf16": 0, "adam_update_bf16": 0,
}
_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _bf16(x: float) -> float:
    """``x`` rounded to f32, then to the nearest bf16 (ties to even): how
    a Python constant enters a bf16 expression in XLA."""
    bits = struct.unpack("<I", struct.pack("<f", x))[0]
    bits = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16
    return struct.unpack("<f", struct.pack("<I", bits & 0xFFFFFFFF))[0]


def _consts(dtype, *xs):
    """The update's constants as its dtype's arithmetic sees them."""
    return tuple(_bf16(x) for x in xs) if dtype == torch.bfloat16 else xs


def _on_cuda(*vectors, scalar=None) -> bool:
    """Validate the operands (f32 or bf16 vectors of one dtype and
    length, contiguous, on one device, and an optional 1-element f32
    ``scalar`` beside them); True when they live on a CUDA device."""
    first = vectors[0]
    log.check(first.dtype in _DTYPES,
              f"fused updates take float32 or bfloat16 tensors, got "
              f"{first.dtype}")
    for t in vectors + ((scalar,) if scalar is not None else ()):
        log.check(t.device == first.device, "operands on different devices")
        log.check(t.is_contiguous(), "operands must be contiguous")
    for t in vectors:
        log.check(t.dtype == first.dtype,
                  f"fused updates take float32 or bfloat16 tensors of one "
                  f"dtype, got {first.dtype} and {t.dtype}")
        log.check(t.numel() == first.numel(), "operand lengths differ")
    if scalar is not None:
        log.check(scalar.dtype == torch.float32 and scalar.numel() == 1,
                  "the scalar operand is one float32")
    if first.device.type == "cuda":
        return True
    log.check(first.device.type == "cpu",
              f"unsupported device {first.device}")
    return False


# -- plain versions ------------------------------------------------------------

def sgd_update_reference(store, mom, agg, lr: float = 0.01,
                         momentum: float = 0.9):
    """``mom = momentum*mom + agg; store -= lr*mom``, in place."""
    lr, momentum = _consts(store.dtype, lr, momentum)
    mom.mul_(momentum).add_(agg)
    store.sub_(lr * mom)
    return store, mom


def adagrad_update_reference(store, acc, agg, lr: float = 0.01,
                             eps: float = 1e-8):
    """``acc += agg**2; store -= lr*agg/(sqrt(acc)+eps)``, in place."""
    lr, eps = _consts(store.dtype, lr, eps)
    acc.add_(agg * agg)
    store.sub_(lr * agg / (acc.sqrt() + eps))
    return store, acc


def adam_update_reference(store, m, v, agg, alpha, beta1: float = 0.9,
                          beta2: float = 0.999, eps: float = 1e-8):
    """One Adam step in place, with the bias-corrected step size
    ``alpha`` (a 1-element f32 tensor, see :func:`adam_alpha`)."""
    b1, b2, c1, c2, eps = _consts(store.dtype, beta1, beta2, 1 - beta1,
                                  1 - beta2, eps)
    m.mul_(b1).add_(c1 * agg)
    v.mul_(b2).add_(c2 * agg * agg)
    store.sub_(alpha * m / (v.sqrt() + eps))
    return store, m, v


def adam_alpha(step, lr: float, beta1: float = 0.9, beta2: float = 0.999,
               device=None) -> torch.Tensor:
    """``lr*sqrt(1-beta2^t)/(1-beta1^t)`` in f32 for the 1-based step
    ``t`` — a 1-element tensor computed where ``step`` lives, so a
    device-resident step counter never syncs to the host."""
    t = torch.as_tensor(step, dtype=torch.float32, device=device).reshape(1)
    # Python-float bases: no host-to-device copy, so no stream sync.
    return lr * torch.sqrt(1.0 - torch.pow(beta2, t)) / (
        1.0 - torch.pow(beta1, t))


# -- kernels ---------------------------------------------------------------------

def _entry(name: str, dtype) -> str:
    return name + "_bf16" if dtype == torch.bfloat16 else name


def sgd_update(store, mom, agg, lr: float = 0.01, momentum: float = 0.9):
    """Fused SGD-with-momentum step over ``store``/``mom`` in place."""
    if not _on_cuda(store, mom, agg):
        return sgd_update_reference(store, mom, agg, lr, momentum)
    name = _entry("sgd_update", store.dtype)
    _native.call(f"pstt_{name}", store.data_ptr(), mom.data_ptr(),
                 agg.data_ptr(), store.numel(),
                 *_consts(store.dtype, lr, momentum),
                 _native.stream_ptr(store.device))
    launches[name] += 1
    return store, mom


def adagrad_update(store, acc, agg, lr: float = 0.01, eps: float = 1e-8):
    """Fused Adagrad step over ``store``/``acc`` in place."""
    if not _on_cuda(store, acc, agg):
        return adagrad_update_reference(store, acc, agg, lr, eps)
    name = _entry("adagrad_update", store.dtype)
    _native.call(f"pstt_{name}", store.data_ptr(), acc.data_ptr(),
                 agg.data_ptr(), store.numel(),
                 *_consts(store.dtype, lr, eps),
                 _native.stream_ptr(store.device))
    launches[name] += 1
    return store, acc


def adam_update(store, m, v, agg, step, lr: float = 1e-3, beta1: float = 0.9,
                beta2: float = 0.999, eps: float = 1e-8):
    """Fused Adam step over ``store``/``m``/``v`` in place.  ``step`` is
    the 1-based step (a number or a 1-element tensor on the device)."""
    alpha = adam_alpha(step, lr, beta1, beta2, device=store.device)
    return adam_update_with_alpha(store, m, v, agg, alpha, beta1, beta2, eps)


def adam_update_with_alpha(store, m, v, agg, alpha, beta1: float = 0.9,
                           beta2: float = 0.999, eps: float = 1e-8):
    """:func:`adam_update` given the step size ``alpha`` (a 1-element f32
    tensor beside the store, the TPU kernel's prefetched scalar)."""
    if not _on_cuda(store, m, v, agg, scalar=alpha):
        return adam_update_reference(store, m, v, agg, alpha, beta1, beta2,
                                     eps)
    name = _entry("adam_update", store.dtype)
    _native.call(f"pstt_{name}", store.data_ptr(), m.data_ptr(),
                 v.data_ptr(), agg.data_ptr(), alpha.data_ptr(),
                 store.numel(),
                 *_consts(store.dtype, beta1, beta2, 1 - beta1, 1 - beta2,
                          eps),
                 _native.stream_ptr(store.device))
    launches[name] += 1
    return store, m, v
