"""Blockwise int8 quantization: one absmax scale per 128-value row.

Counterparts of the Pallas kernels in ``pslite_tpu/ops/quantize.py``
(``quantize_int8`` :71, pallas_call :97; ``dequantize_int8`` :111,
pallas_call :129) and of its host helpers ``np_quantize_int8``,
``np_dequantize_int8`` and ``decode_int8_payload``.  The CUDA kernels are
``csrc/quantize_int8.cu``; its header says what bounds them and how.

Layout, as in the JAX package: the flat f32 vector is padded with zeros
to a multiple of 32 rows of 128 values (the TPU's int8 tile), so
``R = ceil(N / 4096) * 32``.  :func:`quantize_int8` returns int8 codes
``[R, 128]`` and lane-replicated f32 scales ``[R, 128]``; padding rows
get code 0 and scale 1e-12.  :func:`dequantize_int8` takes those scales
or the compact wire form ``[R]`` / ``[R, 1]``.

Numerics follow the TPU kernel as XLA compiles it: ``amax / 127`` is
computed as ``amax * (1/127)`` (the f32 reciprocal), then
``scale = max(., 1e-12)``, ``q = clip(rint(x / scale), -127, 127)`` with
a true division and half-to-even rounding.  The numpy helpers keep the
JAX package's true division ``amax / 127``; on about one row in twenty
their scale differs from the kernel's by one ulp.

On a CPU tensor each function runs its plain PyTorch version; on a CUDA
tensor it launches the kernel, or raises.  ``launches`` counts kernel
launches per function (dequantize per scale form), and nothing else.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..utils import logging as log
from . import _native

QUANT_BLOCK = 128  # values per scale (one row)
_TILE_ROWS = 32  # rows are padded to a multiple of the TPU's int8 tile
_INV127 = torch.tensor(np.float32(1) / np.float32(127))  # f32 1/127
_MIN_SCALE = 1e-12

# dequantize_int8 counts per scale form: [R, 128] scales, or [R] / [R, 1].
launches: Dict[str, int] = {"quantize_int8": 0, "dequantize_int8": 0,
                            "dequantize_int8[compact]": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def quantized_rows(n: int) -> int:
    """Rows of the ``[R, 128]`` outputs for ``n`` input values."""
    tile = QUANT_BLOCK * _TILE_ROWS
    return -(-n // tile) * _TILE_ROWS


# -- host helpers (the message path's numpy codec) ------------------------------

def np_quantize_int8(x):
    """flat f32 -> (int8 ``[rows, 128]``, f32 scales ``[rows]``, n), rows
    padded to a multiple of 128 values only, with the true division
    ``amax / 127`` (the JAX package's numpy helper, copied)."""
    x = np.asarray(x, dtype=np.float32).reshape(-1)
    n = x.shape[0]
    pad = (-n) % QUANT_BLOCK
    if pad:
        x = np.pad(x, (0, pad))
    rows = x.shape[0] // QUANT_BLOCK
    x2 = x.reshape(rows, QUANT_BLOCK)
    scales = np.maximum(
        np.abs(x2).max(axis=1) / 127.0, _MIN_SCALE
    ).astype(np.float32)
    q = np.clip(np.rint(x2 / scales[:, None]), -127, 127).astype(np.int8)
    return q, scales, n


def np_dequantize_int8(q, scales, n: int):
    x = q.astype(np.float32) * np.asarray(scales, np.float32)[:, None]
    return x.reshape(-1)[:n]


def decode_int8_payload(q_sarray, scales_sarray, val_len: int):
    """Decode the wire layout of an int8-compressed message payload
    (int8 codes, f32 scales per 128 values, ``val_len`` the uncompressed
    byte count); the JAX package's helper, which has no caller there
    either (the message path's codecs are ``ops/codecs.py``)."""
    q = q_sarray.astype_view(np.int8).numpy().reshape(-1, QUANT_BLOCK)
    scales = scales_sarray.astype_view(np.float32).numpy()
    return np_dequantize_int8(q, scales, val_len // 4)


# -- plain versions -------------------------------------------------------------

def quantize_int8_reference(x: torch.Tensor):
    """Plain PyTorch version of :func:`quantize_int8` on any device."""
    x = x.reshape(-1).to(torch.float32)
    rows = quantized_rows(x.numel())
    x2 = torch.nn.functional.pad(
        x, (0, rows * QUANT_BLOCK - x.numel())).view(rows, QUANT_BLOCK)
    amax = x2.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp_min(amax * _INV127.to(x.device), _MIN_SCALE)
    q = torch.clamp(torch.round(x2 / scale), -127, 127).to(torch.int8)
    return q, scale.expand(rows, QUANT_BLOCK).contiguous()


def _scale_view(scales: torch.Tensor, rows: int):
    """``[R, 128]`` scales as they are (one scale per value), any other
    ``[R]`` / ``[R, k]`` form as its first column ``[R, 1]`` (one scale
    per row), as the JAX function broadcasts them.  Returns (view,
    per_value)."""
    log.check(scales.dtype == torch.float32, "scales must be float32")
    if scales.dim() == 1:
        scales = scales[:, None]
    log.check(scales.dim() == 2 and int(scales.shape[0]) == rows,
              f"scales must be [rows], [rows, 1] or [rows, 128] with rows "
              f"= {rows}, got {tuple(scales.shape)}")
    if scales.shape[1] == QUANT_BLOCK:
        return scales, True
    return scales[:, :1], False


def dequantize_int8_reference(q: torch.Tensor, scales: torch.Tensor, n: int):
    """Plain PyTorch version of :func:`dequantize_int8` on any device."""
    rows = int(q.shape[0])
    s, _ = _scale_view(scales, rows)
    return (q.to(torch.float32) * s).reshape(-1)[:n]


# -- kernels ----------------------------------------------------------------------

def _on_cuda(*tensors) -> bool:
    first = tensors[0]
    for t in tensors:
        log.check(t.device == first.device, "operands on different devices")
    if first.device.type == "cuda":
        return True
    log.check(first.device.type == "cpu", f"unsupported device {first.device}")
    return False


def quantize_int8(x: torch.Tensor):
    """flat f32 ``[N]`` -> (int8 codes ``[R, 128]``, f32 scales
    ``[R, 128]``), ``R = ceil(N/4096)*32``.  Keep ``N`` for
    :func:`dequantize_int8`."""
    log.check(x.dtype == torch.float32, f"quantize_int8 takes float32, got "
                                        f"{x.dtype}")
    if not _on_cuda(x):
        return quantize_int8_reference(x)
    x = x.reshape(-1)
    log.check(x.is_contiguous(), "x must be contiguous")
    rows = quantized_rows(x.numel())
    q = torch.empty((rows, QUANT_BLOCK), dtype=torch.int8, device=x.device)
    s = torch.empty((rows, QUANT_BLOCK), dtype=torch.float32, device=x.device)
    if rows:
        _native.call("pstt_quantize_int8", x.data_ptr(), q.data_ptr(),
                     s.data_ptr(), x.numel(), rows,
                     _native.stream_ptr(x.device))
        launches["quantize_int8"] += 1
    return q, s


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor, n: int):
    """Inverse of :func:`quantize_int8`: ``q * scale`` over ``[R, 128]``
    codes, flattened and cut to its first ``n`` values (at most
    ``R*128``).  ``scales`` is ``[R, 128]`` (multiplied value by value,
    as the JAX kernel does) or the compact ``[R]`` / ``[R, 1]``."""
    log.check(q.dtype == torch.int8 and q.dim() == 2
              and int(q.shape[1]) == QUANT_BLOCK,
              f"q must be int8 [rows, {QUANT_BLOCK}]")
    rows = int(q.shape[0])
    if not _on_cuda(q, scales):
        return dequantize_int8_reference(q, scales, n)
    s, per_value = _scale_view(scales, rows)
    log.check(q.is_contiguous(), "q must be contiguous")
    if per_value:
        log.check(s.is_contiguous(), "scales must be contiguous")
    n = max(0, min(int(n), rows * QUANT_BLOCK))
    out = torch.empty(n, dtype=torch.float32, device=q.device)
    if n:
        _native.call("pstt_dequantize_int8", q.data_ptr(), s.data_ptr(),
                     int(s.stride(0)), int(per_value), out.data_ptr(), n,
                     _native.stream_ptr(q.device))
        launches["dequantize_int8" if per_value
                 else "dequantize_int8[compact]"] += 1
    return out
