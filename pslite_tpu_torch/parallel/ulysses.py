"""Ulysses sequence parallelism: an all-to-all head/sequence swap.

Counterpart of ``pslite_tpu/parallel/ulysses.py``.  One all-to-all
re-shards each of q, k, v from sequence-parallel ``[B, T/S, H, D]`` to
head-parallel ``[B, T, H/S, D]``, attention runs over the full sequence
for the rank's head group (:func:`~pslite_tpu_torch.parallel.
ring_attention.reference_attention`), and a second all-to-all swaps the
output back (ulysses.py:24-50).  Same contract as
:func:`~pslite_tpu_torch.parallel.ring_attention.ring_attention`:
per-rank ``[R, B, T_local, H, D]`` in and out, shard-major global order;
needs ``H`` divisible by the axis size.
"""

from __future__ import annotations

from typing import Optional

from . import mesh
from .ring_attention import reference_attention


def _all_to_all_seq_to_heads(group, x, axis_name: str, S: int):
    """[R, B, T_local, H, D] -> [R, B, T_global, H/S, D]."""
    R, B, T, H, D = x.shape
    x = x.reshape(R, B, T, S, H // S, D)
    y = mesh.all_to_all(group, x, axis_name, split_dim=2, concat_dim=1)
    return y.reshape(R, B, T * S, H // S, D)


def _all_to_all_heads_to_seq(group, x, axis_name: str, S: int):
    """[R, B, T_global, H/S, D] -> [R, B, T_local, H, D]."""
    R, B, Tg, Hs, D = x.shape
    x = x.reshape(R, B, S, Tg // S, Hs, D)
    y = mesh.all_to_all(group, x, axis_name, split_dim=1, concat_dim=3)
    return y.reshape(R, B, Tg // S, Hs * S, D)


def ulysses_attention(group, q, k, v, axis_name: str, causal: bool = False,
                      scale: Optional[float] = None):
    """All-to-all sequence-parallel attention over ``axis_name`` of
    ``group``."""
    S = mesh.axis_size(group, axis_name)
    qh = _all_to_all_seq_to_heads(group, q, axis_name, S)
    kh = _all_to_all_seq_to_heads(group, k, axis_name, S)
    vh = _all_to_all_seq_to_heads(group, v, axis_name, S)
    oh = reference_attention(qh, kh, vh, causal=causal, scale=scale)
    return _all_to_all_heads_to_seq(group, oh, axis_name, S)
