"""Ring attention: sequence parallelism over an axis of a device group.

Counterpart of ``pslite_tpu/parallel/ring_attention.py``.  Each rank
holds its ``[B, T_local, H, D]`` block of q, k and v (global order
shard-major: rank s owns positions ``[s*T_local, (s+1)*T_local)``); the
k/v blocks rotate around the ring (:func:`~pslite_tpu_torch.parallel.
mesh.ppermute`) while each rank accumulates the blockwise softmax online
with a log-sum-exp carry.  Here every rank runs at once: tensors carry
the leading rank dim of ``parallel/mesh.py``, ``[R, B, T_local, H, D]``.

The arithmetic is JAX's, in plain einsums and exps (no fused attention
kernel: the JAX package runs none here either): the ring masks with a
true ``-inf`` and guards fully masked rows with ``isfinite``
(ring_attention.py:42-58); :func:`reference_attention` masks with
``finfo(dtype).min`` (:90).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import mesh


def ring_attention(group, q, k, v, axis_name: str, causal: bool = False,
                   scale: Optional[float] = None):
    """Blockwise ring attention over ``axis_name`` of ``group``: q, k, v
    ``[R, B, T, H, D]`` per-rank blocks; returns ``[R, B, T, H, D]``, each
    rank's queries over the global key/value sequence."""
    R, B, T, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    S = mesh.axis_size(group, axis_name)
    my = mesh.axis_index(group, axis_name)  # [R]
    ar = torch.arange(T, device=q.device)
    q_pos = my[:, None] * T + ar  # [R, T] global positions of my queries
    neg_inf = float("-inf")  # true -inf: the guards below use isfinite

    o = torch.zeros((R, B, H, T, D), dtype=q.dtype, device=q.device)
    m = torch.full((R, B, H, T), neg_inf, dtype=q.dtype, device=q.device)
    l = torch.zeros((R, B, H, T), dtype=q.dtype, device=q.device)
    k_cur, v_cur = k, v
    for i in range(S):
        # k_cur originated at rank (my - i) mod S along the axis.
        src = (my - i) % S
        k_pos = src[:, None] * T + ar  # [R, Tk]
        scores = torch.einsum("rbthd,rbshd->rbhts", q, k_cur) * scale
        if causal:
            mask = k_pos[:, None, :] > q_pos[:, :, None]  # [R, T, Tk]
            scores = torch.where(mask[:, None, None], neg_inf, scores)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        p = torch.where(torch.isfinite(scores), p, 0.0)
        alpha = torch.exp(m - m_new)
        alpha = torch.where(torch.isfinite(m), alpha, 0.0)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum(
            "rbhts,rbshd->rbthd", p, v_cur).transpose(2, 3)
        m = m_new
        k_cur = mesh.ppermute(group, k_cur, axis_name)
        v_cur = mesh.ppermute(group, v_cur, axis_name)
    l = torch.where(l == 0, 1.0, l)  # fully masked rows output zeros
    return (o / l[..., None]).transpose(2, 3)  # [R, B, T, H, D]


def reference_attention(q, k, v, causal: bool = False,
                        scale: Optional[float] = None):
    """Single-rank attention in the same layout, ``[..., T, H, D]`` with
    any leading dims (the rank dim included)."""
    T, D = q.shape[-3], q.shape[-1]
    if scale is None:
        scale = D ** -0.5
    scores = torch.einsum("...thd,...shd->...hts", q, k) * scale
    if causal:
        pos = torch.arange(T, device=q.device)
        mask = pos[None, :] > pos[:, None]
        scores = torch.where(mask, torch.finfo(q.dtype).min, scores)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("...hts,...shd->...thd", p, v)
