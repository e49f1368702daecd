"""PSFormer, the flagship transformer LM, on PyTorch.

Counterpart of ``pslite_tpu/models/transformer.py``: a functional model
(params are a dict of tensors in the JAX package's layout: weights
``[in, out]``, the same keys), bfloat16 matmuls, and sequence, tensor and
expert parallelism over the axes of a device group.  Under a
:class:`ParallelCtx` with a ``group``, every tensor carries the leading
rank dim of ``parallel/mesh.py``: params ``[R, ...]`` (one copy per
rank, so each rank's gradient is its own row), tokens ``[R, B,
T_local]``; the collectives of JAX's ``shard_map`` body are the mesh
module's tensor ops.  Without one, params and tokens have no rank dim.

Choices against JAX's arithmetic, each as JAX computes it:

- ``jax.nn.gelu`` is the tanh approximation by default, so the port calls
  ``F.gelu(approximate="tanh")`` (``F.gelu``'s default is the erf form).
- The compute dtype is bfloat16 unless the activations are float64
  (transformer.py:191): a matmul casts both operands to it and the
  result back (the logits to float32).  The large products are plain
  ``torch.matmul``/``bmm`` (cuBLAS on the card), as JAX leaves them to
  XLA.
- The positional table is computed in float32 (float64 for float64
  activations, as JAX's default float under x64) from ``pos_offset +
  arange(T)`` and cast to the activations' dtype (:185-189).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..parallel import mesh
from ..parallel.moe import init_moe_params, moe_ffn
from ..parallel.ring_attention import reference_attention
from .ps_step import tree_map


@dataclass(frozen=True)
class ModelConfig:
    vocab: int = 256
    dim: int = 128
    heads: int = 4
    layers: int = 2
    mlp_ratio: int = 4
    moe_experts: int = 0  # >0: replace the MLP with a top-1 routed MoE
    dtype: str = "float32"  # params dtype; matmuls cast to bfloat16
    remat: bool = False  # checkpoint each layer: trade FLOPs for memory


@dataclass(frozen=True)
class ParallelCtx:
    """How a forward pass is sharded over the ranks of ``group``.

    ``attn_fn(q, k, v)`` handles sequence parallelism (per-rank ``[R, B,
    T, H, D]`` blocks); ``pos_offset`` is each rank's first global
    position (an ``[R]`` tensor or an int); ``tp_axis`` shards the MLP
    matmuls column/row-wise (tensor parallelism); ``ep_axis`` shards MoE
    experts.  ``group=None``: one rank, and no rank dim."""

    attn_fn: Optional[Callable] = None
    pos_offset: object = 0
    tp_axis: Optional[str] = None
    ep_axis: Optional[str] = None
    group: object = None


def normal_init(gen, shape, scale, dt, device):
    """``N(0, 1) * scale`` of ``shape`` from ``gen``, as ``dt`` on
    ``device`` (JAX's ``jax.random.normal(key, shape) * scale``)."""
    return (torch.randn(shape, generator=gen, dtype=torch.float64)
            * scale).to(dtype=dt, device=device)


def init_params(gen: torch.Generator, cfg: ModelConfig, device="cpu"):
    """JAX's shapes and scales (``N(0, 1) * dim**-0.5``, norms ones),
    drawn from ``gen``."""
    dt = getattr(torch, cfg.dtype)
    D = cfg.dim
    scale = D ** -0.5

    def dense(shape):
        return normal_init(gen, shape, scale, dt, device)

    def ones():
        return torch.ones((D,), dtype=dt, device=device)

    params = {"embed": dense((cfg.vocab, D)), "ln_f": ones(), "layers": []}
    for _ in range(cfg.layers):
        layer = {"ln1": ones(), "ln2": ones(), "qkv": dense((D, 3 * D)),
                 "proj": dense((D, D))}
        if cfg.moe_experts > 0:
            layer["moe"] = init_moe_params(gen, D, cfg.mlp_ratio * D,
                                           cfg.moe_experts, dt, device)
        else:
            layer["mlp_in"] = dense((D, cfg.mlp_ratio * D))
            layer["mlp_out"] = dense((cfg.mlp_ratio * D, D))
        params["layers"].append(layer)
    return params


def _per_rank(p, x):
    """A per-rank param ``[R, *s]`` shaped to broadcast against ``x``
    ``[R, ..., *s]``."""
    return p.reshape((p.shape[0],) + (1,) * (x.dim() - p.dim())
                     + tuple(p.shape[1:]))


def _mm(x, w, compute_dt):
    """Per-rank ``x @ w``: ``x`` ``[R, ..., K]``, ``w`` ``[R, K, N]``, both
    cast to ``compute_dt``; the product stays in ``compute_dt``."""
    R, K = x.shape[0], x.shape[-1]
    out = torch.bmm(x.reshape(R, -1, K).to(compute_dt), w.to(compute_dt))
    return out.reshape(tuple(x.shape[:-1]) + (w.shape[-1],))


def _rmsnorm(x, scale):
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(var + 1e-6) * _per_rank(scale, x)


def _take(w, index, dim: int, size: int):
    """Each rank's block ``index[r]`` of ``size`` along per-rank dim
    ``dim`` of ``w`` ``[R, ...]`` (``lax.dynamic_slice_in_dim`` at
    ``index * size``)."""
    R = w.shape[0]
    d = 1 + dim
    shape = list(w.shape)
    blocks = w.reshape(shape[:d] + [shape[d] // size, size]
                       + shape[d + 1:]).movedim(d, 1)
    return blocks[torch.arange(R, device=w.device), index]


def _mlp(layer, h, compute_dt, ctx: ParallelCtx, cfg: ModelConfig):
    """Dense MLP.  With ``ctx.tp_axis`` set, the Megatron sequence <->
    tensor parallel transition (transformer.py:95-128): all_gather the
    token blocks, the column/row-sharded matmul pair, and a
    reduce-scatter that sums the feature partials and re-shards the
    sequence."""
    x_dt = h.dtype
    w_in, w_out = layer["mlp_in"], layer["mlp_out"]
    if ctx.tp_axis is None:
        h = F.gelu(_mm(h, w_in, compute_dt).to(x_dt), approximate="tanh")
        return _mm(h, w_out, compute_dt).to(x_dt)

    group, axis = ctx.group, ctx.tp_axis
    S = mesh.axis_size(group, axis)
    my = mesh.axis_index(group, axis)
    f_local = w_in.shape[2] // S
    w_in = _take(w_in, my, 1, f_local)
    w_out = _take(w_out, my, 0, f_local)
    h_full = mesh.all_gather(group, h, axis, 1)  # [R, B, T, D]
    h1 = F.gelu(_mm(h_full, w_in, compute_dt).to(x_dt), approximate="tanh")
    part = _mm(h1, w_out, compute_dt).to(x_dt)
    return mesh.psum_scatter(group, part, axis, 1)


def _moe(layer, h, compute_dt, ctx: ParallelCtx, cfg: ModelConfig):
    """Routed MoE; with ``ctx.ep_axis`` set, experts shard blockwise over
    the axis and tokens route via gather + psum_scatter."""
    moe_p = layer["moe"]
    if ctx.ep_axis is None:
        return moe_ffn(moe_p, h, compute_dtype=compute_dt)
    group = ctx.group
    S = mesh.axis_size(group, ctx.ep_axis)
    my = mesh.axis_index(group, ctx.ep_axis)
    e_local = cfg.moe_experts // S
    local = {
        "gate": moe_p["gate"],  # gating over global expert ids
        "w_in": _take(moe_p["w_in"], my, 0, e_local),
        "w_out": _take(moe_p["w_out"], my, 0, e_local),
    }
    return moe_ffn(local, h, group, ctx.ep_axis, compute_dtype=compute_dt)


def positions(pos_offset, T: int, D: int, dtype, device):
    """The sinusoidal table ``[R, T, D]`` of each rank's global positions
    ``pos_offset + arange(T)`` (``pos_offset`` ``[R]``), in float32
    (float64 for float64 activations), cast to ``dtype``."""
    pe_dt = torch.float64 if dtype == torch.float64 else torch.float32
    pos = pos_offset[:, None] + torch.arange(T, device=device)
    log10k = torch.log(torch.tensor(10000.0, dtype=pe_dt, device=device))
    freqs = torch.exp(-torch.arange(0, D, 2, dtype=pe_dt, device=device)
                      / D * log10k)
    ang = pos[..., None].to(pe_dt) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def compute_dtype(x) -> torch.dtype:
    return x.dtype if x.dtype == torch.float64 else torch.bfloat16


def _layer_fn(layer, x, ctx: ParallelCtx, cfg: ModelConfig, attn):
    R, B, T, D = x.shape
    H = cfg.heads
    hd = D // H
    cdt = compute_dtype(x)
    h = _rmsnorm(x, layer["ln1"])
    qkv = _mm(h, layer["qkv"], cdt).to(x.dtype)
    q, k, v = qkv.split(D, dim=-1)
    o = attn(q.reshape(R, B, T, H, hd), k.reshape(R, B, T, H, hd),
             v.reshape(R, B, T, H, hd)).reshape(R, B, T, D)
    x = x + _mm(o, layer["proj"], cdt).to(x.dtype)
    h = _rmsnorm(x, layer["ln2"])
    if "moe" in layer:
        return x + _moe(layer, h, cdt, ctx, cfg)
    return x + _mlp(layer, h, cdt, ctx, cfg)


def embed_lookup(embed, tokens):
    """Per-rank rows: ``embed`` ``[R, V, D]``, tokens ``[R, ...]``."""
    R = embed.shape[0]
    ar = torch.arange(R, device=embed.device).reshape(
        (R,) + (1,) * (tokens.dim() - 1))
    return embed[ar, tokens]


def forward(params, tokens, cfg: ModelConfig,
            attn_fn: Optional[Callable] = None, pos_offset=0,
            ctx: Optional[ParallelCtx] = None):
    """Token ids -> float32 logits.

    Without a group: ``tokens`` ``[B, T]`` -> ``[B, T, vocab]``.  With
    ``ctx.group``: per-rank params and ``tokens`` ``[R, B, T_local]`` ->
    ``[R, B, T_local, vocab]``."""
    if ctx is None:
        ctx = ParallelCtx(attn_fn=attn_fn, pos_offset=pos_offset)
    one = ctx.group is None
    if one:
        params = tree_map(lambda p: p.unsqueeze(0), params)
        tokens = tokens.unsqueeze(0)
    attn = ctx.attn_fn or (
        lambda q, k, v: reference_attention(q, k, v, causal=True))

    x = embed_lookup(params["embed"], tokens)  # [R, B, T, D]
    R, B, T, D = x.shape
    off = torch.as_tensor(ctx.pos_offset, device=x.device).reshape(-1)
    off = off.expand(R) if off.numel() == 1 else off
    x = x + positions(off, T, D, x.dtype, x.device)[:, None]

    def layer_fn(layer, x):
        return _layer_fn(layer, x, ctx, cfg, attn)

    for layer in params["layers"]:
        if cfg.remat:
            # Recompute the layer's activations in the backward pass.
            x = torch.utils.checkpoint.checkpoint(layer_fn, layer, x,
                                                  use_reentrant=False)
        else:
            x = layer_fn(layer, x)

    x = _rmsnorm(x, params["ln_f"])
    logits = _mm(x, params["embed"].transpose(1, 2),
                 compute_dtype(x)).float()
    return logits[0] if one else logits


def nll(logits, targets):
    """Mean next-token cross-entropy over the trailing ``[B, T]`` dims:
    one value per leading index."""
    logp = torch.log_softmax(logits, dim=-1)
    picked = torch.gather(logp, -1, targets[..., None].long())[..., 0]
    return picked.neg().flatten(-2).mean(dim=-1)


def loss_fn(params, inputs, targets, cfg: ModelConfig, attn_fn=None,
            pos_offset=0, ctx=None):
    """Mean next-token cross-entropy over the local block: a scalar
    without a group, an ``[R]`` tensor (each rank's) with one."""
    logits = forward(params, inputs, cfg, attn_fn=attn_fn,
                     pos_offset=pos_offset, ctx=ctx)
    return nll(logits, targets)

