"""Expert-parallel MoE layer (EP) over an axis of a device group.

Counterpart of ``pslite_tpu/parallel/moe.py``: a top-1 routed expert
feed-forward whose experts shard blockwise over the axis (rank s owns
experts ``[s*E_local, (s+1)*E_local)``).  Tokens and their routes are
gathered across the axis (the "gather" traffic leg), each rank applies
its own experts to the tokens routed to them (one-hot weights, dense
einsums, no capacity overflow), and a ``psum_scatter`` returns each
rank's contributions to the tokens' owners (the "scatter" leg;
moe.py:87-106).  Tensors carry the leading rank dim of
``parallel/mesh.py``; the single-rank path takes the same shapes with
``group=None``.

Routing is ``argmax`` of the gate logits, the first maximum on a tie (as
``jnp.argmax``); the chosen expert's output is scaled by its softmax
probability, the router's only gradient path.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import mesh


def init_moe_params(gen: torch.Generator, dim: int, hidden: int,
                    num_experts: int, dtype, device="cpu"):
    """JAX's shapes and scales (``N(0, 1) * dim**-0.5``), drawn from
    ``gen``."""
    scale = dim ** -0.5

    def normal(shape):
        return (torch.randn(shape, generator=gen, dtype=torch.float64)
                * scale).to(dtype=dtype, device=device)

    return {
        "gate": normal((dim, num_experts)),
        "w_in": normal((num_experts, dim, hidden)),
        "w_out": normal((num_experts, hidden, dim)),
    }


def moe_ffn(params, x, group=None, axis_name: Optional[str] = None,
            compute_dtype=None):
    """Top-1 routed expert FFN of per-rank ``x`` ``[R, B, T, D]``.

    ``params`` leaves carry the rank dim: ``gate`` ``[R, D, E]`` over the
    global expert ids, ``w_in``/``w_out`` ``[R, E_local, ...]`` the rank's
    experts.  With ``axis_name`` set, tokens route across that axis of
    ``group``; without it every expert runs on the rank's own tokens.
    ``compute_dtype`` (bfloat16 on the models' path) applies to the expert
    einsums, as the dense MLP's matmuls.  ``gelu`` is the tanh
    approximation: ``jax.nn.gelu``'s default (``F.gelu``'s is exact)."""
    R, B, T, D = x.shape
    e_local = params["w_in"].shape[1]
    cdt = compute_dtype or x.dtype

    def experts_apply(xs, weights):
        # xs: [R, N, D]; weights: [R, N, E_local] (gate-prob-scaled one-hot)
        h = torch.einsum("rnd,redh->rneh", xs.to(cdt),
                         params["w_in"].to(cdt)).to(x.dtype)
        h = F.gelu(h, approximate="tanh")
        y = torch.einsum("rneh,rehd->rned", h.to(cdt),
                         params["w_out"].to(cdt)).to(x.dtype)
        return torch.einsum("rned,rne->rnd", y, weights)

    # The gate runs in x's dtype (no cast), as in JAX.
    logits = torch.matmul(x.reshape(R, B * T, D), params["gate"])
    probs = torch.softmax(logits, dim=-1)
    top = torch.argmax(logits, dim=-1)  # [R, N]: the first maximum
    top_p = torch.gather(probs, -1, top[..., None])[..., 0]

    experts = torch.arange(e_local, device=x.device)

    def one_hot(ids):  # F.one_hot checks its range on the host
        return (ids[..., None] == experts).to(x.dtype)

    if axis_name is None:
        weights = one_hot(top) * top_p[..., None]
        return experts_apply(x.reshape(R, B * T, D), weights).reshape(
            R, B, T, D)

    S = mesh.axis_size(group, axis_name)
    my = mesh.axis_index(group, axis_name)  # [R]
    # Gather every rank's tokens and routes (the gather leg).
    xs = mesh.all_gather(group, x.reshape(R, B * T, D), axis_name, 0)
    tops = mesh.all_gather(group, top, axis_name, 0)  # [R, S*N]
    top_ps = mesh.all_gather(group, top_p, axis_name, 0)
    # Rank s owns experts [s*E_local, (s+1)*E_local).
    local_id = tops - my[:, None] * e_local
    mine = (local_id >= 0) & (local_id < e_local)
    weights = (one_hot(torch.where(mine, local_id, 0))
               * (mine.to(x.dtype) * top_ps)[..., None])
    contrib = experts_apply(xs, weights)  # [R, S*N, D], 0 for foreign
    # Contributions back to the tokens' owners (the scatter leg).
    back = mesh.psum_scatter(group, contrib.reshape(R, S, B * T, D),
                             axis_name, 0)  # [R, 1, N, D]
    return back.reshape(R, B, T, D)
