"""PS-integrated training steps for PSFormer.

Counterpart of ``pslite_tpu/models/train.py``:

- :func:`make_ps_train_step`: one step over a ``(dp, sp)`` group through
  the flat-store PS cycle (``ps_step.py``): pull, forward and backward
  with sequence parallelism over ``sp`` (ring attention or Ulysses),
  tensor parallelism on the same axis, or expert parallelism for MoE
  configs, then K4's ring push with the fused SGD update.
- :func:`make_pp_train_step`: GPipe pipeline parallelism over the
  group's last axis, optionally data parallel over a leading ``dp``
  axis; each stage owns its layers' key range and updates them with
  plain tensor SGD (plain XLA in JAX).
- :func:`kv_train_loop`: the toy LM over the message-path PS
  (``KVWorker``), with ``register_bucket`` codecs on the pushes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import mesh
from ..parallel.mesh import DeviceGroup, resolve_device
from ..parallel.pipeline import pipeline_loss, stack_layers
from ..parallel.ring_attention import reference_attention, ring_attention
from ..parallel.ulysses import ulysses_attention
from .ps_step import make_flat_ps_step, ravel_pytree, tree_map
from .transformer import (ModelConfig, ParallelCtx, _layer_fn, _mm,
                          _rmsnorm, embed_lookup, init_params, loss_fn, nll,
                          positions)


def _check_model_axis(cfg: ModelConfig, sp: int) -> None:
    # Non-divisible shardings would drop feature columns or experts.
    if cfg.moe_experts:
        if cfg.moe_experts % sp != 0:
            raise ValueError(
                f"moe_experts={cfg.moe_experts} must divide evenly over the "
                f"{sp}-way model axis")
    elif (cfg.mlp_ratio * cfg.dim) % sp != 0:
        raise ValueError(
            f"mlp hidden width {cfg.mlp_ratio * cfg.dim} must divide evenly "
            f"over the {sp}-way model axis")


def make_ps_train_step(cfg: ModelConfig, group: DeviceGroup, lr: float = 0.1,
                       seed: int = 0, sp_strategy: str = "ring"):
    """Returns ``(step, store)``: ``step(inputs, targets) -> loss`` on
    ``[B, T]`` int token arrays (cut into ``(dp, sp)`` blocks: the group's
    first and last axes), ``store`` the :class:`~pslite_tpu_torch.models.
    ps_step.FlatStore` (params from ``init_params`` of a generator seeded
    with ``seed``).

    ``sp_strategy``: ``"ring"`` (k/v blocks rotate) or ``"ulysses"`` (two
    all-to-alls; needs heads % sp == 0).  The model axis carries sequence
    parallelism, tensor parallelism and, for MoE configs, expert
    parallelism at once."""
    axes = tuple(group.axis_names)
    sp_axis = axes[-1]
    sp = group.shape[sp_axis]
    _check_model_axis(cfg, sp)
    if sp_strategy not in ("ring", "ulysses"):
        raise ValueError(f"unknown sp_strategy {sp_strategy!r}")
    if sp_strategy == "ulysses" and cfg.heads % sp != 0:
        raise ValueError(
            f"ulysses needs heads ({cfg.heads}) divisible by the "
            f"{sp}-way sequence axis")
    attn = ring_attention if sp_strategy == "ring" else ulysses_attention
    params0 = init_params(torch.Generator().manual_seed(seed), cfg,
                          device=group.device)
    sp_idx = mesh.axis_index(group, sp_axis)

    def _local_loss(params, inp_l, tgt_l):
        ctx = ParallelCtx(
            attn_fn=lambda q, k, v: attn(group, q, k, v, sp_axis,
                                         causal=True),
            pos_offset=sp_idx * inp_l.shape[2],
            tp_axis=None if cfg.moe_experts else sp_axis,
            ep_axis=sp_axis if cfg.moe_experts else None,
            group=group,
        )
        return loss_fn(params, inp_l, tgt_l, cfg, ctx=ctx)

    token_spec = (axes[0], sp_axis)
    return make_flat_ps_step(group, params0, _local_loss,
                             [token_spec, token_spec], lr=lr)


def _causal(q, k, v):
    return reference_attention(q, k, v, causal=True)


def make_pp_train_step(cfg: ModelConfig, group: DeviceGroup, lr: float = 0.1,
                       num_micro: int = 4, seed: int = 0):
    """PS training step with pipeline parallelism over the group's last
    axis (and data parallelism over a leading ``dp`` axis).

    Each stage owns the key range of its layer block and applies SGD to
    it locally; the replicated head (``embed``, ``ln_f``) is a
    fully-replicated bucket: its gradients are summed over pp (only the
    last stage and, for ``embed``, stage 0 hold any), then averaged over
    dp with the layers' (train.py:228-234).

    Returns ``(step, state)`` with ``state = (stacked_layers, head)``
    (leaves ``[layers, ...]`` and the head's, on ``group.device``);
    ``step(state, inputs, targets) -> (state, loss)`` on int tokens
    ``[dp, M, mb, T]`` (``[M, mb, T]`` without dp)."""
    axes = tuple(group.axis_names)
    pp_axis = axes[-1]
    S = group.shape[pp_axis]
    dp_axis = axes[0] if len(axes) > 1 else None
    if cfg.layers % S != 0:
        raise ValueError(
            f"layers={cfg.layers} must divide over the {S}-stage pipeline")
    if cfg.moe_experts:
        raise ValueError("pp step supports dense layers only for now")

    params0 = init_params(torch.Generator().manual_seed(seed), cfg,
                          device=group.device)
    state0 = (stack_layers(params0["layers"]),
              {"embed": params0["embed"], "ln_f": params0["ln_f"]})
    R = group.num_ranks
    my_pp = mesh.axis_index(group, pp_axis)
    zero = torch.zeros(R, dtype=torch.int64, device=group.device)
    lps = cfg.layers // S
    dev = group.device

    def _embed(head, tokens):
        # tokens [R, M, mb, T]: positions 0..T-1 in every microbatch.
        x = embed_lookup(head["embed"], tokens)
        T = x.shape[-2]
        pe = positions(zero, T, cfg.dim, x.dtype, dev)  # [R, T, D]
        return x + pe[:, None, None]

    def _stage_fn(stage_layers, x):
        # A dense layer over each rank's whole microbatch sequence, the
        # arithmetic of JAX's _one_layer (train.py:158-184).
        for i in range(lps):
            x = _layer_fn({k: v[:, i] for k, v in stage_layers.items()},
                          x, ParallelCtx(), cfg, _causal)
        return x

    def _head_loss(head, outs, tgt):
        # outs [R, M, mb, T, D]; the head always computes in bf16.
        x = _rmsnorm(outs, head["ln_f"])
        logits = _mm(x, head["embed"].transpose(1, 2),
                     torch.bfloat16).float()
        return nll(logits.flatten(1, 2), tgt.flatten(1, 2))

    def _rank_copies(tree, pick):
        return tree_map(lambda p: pick(p.detach()).clone()
                        .requires_grad_(), tree)

    def step(state, inputs, targets):
        stacked, head = state
        inputs = torch.as_tensor(inputs, device=dev)
        targets = torch.as_tensor(targets, device=dev)
        spec = (dp_axis,) if dp_axis is not None else ()
        inp_l = mesh.shard(group, inputs, spec)
        tgt_l = mesh.shard(group, targets, spec)
        if dp_axis is not None:
            inp_l, tgt_l = inp_l[:, 0], tgt_l[:, 0]
        # Per-rank copies: stage s's block of the layers, the head.
        sl = _rank_copies(stacked, lambda p: p.reshape(
            (S, lps) + tuple(p.shape[1:]))[my_pp])
        hr = _rank_copies(head, lambda p: p.expand((R,) + tuple(p.shape)))
        loss = pipeline_loss(group, _stage_fn,
                             lambda h, outs: _head_loss(h, outs, tgt_l),
                             sl, hr, _embed(hr, inp_l), pp_axis, S)
        keys_sl, keys_hr = sorted(sl), sorted(hr)
        grads = torch.autograd.grad(
            loss.sum(), [sl[k] for k in keys_sl] + [hr[k] for k in keys_hr])
        g_sl = dict(zip(keys_sl, grads[:len(keys_sl)]))
        g_hr = {k: mesh.psum(group, g, pp_axis)
                for k, g in zip(keys_hr, grads[len(keys_sl):])}
        loss = loss.detach()
        if dp_axis is not None:
            g_sl = {k: mesh.pmean(group, g, dp_axis) for k, g in g_sl.items()}
            g_hr = {k: mesh.pmean(group, g, dp_axis) for k, g in g_hr.items()}
            loss = mesh.pmean(group, loss, dp_axis)
        # Per-stage SGD, then one copy of each stage's block and the head
        # (every dp replica holds the same values after the pmean).
        first_dp = torch.arange(S, device=dev)  # ranks (dp 0, stage s)
        new_sl = {k: (sl[k].detach() - lr * g)[first_dp].reshape(
            stacked[k].shape) for k, g in g_sl.items()}
        new_hr = {k: (hr[k].detach() - lr * g)[0] for k, g in g_hr.items()}
        return (new_sl, new_hr), loss[0]

    return step, state0


def kv_train_loop(worker, cfg: ModelConfig, steps: int = 30,
                  lr: float = 0.5, batch: int = 8, seq: int = 16,
                  codec=None, pull_codec="raw", seed: int = 0,
                  data_seed: int = 1, val_len: int = 1024, device="cuda"):
    """Train the toy LM over the message-path PS: the flat parameter
    vector lives in the servers' KV store, and each step pulls it,
    computes the gradient on ``device`` and pushes ``-lr * grad`` as the
    delta (train.py:268-330).  ``codec`` compresses the pushes through the
    registered bucket (``register_bucket``), ``pull_codec`` the pulls;
    the initial params always travel raw, so runs that differ only in
    the codec start from the same state (``init_params`` of a generator
    seeded with ``seed``).  Returns the per-step losses."""
    dev = resolve_device(device)
    params0 = init_params(torch.Generator().manual_seed(seed), cfg)
    flat0, unravel = ravel_pytree(params0)
    dt = flat0.dtype
    flat0 = flat0.detach().cpu().numpy().astype(np.float32)
    n = flat0.size
    pad = (-n) % val_len
    flat_pad = np.concatenate([flat0, np.zeros(pad, np.float32)])
    keys = np.arange(flat_pad.size // val_len, dtype=np.uint64)

    inputs, targets = toy_batch(cfg, batch, seq, seed=data_seed)
    inp = torch.as_tensor(inputs, device=dev)
    tgt = torch.as_tensor(targets, device=dev)
    worker.wait(worker.push(keys, flat_pad, codec="raw"))
    worker.register_bucket(keys, codec=codec)
    buf = np.empty_like(flat_pad)
    losses = []
    for _ in range(steps):
        worker.wait(worker.pull(keys, buf, codec=pull_codec))
        flat = torch.as_tensor(buf, device=dev).to(dt).requires_grad_()
        loss = loss_fn(unravel(flat[:n]), inp, tgt, cfg)
        # The gradient of the padded vector: its pad tail is exactly 0.
        (g,) = torch.autograd.grad(loss, flat)
        worker.wait(worker.push(
            keys, (-lr) * g.detach().float().cpu().numpy()))
        losses.append(float(loss.detach()))
    return losses


def toy_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 1):
    """Deterministic toy LM data: predict (token + 1) mod vocab."""
    rng = np.random.default_rng(seed)
    inputs = rng.integers(0, cfg.vocab, size=(batch, seq)).astype(np.int32)
    targets = (inputs + 1) % cfg.vocab
    return inputs, targets
