"""Pipeline parallelism (GPipe microbatching) over a ``pp`` axis of a
device group.

Counterpart of ``pslite_tpu/parallel/pipeline.py``.  The layer stack is
stacked (each leaf gains a leading ``[num_layers, ...]`` dim) and stage
s holds layers ``[s*L/S, (s+1)*L/S)``: the pipeline axis is a key-range
sharding of the layer params.  Microbatches stream through ``M + S - 1``
ticks: stage 0 injects microbatch t, every stage applies its block, the
activations move one stage on (:func:`~pslite_tpu_torch.parallel.mesh.
ppermute`), and the last stage records the microbatch it finished.
Every rank runs each tick at once, on tensors with the leading rank dim
of ``parallel/mesh.py``; autograd carries the cotangents back along the
rotations.
"""

from __future__ import annotations

from typing import Callable

import torch

from . import mesh


def stack_layers(layer_params_list):
    """A list of per-layer param trees -> one tree whose leaves carry a
    leading ``[num_layers, ...]`` dim."""
    first = layer_params_list[0]
    if isinstance(first, dict):
        return {k: stack_layers([p[k] for p in layer_params_list])
                for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_layers([p[i] for p in layer_params_list])
                           for i in range(len(first)))
    return torch.stack(list(layer_params_list), dim=0)


def _ranks_like(mask, x):
    """An ``[R]`` mask shaped to broadcast against ``x`` ``[R, ...]``."""
    return mask.reshape((-1,) + (1,) * (x.dim() - 1))


def pipeline_apply(group, stage_fn: Callable, stage_params, x_micros,
                   axis: str, num_stages: int):
    """Run microbatches through the pipeline.

    ``stage_fn(stage_params, act) -> act`` applies each rank's layer block
    (leaves ``[R, layers_per_stage, ...]``) to per-rank activations
    ``[R, mb, ...]``; ``x_micros`` ``[R, M, mb, ...]`` is replicated over
    the axis (stage 0 consumes it).  Returns ``[R, M, mb, ...]`` finished
    activations, valid on the last stage only (zeros elsewhere)."""
    S = num_stages
    my = mesh.axis_index(group, axis)
    M = x_micros.shape[1]
    act = torch.zeros_like(x_micros[:, 0])
    first = _ranks_like(my == 0, act)
    last = _ranks_like(my == S - 1, act)
    outs = [None] * M
    for t in range(M + S - 1):
        # Stage 0 injects microbatch t (clamped once the pipe drains).
        x = torch.where(first, x_micros[:, min(t, M - 1)], act)
        y = stage_fn(stage_params, x)
        slot = t - (S - 1)  # the last stage finished this microbatch
        if slot >= 0:
            outs[slot] = torch.where(last, y, torch.zeros_like(y))
        act = mesh.ppermute(group, y, axis)
    return torch.stack(outs, dim=1)


def pipeline_loss(group, stage_fn: Callable, loss_fn: Callable,
                  stage_params, head_params, x_micros, axis: str,
                  num_stages: int):
    """Pipelined forward and the last stage's loss, replicated over the
    axis: an ``[R]`` tensor.

    ``loss_fn(head_params, finished) -> [R]`` reads the last stage's
    outputs.  Only the last stage's loss seeds the backward pass: the
    value is summed over the axis outside autograd (JAX's
    ``stop_gradient`` trick, pipeline.py:126-135), so ``autograd.grad`` of
    the ranks' summed losses gives every stage its own layer gradients
    and the last stage the head's."""
    outs = pipeline_apply(group, stage_fn, stage_params, x_micros, axis,
                          num_stages)
    my = mesh.axis_index(group, axis)
    local = loss_fn(head_params, outs)
    masked = torch.where(my == num_stages - 1, local,
                         torch.zeros_like(local))
    frozen = masked.detach()
    return masked + (mesh.psum(group, frozen, axis) - frozen)
