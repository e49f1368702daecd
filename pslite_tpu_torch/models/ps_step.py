"""The PS training cycle over a flat parameter store, on the port's
``CollectiveEngine``.

Counterpart of ``pslite_tpu/models/ps_step.py``.  Every model family that
trains data- or model-parallel through the PS runs the same cycle:

    pull    flat = engine.pull(store)              # JAX: all_gather
    compute loss_r, grad_r on every rank's own copy of the params
    push    engine.push(store, [grad_r], "sgd:lr/n_dev")
            # JAX: psum_scatter, then store - lr * (agg / n_dev)

The flat store is one dense bucket of a 1-D engine over all ``n_dev``
ranks of the group (rank-major, as JAX shards it ``P(axes)``), run with
``impl="ring"``: the push is K4's push-only ring with its fused ``sgd``
handle (``csrc/ring_push_pull.cu``, code 2), the reduce-scatter and the
update in one launch.  It subtracts ``(lr / n_dev) * agg`` where JAX
subtracts ``lr * (agg / n_dev)``, and adds the ranks' rows in the TPU
ring's order where XLA's CPU psum_scatter takes its own: the two agree
to f32 rounding (a few ulps of the update), not bit for bit.

Each rank differentiates its own replica: the step builds ``n_dev``
copies of the pulled vector as the leaves (``[n_dev, n]``), so
``autograd.grad`` of the summed per-rank losses gives row r the gradient
JAX's ``shard_map`` autodiff gives device r (cotangents cross ranks only
through the collectives inside the loss), not their sum.

The flat layout is ``jax.flatten_util.ravel_pytree``'s: dict keys in
sorted order, lists in order (:func:`ravel_pytree`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from ..parallel import mesh
from ..parallel.engine import CollectiveEngine
from ..parallel.mesh import DeviceGroup


def tree_map(fn, tree):
    """``fn`` on every tensor of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves in ``ravel_pytree``'s order: dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def ravel_pytree(tree):
    """``(flat, unravel)``: the leaves concatenated in ``ravel_pytree``'s
    order, and the inverse.  ``unravel`` takes a ``[..., n]`` tensor (any
    leading dims, such as the rank dim) and returns views of it shaped
    ``[..., *leaf_shape]``."""
    leaves = tree_leaves(tree)
    shapes = [tuple(x.shape) for x in leaves]
    sizes = [int(np.prod(s)) for s in shapes]
    flat = torch.cat([x.reshape(-1) for x in leaves]) if leaves else (
        torch.zeros(0))

    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(int).tolist()

    def unravel(v):
        lead = tuple(v.shape[:-1])
        it = iter(range(len(shapes)))

        def build(t):
            if isinstance(t, dict):
                return {k: build(t[k]) for k in sorted(t)}
            if isinstance(t, (list, tuple)):
                return type(t)(build(x) for x in t)
            i = next(it)
            return v[..., offsets[i]:offsets[i + 1]].reshape(
                lead + shapes[i])

        return build(tree)

    return flat, unravel


@dataclass
class FlatStore:
    """The flat parameter store of a step: bucket ``name`` of ``engine``
    (``[padded]``, updated in place by each push; ``set_store_array``
    overwrites it)."""

    engine: CollectiveEngine
    name: str
    n_params: int

    def array(self) -> torch.Tensor:
        """A copy of the ``[padded]`` store."""
        return self.engine.store_array(self.name)


def make_flat_ps_step(group: DeviceGroup, params0, local_loss: Callable,
                      batch_specs: Sequence, lr: float = 0.1):
    """Build the step.

    - ``group``: the ranks (any axes), each rank's data on
      ``group.device``;
    - ``params0``: the initial params tree (it fixes the flat layout);
    - ``local_loss(params, *batch_local) -> [R]``: every rank's loss, with
      per-rank params (leaves ``[R, ...]``) and batch blocks; it may use
      the mesh collectives over the group's axes;
    - ``batch_specs``: one spec per batch argument (a mesh axis or None
      per dim, :func:`~pslite_tpu_torch.parallel.mesh.shard`).

    Returns ``(step, store)``: ``step(*batch) -> loss`` (the mean of the
    ranks' losses, a 0-d tensor on the device) pulls, differentiates and
    pushes once; ``store`` is the :class:`FlatStore`."""
    n_dev = group.num_ranks
    name = "ps_flat"
    flat0, unravel = ravel_pytree(params0)
    n_params = int(flat0.numel())
    engine = CollectiveEngine(DeviceGroup(n_dev, device=group.device),
                              impl="ring")
    engine.register_dense(name, np.arange(1, dtype=np.uint64), n_params,
                          dtype=flat0.dtype, init=flat0)
    handle = f"sgd:{lr / n_dev!r}"
    store = FlatStore(engine, name, n_params)

    def step(*batch):
        local = [mesh.shard(group, torch.as_tensor(b, device=group.device),
                            spec) for b, spec in zip(batch, batch_specs)]
        flat = engine.pull(name)
        leaves = flat.expand(n_dev, n_params).clone().requires_grad_()
        losses = local_loss(unravel(leaves), *local)
        (grads,) = torch.autograd.grad(losses.sum(), leaves)
        engine.push(name, grads, handle=handle)
        return losses.detach().sum() / n_dev

    return step, store
