"""Fixtures and helpers shared by the model tests of pslite_tpu_torch
(``test_torch_models.py``, ``test_torch_model_parallel.py``,
``test_torch_pipeline.py``, ``test_torch_model_zoo.py``).  A test module
imports the fixtures by name, as it does ``_port_loopback_isolation``."""

import jax
import pytest
import torch

from pslite_tpu_torch.parallel import mesh as tm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are small: torch's intra-op threads would only
    contend with the suite's other worker processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def x64():
    """float64 for the JAX side, restored afterwards."""
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", was)


def unshard(group, x: torch.Tensor, spec) -> torch.Tensor:
    """The inverse of ``mesh.shard``: per-rank blocks ``[R, *local]``
    back into the global tensor (a replicated axis reads its first
    rank, as ``out_specs`` without the axis does)."""
    g = tm._split(group, x)
    names, grid = group.axis_names, tm._grid(group)
    local = list(g.shape[len(grid):])
    spec = list(spec) + [None] * (len(local) - len(spec))
    for a in spec:
        if a is not None:
            tm._axis(group, a)
    keep = [i for i, a in enumerate(names) if a in spec]
    index = tuple(slice(None) if i in keep else 0 for i in range(len(grid)))
    g = g[index]
    kept = [names[i] for i in keep]
    # Move each axis's block index in front of its dim and merge.
    order, shape = [], []
    for d, a in enumerate(spec):
        if a is not None:
            order.append(kept.index(a))
            shape.append(grid[names.index(a)] * local[d])
        else:
            shape.append(local[d])
        order.append(len(kept) + d)
    return g.permute(order).reshape(shape)
