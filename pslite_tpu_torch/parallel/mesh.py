"""Device groups: the counterpart of the JAX package's meshes.

``pslite_tpu/parallel/mesh.py`` builds a ``jax.sharding.Mesh`` whose
``kv`` axis is both the worker fan-in and the server key-range sharding
(the reference's colocated deployment, ``ps.h:59-76``), or an N-D mesh
(``make_mesh``, :52-60) whose ``dp`` axis carries the workers and whose
``kv`` axis carries the shards.  Here a :class:`DeviceGroup` names its
axes and their sizes, and places every rank on ONE torch device
("virtual ranks"), the way the JAX tests run 8 virtual CPU devices.  The
engine keeps the shards of a store in one allocation on that device; the
ring kernel treats the rows of a grads tensor as the workers'
contributions.

Groups whose ranks live on several cards are a later slice.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """A torch device for ``device``; CUDA devices must exist.

    The port never drops to the CPU silently: asking for CUDA on a host
    without a card raises, and the CPU is used only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            f"pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


class DeviceGroup:
    """Logical ranks on one device, along one or more named axes.

    ``DeviceGroup(8)`` is 8 ranks along ``kv``; ``DeviceGroup((4, 2),
    axis_name=("dp", "kv"))`` (or :func:`make_group`) is a 4 x 2 grid.
    Exposes the slice of ``jax.sharding.Mesh`` that the engine reads:
    ``shape[axis]``, ``axis_names`` and the ``device`` that holds every
    rank's data."""

    def __init__(self, num_ranks: Union[int, Sequence[int]], device="cuda",
                 axis_name: Union[str, Sequence[str]] = "kv"):
        sizes = ((int(num_ranks),) if isinstance(num_ranks, (int, np.integer))
                 else tuple(int(s) for s in num_ranks))
        names = ((axis_name,) if isinstance(axis_name, str)
                 else tuple(axis_name))
        if len(sizes) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"axis names {names!r} do not match the shape "
                             f"{sizes!r}")
        if not sizes or min(sizes) < 1:
            raise ValueError(f"every axis needs >= 1 rank, got {sizes!r}")
        self.num_ranks = int(np.prod(sizes))
        self.device = resolve_device(device)
        self.axis_names = names
        self.shape = dict(zip(names, sizes))


def make_group(shape: Sequence[int], axis_names: Sequence[str],
               device="cuda") -> DeviceGroup:
    """N-D group with the given per-axis sizes (the counterpart of
    ``make_mesh``); every rank lives on ``device``."""
    return DeviceGroup(tuple(shape), device=device,
                       axis_name=tuple(axis_names))


def default_group(axis_name: str = "kv") -> DeviceGroup:
    """One rank per visible CUDA device (the counterpart of
    ``default_mesh``).  In this slice every rank's data lives on the
    first card; raises when no card is visible."""
    resolve_device("cuda")
    return DeviceGroup(torch.cuda.device_count(), device="cuda:0",
                       axis_name=axis_name)
