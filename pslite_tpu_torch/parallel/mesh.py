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

Inside a model's step (``models/``), the ranks of a group run the JAX
package's ``shard_map`` bodies all at once.  A per-rank tensor carries
its ranks as a leading rank-major dimension of ``group.num_ranks`` rows
(rank ``r``'s coordinates on the group's axes are ``r``'s row-major
digits), and each collective of ``shard_map`` is a tensor op on that
dimension, acting along one named axis of the rank grid:
:func:`ppermute` is a roll, a tiled :func:`all_gather` a concatenation
(then a broadcast over the axis), :func:`psum_scatter` a sum and a
split, :func:`all_to_all` a transpose, :func:`psum`/:func:`pmean` a
reduction, :func:`axis_index` an ``arange``.  Autograd flows through
these ops as JAX's transposes do (ppermute back by the inverse roll,
all_gather into psum_scatter, psum into psum).  ``dim`` arguments count
the per-rank dims, as the JAX functions' axes do inside ``shard_map``.
:func:`shard` cuts a global array into its per-rank blocks by a
``PartitionSpec``-like tuple.

A group may span worker processes (``owners``: the process that owns
each rank, in process order; ``parallel/distributed.py``'s
``global_group``), every process's ranks on the same card: each process
holds the data of its own ranks only, and the engines reach the other
processes' rows through the card's memory (``parallel/peers.py``).
Groups whose ranks live on several cards are a later slice.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

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
                 axis_name: Union[str, Sequence[str]] = "kv",
                 owners: Optional[Sequence[int]] = None,
                 process_index: int = 0):
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
        # The process that owns each rank (None: this process owns all).
        self.owners: Optional[tuple] = None
        self.process_index = int(process_index)
        if owners is not None:
            owners = tuple(int(p) for p in owners)
            if len(owners) != self.num_ranks:
                raise ValueError(f"{len(owners)} owners for "
                                 f"{self.num_ranks} ranks")
            if list(owners) != sorted(owners) or owners[0] < 0:
                raise ValueError(f"owners {owners!r} are not in process "
                                 f"order")
            if self.process_index not in owners:
                raise ValueError(f"process {self.process_index} owns no "
                                 f"rank of {owners!r}")
            if len(set(owners)) > 1:
                self.owners = owners

    @property
    def is_multiprocess(self) -> bool:
        """Whether the ranks belong to more than one process."""
        return self.owners is not None

    def process_of(self, rank: int) -> int:
        """The process that owns ``rank``."""
        if not 0 <= rank < self.num_ranks:
            raise ValueError(f"rank {rank} not in a group of "
                             f"{self.num_ranks}")
        return self.owners[rank] if self.owners is not None else \
            self.process_index

    def ranks_of(self, process: int) -> range:
        """The ranks ``process`` owns (consecutive, in process order)."""
        if self.owners is None:
            return (range(self.num_ranks) if process == self.process_index
                    else range(0))
        first = self.owners.index(process) if process in self.owners else 0
        return range(first, first + self.owners.count(process))

    @property
    def local_ranks(self) -> range:
        """The ranks this process owns."""
        return self.ranks_of(self.process_index)

    @property
    def processes(self) -> tuple:
        """The processes of the group, in order."""
        if self.owners is None:
            return (self.process_index,)
        return tuple(sorted(set(self.owners)))


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


# -- shard_map's collectives over virtual ranks --------------------------------

def _grid(group: DeviceGroup) -> tuple:
    return tuple(group.shape[a] for a in group.axis_names)


def _axis(group: DeviceGroup, axis: str) -> int:
    if axis not in group.axis_names:
        raise ValueError(f"axis {axis!r} not in the device group "
                         f"{group.axis_names!r}")
    return group.axis_names.index(axis)


def _split(group: DeviceGroup, x: torch.Tensor) -> torch.Tensor:
    """``[R, *local]`` -> ``[*grid, *local]``."""
    if x.dim() < 1 or int(x.shape[0]) != group.num_ranks:
        raise ValueError(f"per-rank tensor needs a leading dim of "
                         f"{group.num_ranks} ranks, got {tuple(x.shape)}")
    return x.reshape(_grid(group) + tuple(x.shape[1:]))


def _merge(group: DeviceGroup, x: torch.Tensor) -> torch.Tensor:
    """``[*grid, *local]`` -> ``[R, *local]``."""
    return x.reshape((group.num_ranks,) + tuple(x.shape[len(group.shape):]))


def _local_dim(x: torch.Tensor, dim: int) -> int:
    """A per-rank dim (negative counts from the end) as a dim of the
    ``[R, *local]`` tensor."""
    nd = x.dim() - 1
    if not -nd <= dim < nd:
        raise ValueError(f"dim {dim} out of range for {nd} per-rank dims")
    return 1 + dim % nd


def axis_size(group: DeviceGroup, axis: str) -> int:
    """``lax.psum(1, axis)``."""
    return int(group.shape[group.axis_names[_axis(group, axis)]])


def axis_index(group: DeviceGroup, axis: str) -> torch.Tensor:
    """``lax.axis_index(axis)`` of every rank: an ``[R]`` int64 tensor."""
    grid = _grid(group)
    a = _axis(group, axis)
    idx = torch.arange(grid[a], device=group.device)
    shape = [1] * len(grid)
    shape[a] = grid[a]
    return idx.reshape(shape).expand(grid).reshape(-1)


def ppermute(group: DeviceGroup, x: torch.Tensor, axis: str,
             shift: int = 1) -> torch.Tensor:
    """``lax.ppermute`` with ``perm = [(i, (i + shift) % S)]``: rank i's
    block moves to rank i + shift along ``axis``."""
    a = _axis(group, axis)
    return _merge(group, torch.roll(_split(group, x), shift, dims=a))


def all_gather(group: DeviceGroup, x: torch.Tensor, axis: str,
               dim: int = 0) -> torch.Tensor:
    """Tiled ``lax.all_gather(x, axis, axis=dim, tiled=True)``: every rank
    along ``axis`` gets the blocks of all of them, concatenated in rank
    order along per-rank dim ``dim``."""
    a, g = _axis(group, axis), _split(group, x)
    d = len(group.shape) + _local_dim(x, dim) - 1
    S = g.shape[a]
    # Move the axis's blocks next to the gathered dim and merge them.
    cat = g.movedim(a, d - 1) if d - 1 != a else g
    shape = list(cat.shape)
    merged = cat.reshape(shape[:d - 1] + [S * shape[d]] + shape[d + 1:])
    return _merge(group, merged.unsqueeze(a).expand(
        *merged.shape[:a], S, *merged.shape[a:]))


def psum_scatter(group: DeviceGroup, x: torch.Tensor, axis: str,
                 dim: int = 0) -> torch.Tensor:
    """Tiled ``lax.psum_scatter(x, axis, scatter_dimension=dim,
    tiled=True)``: the sum over ``axis``, whose chunk i along per-rank dim
    ``dim`` goes to rank i."""
    a, g = _axis(group, axis), _split(group, x)
    S = g.shape[a]
    d = len(group.shape) + _local_dim(x, dim) - 1
    n = g.shape[d]
    if n % S:
        raise ValueError(f"dim of {n} does not split over {S} ranks")
    shape = list(g.shape)
    chunks = g.reshape(shape[:d] + [S, n // S] + shape[d + 1:])
    summed = chunks.sum(dim=a)  # the chunk index sits at d - 1 now
    return _merge(group, summed.movedim(d - 1, a))


def all_to_all(group: DeviceGroup, x: torch.Tensor, axis: str,
               split_dim: int, concat_dim: int) -> torch.Tensor:
    """Tiled ``lax.all_to_all(x, axis, split_axis, concat_axis,
    tiled=True)``: per-rank dim ``split_dim`` is cut into S chunks, chunk
    j goes to rank j, and each rank concatenates what it receives in
    source order along ``concat_dim``."""
    a, g = _axis(group, axis), _split(group, x)
    S = g.shape[a]
    ng = len(group.shape)
    sd = ng + _local_dim(x, split_dim) - 1
    cd = ng + _local_dim(x, concat_dim) - 1
    n = g.shape[sd]
    if n % S:
        raise ValueError(f"dim of {n} does not split over {S} ranks")
    shape = list(g.shape)
    chunks = g.reshape(shape[:sd] + [S, n // S] + shape[sd + 1:])
    # Swap the rank axis with the chunk index: rank j now holds chunk j
    # of every source, indexed by the source where the chunk index was;
    # then the source index goes in front of the concat dim and merges
    # with it (source-major, as the tiled concatenation).
    src = chunks.transpose(a, sd).movedim(sd, cd)
    shape = list(src.shape)
    out = src.reshape(shape[:cd] + [S * shape[cd + 1]] + shape[cd + 2:])
    return _merge(group, out)


def psum(group: DeviceGroup, x: torch.Tensor, axis) -> torch.Tensor:
    """``lax.psum`` over one axis or a tuple of axes: every rank gets
    the sum."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    g = _split(group, x)
    dims = tuple(_axis(group, a) for a in axes)
    return _merge(group, g.sum(dim=dims, keepdim=True).expand(g.shape))


def pmean(group: DeviceGroup, x: torch.Tensor, axis) -> torch.Tensor:
    """``lax.pmean``: the psum divided by the ranks it spans."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    n = int(np.prod([axis_size(group, a) for a in axes]))
    return psum(group, x, axes) / n


def _spec(group: DeviceGroup, x: torch.Tensor, spec) -> list:
    spec = list(spec) + [None] * (x.dim() - len(spec))
    for a in spec:
        if a is not None:
            _axis(group, a)
    used = [a for a in spec if a is not None]
    if len(set(used)) != len(used):
        raise ValueError(f"spec {spec!r} names an axis twice")
    return spec


def shard(group: DeviceGroup, x: torch.Tensor, spec) -> torch.Tensor:
    """A global tensor's per-rank blocks ``[R, *local]`` under ``spec``
    (one mesh axis or None per dim, as a ``PartitionSpec``): a dim named
    by an axis is cut into that axis's blocks, the others are whole, and
    axes the spec leaves out replicate."""
    spec = _spec(group, x, spec)
    shape = []
    for n, a in zip(x.shape, spec):
        if a is None:
            shape.append(int(n))
            continue
        S = axis_size(group, a)
        if n % S:
            raise ValueError(f"dim of {n} does not split over {S} ranks")
        shape += [S, int(n) // S]
    blocks = x.reshape(shape)
    # Where each axis's block index sits in ``blocks``.
    pos, at = {}, 0
    for a in spec:
        if a is not None:
            pos[a] = at
            at += 1
        at += 1
    names = group.axis_names
    order = [pos[a] for a in names if a in pos]
    rest = [i for i in range(blocks.dim()) if i not in order]
    out = blocks.permute(order + rest)
    # Insert and broadcast the replicated axes.
    grid = _grid(group)
    for i, a in enumerate(names):
        if a not in pos:
            out = out.unsqueeze(i)
    out = out.expand(grid + tuple(out.shape[len(grid):]))
    return _merge(group, out)
