"""Placement of staged state onto a device group's device.

Counterpart of ``pslite_tpu/parallel/placement.py``'s
``place_host_array``: the one function through which a reshard's staging
(``CollectiveEngine.reshard_staged``, ``SparseEngine.reshard_staged``)
builds every tensor of the new layout.  It is looked up on this module at
call time, so a test can replace it with one that fails on its N-th call
to play a peer that dies in the middle of a recut.
"""

from __future__ import annotations

from typing import Optional

import torch


def place(value: torch.Tensor, device,
          length: Optional[int] = None) -> torch.Tensor:
    """A fresh contiguous tensor on ``device`` holding ``value``'s rows
    first and zeros after them, ``length`` rows in all (``value``'s own
    row count by default).  A copy on the card when ``value`` is there
    too; the state moves with it otherwise."""
    rows = int(value.shape[0])
    length = rows if length is None else int(length)
    out = torch.zeros((length,) + tuple(value.shape[1:]), dtype=value.dtype,
                      device=device)
    out[:rows] = value
    return out


def mesh_is_multiprocess(group) -> bool:
    """Whether ``group``'s ranks belong to more than one process."""
    return bool(getattr(group, "is_multiprocess", False))


def local_shard_count(group) -> int:
    """Ranks of ``group`` owned by THIS process."""
    return len(group.local_ranks)


def place_host_array(group, host_arr, length: Optional[int] = None,
                     multiprocess: Optional[bool] = None) -> torch.Tensor:
    """Place a (globally known) ``[rows, ...]`` array onto ``group``:
    the whole array on a single-process group, and on a group spanning
    processes the rows of this process's ranks, the array cut into
    ``num_ranks`` equal blocks of rows (``length`` rows in all after
    zero padding, the array's own row count by default).  Goes through
    :func:`place`, looked up at call time."""
    if multiprocess is None:
        multiprocess = mesh_is_multiprocess(group)
    value = host_arr if isinstance(host_arr, torch.Tensor) else \
        torch.as_tensor(host_arr)
    rows = int(value.shape[0])
    length = rows if length is None else int(length)
    if not multiprocess:
        return place(value, group.device, length)
    n = group.num_ranks
    if length % n:
        raise ValueError(f"{length} rows do not split over {n} ranks")
    per = length // n
    lo = group.local_ranks[0] * per
    hi = lo + len(group.local_ranks) * per
    return place(value[lo:min(hi, rows)], group.device, hi - lo)


def to_host_global(arr: torch.Tensor, multiprocess: bool) -> torch.Tensor:
    """The FULL value of a tensor sharded over a group's ranks, as a CPU
    tensor on THIS host.

    Single-process: a copy to the host.  Multi-process: a collective —
    every process of the group calls it on its part of the same tensor,
    in the same order (JAX's ``process_allgather``): each process's rows
    (its ranks' shards) are gathered over the host plane and joined in
    process order."""
    local = arr.detach().to("cpu", copy=True)
    if not multiprocess:
        return local
    from . import distributed

    return torch.cat([torch.as_tensor(p) for p in
                      distributed.allgather_object(local)], dim=0)
