"""Placement of staged state onto a device group's device.

Counterpart of ``pslite_tpu/parallel/placement.py``'s
``place_host_array``: the one function through which a reshard's staging
(``CollectiveEngine.reshard_staged``, ``SparseEngine.reshard_staged``)
builds every tensor of the new layout.  It is looked up on this module at
call time, so a test can replace it with one that fails on its N-th call
to play a peer that dies in the middle of a recut.

On a group spanning worker processes, :class:`DenseLayout` says where a
dense bucket lives: which pieces of the store each process holds, which
grads rows it writes, and which rows each piece sums.
:func:`shard_replicas` gives the sparse engine the same rank arithmetic
for a table on an N-D group.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
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


def shard_replicas(group, kv_axes: Sequence[str]) -> Tuple[np.ndarray,
                                                          np.ndarray]:
    """``(shard, replica)`` of every rank of ``group``, as int64 arrays:
    a rank's shard is the row-major index of its coordinates over
    ``kv_axes`` (in that order, as ``P(("kv1", "kv2"))`` lays a store
    out), its replica the row-major index over the group's other axes (in
    the group's order).  The ranks of one replica hold every shard once:
    the JAX programs run each replica's collectives over the kv axes
    alone."""
    names = tuple(group.axis_names)
    sizes = tuple(int(group.shape[a]) for a in names)
    coords = np.unravel_index(np.arange(group.num_ranks), sizes)
    pos = {a: i for i, a in enumerate(names)}

    def ravel(axes):
        if not axes:
            return np.zeros(group.num_ranks, dtype=np.int64)
        return np.ravel_multi_index([coords[pos[a]] for a in axes],
                                    [sizes[pos[a]] for a in axes]
                                    ).astype(np.int64)

    others = [a for a in names if a not in kv_axes]
    return ravel(list(kv_axes)), ravel(others)


class Piece(NamedTuple):
    """A piece of a bucket's store held by one rank: elements ``[start,
    start + length)`` of the bucket, at element ``local`` of its owner
    process's store."""

    rank: int
    start: int
    length: int
    local: int


class DenseLayout:
    """Where a ``[padded]`` dense bucket lives on a group spanning
    processes (the counterpart of the JAX store's sharding there).

    - 1-D family (``worker_axis`` None): the store shards over the kv
      axes (S shards of ``padded / S``); rank r holds shard ``s(r)`` of
      its replica ``g(r)`` (:func:`shard_replicas`) and writes one grads
      row, the worker row of shard s(r) in replica g(r).  The piece of r
      sums the S rows of its replica, in shard order.  On a 1-D group
      every rank is its own shard of the one replica: process p holds
      the contiguous chunks of its ranks.
    - 2-D (``worker_axis``): the store is B kv shards of ``period``
      values, each cut into A sub-chunks of ``sub`` values (the ring
      geometry); rank (d, k) holds sub-chunk d of shard k, so every value
      is held once.  The grads are the A global ``dp`` rows, row a
      written by the process of the first rank on dp index a, and every
      piece sums all A of them.

    ``pieces[p]`` lists process p's pieces in its rank order, back to
    back in its store (``local``); ``slots[p]`` the row ids it writes
    (ranks, or dp indices on 2-D), one slot each; ``rows_of(piece)`` the
    row ids a piece sums, in ring order."""

    def __init__(self, group, kv_axes: Sequence[str],
                 worker_axis: Optional[str], padded: int,
                 sub: Optional[int] = None):
        self.group = group
        self.padded = int(padded)
        self.kv = worker_axis is not None
        shard, replica = shard_replicas(group, kv_axes)
        self.num_shards = int(np.prod([group.shape[a] for a in kv_axes]))
        pieces: Dict[int, List[Piece]] = {p: [] for p in group.processes}
        self.slots: Dict[int, List[int]] = {p: [] for p in group.processes}
        self._rows: Dict[int, tuple] = {}
        if not self.kv:
            S = self.num_shards
            chunk = self.padded // S
            rank_at = {(int(g), int(s)): r for r, (s, g) in
                       enumerate(zip(shard, replica))}
            for r in range(group.num_ranks):
                p = group.process_of(r)
                self._rows[r] = tuple(rank_at[(int(replica[r]), w)]
                                      for w in range(S))
                self.slots[p].append(r)
                pieces[p].append((r, int(shard[r]) * chunk, chunk))
            self._replica = replica
        else:
            names = tuple(group.axis_names)
            dp = np.unravel_index(
                np.arange(group.num_ranks),
                tuple(int(group.shape[a]) for a in names))[
                    names.index(worker_axis)]
            A = int(group.shape[worker_axis])
            period = self.padded // self.num_shards
            sub = int(sub)
            for r in range(group.num_ranks):
                p = group.process_of(r)
                d, k = int(dp[r]), int(shard[r])
                lo = min(d * sub, period)
                pieces[p].append((r, k * period + lo,
                                  min(sub, period - lo)))
                self._rows[r] = tuple(range(A))
            for a in range(A):
                first = int(np.flatnonzero(dp == a)[0])
                self.slots[group.process_of(first)].append(a)
            self._replica = np.zeros(group.num_ranks, dtype=np.int64)
        self.pieces: Dict[int, List[Piece]] = {}
        for p, parts in pieces.items():
            out, local = [], 0
            for r, start, length in parts:
                out.append(Piece(r, start, length, local))
                local += length
            self.pieces[p] = out
        self.slot_at = {row: (p, i) for p, rows in self.slots.items()
                        for i, row in enumerate(rows)}

    def rows_of(self, piece: Piece) -> tuple:
        return self._rows[piece.rank]

    def local_len(self, process: int) -> int:
        return sum(pc.length for pc in self.pieces[process])

    def full(self, process: int) -> List[Piece]:
        """The pieces whose values make the whole bucket as ``process``
        reads it (its first rank's replica), in bucket order."""
        if self.kv:
            parts = [pc for ps in self.pieces.values() for pc in ps]
        else:
            g = self._replica[self.group.ranks_of(process)[0]]
            parts = [pc for ps in self.pieces.values() for pc in ps
                     if self._replica[pc.rank] == g]
        return sorted((pc for pc in parts if pc.length),
                      key=lambda pc: pc.start)

    def runs(self, process: int) -> List[Tuple[tuple, List[tuple]]]:
        """``process``'s non-empty pieces grouped by the rows they sum:
        ``[(row ids, [(start, length, local), ...]), ...]``, neighbouring
        pieces (contiguous in the bucket and in the store) merged."""
        out: Dict[tuple, List[list]] = {}
        for pc in self.pieces[process]:
            if not pc.length:
                continue
            segs = out.setdefault(self.rows_of(pc), [])
            if segs and segs[-1][0] + segs[-1][1] == pc.start and \
                    segs[-1][2] + segs[-1][1] == pc.local:
                segs[-1][1] += pc.length
            else:
                segs.append([pc.start, pc.length, pc.local])
        return [(rows, [tuple(s) for s in segs]) for rows, segs in
                out.items()]

    def local_of(self, full: torch.Tensor, process: int) -> torch.Tensor:
        """``process``'s pieces of a whole ``[padded]`` value, back to
        back (a fresh tensor)."""
        parts = [full[pc.start:pc.start + pc.length]
                 for pc in self.pieces[process]]
        if not parts:
            return full[:0].clone()
        return torch.cat(parts)

    def assemble(self, locals_: Dict[int, torch.Tensor],
                 process: int) -> torch.Tensor:
        """The whole ``[padded]`` value as ``process`` reads it, from
        every process's local pieces (``locals_[p]``)."""
        ref = locals_[process]
        full = torch.zeros(self.padded, dtype=ref.dtype, device=ref.device)
        for pc in self.full(process):
            src = locals_[self.group.process_of(pc.rank)]
            full[pc.start:pc.start + pc.length] = \
                src[pc.local:pc.local + pc.length].to(ref.device)
        return full
