"""Exchange memory between the worker processes of one card.

A :class:`~pslite_tpu_torch.parallel.mesh.DeviceGroup` may span worker
processes (``distributed.global_group``) whose ranks all live on one
card.  Where the JAX package's multi-process mesh moves rows between
hosts over ICI, the processes here share the card's memory: each process
allocates a :class:`PeerSlab` (``cudaMalloc``, outside PyTorch's caching
allocator), exports its IPC handle, and maps every peer's slab through
``cudaIpcOpenMemHandle``; the handles travel over the host plane (gloo).
The engines lay their exchanged rows out in these slabs and the
cross-process kernels read them through plain device addresses
(``ops/ring_collective.py``).

Lifetime.  Creating a slab is a collective with a barrier after the
handle exchange.  A slab that goes out of use (a bucket registered
again, a recut) is retired: this process unmaps its peers' slabs at
once, and frees its own at its next host barrier, after which no peer
maps it any longer (:class:`Retired`).  :meth:`PeerSlab.close`
is the collective teardown.  A refused allocation, export or mapping
raises with the CUDA error; nothing falls back to gloo on a CUDA group.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..ops import ring_collective as ring
from ..utils import logging as log
from . import distributed

ALIGN = 256  # bytes: every region of a slab starts on this boundary


def align(nbytes: int) -> int:
    return -(-int(nbytes) // ALIGN) * ALIGN


class PeerSlab:
    """This process's exchange memory of ``nbytes`` bytes on a
    multi-process CUDA group's card, and every peer's, mapped here.
    Construct it on every process of the group at once (a collective);
    the slabs may differ in size between processes."""

    def __init__(self, group, nbytes: int):
        log.check(group.is_multiprocess and group.device.type == "cuda",
                  "a PeerSlab joins the processes of a CUDA group")
        self.group = group
        self.device = group.device
        self.nbytes = max(int(nbytes), ALIGN)
        self.me = group.process_index
        self.base = ring.ipc_alloc(self.nbytes, self.device)
        self.addrs: Dict[int, int] = {self.me: self.base}
        # Every process's slab size, from the handle exchange.
        self.sizes: Dict[int, int] = {}
        self._opened: List[int] = []
        try:
            handle = ring.ipc_export(self.base, self.device)
            for proc, (h, size) in enumerate(distributed.allgather_object(
                    (handle, self.nbytes))):
                self.sizes[proc] = int(size)
                if proc == self.me or proc not in group.processes:
                    continue
                addr = ring.ipc_open(h, self.device)
                self._opened.append(addr)
                self.addrs[proc] = addr
            distributed.barrier()
        except BaseException:
            self.close_peers()
            ring.ipc_free(self.base, self.device)
            raise

    def addr(self, process: int) -> int:
        """The address, in this process, of ``process``'s slab."""
        return self.addrs[process]

    def view(self, process: int, offset: int, shape,
             dtype: torch.dtype) -> torch.Tensor:
        """A tensor on ``process``'s slab at byte ``offset`` (no copy)."""
        return ring.device_view(self.addrs[process] + int(offset), shape,
                                dtype, self.device)

    def close_peers(self) -> None:
        """Unmap the peers' slabs (local; the peers keep theirs)."""
        opened, self._opened = self._opened, []
        for addr in opened:
            try:
                ring.ipc_close(addr, self.device)
            except RuntimeError as exc:  # the mapping is gone either way
                log.warning(f"closing a peer's slab: {exc}")
        self.addrs = {self.me: self.base}

    def free(self) -> None:
        """Free this process's slab; only once no peer maps it."""
        if self.base:
            base, self.base = self.base, 0
            ring.ipc_free(base, self.device)

    def close(self) -> None:
        """Collective teardown: unmap the peers, barrier, free."""
        self.close_peers()
        distributed.barrier()
        self.free()


class Retired:
    """Slabs out of use, freed at this process's next host barrier."""

    def __init__(self):
        self._slabs: List[PeerSlab] = []

    def retire(self, slab) -> None:
        if slab is None:
            return
        slab.close_peers()
        self._slabs.append(slab)

    def barrier(self) -> None:
        """A host barrier, then free what was retired before it."""
        distributed.barrier()
        slabs, self._slabs = self._slabs, []
        for s in slabs:
            s.free()


def gather_global(local: torch.Tensor, group) -> torch.Tensor:
    """The whole value of a tensor sharded over a multi-process group's
    ranks: every process's part (its ranks' rows) joined in process
    order, on the group's device.  A collective.  On the card the parts
    travel through a transient :class:`PeerSlab` (device to device); on
    a CPU group through ``placement.to_host_global``."""
    from . import placement

    if group.device.type != "cuda":
        return placement.to_host_global(local, True)
    local = local.contiguous()
    shapes = distributed.allgather_object(tuple(local.shape))
    slab = PeerSlab(group, local.numel() * local.element_size())
    try:
        slab.view(slab.me, 0, tuple(local.shape), local.dtype).copy_(local)
        torch.cuda.synchronize(group.device)
        distributed.barrier()
        out = torch.cat([slab.view(p, 0, shapes[p], local.dtype)
                         for p in group.processes])
        torch.cuda.synchronize(group.device)
    finally:
        slab.close()
    return out
