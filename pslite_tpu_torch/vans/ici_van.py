"""ICI vans — the collective data plane nesting a control plane.

Counterpart of ``pslite_tpu/vans/ici_van.py``: ``IciVan(_IciDataPlane,
LoopbackVan)`` (``:223``), ``IciTcpVan(_IciDataPlane, TcpVan)`` and
``IciShmVan(_IciDataPlane, ShmVan)`` (``:227-241``), the FabricVan
pattern of a data plane riding a nested control plane.

- **Control plane**: the loopback van in one process, or the socket
  (shared-memory) van between processes — scheduler bootstrap, ranks,
  barriers, heartbeats, and the message path on which ``KVWorker``
  sends every key outside a registered bucket to the servers.
- **Data plane**: on worker instances only (``:83``), a
  :class:`CollectiveEngine` from ``PS_ICI_SERVER_HANDLE`` and
  ``PS_ICI_IMPL`` (``xla``/``pallas`` keep their JAX meanings: the torch
  path and the ring kernel) and, on the same group and axis, a
  :class:`SparseEngine` (``sparse_engine``).  ``set_mesh`` installs a
  device group before ``start`` (tests pass a CPU group; by default the
  engine takes ``default_group()``, the card).  Scheduler and server
  instances build no engine and touch no device.
- **One process per card's group**: each worker process of an
  ``ici_tcp``/``ici_shm`` cluster runs its own engine on its own group,
  as the JAX engines do without ``PS_ICI_MULTIHOST``.
- **One group across processes** (``PS_ICI_MULTIHOST=1``): each worker
  process takes a lease on the ``torch.distributed`` group
  (``parallel/distributed.py``, coordinator derived from the same
  ``DMLC_*`` variables, ``DMLC_RANK`` per worker) and builds its engines
  on ``global_group()`` (every process's ranks, on one card), or on the
  group ``set_mesh`` installed.  Worker processes then drive registered
  buckets and tables in SPMD lockstep (same ops, same order), as JAX's
  multi-host contract has it.  The lease is released, after the engines
  free their exchange memory, when the van stops.
- **Elastic recut**: ``reshard_engines`` (``KVWorker.reshard``) moves a
  worker's engines onto a new group between WORKER_GROUP barriers, each
  worker process recutting its own engines.

A worker whose environment names no scheduler (``DMLC_PS_ROOT_URI``
unset) runs the data plane alone, with no control plane at all:
there is no cluster to join, no barrier to wait for, and a key outside a
registered bucket has no server to go to (``KVWorker`` raises).
"""

from __future__ import annotations

import os
from typing import Optional

from ..base import WORKER_GROUP
from ..parallel import distributed
from ..parallel.engine import CollectiveEngine
from ..parallel.mesh import DeviceGroup
from ..parallel.sparse import SparseEngine
from ..utils import logging as log
from .loopback_van import LoopbackVan
from .shm_van import ShmVan
from .tcp_van import TcpVan


class _IciDataPlane:
    """Engine management of the ICI van (mixin over a control plane)."""

    def __init__(self, postoffice):
        super().__init__(postoffice)
        self.engine: Optional[CollectiveEngine] = None
        self.sparse_engine: Optional[SparseEngine] = None
        self._group: Optional[DeviceGroup] = None
        self._dist_lease = False
        # Without a scheduler address there is no control plane to run.
        self.control_plane = (not postoffice.is_worker
                              or self.env.find("DMLC_PS_ROOT_URI")
                              is not None)

    def set_mesh(self, group: DeviceGroup) -> None:
        """Install a specific device group before start()."""
        self._group = group

    def _multihost(self) -> bool:
        return self.env.find_int("PS_ICI_MULTIHOST", 0) == 1

    def _make_group(self) -> Optional[DeviceGroup]:
        """The engines' group: ``set_mesh``'s, else under
        ``PS_ICI_MULTIHOST=1`` the global group (after joining the
        process group, lease-counted), else None (the engine's
        default)."""
        if self._multihost():
            self._dist_lease = distributed.acquire(self.env)
            if self._group is None:
                return distributed.global_group()
        return self._group

    def start(self, customer_id: int = 0) -> None:
        if self.control_plane:
            super().start(customer_id)
        if self.engine is None and self.po.is_worker:
            # The van's profiler: ENABLE_PROFILING covers the kernel
            # path too (reference: van.cc:29-77, 440-457).
            self.engine = CollectiveEngine(
                group=self._make_group(),
                server_handle=self.env.find("PS_ICI_SERVER_HANDLE", "sum"),
                impl=self.env.find("PS_ICI_IMPL", None),
                profiler=self.profiler,
            )
            self.sparse_engine = SparseEngine(self.engine.group,
                                              self.engine.axis,
                                              profiler=self.profiler)

    def reshard_engines(self, group: DeviceGroup,
                        customer_id: int = 0) -> None:
        """Cluster-coordinated elastic recut of this worker's engines onto
        ``group`` (JAX ``_IciDataPlane.reshard_engines``).  Every worker
        of the cluster calls it with the same new group; each recuts its
        own engines (one worker process, one group) between WORKER_GROUP
        barriers, so no registered op runs anywhere during a recut and no
        worker resumes before every worker has finished.

        The sequence: the cheap invariants are checked first (a worker
        failing them would otherwise wedge its peers); an entry barrier;
        both engines stage (``reshard_staged``: everything fallible); a
        commit barrier; both commit; a resume barrier.  Each barrier
        waits ``PS_RESHARD_TMO_S`` seconds (default 900, 0 = forever).

        A peer may die at any moment:

        - before the entry barrier: the others time out there and raise
          with their engines untouched;
        - during staging: a process whose staging failed sends no further
          barrier request (barrier rounds are anonymous counts: a stray
          request would release the others' commit barrier), so its peers
          time out at the commit barrier, drop their staged state, and the
          whole cluster stays on the old group together; stores are never
          torn and the engine pair never diverges;
        - after the commit, before the resume barrier: every survivor
          holds the same committed state on the new group, and the resume
          barrier's timeout raises to report the cluster degraded."""
        log.check(self.engine is not None,
                  "reshard_engines: no engine (worker-only, after start)")
        self.engine._layout(group, self.engine.axis)  # checks both axes
        log.check(self.sparse_engine.axis in group.axis_names,
                  f"axis {self.sparse_engine.axis!r} not in the new group")
        tmo = float(os.environ.get("PS_RESHARD_TMO_S", "900")) or None
        self.po.barrier(customer_id, WORKER_GROUP, timeout_s=tmo)
        staged = done = False
        try:
            with self.engine.reshard_staged(group) as commit_dense, \
                    self.sparse_engine.reshard_staged(group) as commit_sp:
                staged = True
                try:
                    self.po.barrier(customer_id, WORKER_GROUP, timeout_s=tmo)
                except log.CheckError:
                    raise log.CheckError(
                        "a peer failed to stage the recut (commit barrier "
                        "timeout) — aborted together on the old group"
                    ) from None
                commit_dense()
                commit_sp()
            done = True
        finally:
            # A process whose staging failed stays silent (see above); the
            # others' commit-abort error wins at the resume barrier.
            if staged:
                try:
                    self.po.barrier(customer_id, WORKER_GROUP, timeout_s=tmo)
                except Exception:  # noqa: BLE001 - degraded report
                    if done:
                        raise log.CheckError(
                            "reshard completed on this process but a peer "
                            "did not reach the resume barrier — cluster "
                            "degraded; recover the dead rank before further "
                            "collective ops"
                        ) from None

    def stop(self) -> None:
        """Drain outstanding device work, free the engines' exchange
        memory (a collective across processes), then stop the control
        plane."""
        if self.engine is not None:
            self.engine.block()
            self.engine.close()
        if self.sparse_engine is not None:
            self.sparse_engine.block()
            self.sparse_engine.close()
        if self.control_plane:
            super().stop()

    def stop_transport(self) -> None:
        super().stop_transport()
        if self._dist_lease:
            self._dist_lease = False
            distributed.release()


class IciVan(_IciDataPlane, LoopbackVan):
    """Collective data plane over the in-process loopback control plane."""


class IciTcpVan(_IciDataPlane, TcpVan):
    """Collective data plane over the socket control plane: bootstrap,
    barriers, heartbeats and the message path ride TCP between OS
    processes, registered buckets the worker's engine."""


class IciShmVan(_IciDataPlane, ShmVan):
    """Collective data plane over the same-host shared-memory van."""
