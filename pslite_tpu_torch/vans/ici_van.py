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
  as the JAX engines do without ``PS_ICI_MULTIHOST``.  A mesh spanning
  processes (``PS_ICI_MULTIHOST=1``, ``parallel/distributed.py``) is
  ROADMAP Queue 1 item 9 and raises on a worker.

A worker whose environment names no scheduler (``DMLC_PS_ROOT_URI``
unset) runs the data plane alone, with no control plane at all:
there is no cluster to join, no barrier to wait for, and a key outside a
registered bucket has no server to go to (``KVWorker`` raises).
"""

from __future__ import annotations

from typing import Optional

from ..parallel.engine import CollectiveEngine
from ..parallel.mesh import DeviceGroup
from ..parallel.sparse import SparseEngine
from .loopback_van import LoopbackVan
from .shm_van import ShmVan
from .tcp_van import TcpVan


class _IciDataPlane:
    """Engine management of the ICI van (mixin over a control plane)."""

    def __init__(self, postoffice):
        super().__init__(postoffice)
        if postoffice.is_worker and self.env.find_int("PS_ICI_MULTIHOST",
                                                      0) == 1:
            raise NotImplementedError(
                "PS_ICI_MULTIHOST=1 (one device group across worker "
                "processes) is not yet ported to pslite_tpu_torch (ROADMAP "
                "Queue 1 item 9: the multi-card data plane)")
        self.engine: Optional[CollectiveEngine] = None
        self.sparse_engine: Optional[SparseEngine] = None
        self._group: Optional[DeviceGroup] = None
        # Without a scheduler address there is no control plane to run.
        self.control_plane = (not postoffice.is_worker
                              or self.env.find("DMLC_PS_ROOT_URI")
                              is not None)

    def set_mesh(self, group: DeviceGroup) -> None:
        """Install a specific device group before start()."""
        self._group = group

    def start(self, customer_id: int = 0) -> None:
        if self.control_plane:
            super().start(customer_id)
        if self.engine is None and self.po.is_worker:
            self.engine = CollectiveEngine(
                group=self._group,
                server_handle=self.env.find("PS_ICI_SERVER_HANDLE", "sum"),
                impl=self.env.find("PS_ICI_IMPL", None),
            )
            self.sparse_engine = SparseEngine(self.engine.group,
                                              self.engine.axis)

    def stop(self) -> None:
        """Drain outstanding device work, then stop the control plane."""
        if self.engine is not None:
            self.engine.block()
        if self.sparse_engine is not None:
            self.sparse_engine.block()
        if self.control_plane:
            super().stop()


class IciVan(_IciDataPlane, LoopbackVan):
    """Collective data plane over the in-process loopback control plane."""


class IciTcpVan(_IciDataPlane, TcpVan):
    """Collective data plane over the socket control plane: bootstrap,
    barriers, heartbeats and the message path ride TCP between OS
    processes, registered buckets the worker's engine."""


class IciShmVan(_IciDataPlane, ShmVan):
    """Collective data plane over the same-host shared-memory van."""
