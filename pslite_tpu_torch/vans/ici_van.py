"""IciVan — the data plane of a worker (dense and sparse), on a device group.

Counterpart of ``pslite_tpu/vans/ici_van.py``'s ``_IciDataPlane``
(``:46-98``): ``set_mesh`` installs a device group before ``start``, and
``start`` builds the worker's :class:`CollectiveEngine` from
``PS_ICI_SERVER_HANDLE`` and ``PS_ICI_IMPL`` (``xla``/``pallas`` keep
their JAX meanings: the torch path and the ring kernel) and, on the same
group and axis, its :class:`SparseEngine` (``sparse_engine``).

This van carries the data plane only.  The message control plane of
the JAX van family (scheduler bootstrap, barriers, heartbeats and the
message path for unregistered keys) is not in this slice, so there is
nothing to connect to and nothing to send.
"""

from __future__ import annotations

from typing import Optional

from ..parallel.engine import CollectiveEngine
from ..parallel.mesh import DeviceGroup
from ..parallel.sparse import SparseEngine


class IciVan:
    def __init__(self, postoffice):
        self.po = postoffice
        self.env = postoffice.env
        self.engine: Optional[CollectiveEngine] = None
        self.sparse_engine: Optional[SparseEngine] = None
        self._group: Optional[DeviceGroup] = None

    def set_mesh(self, group: DeviceGroup) -> None:
        """Install a specific device group before start() (tests pass a
        CPU group; by default the engine takes ``default_group()``)."""
        self._group = group

    def start(self, customer_id: int = 0) -> None:
        if self.engine is None and self.po.is_worker:
            self.engine = CollectiveEngine(
                group=self._group,
                server_handle=self.env.find("PS_ICI_SERVER_HANDLE", "sum"),
                impl=self.env.find("PS_ICI_IMPL", None),
            )
            self.sparse_engine = SparseEngine(self.engine.group,
                                              self.engine.axis)

    def stop(self) -> None:
        if self.engine is not None:
            self.engine.block()
        if self.sparse_engine is not None:
            self.sparse_engine.block()
