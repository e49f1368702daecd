"""Van transport family.

Counterpart of ``pslite_tpu/vans/__init__.py``'s factory (the
reference's ``src/van.cc:43-104``): ``loopback`` (in-process) and
``ici`` (the collective data plane nesting the loopback control plane)
are ported; the socket and shared-memory vans raise
``NotImplementedError`` naming ROADMAP Queue 1 item 3 (the chaos
wrapper item 8); an unknown name raises ``ValueError``.
"""

from __future__ import annotations

_NOT_PORTED = ("tcp", "zmq", "0", "", "shm", "multi", "multivan", "ici_tcp",
               "ici+tcp", "xla", "ici_shm", "ici+shm")


def create(van_type: str, postoffice):
    if van_type == "loopback":
        from .loopback_van import LoopbackVan

        return LoopbackVan(postoffice)
    if van_type == "ici":
        from .ici_van import IciVan

        return IciVan(postoffice)
    if van_type == "chaos" or van_type.startswith("chaos+"):
        raise NotImplementedError(
            f"van {van_type!r} is not yet ported to pslite_tpu_torch "
            f"(ROADMAP Queue 1 item 8: the chaos wrapper)")
    if van_type in _NOT_PORTED:
        raise NotImplementedError(
            f"van {van_type!r} is not yet ported to pslite_tpu_torch "
            f"(ROADMAP Queue 1 item 3: socket vans and separate processes)")
    raise ValueError(f"unknown van type: {van_type!r}")
