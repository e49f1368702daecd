"""Van transport family.

Counterpart of ``pslite_tpu/vans/__init__.py``'s factory (the
reference's ``src/van.cc:43-104``): ``tcp`` (the zmq van's place:
sockets between processes), ``loopback`` (in-process), ``ici`` (the
collective data plane over loopback), ``ici_tcp``/``ici_shm`` (over the
socket or shared-memory van), ``shm`` (same-host IPC) and ``multi``
(several rails).  The chaos wrapper raises ``NotImplementedError``
naming ROADMAP Queue 1 item 8; an unknown name raises ``ValueError``.
"""

from __future__ import annotations


def create(van_type: str, postoffice):
    if van_type in ("tcp", "zmq", "0", ""):
        from .tcp_van import TcpVan as cls
    elif van_type == "loopback":
        from .loopback_van import LoopbackVan as cls
    elif van_type == "ici":
        from .ici_van import IciVan as cls
    elif van_type in ("ici_tcp", "ici+tcp", "xla"):
        from .ici_van import IciTcpVan as cls
    elif van_type in ("ici_shm", "ici+shm"):
        from .ici_van import IciShmVan as cls
    elif van_type == "shm":
        from .shm_van import ShmVan as cls
    elif van_type in ("multi", "multivan"):
        from .multi_van import MultiVan as cls
    elif van_type == "chaos" or van_type.startswith("chaos+"):
        raise NotImplementedError(
            f"van {van_type!r} is not yet ported to pslite_tpu_torch "
            f"(ROADMAP Queue 1 item 8: the chaos wrapper)")
    else:
        raise ValueError(f"unknown van type: {van_type!r}")
    return cls(postoffice)
