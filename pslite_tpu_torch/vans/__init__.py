"""Van transport family.

Counterpart of ``pslite_tpu/vans/__init__.py``'s factory (the
reference's ``src/van.cc:43-104``): ``tcp`` (the zmq van's place:
sockets between processes), ``loopback`` (in-process), ``ici`` (the
collective data plane over loopback), ``ici_tcp``/``ici_shm`` (over the
socket or shared-memory van), ``shm`` (same-host IPC), ``multi``
(several rails), and the chaos wrapper around any of the socket or
loopback ones (``chaos`` wraps ``PS_CHAOS_INNER``, default tcp;
``chaos+shm`` names its inner van).  An unknown name raises
``ValueError``.
"""

from __future__ import annotations

from typing import Optional


def transport_class(van_type: str) -> Optional[type]:
    """The class of a van type name (None for an unknown name): the one
    table that ``create`` and the chaos wrapper share."""
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
    else:
        return None
    return cls


def create(van_type: str, postoffice):
    cls = transport_class(van_type)
    if cls is not None:
        return cls(postoffice)
    if van_type == "chaos" or van_type.startswith("chaos+"):
        from .chaos_van import create_chaos

        inner = (van_type.split("+", 1)[1] if "+" in van_type
                 else (postoffice.env.find("PS_CHAOS_INNER") or "tcp"))
        return create_chaos(inner, postoffice)
    raise ValueError(f"unknown van type: {van_type!r}")
