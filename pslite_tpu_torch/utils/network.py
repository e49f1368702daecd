"""Local address discovery.

Counterpart of ``pslite_tpu/utils/network.py`` (the reference's
``src/network_utils.h`` ``GetIP``), without the JAX module's UDP-connect probe:
the address comes from the host name alone, so discovery never touches
a route to another host.  Set ``DMLC_NODE_HOST`` to choose it.
"""

from __future__ import annotations

import socket
from typing import Optional


def get_ip(interface: Optional[str] = None) -> str:
    """This host's address: ``127.0.0.1`` for ``lo``, else the host
    name's address (``127.0.0.1`` when it does not resolve)."""
    if interface == "lo":
        return "127.0.0.1"
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"

