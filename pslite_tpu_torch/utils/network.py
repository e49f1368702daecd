"""Local address discovery and ephemeral ports.

Counterpart of ``pslite_tpu/utils/network.py`` (the reference's
``src/network_utils.h`` ``GetIP``, ``GetAvailablePort``), without the JAX
module's UDP-connect probe:
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



def get_available_port(host: str = "") -> int:
    """Bind port 0 and return the port the kernel assigned."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, 0))
        return s.getsockname()[1]
    finally:
        s.close()
