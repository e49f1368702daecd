"""Receive-queue levels of a message.

The part of ``pslite_tpu/vans/chunking.py`` the loopback van uses
(``:62-106``): the receive-queue priority of a decoded message.  Control
rides above every data level, so a data backlog never starves
heartbeats, ACKs or barriers; TERMINATE and the shutdown sentinel drain
last, so queued traffic is delivered before the pump retires.  Chunked
transfers (the rest of the JAX module) are ROADMAP Queue 1 item 3, and
the tenant and cost of a message are item 6's weighted-fair queues.
"""

from __future__ import annotations

from ..message import Command
from ..utils.queues import DRAIN_LEVEL

RECV_CONTROL_PRIORITY = 1 << 20
RECV_DRAIN_LAST = DRAIN_LEVEL


def recv_priority(msg) -> int:
    """Receive-queue level: data messages keep their send-side
    ``meta.priority``, so a priority op that jumped the send lanes jumps
    the receive backlog too."""
    if msg is None:
        return RECV_DRAIN_LAST
    c = msg.meta.control
    if not c.empty():
        if c.cmd == Command.TERMINATE:
            return RECV_DRAIN_LAST
        return RECV_CONTROL_PRIORITY
    return msg.meta.priority
