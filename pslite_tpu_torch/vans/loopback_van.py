"""Loopback van — in-process transport.

Counterpart of ``pslite_tpu/vans/loopback_van.py``: a whole cluster
(scheduler, servers, workers, instance groups too) runs inside one
process, with every message round-tripped through the real wire format
(``wire.pack_frame`` / ``rebuild_message``), so serialization runs on
every message.  Bootstrap, rank assignment, barriers and heartbeats run
for real; only the sockets are replaced by queues.

Endpoints register in a process-global registry keyed by ``(namespace,
host, port)``; the namespace (``PS_LOOPBACK_NS``) keeps concurrently
running clusters apart, and ``reset_registry()`` clears it.
"""

from __future__ import annotations

import struct
import threading
from typing import Dict, Optional, Tuple

from .. import wire
from ..message import Message, Node
from ..utils import logging as log
from ..utils.queues import PriorityRecvQueue
from .chunking import RECV_DRAIN_LAST, recv_cost, recv_priority, recv_tenant
from .van import Van

_registry_mu = threading.Lock()
_registry: Dict[Tuple[str, str, int], "LoopbackVan"] = {}
_port_counter = [20000]


def reset_registry() -> None:
    """Drop all registered endpoints."""
    with _registry_mu:
        _registry.clear()


class LoopbackVan(Van):
    def __init__(self, postoffice):
        super().__init__(postoffice)
        self._ns = self.env.find("PS_LOOPBACK_NS", "default")
        # The queue holds packed blobs, so the sender (which still has
        # the Message) computes the receive level and pushes it along.
        self._queue = PriorityRecvQueue(lambda _b: 0,
                                        weights=self._tenant_weights)
        self._peers: Dict[int, Tuple[str, int]] = {}
        self._bound_key: Optional[Tuple[str, str, int]] = None

    def bind_transport(self, node: Node, max_retry: int) -> int:
        port = node.port
        with _registry_mu:
            if port == 0:
                _port_counter[0] += 1
                port = _port_counter[0]
            key = (self._ns, node.hostname, port)
            log.check(key not in _registry, f"loopback addr in use: {key}")
            _registry[key] = self
            self._bound_key = key
        return port

    def connect_transport(self, node: Node) -> None:
        if node.id >= 0:
            self._peers[node.id] = (node.hostname, node.port)

    def _resolve(self, recver: int) -> "LoopbackVan":
        if recver == self.my_node.id:
            return self
        addr = self._peers.get(recver)
        log.check(addr is not None, f"loopback: unknown recver {recver}")
        with _registry_mu:
            van = _registry.get((self._ns, addr[0], addr[1]))
        log.check(van is not None, f"loopback: no endpoint at {addr}")
        return van

    def send_msg(self, msg: Message) -> int:
        # The one-pass join serializes the payload here (dispatch time),
        # so callers must not mutate buffers until wait(ts), as with a
        # socket van.
        target = self._resolve(msg.meta.recver)
        blob = b"".join(wire.pack_frame(msg))
        target._queue.push(blob, priority=recv_priority(msg),
                           tenant=recv_tenant(msg), cost=recv_cost(msg))
        return len(blob)

    def recv_msg(self) -> Optional[Message]:
        blob = self._queue.wait_and_pop()
        if blob is None:
            return None
        meta_len, n_data = wire.unpack_frame_header(
            blob[: wire.FRAME_HEADER_SIZE])
        off = wire.FRAME_HEADER_SIZE
        lens = struct.unpack_from(f"<{n_data}Q", blob, off)
        off += 8 * n_data
        meta = wire.unpack_meta(blob[off: off + meta_len])
        off += meta_len
        bufs = []
        for ln in lens:
            bufs.append(blob[off: off + ln])
            off += ln
        return wire.rebuild_message(meta, bufs)

    def stop_transport(self) -> None:
        self._queue.push(None, priority=RECV_DRAIN_LAST)
        if self._bound_key is not None:
            with _registry_mu:
                _registry.pop(self._bound_key, None)
            self._bound_key = None
