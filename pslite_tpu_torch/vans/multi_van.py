"""MultiVan — a composite of several transport rails.

Counterpart of ``pslite_tpu/vans/multi_van.py`` (the reference's
MultiVan, ``src/multi_van.h``): ``DMLC_NUM_PORTS`` (default 2) inner
rails of ``PS_MULTI_RAIL_VAN`` (``tcp``, default, or ``shm``), one pump
thread per rail feeding one receive queue.  Control rides rail 0; the
chunks of one transfer stripe across every rail, starting at a rail set
by the transfer id; other data goes by its source device id, else round
robin.  Send lanes are keyed (peer, rail), so one peer's data streams
down every rail at once; the rails keep no order between them, and the
chunk assembler does not need one.  Each rail van runs the native core
unless ``PS_NATIVE=0`` (its frames written inline by the core: the
composite's Python lanes pick the rail), with the core's reassembly off,
and ``post_stop`` frees the cores once the pumps have left.
"""

from __future__ import annotations

import itertools
import threading
from typing import List, Optional

from ..message import Message, Node
from ..utils import logging as log
from ..utils.queues import PriorityRecvQueue
from .chunking import recv_cost, recv_priority, recv_tenant
from .van import Van


def _rail_class(kind: str):
    """A transport-only subclass of the rail van (its control plane is
    never started)."""
    if kind == "shm":
        from .shm_van import ShmVan

        return type("_ShmRail", (ShmVan,), {})
    from .tcp_van import TcpVan

    return type("_TcpRail", (TcpVan,), {})


class MultiVan(Van):
    def __init__(self, postoffice):
        super().__init__(postoffice)
        self.num_rails = max(self.env.find_int("DMLC_NUM_PORTS", 2), 1)
        kind = self.env.find("PS_MULTI_RAIL_VAN", "tcp")
        log.check(kind in ("tcp", "shm"), f"unknown rail van {kind!r}")
        cls = _rail_class(kind)
        self._rails = [cls(postoffice) for _ in range(self.num_rails)]
        for i, rail in enumerate(self._rails):
            if hasattr(rail, "_ns"):
                # Disjoint segment names per rail: one (sender, recver,
                # key) round-robins across rails.
                rail._ns = f"{rail._ns}r{i}"
            if rail._native is not None:
                # Each rail van is a core of its own and sees only its
                # stripe of a transfer: the shared Python assembler
                # rebuilds it.
                rail._native.set_reassembly(False)
        self._queue = PriorityRecvQueue(
            recv_priority, tenant_fn=recv_tenant, cost_fn=recv_cost,
            weights=self._tenant_weights)
        self._pumps: List[threading.Thread] = []
        self._rr = itertools.count()

    def bind_transport(self, node: Node, max_retry: int) -> int:
        ports = []
        for i, rail in enumerate(self._rails):
            # Rail 0 owns the advertised port; the others take any.
            sub = Node(role=node.role, hostname=node.hostname,
                       ports=[node.port if i == 0 else 0])
            port = rail.bind_transport(sub, max_retry)
            rail.my_node.hostname = node.hostname
            rail.my_node.ports = [port]
            ports.append(port)
        node.ports = ports
        for i, rail in enumerate(self._rails):
            t = threading.Thread(target=self._pump, args=(rail,),
                                 name=f"multivan-pump-{i}", daemon=True)
            t.start()
            self._pumps.append(t)
        return ports[0]

    def connect_transport(self, node: Node) -> None:
        for i, rail in enumerate(self._rails):
            rail.connect_transport(Node(
                role=node.role, id=node.id, hostname=node.hostname,
                ports=[node.ports[i % len(node.ports)]]))

    def _rail_index(self, msg: Message) -> int:
        """The message's rail, chosen once and stamped on it, so the lane
        picked at enqueue and the rail used at dispatch agree (and a
        retransmit reuses it)."""
        rail = getattr(msg, "_rail", None)
        if rail is not None:
            return rail
        if not msg.meta.control.empty():
            rail = 0
        elif msg.meta.chunk is not None:
            ck = msg.meta.chunk
            rail = (ck.xfer + ck.index) % self.num_rails
        elif msg.meta.src_dev_id is not None and msg.meta.src_dev_id >= 0:
            rail = msg.meta.src_dev_id % self.num_rails
        else:
            rail = next(self._rr) % self.num_rails
        msg._rail = rail
        return rail

    def _lane_key(self, msg: Message):
        return (msg.meta.recver, self._rail_index(msg))

    def send_msg(self, msg: Message) -> int:
        return self._rails[self._rail_index(msg)].send_msg(msg)

    def recv_msg(self) -> Optional[Message]:
        return self._queue.wait_and_pop()

    def _pump(self, rail) -> None:
        while True:
            msg = rail.recv_msg()
            if msg is None:
                break
            self._queue.push(msg)

    def stop_transport(self) -> None:
        for rail in self._rails:
            rail.stop_transport()  # each pump's recv_msg returns None
        for t in self._pumps:
            t.join(timeout=5)
        self._pumps = []
        self._queue.push(None)

    def post_stop(self) -> None:
        for rail in self._rails:
            rail.post_stop()
