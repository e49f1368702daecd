"""SimpleApp — (head:int, body:bytes) request/response control messaging.

Copy of ``pslite_tpu/kv/simple_app.py`` (the reference's
``include/ps/simple_app.h``): requests go to a node or a whole group;
``simple_app=true`` messages bypass KV parsing; the default request
handle answers with an empty body and the default response handle does
nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from .. import ps as ps_mod
from ..customer import Customer
from ..message import Message
from ..utils import logging as log


@dataclass
class SimpleData:
    head: int = 0
    body: bytes = b""
    sender: int = 0
    timestamp: int = 0
    customer_id: int = 0


class SimpleApp:
    def __init__(self, app_id: int, customer_id=None, postoffice=None):
        self.po = postoffice or ps_mod.postoffice()
        if customer_id is None:
            # Servers demux incoming messages by app_id (van.cc:428-438), so
            # a server-side app must register under customer_id == app_id.
            customer_id = app_id if self.po.is_server else 0
        self._customer = Customer(app_id, customer_id, self._process, self.po)
        self._request_handle: Callable[[SimpleData, "SimpleApp"], None] = (
            lambda req, app: app.response(req)
        )
        self._response_handle: Callable[[SimpleData, "SimpleApp"], None] = (
            lambda req, app: None
        )

    def set_request_handle(self, fn) -> None:
        self._request_handle = fn

    def set_response_handle(self, fn) -> None:
        self._response_handle = fn

    def request(self, head: int, body, recv_id: int) -> int:
        """Send a request to a node id or group; returns the timestamp."""
        ts = self._customer.new_request(recv_id)
        if isinstance(body, str):
            body = body.encode()
        for recver in self._recipients(recv_id):
            msg = Message()
            m = msg.meta
            m.head = head
            m.body = body
            m.app_id = self._customer.app_id
            m.customer_id = self._customer.customer_id
            m.timestamp = ts
            m.request = True
            m.simple_app = True
            m.recver = recver
            self.po.van.send(msg)
        return ts

    def _recipients(self, recv_id: int):
        ids = self.po.get_node_ids(recv_id)
        if recv_id < 8 and self.po.group_size > 1:
            # Instance groups: talk to the matching instance of each group.
            ids = [
                i
                for i in ids
                if i == 1 or (i - 8) // 2 % self.po.group_size == self.po.instance_idx
            ]
        return ids

    def response(self, req: SimpleData, body=b"") -> None:
        if isinstance(body, str):
            body = body.encode()
        msg = Message()
        m = msg.meta
        m.head = req.head
        m.body = body
        m.app_id = self._customer.app_id
        m.customer_id = req.customer_id
        m.timestamp = req.timestamp
        m.request = False
        m.simple_app = True
        m.recver = req.sender
        self.po.van.send(msg)

    def wait(self, timestamp: int) -> None:
        self._customer.wait_request(timestamp)

    def stop(self) -> None:
        self._customer.stop()

    def _process(self, msg: Message) -> None:
        data = SimpleData(
            head=msg.meta.head,
            body=msg.meta.body,
            sender=msg.meta.sender,
            timestamp=msg.meta.timestamp,
            customer_id=msg.meta.customer_id,
        )
        if msg.meta.request:
            log.check(self._request_handle is not None, "no request handle")
            self._request_handle(data, self)
        else:
            self._response_handle(data, self)
