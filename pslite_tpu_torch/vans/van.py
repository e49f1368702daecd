"""Van base class — the control plane shared by every transport.

Counterpart of the core of ``pslite_tpu/vans/van.py`` (the reference's
``include/ps/internal/van.h`` + ``src/van.cc``): scheduler bootstrap
(ADD_NODE handshake, rank assignment with preferred ranks, ordered hosts
or mixed mode), group and instance barriers, heartbeats with the
scheduler's failure detector, drop injection (``PS_DROP_MSG``), the
optional Resender (``PS_RESEND``), byte counters, and the receive loop
that dispatches data messages to Customers.

Transports implement ``bind_transport / connect_transport / send_msg /
recv_msg / stop_transport`` (and may hook ``post_stop``,
``deliver_data_msg`` and ``_chunk_recv_alloc``).

Chunked transfers (``PS_CHUNK_BYTES``, default 1 MiB as in JAX, 0 sends
whole messages): a data message larger than that is split into chunk
messages (``chunking.split_message``) that ride the peer's lane one by
one, each with its own sid; the receive loop feeds chunks to a
``ChunkAssembler`` and delivers the reassembled message (and the
``OPT_XFER_PART`` partials of a plain push, which the port's serial
server ignores).  A peer marked down drops its partial transfers.
Zero-copy pull responses (``OPT_ZPULL``) and shm-descriptor messages go
whole, as in JAX.

Send path — per-peer send lanes (``docs/send_lanes.md``): every
destination gets its own FIFO lane (a ``LaneQueue``, a transmit lock and
a sender thread started on first use), so sends to different peers
proceed concurrently.  ``sid`` is assigned at dispatch time, one message
at a time per lane, so the per-peer sid sequence is the wire order; a
lane drains highest ``meta.priority`` first, FIFO within a level;
control messages dispatch inline on the caller's thread, under the
peer's transmit lock; ``stop()`` drains every lane before the TERMINATE
self-send; a lane's dispatch error is parked and re-raised by the next
``send()``.

Native data plane (``docs/native_core.md``): ``send`` first offers a
data message to the transport's ``_native_submit`` (the tcp van's native
sender lanes take it whole, chunk split included); ``None`` takes the
Python lanes below.  With ``PS_TENANTS`` the native lanes are not
offered anything: they order by priority only.  The chunk assembler's
large copies run in the native copy pool unless ``PS_NATIVE=0``.

Not in this port (each raises or is absent, named by its ROADMAP Queue 1
item): late registration and node recovery (so no peer's sids are ever
reset), elastic admission, routing epochs and removal,
metrics/trace/snapshot pulls (item 8).  Tenants (``PS_TENANTS``,
``tenants.py``): each lane dequeues bulk traffic weighted-fair across
tenants by bytes (``LaneQueue(weights)``), as the receive intake does.
Data always rides the lanes and messages are delivered in arrival order:
the JAX van's inline mode (``PS_SEND_LANES=0``) and its sid reordering
(``PS_FORCE_REQ_ORDER``) are absent.
"""

from __future__ import annotations

import copy
import itertools
import random
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..base import (
    EMPTY_ID,
    SCHEDULER_ID,
    SERVER_GROUP,
    WORKER_GROUP,
    group_members,
    is_server_id,
    server_rank_to_id,
    worker_rank_to_id,
)
from ..message import (
    Command,
    Control,
    Message,
    Node,
    OPT_SEND_FAILED,
    OPT_ZPULL,
    Role,
)
from ..telemetry import Profiler
from ..utils import logging as log
from ..utils.network import get_ip
from ..tenants import table_for
from ..utils.queues import LaneQueue
from . import native
from .chunking import ChunkAssembler, split_message
from .resender import Resender


class PeerDeadError(ConnectionError):
    """The destination was declared dead by the failure detector; the
    send fails fast instead of parking on a lane that never drains."""


class _SendLane:
    """One per-destination send lane: the queue (weighted fair across
    tenants when ``weights`` is given), the transmit lock that
    serializes every wire write to this peer, and the sender thread."""

    __slots__ = ("key", "q", "tx_mu", "thread")

    def __init__(self, key, weights=None):
        self.key = key
        self.q: LaneQueue = LaneQueue(weights)
        self.tx_mu = threading.Lock()
        self.thread: Optional[threading.Thread] = None


def _msg_cost(msg: Message) -> int:
    """Weighted-fair charge of one message: its payload bytes (chunk
    frames carry theirs in ``data``; their canonical meta zeroes
    data_size)."""
    if msg.data:
        return max(1, sum(d.nbytes for d in msg.data))
    return max(1, msg.meta.data_size)


class Van:
    # Whether this van runs a control plane (a data-plane-only IciVan
    # worker without a scheduler does not).
    control_plane = True
    # meta.option of a barrier REQUEST that withdraws a timed-out
    # peer's pending request (Postoffice.barrier's timeout contract).
    BARRIER_CANCEL_OPT = 0x5ca1
    # meta.option of a NODE_FAILURE control that rehabilitates a peer
    # declared dead that heartbeat again.
    NODE_REHAB_OPT = 0xA11E

    def __init__(self, postoffice):
        self.po = postoffice
        self.env = postoffice.env
        self.my_node: Node = Node()
        self.scheduler: Node = Node()
        self.ready = threading.Event()
        self.send_bytes = 0
        self.recv_bytes = 0
        # Data frames (chunks and batch frames one each) each way.
        self.frames_sent = 0
        self.frames_recv = 0
        self.chunks_sent = 0
        self.chunks_recv = 0
        self._start_mu = threading.Lock()
        self._bytes_mu = threading.Lock()
        self._init_stage = 0
        self._recv_thread: Optional[threading.Thread] = None
        self._heartbeat_thread: Optional[threading.Thread] = None
        self._failure_thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        self._drop_rate = 0
        self.resender: Optional[Resender] = None
        self.profiler = Profiler()
        self.flight = postoffice.flight
        # Scheduler-side registration state.
        self._registrations: List[Node] = []
        self._registered_addrs: Dict[str, int] = {}  # addr -> assigned id
        self._barrier_senders: Dict[Tuple[int, bool], Set[int]] = {}
        self._connected_nodes: Dict[str, int] = {}
        self._timestamp = 0
        self._timestamp_mu = threading.Lock()
        # Per-peer sequence ids, stamped at dispatch.
        self._send_sids: Dict[int, int] = {}
        # The node's tenant table: lanes (and the transports' receive
        # intake) dequeue bulk traffic weighted-fair across its tenants.
        self.tenants = table_for(self.env)
        self._tenant_weights = (self.tenants.weights_by_id()
                                if self.tenants.enabled else None)
        self._lanes: Dict[object, _SendLane] = {}
        self._lanes_mu = threading.Lock()
        self._lane_stop = False
        self._lane_abort = False
        self._lane_error: Optional[Exception] = None
        self._lane_err_mu = threading.Lock()
        # Peers the scheduler's detector declared dead.
        self._down_peers: Set[int] = set()
        self._down_mu = threading.Lock()
        self._announced_dead: Set[int] = set()  # scheduler: broadcast
        self._chunk_bytes = max(0, self.env.find_int("PS_CHUNK_BYTES",
                                                     1 << 20))
        self._xfer_seq = itertools.count(1)
        self._assembler = ChunkAssembler(
            ttl_s=self.env.find_float("PS_XFER_TIMEOUT", 120.0),
            alloc=self._chunk_recv_alloc,
            copy_kernel=native.scatter_copy_kernel(self.env))

    # -- transport interface -------------------------------------------------

    def bind_transport(self, node: Node, max_retry: int) -> int:
        """Bind the receive endpoint; returns the bound port."""
        raise NotImplementedError

    def connect_transport(self, node: Node) -> None:
        raise NotImplementedError

    def send_msg(self, msg: Message) -> int:
        """Send one message; returns bytes sent."""
        raise NotImplementedError

    def recv_msg(self) -> Optional[Message]:
        """Blocking receive; None means the transport is shutting down."""
        raise NotImplementedError

    def stop_transport(self) -> None:
        raise NotImplementedError

    def post_stop(self) -> None:
        """Final teardown after the receive thread has joined."""

    def deliver_data_msg(self, msg: Message) -> None:
        """Last-mile payload placement (registered receive buffers), run
        after drop injection, resender dedup and reassembly."""

    def _chunk_recv_alloc(self, nbytes: int) -> np.ndarray:
        """Reassembly buffers (a pooled transport overrides this)."""
        return np.empty(nbytes, np.uint8)

    def _native_submit(self, msg: Message) -> Optional[int]:
        """Hand a data message to native sender lanes and return 0, or
        None to take the Python lanes.  A transport that accepts owns
        the message from here: sids, chunk split, byte counters and
        failure reporting."""
        return None

    # -- lifecycle -----------------------------------------------------------

    def start(self, customer_id: int) -> None:
        with self._start_mu:
            if self._init_stage == 0:
                self._lane_stop = False  # re-arm after a prior stop()
                self._lane_abort = False
                self._lane_error = None
                with self._down_mu:
                    self._down_peers = set()
                self._announced_dead = set()
                with self._lanes_mu:
                    self._lanes = {}
                self._assembler.clear()  # no partial transfer of a prior run
                self._stop_event.clear()
                self._init_nodes()
                port = self.bind_transport(self.my_node, max_retry=40)
                if port:
                    self.my_node.ports = [port]
                log.vlog(1, f"Bind to {self.my_node.short_debug()}")
                self.connect(self.scheduler)
                self._recv_thread = threading.Thread(
                    target=self._receiving, name="van-recv", daemon=True
                )
                self._recv_thread.start()
                self._init_stage = 1
        if not self.po.is_scheduler:
            node = copy.deepcopy(self.my_node)
            node.customer_id = customer_id
            node.aux_id = self.po.preferred_rank
            msg = Message()
            msg.meta.recver = SCHEDULER_ID
            msg.meta.request = True
            msg.meta.control = Control(cmd=Command.ADD_NODE, node=[node])
            msg.meta.timestamp = self.next_timestamp()
            self.send(msg)
        self.ready.wait()
        with self._start_mu:
            if self._init_stage == 1:
                self._drop_rate = self.env.find_int("PS_DROP_MSG", 0)
                if self.env.find_int("PS_RESEND", 0):
                    self.resender = Resender(
                        self, self.env.find_int("PS_RESEND_TIMEOUT", 1000))
                interval = self.env.find_float("PS_HEARTBEAT_INTERVAL", 0)
                if interval > 0 and not self.po.is_scheduler:
                    self._heartbeat_thread = threading.Thread(
                        target=self._heartbeat_loop, args=(interval,),
                        name="van-heartbeat", daemon=True,
                    )
                    self._heartbeat_thread.start()
                timeout = self.heartbeat_timeout_s()
                if self.po.is_scheduler and timeout > 0 and interval > 0:
                    scan = max(0.2, min(timeout / 2.0, interval))
                    self._failure_thread = threading.Thread(
                        target=self._failure_detector_loop,
                        args=(scan, timeout),
                        name="van-failure-detector", daemon=True,
                    )
                    self._failure_thread.start()
                self._init_stage = 2

    def heartbeat_timeout_s(self) -> float:
        """Dead-node threshold: ``PS_HEARTBEAT_TIMEOUT``, else 5
        heartbeat intervals when heartbeats are on (an explicit 0 turns
        detection off)."""
        raw = self.env.find("PS_HEARTBEAT_TIMEOUT")
        if raw not in (None, ""):
            return float(raw)
        interval = self.env.find_float("PS_HEARTBEAT_INTERVAL", 0)
        return 5.0 * interval if interval > 0 else 0.0

    def _init_nodes(self) -> None:
        uri = self.env.find("DMLC_PS_ROOT_URI")
        log.check(uri is not None, "DMLC_PS_ROOT_URI not set")
        self.scheduler = Node(
            role=Role.SCHEDULER, id=SCHEDULER_ID, hostname=uri,
            ports=[self.env.find_int("DMLC_PS_ROOT_PORT", 0)],
        )
        if self.po.is_scheduler:
            self.my_node = copy.deepcopy(self.scheduler)
        else:
            host = (self.env.find("DMLC_NODE_HOST")
                    or get_ip(self.env.find("DMLC_INTERFACE")))
            self.my_node = Node(
                role=Role.WORKER if self.po.is_worker else Role.SERVER,
                id=EMPTY_ID, hostname=host,
                ports=[self.env.find_int("DMLC_PORT", 0)],
            )

    def connect(self, node: Node) -> None:
        addr = node.addr_key()
        if node.id != EMPTY_ID and self._connected_nodes.get(addr) == node.id:
            return
        self.connect_transport(node)
        if node.id != EMPTY_ID:
            self._connected_nodes[addr] = node.id

    def stop(self) -> None:
        """Drain the send lanes, self-send TERMINATE, close the transport
        and join every thread this van started."""
        self._drain_send_lanes()
        if self.resender is not None:
            self.resender.drain()
        exit_msg = Message()
        exit_msg.meta.recver = self.my_node.id
        exit_msg.meta.sender = self.my_node.id
        exit_msg.meta.control = Control(cmd=Command.TERMINATE)
        try:
            self.send(exit_msg)
        except Exception:  # noqa: BLE001 - the receiver exits anyway
            pass
        self._stop_event.set()
        self.stop_transport()
        for attr in ("_recv_thread", "_heartbeat_thread", "_failure_thread"):
            t = getattr(self, attr)
            if t is not None:
                t.join(timeout=10)
                setattr(self, attr, None)
        self.post_stop()
        if self.resender is not None:
            self.resender.stop()
            self.resender = None
        self.profiler.close()
        self.ready.clear()
        self._init_stage = 0

    # -- send path -----------------------------------------------------------

    def next_timestamp(self) -> int:
        with self._timestamp_mu:
            self._timestamp += 1
            return self._timestamp

    def _lane_key(self, msg: Message):
        """The send lane of a message: its destination (MultiVan widens
        it to (destination, rail))."""
        return msg.meta.recver

    def _lane_for(self, msg: Message) -> _SendLane:
        key = self._lane_key(msg)
        with self._lanes_mu:
            lane = self._lanes.get(key)
            if lane is None:
                lane = self._lanes[key] = _SendLane(key,
                                                    self._tenant_weights)
            return lane

    def _ensure_lane_thread(self, lane: _SendLane) -> None:
        if lane.thread is not None and lane.thread.is_alive():
            return
        with self._lanes_mu:
            if lane.thread is None or not lane.thread.is_alive():
                lane.thread = threading.Thread(
                    target=self._lane_sender, args=(lane,),
                    name=f"van-send-{lane.key}", daemon=True,
                )
                lane.thread.start()

    def _raise_pending_send_error(self) -> None:
        """Re-raise (and clear) an error a lane thread parked."""
        if self._lane_error is None:
            return
        with self._lane_err_mu:
            exc, self._lane_error = self._lane_error, None
        if exc is not None:
            raise exc

    def send(self, msg: Message) -> int:
        if msg.meta.sender == EMPTY_ID:
            msg.meta.sender = self.my_node.id
        self._raise_pending_send_error()
        if msg.meta.control.empty() and msg.meta.recver in self._down_peers:
            raise PeerDeadError(
                f"node {msg.meta.recver} was declared dead by the "
                f"failure detector")
        m = msg.meta
        if m.control.empty() and not self.tenants.enabled:
            nbytes = self._native_submit(msg)
            if nbytes is not None:
                return nbytes
        if (self._chunk_bytes > 0 and m.control.empty() and m.chunk is None
                and m.data_size > self._chunk_bytes
                and m.option != OPT_ZPULL and not m.shm_data):
            # Each chunk rides the lane on its own, so smaller ops of a
            # higher priority can pass between them.  OPT_ZPULL goes
            # whole: its addr places the payload in one piece.
            chunks = split_message(msg, self._chunk_bytes,
                                   next(self._xfer_seq))
            if chunks is not None:
                for c in chunks:
                    self._submit_data(c)
                return 0
        return self._submit_data(msg)

    def _submit_data(self, msg: Message) -> int:
        """A data message onto its lane (or inline once the lanes
        stopped); a control message inline."""
        if msg.meta.control.empty() and not self._lane_stop:
            # (unlocked probe; re-checked under the lane lock)
            lane = self._lane_for(msg)
            # Thread before push: a message pushed with no thread to
            # drain it would strand until the drain deadline.
            self._ensure_lane_thread(lane)
            if lane.q.push(msg.meta.priority, (msg, False),
                           unless=lambda: self._lane_stop,
                           tenant=msg.meta.tenant, cost=_msg_cost(msg)):
                return 0  # bytes are accounted at dispatch
        return self._dispatch_send(msg)

    def _dispatch_send(self, msg: Message) -> int:
        if msg.meta.control.empty():
            with self._timestamp_mu:
                sid = self._send_sids.get(msg.meta.recver, 0)
                self._send_sids[msg.meta.recver] = sid + 1
            msg.meta.sid = sid
        if self.resender is not None:
            self.resender.add_outgoing(msg)
        nbytes = self._transmit(msg)
        if msg.meta.control.empty():
            self.profiler.record(msg.meta.key, "send", msg.meta.push)
        log.vlog(2, lambda: f"SEND {msg.debug_string()}")
        return nbytes

    def _transmit(self, msg: Message) -> int:
        """Wire write under the peer's transmit lock — the only
        serialization on the send path, and it is per peer."""
        lane = self._lane_for(msg)
        with lane.tx_mu:
            nbytes = self.send_msg(msg)
        with self._bytes_mu:
            self.send_bytes += nbytes
            if msg.meta.control.empty():
                self.frames_sent += 1
            if msg.meta.chunk is not None:
                self.chunks_sent += 1
        return nbytes

    def _lane_sender(self, lane: _SendLane) -> None:
        while True:
            item, dropped = lane.q.pop(
                stopping=lambda: self._lane_stop,
                aborting=lambda: self._lane_abort,
            )
            if item is None:
                if dropped:
                    log.warning(f"send lane {lane.key} aborted with "
                                f"{dropped} undispatched messages")
                return
            msg, raw = item
            try:
                if raw:  # resender retransmit: already sid'd + buffered
                    self._transmit(msg)
                else:
                    self._dispatch_send(msg)
            except Exception as exc:  # noqa: BLE001 - parked for send()
                log.warning(f"send lane {lane.key} dispatch failed: "
                            f"{exc!r}")
                with self._lane_err_mu:
                    if self._lane_error is None:
                        self._lane_error = exc
            finally:
                lane.q.done()

    def _drain_send_lanes(self, timeout_s: float = 10.0) -> None:
        """Block until every lane has dispatched its queued messages,
        then retire the lane threads.  ``_lane_stop`` is raised first, so
        no message is enqueued after this point (late sends dispatch
        inline); lanes a racing send created are reaped too."""
        self._lane_stop = True
        deadline = time.monotonic() + timeout_s
        seen: set = set()
        while True:
            with self._lanes_mu:
                lanes = [ln for ln in self._lanes.values()
                         if id(ln) not in seen
                         and (ln.thread is not None or len(ln.q))]
            if not lanes:
                return
            seen.update(id(ln) for ln in lanes)
            if not all([ln.q.wait_idle(deadline) for ln in lanes]):
                self._lane_abort = True  # stuck link: drop, don't hang
            for ln in lanes:
                ln.q.wake()
            for ln in lanes:
                if ln.thread is not None:
                    ln.thread.join(timeout=5)
                    ln.thread = None

    def send_msg_locked(self, msg: Message) -> int:
        """Retransmit path of the Resender (no sid re-assignment, no
        re-buffering), through the peer's lane."""
        if msg.meta.control.empty() and not self._lane_stop:
            lane = self._lane_for(msg)
            self._ensure_lane_thread(lane)
            if lane.q.push(msg.meta.priority, (msg, True),
                           unless=lambda: self._lane_stop,
                           tenant=msg.meta.tenant, cost=_msg_cost(msg)):
                return 0
        return self._transmit(msg)

    # -- failure detection ---------------------------------------------------

    def is_peer_down(self, node_id: int) -> bool:
        return node_id in self._down_peers

    def mark_peer_down(self, node_id: int) -> None:
        """Declare a peer dead: later data sends to it raise
        PeerDeadError, and every message parked in its lane fails fast
        (a request gets a synthesized OPT_SEND_FAILED response)."""
        with self._down_mu:
            if node_id in self._down_peers:
                return
            self._down_peers.add(node_id)
        # No further chunk can complete the dead sender's transfers.
        self._assembler.drop_peer(node_id)
        for lane in self._lanes_of(node_id):
            for msg, _raw in lane.q.drain():
                self._delivery_failed(msg, PeerDeadError(
                    f"node {node_id} declared dead with the message "
                    f"parked in its send lane"))
            lane.q.wake()

    def _lanes_of(self, node_id: int) -> List[_SendLane]:
        """Every lane of a peer (MultiVan keys lanes (peer, rail))."""
        with self._lanes_mu:
            return [lane for key, lane in self._lanes.items()
                    if key == node_id or (isinstance(key, tuple)
                                          and key[0] == node_id)]

    def clear_peer_down(self, node_id: int) -> None:
        with self._down_mu:
            self._down_peers.discard(node_id)
        self._announced_dead.discard(node_id)

    def _delivery_failed(self, msg: Message, exc: Exception) -> None:
        """The transport gave up on ``msg``.  A data REQUEST has a local
        waiter: synthesize an empty OPT_SEND_FAILED response so its wait
        raises instead of hanging.  Control messages and responses have
        no local waiter: log only (a parked error would fail the van's
        next unrelated send)."""
        m = msg.meta
        if not m.control.empty() or not m.request:
            log.warning(f"abandoned delivery to node {m.recver}: "
                        f"{msg.debug_string()} ({exc})")
            return
        log.warning(f"delivery to node {m.recver} failed ({exc}); failing "
                    f"local request ts={m.timestamp}")
        self.flight.record("send_failed", severity="warn", peer=m.recver,
                           ts=m.timestamp, error=repr(exc)[:200])
        # A batch frame carries one waiter per sub-op, each with its own
        # timestamp: fail every one, not only the envelope's first.
        subs = ([(op.timestamp, op.key, op.push, op.pull)
                 for op in m.batch.ops] if m.batch is not None
                else [(m.timestamp, m.key, m.push, m.pull)])
        for ts, key, push, pull in subs:
            fail = Message()
            f = fail.meta
            f.app_id, f.customer_id, f.timestamp = (m.app_id, m.customer_id,
                                                    ts)
            f.sender, f.recver = m.recver, self.my_node.id
            f.push, f.pull, f.simple_app, f.key = push, pull, m.simple_app, key
            f.option = OPT_SEND_FAILED
            try:
                self._process_data_msg(fail)
            except Exception as deliver_exc:  # noqa: BLE001
                log.warning(f"could not fail local request ts={ts}: "
                            f"{deliver_exc!r}")

    def _broadcast_failure(self, nodes: List[Node], option: int = 0) -> None:
        """NODE_FAILURE (or, with NODE_REHAB_OPT, its inverse) to every
        live server and worker.  ``_dispatch_send``, not ``send``: a
        broadcast must not consume a parked lane error, and another peer
        may be dead too."""
        for peer in self.po.get_node_ids(SERVER_GROUP + WORKER_GROUP):
            if peer in self._announced_dead:
                continue
            msg = Message()
            msg.meta.recver = peer
            msg.meta.sender = self.my_node.id
            msg.meta.request = True
            msg.meta.option = option
            msg.meta.control = Control(cmd=Command.NODE_FAILURE, node=nodes)
            msg.meta.timestamp = self.next_timestamp()
            try:
                self._dispatch_send(msg)
            except Exception as exc:  # noqa: BLE001
                log.warning(f"NODE_FAILURE broadcast to {peer} failed: "
                            f"{exc!r}")

    @staticmethod
    def _peer_node(node_id: int) -> Node:
        return Node(role=Role.SERVER if is_server_id(node_id)
                    else Role.WORKER, id=node_id)

    def _failure_detector_loop(self, scan_s: float, timeout_s: float) -> None:
        """Scheduler-side active scan: broadcast NODE_FAILURE for peers
        silent longer than ``timeout_s``."""
        while not self._stop_event.wait(scan_s):
            if not self.ready.is_set():
                continue
            dead = [d for d in self.po.get_dead_nodes(timeout_s)
                    if d not in self._announced_dead]
            if not dead:
                continue
            for d in dead:
                self._announced_dead.add(d)
                log.warning(f"failure detector: node {d} silent for more "
                            f"than {timeout_s}s — declaring dead")
                self.mark_peer_down(d)
                self.po.notify_node_failure(d, True)
            self._broadcast_failure([self._peer_node(d) for d in dead])

    def _process_node_failure(self, msg: Message) -> None:
        """A peer's handling of the scheduler's NODE_FAILURE broadcast
        (or of its NODE_REHAB_OPT inverse)."""
        rehab = msg.meta.option == self.NODE_REHAB_OPT
        for node in msg.meta.control.node:
            if node.id == self.my_node.id:
                # Declared dead while alive (slow, not crashed): keep
                # serving; the scheduler rehabilitates on the next beat.
                if rehab:
                    self.po.notify_node_failure(node.id, False)
                continue
            if rehab:
                self.clear_peer_down(node.id)
            else:
                log.warning(f"peer {node.id} declared dead by the "
                            f"scheduler")
                self.mark_peer_down(node.id)
            self.po.notify_node_failure(node.id, not rehab)

    # -- receive loop --------------------------------------------------------

    def _receiving(self) -> None:
        while not self._stop_event.is_set():
            try:
                msg = self.recv_msg()
            except Exception as exc:  # noqa: BLE001 - one bad frame
                if self._stop_event.is_set():
                    break
                log.warning(f"recv_msg failed: {exc!r}")
                continue
            if msg is None:
                break
            # Chunk metas carry data_size 0: count their payload.
            self.recv_bytes += (sum(d.nbytes for d in msg.data)
                                if msg.meta.chunk is not None
                                else msg.meta.data_size)
            ctrl = msg.meta.control
            if ctrl.empty():
                self.frames_recv += 1
            if (self._drop_rate > 0 and self.ready.is_set()
                    and ctrl.cmd != Command.TERMINATE
                    and random.randint(0, 99) < self._drop_rate):
                log.vlog(1, lambda: f"Drop message {msg.debug_string()}")
                continue
            if self.resender is not None and self.resender.add_incoming(msg):
                continue
            log.vlog(2, lambda: f"RECV {msg.debug_string()}")
            if ctrl.cmd == Command.TERMINATE:
                break
            try:
                if ctrl.empty():
                    self._accept_data(msg)
                elif ctrl.cmd == Command.ADD_NODE:
                    self._process_add_node(msg)
                elif ctrl.cmd == Command.BARRIER:
                    self._process_barrier(msg, instance=False)
                elif ctrl.cmd == Command.INSTANCE_BARRIER:
                    self._process_barrier(msg, instance=True)
                elif ctrl.cmd == Command.HEARTBEAT:
                    self._process_heartbeat(msg)
                elif ctrl.cmd == Command.NODE_FAILURE:
                    self._process_node_failure(msg)
                elif ctrl.cmd == Command.ACK:
                    pass  # consumed by the resender when enabled
                else:
                    raise NotImplementedError(
                        f"control {ctrl.cmd.name} not yet ported to "
                        f"pslite_tpu_torch (ROADMAP Queue 1 item 8)")
            except log.CheckError as exc:
                # An invariant violation takes this node dark (pump and
                # heartbeat stop) without killing the interpreter, which
                # may host many logical nodes (the JAX van's
                # PS_CHECK_FATAL=0 behaviour).
                log.fatal_log(f"CHECK failed: {exc} (while processing "
                              f"{msg.debug_string()}); node going dark")
                self._stop_event.set()
                raise
            except Exception as exc:  # noqa: BLE001 - keep the pump alive
                log.warning(f"error processing {msg.debug_string()}: "
                            f"{exc!r}")

    # -- data plane dispatch -------------------------------------------------

    def _accept_data(self, msg: Message) -> None:
        """A chunk feeds the assembler, which hands back what is ready
        (partials, and the whole message on its last chunk)."""
        if msg.meta.chunk is None:
            self._process_data_msg(msg)
            return
        self.chunks_recv += 1
        for out in self._assembler.add(msg):
            self._process_data_msg(out)

    def _process_data_msg(self, msg: Message) -> None:
        self.deliver_data_msg(msg)
        self.profiler.record(msg.meta.key, "recv", msg.meta.push)
        app_id = msg.meta.app_id
        # Workers demux by customer_id (several KVWorker customers share
        # one app); servers demux by app_id (reference: van.cc:428-438).
        customer_id = (msg.meta.customer_id
                       if self.my_node.role == Role.WORKER else app_id)
        # Never block the receive loop waiting for the app: a barrier
        # response queued behind this message may be exactly what lets
        # the main thread register it.  Park early arrivals instead.
        customer = self.po.get_customer(app_id, customer_id)
        if customer is not None:
            customer.accept(msg)
        else:
            self.po.buffer_pending(app_id, customer_id, msg)

    # -- scheduler: registration & rank assignment ---------------------------

    def _process_add_node(self, msg: Message) -> None:
        if msg.meta.request:
            log.check(self.po.is_scheduler,
                      "ADD_NODE request at non-scheduler")
            self._process_add_node_at_scheduler(msg)
        else:
            self._process_roster(msg)

    def _process_add_node_at_scheduler(self, msg: Message) -> None:
        if self.ready.is_set():
            raise NotImplementedError(
                "ADD_NODE after bootstrap (node recovery, elastic join) is "
                "not yet ported to pslite_tpu_torch (ROADMAP Queue 1 "
                "item 8)")
        for node in msg.meta.control.node:
            addr = node.addr_key()
            if addr in self._registered_addrs:
                continue  # another customer registering on one endpoint
            self._registered_addrs[addr] = EMPTY_ID
            self._registrations.append(node)
        expected = self.po.num_worker_instances + self.po.num_server_instances
        if len(self._registrations) < expected:
            return
        self._assign_ranks(self._registrations)
        for node in self._registrations:
            self.connect(node)
            self._registered_addrs[node.addr_key()] = node.id
            self.po.update_heartbeat(node.id, time.time())
        roster = [copy.deepcopy(self.scheduler)] + [
            copy.deepcopy(n) for n in self._registrations]
        for node in self._registrations:
            reply = Message()
            reply.meta.recver = node.id
            reply.meta.control = Control(cmd=Command.ADD_NODE, node=roster)
            reply.meta.timestamp = self.next_timestamp()
            self.send(reply)
        log.vlog(1, f"the scheduler is connected to "
                    f"{self.po.num_worker_instances} workers and "
                    f"{self.po.num_server_instances} servers")
        self.ready.set()

    def _assign_ranks(self, nodes: List[Node]) -> None:
        """Assign node ids — reference: van.cc:112-265.  Precedence:
        preferred ranks (when every node supplied ``aux_id``), then
        ``BYTEPS_ORDERED_HOSTS``, then mixed mode (non-colocated servers
        first), then ip:port order."""
        servers = [n for n in nodes if n.role == Role.SERVER]
        workers = [n for n in nodes if n.role == Role.WORKER]
        if nodes and all(n.aux_id != EMPTY_ID for n in nodes):
            for n in servers:
                n.id = server_rank_to_id(n.aux_id)
            for n in workers:
                n.id = worker_rank_to_id(n.aux_id)
            return
        ordered_hosts = self.env.find("BYTEPS_ORDERED_HOSTS")
        if ordered_hosts:
            order = {h: i for i, h in enumerate(ordered_hosts.split(","))}

            def keyfn(n):
                return order.get(n.hostname, len(order)), n.addr_key()
        elif self.env.find_int("BYTEPS_ENABLE_MIXED_MODE", 0):
            worker_hosts = {n.hostname for n in workers}

            def keyfn(n):
                return n.hostname in worker_hosts, n.addr_key()
        else:
            def keyfn(n):
                return n.addr_key()
        for rank, n in enumerate(sorted(servers, key=keyfn)):
            n.id = server_rank_to_id(rank)
        for rank, n in enumerate(sorted(workers, key=keyfn)):
            n.id = worker_rank_to_id(rank)

    def _process_roster(self, msg: Message) -> None:
        """Non-scheduler handling of the scheduler's ADD_NODE roster."""
        my_addr = self.my_node.addr_key()
        for node in msg.meta.control.node:
            if (self.my_node.id == EMPTY_ID and node.addr_key() == my_addr
                    and node.role == self.my_node.role):
                self.my_node.id = node.id
                self.my_node.is_recovery = node.is_recovery
                self.po.on_id_assigned(node)
            # Never connect worker<->worker or server<->server
            # (reference: README.md:20), but do connect to self: the
            # TERMINATE self-send rides that connection.
            if node.id != self.my_node.id and node.role == self.my_node.role:
                continue
            if node.role == Role.SCHEDULER and not self.po.is_scheduler:
                continue  # connected during start()
            self.connect(node)
        log.check(self.my_node.id != EMPTY_ID,
                  "scheduler did not assign my id")
        # Seed the scheduler's heartbeat entry now, so a late registrant
        # does not age the scheduler from process start.
        self.po.update_heartbeat(SCHEDULER_ID, time.time())
        self.ready.set()

    # -- barriers ------------------------------------------------------------

    def request_barrier(self, group: int, instance: bool,
                        cancel: bool = False) -> None:
        """Ask the scheduler for a barrier of ``group``; with ``cancel``
        withdraw this node's pending request instead (after a timeout)."""
        msg = Message()
        msg.meta.recver = SCHEDULER_ID
        msg.meta.request = True
        if cancel:
            msg.meta.option = self.BARRIER_CANCEL_OPT
        msg.meta.control = Control(
            cmd=Command.INSTANCE_BARRIER if instance else Command.BARRIER,
            barrier_group=group,
        )
        msg.meta.timestamp = self.next_timestamp()
        self.send(msg)

    def _barrier_expected(self, group: int, instance: bool) -> int:
        sched, srv, wrk = group_members(group)
        count = 1 if sched else 0
        if instance:
            count += self.po.num_server_instances if srv else 0
            count += self.po.num_worker_instances if wrk else 0
        else:
            count += self.po.num_servers if srv else 0
            count += self.po.num_workers if wrk else 0
        return count

    def _process_barrier(self, msg: Message, instance: bool) -> None:
        if not msg.meta.request:
            self.po.manage(msg)
            return
        group = msg.meta.control.barrier_group
        key = (group, instance)
        senders = self._barrier_senders.setdefault(key, set())
        if msg.meta.option == self.BARRIER_CANCEL_OPT:
            senders.discard(msg.meta.sender)
            return
        senders.add(msg.meta.sender)
        # Instance barriers count instances; group barriers count
        # distinct group members, keyed by role parity too (server id 8
        # and worker id 9 are both group rank 0 — reference:
        # van.cc:351-426).
        progress = (len(senders) if instance else len(
            {(s % 2, self.po.id_to_group_rank(s)) for s in senders}))
        expected = self._barrier_expected(group, instance)
        log.vlog(1, f"barrier(group={group}, instance={instance}): "
                    f"{progress}/{expected}")
        if progress < expected:
            return
        self._barrier_senders[key] = set()
        for member in sorted(senders):
            reply = Message()
            reply.meta.recver = member
            reply.meta.app_id = msg.meta.app_id
            reply.meta.customer_id = msg.meta.customer_id
            reply.meta.control = Control(cmd=msg.meta.control.cmd,
                                         barrier_group=group)
            reply.meta.timestamp = self.next_timestamp()
            self.send(reply)

    # -- heartbeat -----------------------------------------------------------

    def _heartbeat_loop(self, interval_s: float) -> None:
        while not self._stop_event.wait(interval_s):
            if not self.ready.is_set():
                continue
            msg = Message()
            msg.meta.recver = SCHEDULER_ID
            msg.meta.request = True
            msg.meta.control = Control(cmd=Command.HEARTBEAT,
                                       node=[copy.deepcopy(self.my_node)])
            msg.meta.timestamp = self.next_timestamp()
            try:
                self.send(msg)
            except Exception as exc:  # noqa: BLE001 - next beat retries
                log.warning(f"heartbeat send failed: {exc!r}")

    def _process_heartbeat(self, msg: Message) -> None:
        sender = msg.meta.sender
        self.po.update_heartbeat(sender, time.time())
        if not (msg.meta.request and self.po.is_scheduler):
            return
        if sender in self._announced_dead:
            # Declared dead but beating (slow, not crashed): rehabilitate
            # it here and on every peer that got the NODE_FAILURE.
            log.warning(f"node {sender} heartbeat after being declared "
                        f"dead — rehabilitating")
            self.clear_peer_down(sender)
            self.po.notify_node_failure(sender, False)
            self._broadcast_failure([self._peer_node(sender)],
                                    option=self.NODE_REHAB_OPT)
        reply = Message()
        reply.meta.recver = sender
        reply.meta.control = Control(cmd=Command.HEARTBEAT)
        reply.meta.timestamp = self.next_timestamp()
        self.send(reply)
