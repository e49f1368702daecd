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

Recovery (the reference's ``van.cc:266-332``): an ADD_NODE after
bootstrap is a late registration.  Another customer on a known endpoint
gets the roster again; a node of a role with a dead id takes that id
back (its preferred rank ``aux_id`` wins among several), marked
``is_recovery`` so it skips the startup barrier, and every peer resets
its sequence state toward it (``_reset_peer_sids``) and clears its down
mark.  Under ``PS_KV_REPLICATION`` >= 2 servers also connect to each
other (``_connect_server_peers``): chain forwards and replica fetches
travel server to server.  ``Command.SNAPSHOT`` requests go to the
Postoffice's snapshot hooks (a KVServer) and replies to the scheduler's
gather (``_process_snapshot``).  Elastic membership (``PS_ELASTIC=1``): the scheduler broadcasts routing
epoch 0 at bootstrap, admits a late server with no preferred rank as a
joiner (``_elastic_admit``: the smallest free rank, ``ELASTIC_JOIN_OPT``
on its roster, an epoch that splits the widest range toward it), runs
the decommission handshake (``_process_remove_node``,
``_finish_removal``) and answers table pulls and ``MIGRATE_DONE_OPT``
notes (``_process_routing``); barriers count active servers and are
re-evaluated on every epoch (``_maybe_release_barrier``), and a
heartbeat reply carries the epoch, so a node that missed a broadcast
pulls the table.  Telemetry: the node's metrics registry, wire stats
(``wire.*``), tracer spans (``wire_send``, ``lane_wait``, the ``recv``
instant), the flight recorder (dumped on an abnormal stop) and the
``ENABLE_PROFILING`` event log; ``METRICS_PULL`` and ``TRACE_PULL``
requests are answered from them and replies go to the scheduler's
gather.  Tenants (``PS_TENANTS``, ``tenants.py``): each lane dequeues bulk
traffic weighted-fair across tenants by bytes (``LaneQueue(weights)``),
as the receive intake does.  Data always rides the lanes and messages
are delivered in arrival order: the JAX van's inline mode
(``PS_SEND_LANES=0``) and its sid reordering (``PS_FORCE_REQ_ORDER``,
``BYTEPS_UCX_FORCE_REQ_ORDER``) are refused by name.  A CHECK
failure on the pump exits the process with 134 unless
``PS_CHECK_FATAL=0``, which takes only the node dark.
"""

from __future__ import annotations

import copy
import itertools
import json
import os
import random
import sys
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
    ELASTIC_JOIN_OPT,
    MIGRATE_DONE_OPT,
    REMOVE_DONE_OPT,
    Command,
    Control,
    Message,
    Node,
    OPT_SEND_FAILED,
    OPT_ZPULL,
    Role,
)
from ..routing import RoutingTable
from ..telemetry.flight import NULL_FLIGHT
from ..telemetry.metrics import node_registry
from ..telemetry.tracing import NULL_TRACER
from ..telemetry.wire import make_wire_stats
from ..utils.profiling import Profiler
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


class _Countdown:
    """Sets ``event`` on the ``n``-th ``set()``: a chunked message's
    ``_sent_event`` shared by its chunks."""

    __slots__ = ("_event", "_left", "_mu")

    def __init__(self, event: threading.Event, n: int):
        self._event = event
        self._left = n
        self._mu = threading.Lock()

    def set(self) -> None:
        with self._mu:
            self._left -= 1
            done = self._left == 0
        if done:
            self._event.set()


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
        self._start_mu = threading.Lock()
        self._stopped = False
        self._bytes_mu = threading.Lock()
        self._init_stage = 0
        self._recv_thread: Optional[threading.Thread] = None
        self._heartbeat_thread: Optional[threading.Thread] = None
        self._failure_thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        self._drop_rate = 0
        self.resender: Optional[Resender] = None
        # (A stub postoffice without a role names its log "node".)
        self._role = getattr(postoffice, "role_str", lambda: "node")()
        self.profiler = Profiler(self.env, self._role)
        # Telemetry: the node's registry, tracer and flight recorder (a
        # stub postoffice gets a private registry and the no-ops), and
        # the wire plane's stats (PS_WIRE_TELEMETRY=0: the no-op).
        self.metrics = node_registry(getattr(postoffice, "metrics", None))
        self.wire = make_wire_stats(self.metrics, self.env)
        self.tracer = getattr(postoffice, "tracer", None) or NULL_TRACER
        self.flight = getattr(postoffice, "flight", None) or NULL_FLIGHT
        self._c_sent_msgs = self.metrics.counter("van.sent_messages")
        self._c_sent_bytes = self.metrics.counter("van.sent_bytes")
        self._c_recv_msgs = self.metrics.counter("van.recv_messages")
        self._c_recv_bytes = self.metrics.counter("van.recv_bytes")
        self._h_lane_wait = self.metrics.histogram("van.lane_wait_s")
        self._h_hol_wait = self.metrics.histogram("van.hol_wait_s")
        self.metrics.gauge("van.lane_depth", fn=self._owner_lane_depth)
        self._c_chunks_sent = self.metrics.counter("van.chunks_sent")
        self._c_chunks_recv = self.metrics.counter("van.chunks_recv")
        # Multi-op EXT_BATCH frames and the ops they carried, split by
        # direction: requests are the worker's op combiner, responses
        # the server's.
        self._c_batched_frames = self.metrics.counter("van.batched_frames")
        self._c_batch_ops = self.metrics.counter("van.batch_ops")
        self._c_resp_batched_frames = self.metrics.counter(
            "van.resp_batched_frames")
        self._c_resp_batch_ops = self.metrics.counter("van.resp_batch_ops")
        self.metrics.gauge("van.xfers_inflight",
                           fn=self._owner_xfer_depth)
        # Pull replies this node failed to send (the collector sees
        # only absence).
        self._c_pull_reply_failures = self.metrics.counter(
            "van.metrics_pull_failures")
        self._c_trace_reply_failures = self.metrics.counter(
            "van.trace_pull_failures")
        # Scheduler-side registration state.
        self._registrations: List[Node] = []
        self._registered_addrs: Dict[str, int] = {}  # addr -> assigned id
        self._barrier_senders: Dict[Tuple[int, bool], Set[int]] = {}
        # The newest barrier request counted per sender (its timestamp).
        self._barrier_last_ts: Dict[int, int] = {}
        self._connected_nodes: Dict[str, int] = {}
        self._timestamp = 0
        self._timestamp_mu = threading.Lock()
        # Per-peer sequence ids, stamped at dispatch.
        self._send_sids: Dict[int, int] = {}
        # The JAX van's lane-less dispatch and sid reordering are not
        # ported: refused by name, never silently ignored.
        if self.env.find_int("PS_SEND_LANES", 1) == 0:
            raise NotImplementedError(
                "PS_SEND_LANES=0 (inline data dispatch) is not ported to "
                "pslite_tpu_torch: data always rides the send lanes; "
                "unset it")
        for knob in ("PS_FORCE_REQ_ORDER", "BYTEPS_UCX_FORCE_REQ_ORDER"):
            if self.env.find_int(knob, 0):
                raise NotImplementedError(
                    f"{knob} (per-sender sid reordering) is not ported "
                    f"to pslite_tpu_torch: messages are delivered in "
                    f"arrival order; unset it")
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
        # Chain replication and elastic membership (range migrations
        # travel server to server) need server<->server connections,
        # which the bootstrap otherwise never makes.
        self._connect_server_peers = (
            self.env.find_int("PS_KV_REPLICATION", 1) >= 2
            or self.env.find_int("PS_ELASTIC", 0) != 0)
        # Scheduler: decommissions mid-handshake, group rank -> the
        # leaver's node id, resolved when its REMOVE_DONE arrives.
        self._removals_pending: Dict[int, int] = {}
        self._chunk_bytes = max(0, self.env.find_int("PS_CHUNK_BYTES",
                                                     1 << 20))
        self._xfer_seq = itertools.count(1)
        self._assembler = ChunkAssembler(
            tracer=self.tracer,
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

    @property
    def chunks_sent(self) -> int:
        """Chunk frames sent (the ``van.chunks_sent`` counter)."""
        return self._c_chunks_sent.value

    @property
    def chunks_recv(self) -> int:
        """Chunk frames received (``van.chunks_recv``)."""
        return self._c_chunks_recv.value

    def _owner_lane_depth(self) -> float:
        """Gauge fn of ``van.lane_depth``: messages queued on every send
        lane."""
        lanes_mu = getattr(self, "_lanes_mu", None)
        if lanes_mu is None:
            return 0.0
        with lanes_mu:
            lanes = list(self._lanes.values())
        return float(sum(len(ln.q) for ln in lanes))

    def _owner_xfer_depth(self) -> float:
        """Gauge fn of ``van.xfers_inflight``: partially reassembled
        chunked transfers."""
        asm = getattr(self, "_assembler", None)
        return float(len(asm)) if asm is not None else 0.0

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
                self._stopped = False
                self._lane_abort = False
                self._lane_error = None
                with self._down_mu:
                    self._down_peers = set()
                self._announced_dead = set()
                self._barrier_last_ts = {}
                with self._lanes_mu:
                    self._lanes = {}
                self._assembler.clear()  # no partial transfer of a prior run
                self._stop_event.clear()
                if self.profiler.closed:
                    # A restarted van records again into a new log.
                    self.profiler = Profiler(self.env, self._role)
                self._init_nodes()
                if self.my_node.id >= 0:
                    self.tracer.node_id = self.my_node.id  # scheduler
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
        and join every thread this van started.  Idempotent: a test that
        crashed a node by stopping its van stops every van again at
        teardown, and a second stop must not touch the closed
        transport."""
        with self._start_mu:
            if self._stopped:
                return
            self._stopped = True
        # The scheduler's sampler pulls through this van: stop it first,
        # so no METRICS_PULL broadcast races the teardown.
        stop_history = getattr(self.po, "stop_history", None)
        if stop_history is not None:
            try:
                stop_history()
            except Exception as exc:  # noqa: BLE001 - best-effort
                log.warning(f"history stop failed: {exc!r}")
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
        try:
            # One Chrome trace file per node on a clean stop (nothing
            # when tracing is off or recorded nothing).
            self.tracer.export_if_any()
        except Exception as exc:  # noqa: BLE001 - teardown best-effort
            log.warning(f"trace export failed: {exc!r}")
        # An abnormal stop (a CHECK failure, a chaos crash, any CRIT
        # event) dumps the flight ring; a clean stop does not.
        chaos_crashed = getattr(self, "chaos_crashed", None)
        if chaos_crashed is not None and chaos_crashed.is_set():
            self.flight.record("chaos_crash", severity="crit",
                               phase=str(getattr(self, "chaos", None)
                                         and self.chaos.spec.get(
                                             "crash_phase")))
        try:
            path = self.flight.dump_if_abnormal()
            if path:
                log.warning(f"abnormal stop: flight recorder dumped to "
                            f"{path} ({self.flight.abnormal_reason})")
        except Exception as exc:  # noqa: BLE001 - teardown best-effort
            log.warning(f"flight dump failed: {exc!r}")
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
        if m.batch is not None and m.control.empty():
            # Counted once per frame at submission, whichever plane
            # carries it.
            if m.request:
                self._c_batched_frames.inc()
                self._c_batch_ops.inc(len(m.batch.ops))
            else:
                self._c_resp_batched_frames.inc()
                self._c_resp_batch_ops.inc(len(m.batch.ops))
        n_ops = 0
        if m.control.empty():
            # Ops on this frame (a singleton combiner flush is 1).
            n_ops = len(m.batch.ops) if m.batch is not None else 1
        if m.control.empty() and not self.tenants.enabled:
            nbytes = self._native_submit(msg)
            if nbytes is not None:
                # The op itself counts in the core's own block
                # (wire.native.tx.ops).
                self.wire.batch_occupancy(n_ops)
                return nbytes
        if n_ops:
            self.wire.tx_msg(n_ops)
        if (self._chunk_bytes > 0 and m.control.empty() and m.chunk is None
                and m.data_size > self._chunk_bytes
                and m.option != OPT_ZPULL and not m.shm_data):
            # Each chunk rides the lane on its own, so smaller ops of a
            # higher priority can pass between them.  OPT_ZPULL goes
            # whole: its addr places the payload in one piece.
            chunks = split_message(msg, self._chunk_bytes,
                                   next(self._xfer_seq))
            if chunks is not None:
                ev = getattr(msg, "_sent_event", None)
                if ev is not None:
                    # The chunks may ride several lanes (rails): the
                    # event is set once each of them is written.
                    latch = _Countdown(ev, len(chunks))
                    for c in chunks:
                        c._sent_event = latch
                for c in chunks:
                    self._submit_data(c)
                return 0
        return self._submit_data(msg)

    def _submit_data(self, msg: Message) -> int:
        """A data message onto its lane (or inline once the lanes
        stopped); a control message inline."""
        if msg.meta.control.empty() and not self._lane_stop:
            # (unlocked probe; re-checked under the lane lock)
            # Stamped at enqueue, read at dequeue (lane_wait).
            msg._lane_enq = time.monotonic()
            lane = self._lane_for(msg)
            # The HOL mark: bytes this lane sent below the message's
            # priority so far (more at dequeue: it waited behind them).
            msg._hol_mark = lane.q.bytes_below(msg.meta.priority)
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
            if msg.meta.chunk is not None:
                self._c_chunks_sent.inc()
        if self.resender is not None:
            self.resender.add_outgoing(msg)
        trace = msg.meta.trace if msg.meta.control.empty() else 0
        if trace and self.tracer.active:
            t0 = self.tracer.now_us()
            nbytes = self._transmit(msg)
            self.tracer.span(trace, "wire_send", t0, args={
                "dst": msg.meta.recver, "bytes": nbytes})
        else:
            nbytes = self._transmit(msg)
        if msg.meta.control.empty():
            self.profiler.record(msg.meta.key, "send", msg.meta.push)
        log.vlog(2, lambda: f"SEND {msg.debug_string()}")
        return nbytes

    def _transmit(self, msg: Message) -> int:
        """Wire write under the peer's transmit lock — the only
        serialization on the send path, and it is per peer.  A message
        carrying ``_sent_event`` has it set once its bytes are written
        (or the write failed): a replicated push's acknowledgement
        waits for its forwards so."""
        lane = self._lane_for(msg)
        try:
            with lane.tx_mu:
                nbytes = self.send_msg(msg)
        finally:
            ev = getattr(msg, "_sent_event", None)
            if ev is not None:
                ev.set()
        with self._bytes_mu:
            self.send_bytes += nbytes
            self._c_sent_msgs.inc()
            self._c_sent_bytes.inc(nbytes)
            if msg.meta.control.empty():
                self.frames_sent += 1
        # Payload views go to the kernel borrowed (zero-copy); the
        # header and meta are serialized (copied).
        zc = msg.meta.data_size if msg.meta.control.empty() else 0
        if zc > nbytes:
            zc = nbytes
        self.wire.tx_frame(msg.meta.recver, zc, nbytes - zc)
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
            enq = getattr(msg, "_lane_enq", None)
            if enq is not None:
                wait = time.monotonic() - enq
                self._h_lane_wait.observe(wait)
                self.wire.lane_residency(wait)
                mark = getattr(msg, "_hol_mark", None)
                if (mark is not None and msg.meta.priority >= 0
                        and lane.q.bytes_below(msg.meta.priority) > mark):
                    self._h_hol_wait.observe(wait)
                if msg.meta.trace and self.tracer.active:
                    now = self.tracer.now_us()
                    self.tracer.span(
                        msg.meta.trace, "lane_wait", now - wait * 1e6,
                        wait * 1e6, args={"dst": msg.meta.recver})
            try:
                if raw:  # resender retransmit: already sid'd + buffered
                    nbytes = self._transmit(msg)
                else:
                    nbytes = self._dispatch_send(msg)
                lane.q.note_dispatch(msg.meta.priority, nbytes)
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

    def _reset_peer_sids(self, node_id: int) -> None:
        """Forget the sequence state toward a (re)joining peer: its send
        sid, its partial transfers and transfer-id tombstones, and the
        resender's record of its messages (the port delivers in arrival
        order, so there is no expected receive sid or reorder buffer to
        clear)."""
        with self._timestamp_mu:
            self._send_sids.pop(node_id, None)
        self._barrier_last_ts.pop(node_id, None)  # timestamps restart too
        self._assembler.drop_peer(node_id)
        if self.resender is not None:
            for msg in self.resender.reset_peer(node_id):
                self._delivery_failed(msg, PeerDeadError(
                    f"node {node_id} restarted with the message unacked"))

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
                self.flight.record("node_down", severity="warn", peer=d,
                                   detector="heartbeat",
                                   timeout_s=timeout_s)
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
                self.flight.record("node_up", severity="info", peer=node.id)
                self.clear_peer_down(node.id)
            else:
                log.warning(f"peer {node.id} declared dead by the "
                            f"scheduler")
                self.flight.record("node_down", severity="warn",
                                   peer=node.id)
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
                self.flight.record("van_error", severity="warn",
                                   error=repr(exc)[:200])
                continue
            if msg is None:
                break
            # Chunk metas carry data_size 0: count their payload.
            nbytes = (sum(d.nbytes for d in msg.data)
                      if msg.meta.chunk is not None
                      else msg.meta.data_size)
            self.recv_bytes += nbytes
            self._c_recv_msgs.inc()
            self._c_recv_bytes.inc(nbytes)
            ctrl = msg.meta.control
            if ctrl.empty():
                self.frames_recv += 1
                self.wire.rx_msg(len(msg.meta.batch.ops)
                                 if msg.meta.batch is not None else 1,
                                 nbytes)
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
                elif ctrl.cmd == Command.SNAPSHOT:
                    self._process_snapshot(msg)
                elif ctrl.cmd == Command.ROUTING:
                    self._process_routing(msg)
                elif ctrl.cmd == Command.REMOVE_NODE:
                    self._process_remove_node(msg)
                elif ctrl.cmd == Command.METRICS_PULL:
                    self._process_metrics_pull(msg)
                elif ctrl.cmd == Command.TRACE_PULL:
                    self._process_trace_pull(msg)
                else:
                    log.warning(f"unhandled control {ctrl.cmd}: "
                                f"{msg.debug_string()}")
            except log.CheckError as exc:
                # An invariant violation is fatal, like the reference's
                # CHECK -> abort: the process exits 134, so the
                # launcher's keepalive can restart it and local waits do
                # not hang on a zombie.  PS_CHECK_FATAL=0 takes only this
                # node dark (pump and heartbeat stop): in-process test
                # clusters host many logical nodes in one interpreter.
                log.fatal_log(f"CHECK failed: {exc} (while processing "
                              f"{msg.debug_string()}); node going dark")
                # The postmortem now: with PS_CHECK_FATAL the process
                # exits at once and no stop() runs.  The trace ring
                # dumps beside the flight ring.
                trace_path = None
                try:
                    trace_path = self.tracer.export_if_any()
                except Exception:  # noqa: BLE001 - dying anyway
                    pass
                self.flight.record("check_failure", severity="crit",
                                   error=str(exc)[:200],
                                   trace_file=trace_path)
                try:
                    self.flight.dump()
                except Exception:  # noqa: BLE001 - dying anyway
                    pass
                self._stop_event.set()
                if self.env.find_bool("PS_CHECK_FATAL", True):
                    sys.stderr.flush()
                    os._exit(134)
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
        self._c_chunks_recv.inc()
        for out in self._assembler.add(msg):
            self._process_data_msg(out)

    def _process_data_msg(self, msg: Message) -> None:
        self.deliver_data_msg(msg)
        self.profiler.record(msg.meta.key, "recv", msg.meta.push)
        if self.tracer.active:
            # The wire-to-intake boundary every server_queue span starts
            # from: stamped on every data message (a batch envelope
            # carries its traces in the per-op table).
            msg._recv_us = self.tracer.now_us()
            if msg.meta.trace:
                self.tracer.instant(msg.meta.trace, "recv", args={
                    "from": msg.meta.sender, "bytes": msg.meta.data_size,
                    "push": msg.meta.push, "request": msg.meta.request})
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
            self._handle_late_registration(msg.meta.control.node)
            return
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
        roster = self._roster()
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
        if self.po.elastic:
            # Every server holds a table from the start (epoch 0, the
            # static split), so an ownership change is always bounced or
            # parked by a server that knows it: a gaining server that
            # applied requests tableless would have them overwritten by
            # the migration import.
            self.broadcast_routing(self.po.routing_table())

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

    def _roster(self) -> List[Node]:
        return [copy.deepcopy(self.scheduler)] + [
            copy.deepcopy(n) for n in self._registrations]

    def _send_roster(self, peer: int, nodes: List[Node], what: str,
                     option: int = 0) -> None:
        """An ADD_NODE roster to ``peer`` through ``_dispatch_send``,
        caught: a peer may be dead right now, the scheduler's pump must
        survive it, and ``send()`` would re-raise (and so consume) an
        unrelated parked lane error.  A fresh timestamp each time: under
        ``PS_RESEND`` two identical rosters would dedup as one."""
        reply = Message()
        reply.meta.recver = peer
        reply.meta.sender = self.my_node.id
        reply.meta.timestamp = self.next_timestamp()
        reply.meta.option = option
        reply.meta.control = Control(cmd=Command.ADD_NODE, node=nodes)
        try:
            self._dispatch_send(reply)
        except Exception as exc:  # noqa: BLE001 - the peer died since
            log.warning(f"{what} to {peer} failed: {exc!r}")

    def _handle_late_registration(self, nodes: List[Node]) -> None:
        """A post-bootstrap ADD_NODE: another customer on a known node,
        or the recovery of a dead one (reference: van.cc:266-332)."""
        for node in nodes:
            addr = node.addr_key()
            known_id = self._registered_addrs.get(addr, EMPTY_ID)
            if known_id != EMPTY_ID:
                self._send_roster(known_id, self._roster(), "roster resend")
                continue
            dead = [d for d in self.po.get_dead_nodes(
                        self.heartbeat_timeout_s())
                    if is_server_id(d) == (node.role == Role.SERVER)]
            if not dead:
                if (self.po.elastic and node.role == Role.SERVER
                        and node.aux_id == EMPTY_ID):
                    # A new server joining the running cluster, not a
                    # recovery.  A late registrant that names a
                    # preferred rank (DMLC_RANK) is a supervised restart
                    # that beat the detector: admitted as a joiner, it
                    # would orphan its old rank's ranges; it waits for
                    # the detector and the recovery path instead.
                    self._elastic_admit(node, addr)
                    continue
                log.warning(f"unexpected late ADD_NODE from "
                            f"{node.short_debug()}")
                continue
            # With several dead ids of this role, the node's preferred
            # rank names its own (reference van.cc:187-225): any other
            # choice would hand a restarted worker 0 worker 1's place.
            chosen = dead[0]
            if node.aux_id != EMPTY_ID:
                preferred = self.po.instance_rank_to_id(node.role,
                                                        node.aux_id)
                if preferred in dead:
                    chosen = preferred
            node.id = chosen
            node.is_recovery = True
            log.vlog(1, f"recovering node {node.short_debug()}")
            self._reset_peer_sids(node.id)
            # The replacement inherits the dead id: the down mark (and
            # the detector's announced set) clears before the broadcast.
            self.clear_peer_down(node.id)
            self.po.notify_node_failure(node.id, False)
            self.connect(node)
            self._registered_addrs[addr] = node.id
            self.po.update_heartbeat(node.id, time.time())
            self._registrations = [n for n in self._registrations
                                   if n.id != node.id] + [node]
            # The whole roster to the recovered node, the recovered node
            # alone to everyone else (reference: van.cc:266-285).
            roster = self._roster()
            for peer in self._registrations:
                self._send_roster(
                    peer.id,
                    roster if peer.id == node.id else [copy.deepcopy(node)],
                    "recovery broadcast")

    def _process_roster(self, msg: Message) -> None:
        """Non-scheduler handling of the scheduler's ADD_NODE roster."""
        if msg.meta.option == ELASTIC_JOIN_OPT:
            # Admitted as a live elastic joiner: it skips the barrier
            # (is_recovery below) but runs no replica restore.
            self.po.elastic_join = True
        my_addr = self.my_node.addr_key()
        for node in msg.meta.control.node:
            if (self.my_node.id == EMPTY_ID and node.addr_key() == my_addr
                    and node.role == self.my_node.role):
                self.my_node.id = node.id
                self.my_node.is_recovery = node.is_recovery
                self.po.on_id_assigned(node)
            # Never connect worker<->worker or server<->server
            # (reference: README.md:20), but do connect to self: the
            # TERMINATE self-send rides that connection.  Under chain
            # replication servers do connect to their fellow servers.
            if (node.id != self.my_node.id and node.role == self.my_node.role
                    and not (self._connect_server_peers
                             and self.po.is_server
                             and node.role == Role.SERVER)):
                continue
            if node.role == Role.SCHEDULER and not self.po.is_scheduler:
                continue  # connected during start()
            if node.id != self.my_node.id and node.is_recovery:
                # A restarted peer counts its sids (and transfer ids)
                # from the start again: stale state toward it would
                # swallow or misplace its new life's messages.
                self._reset_peer_sids(node.id)
                self.clear_peer_down(node.id)
                self.po.notify_node_failure(node.id, False)
            self.connect(node)
        log.check(self.my_node.id != EMPTY_ID,
                  "scheduler did not assign my id")
        # Seed the scheduler's heartbeat entry now, so a late registrant
        # does not age the scheduler from process start.
        self.po.update_heartbeat(SCHEDULER_ID, time.time())
        self.ready.set()

    # -- cluster telemetry pulls ---------------------------------------------

    def wire_sync(self) -> None:
        """Drain the wire plane's thread-local shards into the registry
        (a native transport also folds its core's counter block in).
        Called on the snapshot path, from any thread."""
        self.wire.flush()

    def _reply_pull(self, msg: Message, body: bytes, failures) -> None:
        reply = Message()
        reply.meta.recver = msg.meta.sender
        reply.meta.sender = self.my_node.id
        reply.meta.request = False
        reply.meta.timestamp = msg.meta.timestamp  # the gather token
        reply.meta.control = Control(cmd=msg.meta.control.cmd)
        reply.meta.body = body
        try:
            # _dispatch_send, not send(): this runs on the pump and must
            # neither take a parked lane error nor die of a send error.
            self._dispatch_send(reply)
        except Exception as exc:  # noqa: BLE001
            failures.inc()
            log.warning(f"{msg.meta.control.cmd.name} reply failed: "
                        f"{exc!r}")

    def _process_metrics_pull(self, msg: Message) -> None:
        """METRICS_PULL: a request is answered with this node's registry
        snapshot (JSON); a reply goes to the scheduler's gather."""
        if not msg.meta.request:
            self.po.absorb_metrics_reply(msg)
            return
        try:
            body = json.dumps(self.po.telemetry_snapshot()).encode()
        except Exception as exc:  # noqa: BLE001 - a bad gauge must not
            # strand the collector waiting for this node.
            body = json.dumps({"node_id": self.my_node.id,
                               "error": repr(exc)}).encode()
        self._reply_pull(msg, body, self._c_pull_reply_failures)

    def _process_trace_pull(self, msg: Message) -> None:
        """TRACE_PULL: a request takes the scheduler's tail-threshold
        hints and is answered with this node's drained span ring, its
        trace-correlated flight events and the eviction count (JSON); a
        reply goes to the scheduler's collector."""
        if not msg.meta.request:
            self.po.absorb_trace_reply(msg)
            return
        try:
            req_body = (json.loads(msg.meta.body.decode())
                        if msg.meta.body else {})
        except Exception:  # noqa: BLE001 - hints are best-effort
            req_body = {}
        hints = req_body.get("hints") or {}
        if hints:
            try:
                self.tracer.note_hints(hints)
            except Exception as exc:  # noqa: BLE001
                log.warning(f"bad TRACE_PULL hints: {exc!r}")
        try:
            spans, evicted = self.tracer.drain()
            flight = [e for e in self.flight.events() if e.get("trace")]
            body = json.dumps({
                "node_id": self.my_node.id, "role": self.po.role_str(),
                "spans": spans, "flight": flight, "evicted": evicted,
            }).encode()
        except Exception as exc:  # noqa: BLE001 - never strand the
            # collector waiting for this node.
            body = json.dumps({"node_id": self.my_node.id,
                               "error": repr(exc)}).encode()
        self._reply_pull(msg, body, self._c_trace_reply_failures)

    # -- snapshots -----------------------------------------------------------

    def _process_snapshot(self, msg: Message) -> None:
        """SNAPSHOT control: a request asks this server to fence and
        export its ranges (or run a namespace op) and goes to the app
        hook (KVServer), which replies from its request thread; a reply
        goes to the scheduler's gather.  A node with no hook answers an
        error, so the commit vetoes instead of waiting out its
        timeout."""
        if not msg.meta.request:
            self.po.absorb_snapshot_reply(msg)
            return
        if self.po.notify_snapshot(msg):
            return
        reply = Message()
        reply.meta.recver = msg.meta.sender
        reply.meta.sender = self.my_node.id
        reply.meta.request = False
        reply.meta.timestamp = msg.meta.timestamp  # the gather token
        reply.meta.control = Control(cmd=Command.SNAPSHOT)
        reply.meta.body = json.dumps(
            {"error": "no KV server registered on this node"}).encode()
        try:
            self._dispatch_send(reply)
        except Exception as exc:  # noqa: BLE001 - the scheduler times out
            log.warning(f"SNAPSHOT reply failed: {exc!r}")

    # -- elastic membership --------------------------------------------------

    def broadcast_routing(self, table) -> None:
        """Scheduler: adopt ``table`` and send it to every live worker
        and server (JSON body on a ROUTING control).  Adopted first, so
        the broadcast reaches a joiner and skips a departed rank."""
        self.po.apply_routing(table)
        body = table.to_json().encode()
        for peer in self.po.get_node_ids(SERVER_GROUP + WORKER_GROUP):
            msg = Message()
            msg.meta.recver = peer
            msg.meta.sender = self.my_node.id
            msg.meta.body = body
            msg.meta.control = Control(cmd=Command.ROUTING)
            msg.meta.timestamp = self.next_timestamp()
            try:
                # On the pump: must not consume a parked lane error or
                # die on one dead peer.
                self._dispatch_send(msg)
            except Exception as exc:  # noqa: BLE001
                log.warning(f"ROUTING broadcast to {peer} failed: {exc!r}")
        # Membership may have shrunk: re-evaluate pending barriers.
        for group, instance in list(self._barrier_senders):
            self._maybe_release_barrier(group, instance)

    def _pull_routing(self) -> None:
        """Ask the scheduler for its current table (a stale node)."""
        pull = Message()
        pull.meta.recver = SCHEDULER_ID
        pull.meta.sender = self.my_node.id
        pull.meta.request = True
        pull.meta.control = Control(cmd=Command.ROUTING)
        pull.meta.timestamp = self.next_timestamp()
        try:
            self._dispatch_send(pull)
        except Exception as exc:  # noqa: BLE001 - the next beat retries
            log.warning(f"routing pull failed: {exc!r}")

    def _process_routing(self, msg: Message) -> None:
        """ROUTING control: at the scheduler a request is a
        ``MIGRATE_DONE_OPT`` note or a stale node's table pull; a
        message with a body is a table to adopt."""
        if msg.meta.request and self.po.is_scheduler:
            if msg.meta.option == MIGRATE_DONE_OPT:
                try:
                    d = json.loads(msg.meta.body.decode())
                    self.po.note_migration_done(int(d["epoch"]),
                                                int(d["begin"]))
                except Exception as exc:  # noqa: BLE001 - the entry expires
                    log.warning(f"bad MIGRATE_DONE note: {exc!r}")
                return
            table = self.po.routing_table()
            if table is None:
                return
            reply = Message()
            reply.meta.recver = msg.meta.sender
            reply.meta.sender = self.my_node.id
            reply.meta.body = table.to_json().encode()
            reply.meta.control = Control(cmd=Command.ROUTING)
            reply.meta.timestamp = self.next_timestamp()
            try:
                self._dispatch_send(reply)
            except Exception as exc:  # noqa: BLE001
                log.warning(f"ROUTING reply failed: {exc!r}")
            return
        if not msg.meta.body:
            return
        try:
            table = RoutingTable.from_json(msg.meta.body)
        except Exception as exc:  # noqa: BLE001 - a corrupt broadcast
            log.warning(f"bad ROUTING body: {exc!r}")
            return
        self.po.apply_routing(table)

    def _process_remove_node(self, msg: Message) -> None:
        """The decommission handshake.  At the scheduler a plain request
        starts a removal (the leaver's ranges reassigned, an epoch
        broadcast) and a ``REMOVE_DONE_OPT`` request finishes it (the
        rank retired, a final epoch, the leaver acknowledged).  At the
        leaver the acknowledgement completes
        ``Postoffice.request_decommission``."""
        if not msg.meta.request:
            self.po._removed_event.set()
            return
        if not self.po.is_scheduler:
            log.warning("REMOVE_NODE request at a non-scheduler; dropped")
            return
        try:
            rank = int(json.loads(msg.meta.body.decode())["rank"])
        except Exception:  # noqa: BLE001 - fall back to the sender id
            rank = self.po.id_to_group_rank(msg.meta.sender)
        table = self.po.routing_table()
        if table is None:
            log.warning("REMOVE_NODE without elastic routing; dropped")
            return
        if msg.meta.option == REMOVE_DONE_OPT:
            self._finish_removal(rank)
            return
        if rank in self._removals_pending:
            return  # a duplicate request
        # Rejected, never aborted: a bad request must not kill the
        # scheduler's pump (the caller's decommission times out).
        survivors = [r for r in table.active
                     if r != rank and r not in table.leaving]
        if rank not in table.active or not survivors:
            log.warning(f"decommission of rank {rank} rejected: "
                        f"active={list(table.active)} "
                        f"leaving={list(table.leaving)}")
            return
        log.warning(f"decommission requested for server rank {rank}")
        self._removals_pending[rank] = msg.meta.sender
        try:
            self.broadcast_routing(table.with_leave(rank))
        except Exception as exc:  # noqa: BLE001 - reject, don't abort
            self._removals_pending.pop(rank, None)
            log.warning(f"decommission of rank {rank} failed: {exc!r}")

    def _finish_removal(self, rank: int) -> None:
        """The leaver migrated everything: retire it (registrations,
        heartbeats, node tables through the final epoch) and acknowledge
        it.  Only a pending removal is acted on: a resent REMOVE_DONE
        arriving after the retirement would strip a joiner that has
        taken the rank since."""
        leaver_id = self._removals_pending.pop(rank, None)
        if leaver_id is None:
            log.vlog(1, f"duplicate REMOVE_DONE for rank {rank}; ignored")
            return
        table = self.po.routing_table()
        log.warning(f"retiring decommissioned server rank {rank} "
                    f"(node {leaver_id})")
        self._registrations = [n for n in self._registrations
                               if n.id != leaver_id]
        self._registered_addrs = {a: i for a, i in
                                  self._registered_addrs.items()
                                  if i != leaver_id}
        with self.po._heartbeat_mu:
            self.po._heartbeats.pop(leaver_id, None)
        self._announced_dead.discard(leaver_id)
        try:
            self.broadcast_routing(table.with_departed(rank))
        except Exception as exc:  # noqa: BLE001 - never abort the pump
            log.warning(f"retirement epoch for rank {rank} failed: "
                        f"{exc!r}")
            return  # no ack: the leaver's decommission times out loudly
        ack = Message()
        ack.meta.recver = leaver_id
        ack.meta.sender = self.my_node.id
        ack.meta.control = Control(cmd=Command.REMOVE_NODE)
        ack.meta.timestamp = self.next_timestamp()
        try:
            self._dispatch_send(ack)
        except Exception as exc:  # noqa: BLE001
            log.warning(f"REMOVE_NODE ack to {leaver_id} failed: {exc!r}")

    def _elastic_admit(self, node: Node, addr: str) -> None:
        """Admit a new server into the running cluster: the smallest
        free rank, the roster broadcast as for a recovery (peers reset
        their sequence state and connect), then a new epoch splitting
        the widest range toward the joiner, marked for migration from
        its donor."""
        log.check(self.po.group_size == 1,
                  "elastic membership requires DMLC_GROUP_SIZE=1")
        table = self.po.routing_table()
        taken = set(table.active) | set(self._removals_pending)
        rank = next(r for r in itertools.count() if r not in taken)
        node.id = server_rank_to_id(rank)
        node.is_recovery = True  # skips the barrier; peers reset sids
        log.warning(f"elastic join: admitting {node.short_debug()} as "
                    f"server rank {rank}")
        self._reset_peer_sids(node.id)
        self.clear_peer_down(node.id)
        self.connect(node)
        self._registered_addrs[addr] = node.id
        self.po.update_heartbeat(node.id, time.time())
        self._registrations = [n for n in self._registrations
                               if n.id != node.id] + [node]
        roster = self._roster()
        for peer in self._registrations:
            joiner = peer.id == node.id
            self._send_roster(
                peer.id, roster if joiner else [copy.deepcopy(node)],
                "join broadcast",
                option=ELASTIC_JOIN_OPT if joiner else 0)
        # The load hint: the split goes to the median hot key of the
        # last metrics pull (the widest range splits without one).
        self.broadcast_routing(
            table.with_join(rank, hot=self.po.hot_key_hint()))

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
        # Active servers: under elastic membership a departed rank is
        # not waited for and a joiner is.
        if instance:
            count += self.po.num_active_server_instances if srv else 0
            count += self.po.num_worker_instances if wrk else 0
        else:
            count += self.po.num_active_servers if srv else 0
            count += self.po.num_workers if wrk else 0
        return count

    def _process_barrier(self, msg: Message, instance: bool) -> None:
        if not msg.meta.request:
            self.po.manage(msg)
            return
        sender, ts = msg.meta.sender, msg.meta.timestamp
        if ts <= self._barrier_last_ts.get(sender, -1):
            # A retransmission of a request already counted: with
            # PS_RESEND, a request that reached this scheduler before its
            # resender existed was never acked nor recorded, so the
            # resender's dedup lets the peer's retransmission through; it
            # must not count toward the next barrier.
            return
        self._barrier_last_ts[sender] = ts
        group = msg.meta.control.barrier_group
        key = (group, instance)
        senders = self._barrier_senders.setdefault(key, set())
        if msg.meta.option == self.BARRIER_CANCEL_OPT:
            senders.discard(msg.meta.sender)
            return
        senders.add(msg.meta.sender)
        self._maybe_release_barrier(group, instance, msg.meta.app_id,
                                    msg.meta.customer_id)

    def _maybe_release_barrier(self, group: int, instance: bool,
                               app_id: int = 0,
                               customer_id: int = 0) -> None:
        """Release a pending barrier once its senders meet the current
        expected count.  Run on every barrier request and on every
        membership change: a barrier whose last arrival preceded a
        retirement epoch would otherwise wait forever for a node that no
        longer exists."""
        key = (group, instance)
        senders = self._barrier_senders.get(key) or set()
        if not senders:
            return
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
        cmd = Command.INSTANCE_BARRIER if instance else Command.BARRIER
        for member in sorted(senders):
            reply = Message()
            reply.meta.recver = member
            reply.meta.app_id = app_id
            reply.meta.customer_id = customer_id
            reply.meta.control = Control(cmd=cmd, barrier_group=group)
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
            if not msg.meta.request and self.po.elastic:
                # The scheduler's reply carries its routing epoch: a
                # node whose ROUTING broadcast was lost learns it is
                # stale here and pulls the table.
                rt = self.po.current_routing()
                if msg.meta.option > (rt.epoch if rt is not None else -1):
                    self._pull_routing()
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
        if self.po.elastic:
            rt = self.po.routing_table()
            if rt is not None:
                reply.meta.option = rt.epoch
        self.send(reply)
