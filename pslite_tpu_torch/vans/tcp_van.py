"""TCP van — the socket transport between OS processes.

Counterpart of ``pslite_tpu/vans/tcp_van.py`` (the reference's ZMQVan,
``src/zmq_van.h``).  Two planes carry the same frames (``wire.py``'s,
byte-identical to the JAX package's), so port and JAX nodes, native or
not, meet in one cluster:

- **Native** (``vans/native.py``, ``docs/native_core.md``; the default
  ``PS_NATIVE=auto`` on a host with 2 or more cores, ``PS_NATIVE=1``
  anywhere): the core owns the sockets.  Data messages go to its
  per-peer sender lanes as descriptors (:meth:`TcpVan._native_submit`)
  which encode, chunk and ``writev`` without the GIL; their payload
  arrays stay pinned until a reaper thread collects the lane's ticket.
  Control frames are written inline by the core.  Receive pumps (one per
  accepted connection, up to ``PSL_IO_THREADS``) frame what arrives and
  ``recv_msg`` pops the core's queue, control and priority frames ahead
  of bulk.  ``PS_NATIVE_RAILS`` (default 2, at most 4) stripes each
  chunked transfer over that many connections per peer; with
  ``PS_NATIVE_REASSEMBLY=1`` the core reassembles transfers itself.
  The resender (``PS_RESEND``) clamps rails to 1 and turns reassembly
  off, and is served by the Python lanes.
- **Python** (``PS_NATIVE=0``): a listener thread accepts connections,
  each pumped by a reader thread into one receive queue (priority
  ordered, weighted fair across tenants); a frame goes out as one
  vectored ``sendmsg``, and data segments are received with
  ``recv_into`` into recycled blocks of a receive pool
  (:class:`_RecvPool`).

- Bind and connect retry (peers start in any order); ``DMLC_LOCAL=1``
  swaps TCP for unix sockets at ``<tmpdir>/pslite_ipc_<port>.sock``,
  the JAX package's paths, reclaiming a stale file under an ``flock``.
- ``PS_TCP_SNDBUF`` / ``PS_TCP_RCVBUF`` cap the kernel buffers.
- A send that hits a broken connection redials the peer's last address
  once after ``PS_RECONNECT_TMO`` ms (-1: never).
- ``register_recv_buffer(sender, key, buf)``: that sender's pushes of
  ``key`` are placed in ``buf`` at delivery.

As in JAX, a native node's intake is the core's queue, which orders by
priority only: ``PS_TENANTS``' weighted-fair receive queue runs on the
Python plane (ROADMAP Queue 3).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import random
import socket
import struct
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import wire
from ..base import is_scheduler_id
from ..message import (
    Message,
    Node,
    OPT_COMPRESS_INT8,
    OPT_XFER_PART,
    OPT_ZPULL,
)
from ..sarray import SArray
from ..utils import logging as log
from ..utils.queues import PriorityRecvQueue
from . import native
from .chunking import (
    NATIVE_XFER_COMPLETE,
    finalize_native_transfer,
    native_descriptor,
    recv_cost,
    recv_priority,
    recv_tenant,
)
from .van import PeerDeadError, Van


def host_cores() -> int:
    """Cores this process may run on (a container pinned to one core of
    a large host counts one)."""
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def local_sock_path(port: int) -> str:
    """``DMLC_LOCAL`` addressing: every peer derives the unix-socket path
    from the advertised port (the reference's ipc:///tmp/<port>), the
    same path as the JAX package's."""
    return os.path.join(tempfile.gettempdir(), f"pslite_ipc_{port}.sock")


def _recv_exact(sock: socket.socket, n: int) -> Optional[memoryview]:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            return None
        got += r
    return view


def _free_block_refcount() -> int:
    """The refcount ``sys.getrefcount(entries[i])`` reads for a block
    only the pool's list holds, calibrated, so an interpreter that counts
    differently never reuses a live block."""
    probe = [np.empty(0, np.uint8)]
    return sys.getrefcount(probe[0])


_FREE_BLOCK_REFS = _free_block_refcount()


class _RecvPool:
    """Recycled uint8 blocks for received data segments.

    A block is handed out again only when nothing outside the pool
    references it: blocks own their data, so every view of a message
    (keys, vals, handler slices) keeps the block's refcount above its
    free baseline until the message is dead.  Power-of-two size classes
    (>= 4 KiB); ``budget_mb`` caps the pooled bytes, free smaller blocks
    are evicted to admit a larger class; blocks above ``_MAX_BLOCK`` are
    not pooled."""

    _MAX_ENTRIES = 64
    _MAX_BLOCK = 128 << 20

    def __init__(self, budget_mb: int = 128):
        self._mu = threading.Lock()  # reader threads share the pool
        self._entries: List[np.ndarray] = []
        self._total = 0
        self._max_total = max(1, budget_mb) << 20
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _class_of(nbytes: int) -> int:
        return 1 << max(12, (max(nbytes, 1) - 1).bit_length())

    def acquire(self, nbytes: int) -> np.ndarray:
        """A uint8 block of at least ``nbytes``, recycled when one is
        free.  (The refcount probes index the list directly: a local
        name would raise the count.)"""
        if nbytes > self._MAX_BLOCK:
            self.misses += 1
            return np.empty(nbytes, np.uint8)
        with self._mu:
            best = -1
            for i in range(len(self._entries)):
                if (self._entries[i].nbytes >= nbytes
                        and sys.getrefcount(self._entries[i])
                        == _FREE_BLOCK_REFS
                        and (best < 0 or self._entries[i].nbytes
                             < self._entries[best].nbytes)):
                    best = i  # the smallest free block that fits
            if best >= 0:
                self.hits += 1
                return self._entries[best]
            block = np.empty(self._class_of(nbytes), np.uint8)
            live = len(self._entries)
            for i in sorted(range(len(self._entries)),
                            key=lambda j: self._entries[j].nbytes):
                if (self._total + block.nbytes <= self._max_total
                        and live < self._MAX_ENTRIES):
                    break
                if (self._entries[i].nbytes < block.nbytes
                        and sys.getrefcount(self._entries[i])
                        == _FREE_BLOCK_REFS):
                    self._total -= self._entries[i].nbytes
                    self._entries[i] = None
                    live -= 1
            self._entries = [e for e in self._entries if e is not None]
            if (len(self._entries) < self._MAX_ENTRIES
                    and self._total + block.nbytes <= self._max_total):
                self._entries.append(block)
                self._total += block.nbytes
            self.misses += 1
            return block

    @staticmethod
    def recv_exact_into(sock: socket.socket, block: np.ndarray,
                        n: int) -> bool:
        view = memoryview(block)
        try:
            got = 0
            while got < n:
                r = sock.recv_into(view[got:n], n - got)
                if r == 0:
                    return False
                got += r
            return True
        finally:
            view.release()  # the block's refcount counts messages only


class TcpVan(Van):
    def __init__(self, postoffice):
        super().__init__(postoffice)
        # PS_NATIVE through the node's Environment: an in-process
        # cluster sets it per node.  auto takes the core where a spare
        # core runs its threads (on one core the extra handoffs cost
        # more than the GIL they avoid, as measured for JAX).
        pref = self.env.find("PS_NATIVE", "auto")
        self._native_allowed = pref not in ("0", "false")
        self._native: Optional[native.NativeTransport] = None
        self._native_rails = 1
        if self._native_allowed and (pref in ("1", "true")
                                     or host_cores() >= 2):
            self._native = native.NativeTransport(self.env)
            resend = self.env.find_int("PS_RESEND", 0) != 0
            # Every transfer's last chunk (and every whole frame) rides
            # rail 0, so completions arrive in submission order.  The
            # resender acknowledges per connection: one rail.
            self._native_rails = 1 if resend else max(1, min(4, (
                self.env.find_int("PS_NATIVE_RAILS", 2))))
            self._native.set_rails(self._native_rails)
            # Opt-in: one delivery per transfer forfeits the server's
            # streamed apply of a push's chunks.
            self._native.set_reassembly(
                not resend
                and self.env.find_int("PS_NATIVE_REASSEMBLY", 0) != 0)
        # Native sends: ticket -> (msg, descriptor), pinned from enqueue
        # to reap (the caller's don't-mutate-until-wait contract).
        self._nat_mu = threading.Lock()
        self._nat_pins: Dict[int, tuple] = {}
        self._nat_peers: set = set()
        self._nat_wake = threading.Event()
        self._nat_reaper: Optional[threading.Thread] = None
        self._queue = PriorityRecvQueue(
            recv_priority, tenant_fn=recv_tenant, cost_fn=recv_cost,
            weights=self._tenant_weights)
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._readers: List[Tuple[threading.Thread, socket.socket]] = []
        self._send_socks: Dict[int, socket.socket] = {}
        self._send_addrs: Dict[int, Tuple[str, int]] = {}
        self._socks_mu = threading.Lock()  # guards the maps, not writes
        # One write lock per peer socket: a frame's vectored write must
        # not interleave with another writer or a redial's close on the
        # same socket; writes to different peers run in parallel.
        self._sock_send_mus: Dict[int, threading.Lock] = {}
        self._closing = False
        self._local = bool(self.env.find_int("DMLC_LOCAL", 0))
        self._bound_path: Optional[str] = None
        self._reconnect_ms = self.env.find_int("PS_RECONNECT_TMO", 100)
        self._sndbuf = self.env.find_int("PS_TCP_SNDBUF", 0)
        self._rcvbuf = self.env.find_int("PS_TCP_RCVBUF", 0)
        if self._native is not None:
            self._native.set_sockbuf(self._sndbuf, self._rcvbuf)
        # (sender, key) -> registered push buffer (zmq_van.h:206-263).
        self._push_recv_bufs: Dict[tuple, np.ndarray] = {}
        self._recv_pool = _RecvPool()

    # -- transport interface -------------------------------------------------

    def bind_transport(self, node: Node, max_retry: int) -> int:
        if self._local:
            return self._bind_local(node, max_retry)
        port = node.port
        if self._native is not None:
            for attempt in range(max_retry + 1):
                try:
                    return self._native.bind(port)
                except OSError:
                    if attempt == max_retry:
                        raise
                    port = 10000 + random.randint(0, 40000)
        for attempt in range(max_retry + 1):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            try:
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                self._apply_buf(s, socket.SO_RCVBUF, self._rcvbuf)
                s.bind(("", port))
                break
            except OSError:
                s.close()
                if attempt == max_retry:
                    raise
                port = 10000 + random.randint(0, 40000)
        s.listen(128)
        self._start_accepting(s)
        return s.getsockname()[1]

    def _start_accepting(self, listener: socket.socket) -> None:
        self._listener = listener
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="tcp-accept", daemon=True)
        self._accept_thread.start()

    @staticmethod
    def _reclaim_stale_local(path: str) -> None:
        """Unlink a socket file no listener owns (a crashed run's), so the
        fixed scheduler port can be bound again."""
        if not os.path.exists(path):
            return
        probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            probe.settimeout(1)
            probe.connect(path)
        except ConnectionRefusedError:
            try:
                os.unlink(path)
            except OSError:
                pass
        except OSError:
            pass
        finally:
            probe.close()

    def _bind_local(self, node: Node, max_retry: int) -> int:
        """``DMLC_LOCAL`` bind: a unix socket whose path encodes the
        advertised port.  Probe-unlink-bind runs under an ``flock`` of
        a sibling ``.lock`` file (left behind on purpose: unlinking it
        would hand a third process another inode to lock)."""
        port = node.port or 10000 + random.randint(0, 40000)
        for attempt in range(max_retry + 1):
            path = local_sock_path(port)
            lock_fd = os.open(path + ".lock", os.O_CREAT | os.O_RDWR, 0o600)
            s = None
            try:
                fcntl.flock(lock_fd, fcntl.LOCK_EX)
                self._reclaim_stale_local(path)
                if self._native is not None:
                    self._native.bind_local(path)  # unlinked at its stop
                    return port
                s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                s.bind(path)
                s.listen(128)
                self._bound_path = path
                self._start_accepting(s)
                return port
            except OSError:
                if s is not None:
                    s.close()
                if attempt == max_retry:
                    raise
                port = 10000 + random.randint(0, 40000)
            finally:
                fcntl.flock(lock_fd, fcntl.LOCK_UN)
                os.close(lock_fd)

    def _retry_connect(self, connect_once, deadline: float = 60.0):
        """Retry until the remote listener is up; ``deadline <= 0``
        tries once (the redial after a failed send)."""
        delay = 0.05
        while True:
            try:
                return connect_once()
            except OSError:
                if deadline <= 0 or self._closing:
                    raise
                time.sleep(delay)
                deadline -= delay
                delay = min(delay * 2, 1.0)

    def connect_transport(self, node: Node, deadline: float = 60.0,
                          timeout_s: float = 30.0) -> None:
        if node.id < 0:
            return
        if self._native is not None:
            self._native_connect(node, deadline, timeout_s)
            return
        if self._local:
            path = local_sock_path(node.port)

            def connect_once():
                s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                s.settimeout(timeout_s)
                try:
                    s.connect(path)
                except OSError:
                    s.close()
                    raise
                s.settimeout(None)
                self._apply_buf(s, socket.SO_SNDBUF, self._sndbuf)
                return s
        else:
            def connect_once():
                s = socket.create_connection((node.hostname, node.port),
                                             timeout=timeout_s)
                s.settimeout(None)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                self._apply_buf(s, socket.SO_SNDBUF, self._sndbuf)
                return s
        self._dial_and_swap(node, connect_once, deadline)

    def _native_connect(self, node: Node, deadline: float,
                        timeout_s: float) -> None:
        """Dial through the core: the main connection, then the extra
        rails to a peer that receives bulk data (not the scheduler; by
        id, as a redial knows the peer by id only)."""
        ms = int(timeout_s * 1000)
        if self._local:
            with self._socks_mu:
                if self._send_addrs.get(node.id) == (node.hostname,
                                                     node.port):
                    return
            path = local_sock_path(node.port)
            self._retry_connect(
                lambda: self._native.connect_local(node.id, path, ms),
                deadline)
        else:
            self._retry_connect(
                lambda: self._native.connect(node.id, node.hostname,
                                             node.port, ms), deadline)
            if self._native_rails > 1 and not is_scheduler_id(node.id):
                for idx in range(1, self._native_rails):
                    self._retry_connect(
                        lambda i=idx: self._native.add_rail(
                            node.id, node.hostname, node.port, ms, i),
                        deadline)
        with self._socks_mu:
            self._send_addrs[node.id] = (node.hostname, node.port)

    @staticmethod
    def _apply_buf(s: socket.socket, opt: int, nbytes: int) -> None:
        if nbytes > 0:
            try:
                s.setsockopt(socket.SOL_SOCKET, opt, nbytes)
            except OSError:
                pass  # advisory: the OS default is merely less bounded

    def _dial_and_swap(self, node: Node, connect_once,
                       deadline: float = 60.0) -> None:
        """Dial (unless this address is connected already), then swap the
        peer's socket under its send lock and close the old one."""
        with self._socks_mu:
            if (self._send_addrs.get(node.id) == (node.hostname, node.port)
                    and node.id in self._send_socks):
                return
        sock = self._retry_connect(connect_once, deadline)
        with self._sock_send_lock(node.id):
            with self._socks_mu:
                old = self._send_socks.pop(node.id, None)
                self._send_socks[node.id] = sock
                self._send_addrs[node.id] = (node.hostname, node.port)
            if old is not None:
                old.close()

    def send_msg(self, msg: Message) -> int:
        try:
            return self._send_msg_once(msg)
        except OSError as exc:
            if self._closing or self._reconnect_ms < 0:
                raise
            log.warning(f"send to node {msg.meta.recver} failed ({exc!r}); "
                        f"redialing in {self._reconnect_ms} ms")
            time.sleep(self._reconnect_ms / 1000.0)
            if self._closing or not self._redial(msg.meta.recver):
                raise
            return self._send_msg_once(msg)

    def _redial(self, recver: int) -> bool:
        """Drop the broken connection and reconnect to the peer's last
        address within a short window (a peer restarting in place)."""
        with self._sock_send_lock(recver):
            with self._socks_mu:
                addr = self._send_addrs.pop(recver, None)
                sock = self._send_socks.pop(recver, None)
            if sock is not None:
                sock.close()
        if addr is None:
            return False
        try:
            self.connect_transport(
                Node(id=recver, hostname=addr[0], ports=[addr[1]]),
                deadline=3.0, timeout_s=3.0)
        except OSError:
            # Keep the address so a later send can redial.
            with self._socks_mu:
                self._send_addrs.setdefault(recver, addr)
            return False
        return True

    def _sock_send_lock(self, recver: int) -> threading.Lock:
        with self._socks_mu:
            mu = self._sock_send_mus.get(recver)
            if mu is None:
                mu = self._sock_send_mus[recver] = threading.Lock()
            return mu

    def _sendv(self, sock: socket.socket, chunks) -> int:
        """One vectored ``sendmsg`` per frame (at most 1,000 iovecs a
        call); after a partial write, ``sendall`` the rest."""
        views = []
        for c in chunks:
            v = memoryview(c)
            if v.format != "B" or v.ndim != 1:
                v = v.cast("B")
            views.append(v)
        for lo in range(0, len(views), 1000):
            part = views[lo:lo + 1000]
            sent = sock.sendmsg(part)
            if sent < sum(v.nbytes for v in part):
                for v in part:
                    if sent >= v.nbytes:
                        sent -= v.nbytes
                        continue
                    sock.sendall(v[sent:] if sent else v)
                    sent = 0
        return sum(v.nbytes for v in views)

    def _send_msg_once(self, msg: Message) -> int:
        recver = msg.meta.recver
        if self._native is not None:
            # Inline, under the core's per-connection write lock.
            data = [memoryview(np.ascontiguousarray(d.data)).cast("B")
                    for d in msg.data]
            return self._native.send(recver, wire.pack_meta(msg.meta), data)
        with self._sock_send_lock(recver):
            with self._socks_mu:
                sock = self._send_socks.get(recver)
            log.check(sock is not None, f"tcp: not connected to node {recver}")
            return self._sendv(sock, wire.pack_frame(msg))

    # -- native data plane (docs/native_core.md) -----------------------------

    def _native_submit(self, msg: Message) -> Optional[int]:
        """Queue a data message on the core's sender lane to its peer and
        return 0: the core stamps the sid, splits chunks and writes
        without the GIL, draining highest priority first as the Python
        lanes do.  None (the Python lanes) without the core, under the
        resender (its per-frame bookkeeping is Python), while draining,
        or for a shared-memory descriptor."""
        if (self._native is None or self.resender is not None
                or self._lane_stop):
            return None
        m = msg.meta
        if m.shm_data:
            return None
        # A zero-copy pull response is placed whole: never chunked.
        chunk_bytes = 0 if m.option == OPT_ZPULL else self._chunk_bytes
        desc = native_descriptor(msg, chunk_bytes, self._xfer_seq)
        with self._nat_mu:
            # Enqueue and pin under one lock: the reaper may collect the
            # ticket before this thread returns, and a ticket without
            # its pin would be dropped and its pin wedge the reaper.
            ticket = self._native.send_enqueue(
                m.recver, m.priority, desc.meta_buf, desc.arrs,
                desc.chunk_bytes, desc.ext_off)
            self._nat_pins[ticket] = (msg, desc)
            self._nat_peers.add(m.recver)
            if self._nat_reaper is None or not self._nat_reaper.is_alive():
                self._nat_reaper = threading.Thread(
                    target=self._native_reaper_loop, name="tcp-native-reap",
                    daemon=True)
                self._nat_reaper.start()
        self._nat_wake.set()
        log.vlog(2, lambda: f"NSEND {msg.debug_string()}")
        return 0  # bytes are accounted at reap

    def _reap_native(self, peers=None) -> None:
        """Collect finished tickets: a sent frame counts its bytes and
        frames; an abandoned one fails its request (unless the van is
        stopping)."""
        nt = self._native
        if nt is None:
            return
        with self._nat_mu:
            targets = list(self._nat_peers if peers is None else peers)
        for peer in targets:
            try:
                done = nt.send_reap(peer)
            except Exception:  # noqa: BLE001 - the core is being torn down
                continue
            for ticket, status in done:
                with self._nat_mu:
                    pin = self._nat_pins.pop(ticket, None)
                if pin is None:
                    continue
                msg, desc = pin
                if status == 0:
                    with self._bytes_mu:
                        self.send_bytes += desc.wire_bytes
                        self.frames_sent += desc.n_chunks
                        if desc.n_chunks > 1:
                            self.chunks_sent += desc.n_chunks
                    self.profiler.record(msg.meta.key, "send",
                                         msg.meta.push)
                    continue
                if self._closing or self._lane_stop:
                    log.warning(f"native lane abandoned a send to node "
                                f"{peer} at shutdown (status {status})")
                    continue
                exc: Exception = (
                    PeerDeadError(f"node {peer} declared dead with the "
                                  f"message in its native send lane")
                    if self.is_peer_down(peer)
                    else OSError(-status, os.strerror(-status)))
                self._delivery_failed(msg, exc)

    def _native_reaper_loop(self) -> None:
        """Poll completions while pins are out, park while idle, leave
        at close after one last reap (``post_stop`` joins this thread
        before it destroys the core)."""
        while True:
            if self._closing:
                self._reap_native()
                return
            if self._nat_pins:
                self._reap_native()
                time.sleep(0.002)
                continue
            self._nat_wake.wait(timeout=0.2)
            self._nat_wake.clear()

    def _drain_send_lanes(self, timeout_s: float = 10.0) -> None:
        # The Python lanes first (their control frames go through the
        # core inline), then the native lanes: TERMINATE overtakes
        # queued data in neither plane.
        super()._drain_send_lanes(timeout_s)
        if self._native is not None and self._nat_pins:
            if not self._native.send_flush(int(timeout_s * 1000)):
                log.warning("native send lanes did not drain before "
                            "shutdown; abandoning the backlog")
            self._reap_native()

    def mark_peer_down(self, node_id: int) -> None:
        super().mark_peer_down(node_id)
        if self._native is not None:
            try:
                self._native.send_cancel(node_id)
            except Exception:  # noqa: BLE001 - the core may be stopping
                pass
            self._reap_native([node_id])

    def _chunk_recv_alloc(self, nbytes: int) -> np.ndarray:
        """Reassembly buffers from the receive pool (its refcount probe
        frees them once the rebuilt message dies)."""
        pool = getattr(self, "_recv_pool", None)  # None inside Van.__init__
        if pool is not None and nbytes > 0:
            return pool.acquire(nbytes)[:nbytes]
        return np.empty(nbytes, np.uint8)

    # -- registered receive buffers (RegisterRecvBuffer, van.h:114-116) -----

    def register_recv_buffer(self, sender_id: int, key: int,
                             buffer: np.ndarray) -> None:
        """Pushes of ``key`` from ``sender_id`` land in ``buffer`` at
        delivery (one outstanding push per pair, kv_app.h:210-217)."""
        self._push_recv_bufs[(sender_id, key)] = buffer

    def _copy_into(self, dst_addr: int, arr: np.ndarray) -> None:
        ctypes.memmove(dst_addr, arr.ctypes.data, arr.nbytes)

    def _registered_for(self, meta, n_data: int) -> Optional[np.ndarray]:
        """The registered buffer a push lands in, or None.  Not for int8
        payloads (codes, not values) nor partials (``OPT_XFER_PART``: the
        reassembled message places the whole)."""
        if not (meta.push and meta.request and meta.control.empty()
                and meta.option not in (OPT_COMPRESS_INT8, OPT_XFER_PART)
                and meta.codec is None and n_data >= 2):
            return None
        return self._push_recv_bufs.get((meta.sender, meta.key))

    def deliver_data_msg(self, msg: Message) -> None:
        """Place a registered push's values in its buffer and alias the
        message's vals to it; any failure delivers the message as is."""
        m = msg.meta
        reg = self._registered_for(m, len(msg.data))
        if reg is None:
            return
        try:
            vals = msg.data[1]
            arr = np.ascontiguousarray(vals.data)
            if np.shares_memory(arr, reg):
                return
            flat = reg.reshape(-1).view(np.uint8)
            if arr.nbytes > flat.nbytes:
                log.warning(f"registered buffer for key {m.key} too small "
                            f"({flat.nbytes} < {arr.nbytes}); delivering "
                            f"unpinned")
                return
            self._copy_into(flat.ctypes.data, arr)
            n = arr.nbytes // np.dtype(vals.dtype).itemsize
            msg.data[1] = SArray(reg.reshape(-1).view(vals.dtype)[:n])
        except Exception as exc:  # noqa: BLE001 - deliver unpinned
            log.warning(f"registered-buffer delivery failed for key "
                        f"{m.key}: {exc!r}; delivering unpinned")

    def recv_msg(self) -> Optional[Message]:
        if self._native is None:
            return self._queue.wait_and_pop()
        res = self._native.recv(-1)
        if res is None:
            return None
        meta_buf, segs = res
        msg = wire.rebuild_message(wire.unpack_meta(meta_buf), segs)
        ck = msg.meta.chunk
        if ck is not None and ck.index == NATIVE_XFER_COMPLETE:
            # The core reassembled the whole transfer: its frames.
            with self._bytes_mu:
                self.chunks_recv += ck.total
                self.frames_recv += ck.total - 1  # _receiving counts one
            return finalize_native_transfer(msg)
        return msg

    def stop_transport(self) -> None:
        """Wake ``recv_msg`` and close every socket: the core's (its
        ``recv`` returns None), the listener (its accept thread wakes),
        the outbound ones, and the inbound ones (their readers end)."""
        self._closing = True
        self._nat_wake.set()  # the reaper leaves after a last reap
        if self._native is not None:
            self._native.stop()
        if self._listener is not None:
            for fn in (lambda: self._listener.shutdown(socket.SHUT_RDWR),
                       self._listener.close):
                try:
                    fn()
                except OSError:
                    pass
        with self._socks_mu:
            socks = list(self._send_socks.values())
            self._send_socks.clear()
        socks += [conn for _t, conn in self._readers]
        for s in socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            s.close()
        if self._bound_path is not None:
            try:
                os.unlink(self._bound_path)
            except OSError:
                pass
            self._bound_path = None
        self._queue.push(None)

    def post_stop(self) -> None:
        # The reaper polls the core: it retires before the core dies.
        reaper = self._nat_reaper
        if reaper is not None and reaper.is_alive():
            self._nat_wake.set()
            reaper.join(timeout=5)
        self._nat_reaper = None
        if self._native is not None:
            self._native.destroy()  # after the receive thread joined
        threads = [t for t, _c in self._readers]
        if self._accept_thread is not None:
            threads.append(self._accept_thread)
        for t in threads:
            t.join(timeout=5)
        self._readers = []
        self._accept_thread = None

    # -- internals -----------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                break
            if not self._local:  # no TCP_NODELAY on AF_UNIX
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._reader_loop, args=(conn,),
                                 name="tcp-reader", daemon=True)
            self._readers.append((t, conn))
            t.start()

    def _reader_loop(self, conn: socket.socket) -> None:
        try:
            while not self._closing:
                hdr = _recv_exact(conn, wire.FRAME_HEADER_SIZE)
                if hdr is None:
                    break
                meta_len, n_data = wire.unpack_frame_header(bytes(hdr))
                lens_buf = _recv_exact(conn, 8 * n_data)
                meta_buf = (None if lens_buf is None
                            else _recv_exact(conn, meta_len))
                if meta_buf is None:
                    break
                lens = struct.unpack(f"<{n_data}Q", bytes(lens_buf))
                meta = wire.unpack_meta(bytes(meta_buf))
                bufs = []
                for ln in lens:
                    ln = int(ln)
                    if ln:
                        block = self._recv_pool.acquire(ln)
                        if not self._recv_pool.recv_exact_into(conn, block,
                                                               ln):
                            break
                        # A slice, so every view's base is the block.
                        bufs.append(block[:ln])
                        continue
                    b = _recv_exact(conn, ln)
                    if b is None:
                        break
                    bufs.append(b)
                if len(bufs) < n_data:
                    break
                # Registered-buffer placement waits for deliver_data_msg:
                # a connection dropped mid-payload must not tear the
                # app's buffer.
                self._queue.push(wire.rebuild_message(meta, bufs))
        except OSError:
            pass
        except Exception as exc:  # noqa: BLE001 - framing lost
            log.warning(f"dropping connection on corrupt frame: {exc!r}")
        finally:
            conn.close()
