"""TCP van — the socket transport between OS processes.

Counterpart of ``pslite_tpu/vans/tcp_van.py``'s pure-Python path (the
reference's ZMQVan, ``src/zmq_van.h``): a listener accepts inbound
connections, each pumped by a reader thread into one receive queue, and
sends go over one outbound socket per peer.  Frames are ``wire.py``'s,
byte-identical to the JAX package's (its native core writes the same
bytes), so port and JAX nodes meet in one cluster.  A frame goes out as
one vectored ``sendmsg`` of memoryviews, and data segments are received
with ``recv_into`` straight into recycled blocks of a receive pool
(:class:`_RecvPool`).

- Bind and connect retry (peers start in any order); ``DMLC_LOCAL=1``
  swaps TCP for unix sockets at ``<tmpdir>/pslite_ipc_<port>.sock``,
  the JAX package's paths, reclaiming a stale file under an ``flock``.
- ``PS_TCP_SNDBUF`` / ``PS_TCP_RCVBUF`` cap the kernel buffers.
- A send that hits a broken connection redials the peer's last address
  once after ``PS_RECONNECT_TMO`` ms (-1: never).
- ``register_recv_buffer(sender, key, buf)``: that sender's pushes of
  ``key`` are placed in ``buf`` at delivery.
- The receive queue is priority-ordered (FIFO within a level), so a
  priority frame does not wait behind a decoded chunk backlog.

The native core (``vans/native.py``, ``cpp/pslite_core.cc``: GIL-free
lanes, rails, native reassembly) is ROADMAP Queue 1 item 11:
``PS_NATIVE=auto`` (the default) means this Python path, and
``PS_NATIVE=1`` or ``PS_NATIVE_RAILS`` above 1 raise.
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
from ..message import Message, Node, OPT_COMPRESS_INT8, OPT_XFER_PART
from ..sarray import SArray
from ..utils import logging as log
from ..utils.queues import PriorityRecvQueue
from .chunking import recv_cost, recv_priority, recv_tenant
from .van import Van

NATIVE_CORE_ITEM = "ROADMAP Queue 1 item 11: the native core"


def native_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not yet ported to pslite_tpu_torch ({NATIVE_CORE_ITEM})")


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
        if self.env.find("PS_NATIVE", "auto") in ("1", "true"):
            raise native_not_ported("PS_NATIVE=1 (the native core)")
        if self.env.find_int("PS_NATIVE_RAILS", 1) > 1:
            raise native_not_ported("PS_NATIVE_RAILS > 1 (native rails)")
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
        # (sender, key) -> registered push buffer (zmq_van.h:206-263).
        self._push_recv_bufs: Dict[tuple, np.ndarray] = {}
        self._recv_pool = _RecvPool()

    # -- transport interface -------------------------------------------------

    def bind_transport(self, node: Node, max_retry: int) -> int:
        if self._local:
            return self._bind_local(node, max_retry)
        port = node.port
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
        with self._sock_send_lock(recver):
            with self._socks_mu:
                sock = self._send_socks.get(recver)
            log.check(sock is not None, f"tcp: not connected to node {recver}")
            return self._sendv(sock, wire.pack_frame(msg))

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
        return self._queue.wait_and_pop()

    def stop_transport(self) -> None:
        """Wake ``recv_msg`` and close every socket: the listener (its
        accept thread wakes), the outbound ones, and the inbound ones
        (their readers end)."""
        self._closing = True
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
