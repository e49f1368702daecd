"""ShmVan — same-host IPC: meta over the socket, data through /dev/shm.

Counterpart of ``pslite_tpu/vans/shm_van.py`` (the reference's
IPCTransport inside the RDMA van, ``rdma_transport.h:469-633``): between
peers on one host, a payload of at least ``PS_SHM_MIN_BYTES`` (4 KiB) is
copied into a named shared-memory segment, one per (sender, recver, key,
direction, chunk index) and reused across iterations, and only the meta
frame crosses the socket; the receiver maps the segment and hands the
app a view of it.  The names (``psl_<ns>_...``, ``pslpull_<ns>_...``)
are the JAX package's, so port and JAX nodes on one host meet.  As in
the reference, one message per (key, direction) may be in flight.

Zero-copy pulls: a worker's ``alloc_pull_segment`` creates its pull
buffer as a segment (namespaced by the scheduler's port); a server's
``OPT_ZPULL`` response writes its values straight into it at the slice's
offset and sends keys only.  ``stop_transport`` unlinks every segment
this van created.

The native core (``docs/shm_pipes.md``) adds two tiers unless
``PS_NATIVE=0``: payloads of 1 MiB and more are copied by the
process-wide native copy pool (``PS_SHM_COPY_THREADS``, default 4), and
with ``PS_SHM_RING=1`` same-host peers exchange their whole frame stream
through shared-memory byte pipes instead of the socket
(``pslpipe_<ns>_<sender port>_<receiver port>``, found by the receiver's
poller by name; a writer whose reader stays silent for
``PS_SHM_RING_DEAD_MS`` retires the pipe and goes back to the socket).
The data of this van never rides the native sender lanes
(``_native_submit`` declines): placement into segments happens in
``send_msg``.
"""

from __future__ import annotations

import base64
import copy
import ctypes
import json
import mmap
import os
import threading
from typing import Dict, Optional

import numpy as np

from .. import wire
from ..message import Message, OPT_ZPULL, ZPULL_OFF_BITS
from ..sarray import SArray
from ..utils import logging as log
from . import native
from .tcp_van import TcpVan

SHM_DIR = "/dev/shm"
# Payloads from this size on go through the native copy pool.
COPY_POOL_MIN = 1 << 20


class _Segment:
    def __init__(self, name: str, size: int, create: bool):
        self.name = name
        self.path = os.path.join(SHM_DIR, name)
        self.created = create
        fd = os.open(self.path, os.O_RDWR | (os.O_CREAT if create else 0),
                     0o600)
        try:
            if create:
                os.ftruncate(fd, size)
            else:
                size = os.fstat(fd).st_size
            self.mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        self.size = size

    def close(self, unlink: bool = False) -> None:
        try:
            self.mm.close()
        except BufferError:
            pass  # views still alive: the mapping dies with them
        if unlink:
            try:
                os.unlink(self.path)
            except OSError:
                pass


class ShmVan(TcpVan):
    """The socket plane for meta and remote peers, shared memory for
    same-host payloads.  ``send_msg`` runs under the peer's transmit
    lock and segment names embed the pair, so lanes to different peers
    copy into disjoint segments concurrently; ``_seg_mu`` guards only
    the segment map."""

    _MAX_PULL_MAPPINGS = 64

    def __init__(self, postoffice):
        super().__init__(postoffice)
        self._segments: Dict[str, _Segment] = {}
        self._seg_mu = threading.Lock()
        self._ns = self.env.find("PS_SHM_NS", str(os.getpid()))
        self._peer_hosts: Dict[int, str] = {}
        self._min_bytes = self.env.find_int("PS_SHM_MIN_BYTES", 4096)
        # Pull segments are named by the cluster's scheduler port (the
        # same in every process, unlike the pid default of PS_SHM_NS),
        # so a server derives the name the worker allocated under.
        self._pull_ns = (self.env.find("PS_SHM_NS")
                         or self.env.find("DMLC_PS_ROOT_PORT", "0"))
        # Not gated on the core-count rule: the pool only takes copies of
        # a MiB and more.  Process-wide and never closed, so no van's
        # stop frees it under another van's copy.
        self._copy_pool = None
        n_copy = self.env.find_int("PS_SHM_COPY_THREADS", 4)
        if n_copy > 0 and self._native_allowed:
            self._copy_pool = native.shared_copy_pool(n_copy, self.env)
        self._pipe_mode = False
        self._pipe_bytes = self.env.find_int("PS_SHM_RING_BYTES", 1 << 22)
        if self.env.find_int("PS_SHM_RING", 0):
            if self._native_allowed:
                # The pipes are the core's: asking for them takes the
                # core whatever the core count.
                if self._native is None:
                    self._native = native.NativeTransport(self.env)
                self._pipe_mode = True
            else:
                log.warning("PS_SHM_RING=1 needs the native core, and "
                            "PS_NATIVE=0 selects the Python plane: staying "
                            "on the socket")

    def bind_transport(self, node, max_retry: int) -> int:
        port = super().bind_transport(node, max_retry)
        if self._pipe_mode:
            # Found by name: a booting peer writes ADD_NODE before anyone
            # knows its id.
            self._native.pipe_watch(
                SHM_DIR, f"pslpipe_{self._pull_ns}_", f"_{port}",
                self.env.find_int("PS_SHM_RING_IDLE_US", 0))
        return port

    def connect_transport(self, node, deadline: float = 60.0,
                          timeout_s: float = 30.0) -> None:
        super().connect_transport(node, deadline, timeout_s)
        if node.id >= 0:
            self._peer_hosts[node.id] = node.hostname
            if (self._pipe_mode and node.port and self.my_node.port
                    and node.hostname == self.my_node.hostname):
                path = os.path.join(SHM_DIR, f"pslpipe_{self._pull_ns}_"
                                             f"{self.my_node.port}_"
                                             f"{node.port}")
                try:
                    self._native.pipe_connect(node.id, path,
                                              self._pipe_bytes)
                except OSError as exc:
                    log.warning(f"shm pipe to node {node.id} unavailable "
                                f"({exc!r}); staying on the socket")

    def _same_host(self, recver: int) -> bool:
        host = self._peer_hosts.get(recver)
        return host is not None and host == self.my_node.hostname

    def _segment(self, name: str, size: int, create: bool) -> _Segment:
        with self._seg_mu:
            seg = self._segments.get(name)
            if seg is not None and seg.size >= size:
                return seg
            if seg is not None:
                seg.close(unlink=seg.created)
                # Gone before re-creation, so a failure below cannot
                # leave a closed segment cached.
                del self._segments[name]
            seg = _Segment(name, size, create)
            self._segments[name] = seg
            return seg

    def _copy_into(self, dst_addr: int, arr: np.ndarray) -> None:
        """Large copies in the native pool's threads, the rest inline."""
        if self._copy_pool is not None and arr.nbytes >= COPY_POOL_MIN:
            self._copy_pool.copy(dst_addr, arr.ctypes.data, arr.nbytes)
        else:
            ctypes.memmove(dst_addr, arr.ctypes.data, arr.nbytes)

    def _native_submit(self, msg: Message):
        """Segment placement, zero-copy pull descriptors and the pipes
        live in ``send_msg``: data takes the Python lanes (as in JAX)."""
        return None

    def _seg_write(self, seg: _Segment, off: int, data) -> int:
        """Copy one payload into a segment; returns the bytes written."""
        arr = np.ascontiguousarray(data)
        dst = ctypes.addressof(ctypes.c_char.from_buffer(seg.mm, off))
        self._copy_into(dst, arr)
        return arr.nbytes

    # -- zero-copy pull (is_worker_zpull_) -----------------------------------

    def _pull_segment_name(self, worker_id: int, buf_id: int) -> str:
        return f"pslpull_{self._pull_ns}_{worker_id}_{buf_id}"

    def alloc_pull_segment(self, buf_id: int, nbytes: int) -> np.ndarray:
        """Worker side: the registered pull buffer as a segment servers
        on this host write into; a uint8 view."""
        name = self._pull_segment_name(self.my_node.id, buf_id)
        seg = self._segment(name, nbytes, create=True)
        return np.frombuffer(seg.mm, dtype=np.uint8, count=nbytes)

    def free_pull_segment(self, buf_id: int) -> None:
        name = self._pull_segment_name(self.my_node.id, buf_id)
        with self._seg_mu:
            seg = self._segments.pop(name, None)
        if seg is not None:
            seg.close(unlink=True)

    def _cap_pull_mappings(self) -> None:
        """Unmap the oldest of other nodes' pull segments beyond a
        window (buf ids never repeat; a live one re-opens on use)."""
        mine = f"pslpull_{self._pull_ns}"
        with self._seg_mu:
            names = [n for n, s in self._segments.items()
                     if n.startswith(mine) and not s.created]
            for n in names[: max(0, len(names) - self._MAX_PULL_MAPPINGS)]:
                self._segments.pop(n).close()

    def _try_zpull_send(self, msg: Message) -> int:
        """Server side: write a pull response's values straight into the
        worker's registered segment; only keys (+lens) cross the socket.
        -1 when the path does not apply."""
        m = msg.meta
        if (m.request or not m.pull or m.option != OPT_ZPULL
                or len(msg.data) < 2 or not m.control.empty()
                or not self._same_host(m.recver)):
            return -1
        buf_id = m.addr >> ZPULL_OFF_BITS
        off = m.addr & ((1 << ZPULL_OFF_BITS) - 1)
        name = self._pull_segment_name(m.recver, buf_id)
        arr = np.ascontiguousarray(msg.data[1].data)
        with self._seg_mu:
            new_mapping = name not in self._segments
        try:
            # No exists() first: the worker may unlink in between.
            seg = self._segment(name, off + arr.nbytes, create=False)
        except OSError:
            return -1
        if seg.size < off + arr.nbytes:
            return -1
        self._seg_write(seg, off, arr)
        if new_mapping:
            self._cap_pull_mappings()
        desc = {"zpull_seg": name, "off": off, "nbytes": arr.nbytes,
                "code": m.data_type[1]}
        if m.body:
            desc["body"] = base64.b64encode(bytes(m.body)).decode("ascii")
        meta_only = Message()
        meta_only.meta = copy.copy(m)
        meta_only.meta.body = json.dumps(desc).encode()
        meta_only.meta.shm_data = True
        meta_only.meta.data_type = [m.data_type[0]] + list(m.data_type[2:])
        meta_only.data = [msg.data[0]] + list(msg.data[2:])
        return super().send_msg(meta_only) + arr.nbytes

    def send_msg(self, msg: Message) -> int:
        sent = self._try_zpull_send(msg)
        if sent >= 0:
            return sent
        m = msg.meta
        total = sum(d.nbytes for d in msg.data)
        if (not msg.data or not m.control.empty() or total < self._min_bytes
                or not self._same_host(m.recver)):
            return super().send_msg(msg)
        # Chunks suffix their index: the chunks of one message would
        # otherwise overwrite one segment before the receiver copies.
        ck = m.chunk
        name = (f"psl_{self._ns}_{m.sender}_{m.recver}_{m.key}"
                f"_{int(m.push)}{int(m.request)}"
                + (f"_c{ck.index}" if ck is not None else ""))
        try:
            seg = self._segment(name, total, create=True)
        except OSError as exc:
            log.warning(f"shm segment {name} unavailable ({exc!r}); "
                        f"sending over the socket")
            return super().send_msg(msg)
        off = 0
        for d in msg.data:
            off += self._seg_write(seg, off, d.data)
        meta_only = Message()
        meta_only.meta = copy.copy(m)  # the caller's message stays as is
        meta_only.meta.shm_data = True
        desc = {
            "seg": name,
            "lens": [d.nbytes for d in msg.data],
            # Chunk metas carry an empty data_type (raw uint8 slices).
            "codes": [m.data_type[i] if i < len(m.data_type) else 2
                      for i in range(len(msg.data))],
        }
        if m.body:
            desc["body"] = base64.b64encode(bytes(m.body)).decode("ascii")
        meta_only.meta.body = json.dumps(desc).encode()
        return super().send_msg(meta_only) + total

    def recv_msg(self) -> Optional[Message]:
        msg = super().recv_msg()
        if msg is None or not msg.meta.shm_data:
            return msg
        info = json.loads(msg.meta.body.decode())
        msg.meta.shm_data = False
        body = base64.b64decode(info["body"]) if "body" in info else b""
        if "zpull_seg" in info:
            # The values already sit in this worker's registered buffer:
            # alias them back into the message.
            try:
                seg = self._segment(info["zpull_seg"],
                                    info["off"] + info["nbytes"],
                                    create=False)
            except OSError:
                log.warning(f"zpull segment {info['zpull_seg']} gone; "
                            f"dropping payload")
                msg.meta.body = b""
                return msg
            dt = wire.code_dtype(info["code"])
            vals = np.frombuffer(seg.mm, dtype=dt,
                                 count=info["nbytes"] // np.dtype(dt).itemsize,
                                 offset=info["off"])
            msg.data = [msg.data[0], SArray(vals)] + list(msg.data[1:])
            msg.meta.data_type = ([msg.meta.data_type[0], info["code"]]
                                  + list(msg.meta.data_type[1:]))
            msg.meta.body = body
            return msg
        seg = self._segment(info["seg"], sum(info["lens"]), create=False)
        view = memoryview(seg.mm)
        off = 0
        msg.data = []
        msg.meta.data_type = list(info["codes"])
        for ln, code in zip(info["lens"], info["codes"]):
            msg.data.append(SArray(np.frombuffer(
                view[off:off + ln], dtype=wire.code_dtype(code))))
            off += ln
        msg.meta.body = body
        return msg

    def stop_transport(self) -> None:
        super().stop_transport()
        with self._seg_mu:
            for seg in self._segments.values():
                seg.close(unlink=seg.created)
            self._segments.clear()
