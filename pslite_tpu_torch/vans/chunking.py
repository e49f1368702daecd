"""Chunked streaming transfers (``PS_CHUNK_BYTES``) and receive levels.

Counterpart of ``pslite_tpu/vans/chunking.py``, the pure-Python half:

- :func:`recv_priority` (``:62-106``): the receive-queue level of a
  decoded message.  Control rides above every data level, so a data
  backlog never starves heartbeats, ACKs or barriers; TERMINATE and the
  shutdown sentinel drain last.
- :func:`split_message` (``:117``) turns one large data message into
  ``total`` chunk messages, each a contiguous byte range of the
  concatenated data segments (zero-copy views) plus a ``ChunkInfo`` wire
  extension.  Chunk metas are canonical (empty ``data_type``,
  ``data_size`` 0), so the frames are byte-identical to the JAX
  package's, whichever of its planes (Python or native) sent them.
- :class:`ChunkAssembler` (``:338-550``) is the receive side: a
  per-``(sender, xfer)`` table that copies chunks into per-segment
  buffers in any arrival order, emits ``OPT_XFER_PART`` partials (the
  newly completed whole-key prefix of a plain fixed-k push) and the
  reassembled message on the last chunk; stale duplicates of a completed
  transfer are tombstoned, a dead peer's partial transfers dropped
  (``drop_peer``), idle ones swept after ``ttl_s``.

- :func:`recv_tenant` / :func:`recv_cost` (``:87-110``): the tenant and
  byte charge of a decoded message in the weighted-fair receive queues
  (``PS_TENANTS``); a chunk's meta is a copy of the original's, so
  every chunk carries the message's tenant.

- :func:`native_descriptor` / :func:`finalize_native_transfer`
  (``:175-275``): a data message prepared for the native sender lanes
  (``vans/native.py``: the meta template whose ``EXT_CHUNK`` index and
  offset the core patches per chunk, so native frames are byte-identical
  to :func:`split_message`'s), and the message rebuilt from a transfer
  the core reassembled itself (``PS_NATIVE_REASSEMBLY=1``).  The
  assembler's scatter copies through the native copy pool above
  ``COPY_KERNEL_MIN`` (``:349``).
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..message import ChunkInfo, Command, Control, Message, OPT_XFER_PART
from ..message import code_dtype
from ..sarray import SArray
from ..utils import logging as log
from ..utils.bounded import BoundedKeySet
from ..utils.queues import DRAIN_LEVEL
from ..wire import (
    CHUNK_MAX_SEGS,
    FRAME_HEADER_SIZE,
    chunk_ext_payload_size,
    pack_meta,
)
from .native import COPY_KERNEL_MIN

_UINT64_CODE = 8  # wire dtype code of the keys segment

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


def recv_tenant(msg) -> int:
    """Receive-queue tenant of a decoded message: control and the
    shutdown sentinel are tenantless (they ride the express and drain
    bands, never the weighted pool)."""
    if msg is None or not msg.meta.control.empty():
        return 0
    return msg.meta.tenant


def recv_cost(msg) -> int:
    """Weighted-fair charge of a decoded message: its payload bytes
    (chunk frames carry theirs in ``data``).  A batch frame charges its
    whole multi-op payload: the combiner never merges across tenants or
    priorities, so the envelope prices every sub-op."""
    if msg is None or not msg.meta.control.empty():
        return 1
    if msg.data:
        return max(1, sum(d.nbytes for d in msg.data))
    return max(1, msg.meta.data_size)


def _flat_u8(arr) -> np.ndarray:
    """A contiguous 1-D uint8 view of an array (copying only a strided
    input, as ``wire.pack_frame`` does)."""
    if not (isinstance(arr, np.ndarray) and arr.flags["C_CONTIGUOUS"]):
        arr = np.ascontiguousarray(arr)
    return arr.reshape(-1).view(np.uint8)


def split_message(msg: Message, chunk_bytes: int,
                  xfer_id: int) -> Optional[List[Message]]:
    """The chunk messages of one large data message, or None when it goes
    whole (small, control, already a chunk, or more segments than the
    wire extension holds).  The payloads are views of the original
    segments: the caller must not mutate them until ``wait``."""
    m = msg.meta
    if chunk_bytes <= 0 or not m.control.empty() or m.chunk is not None:
        return None
    n_data = len(msg.data)
    if n_data == 0 or n_data > CHUNK_MAX_SEGS:
        return None
    seg_lens = [d.nbytes for d in msg.data]
    total = sum(seg_lens)
    if total <= chunk_bytes:
        return None
    seg_types = tuple(m.data_type[i] if i < len(m.data_type) else 2
                      for i in range(n_data))
    raws = [_flat_u8(d.data) for d in msg.data]
    bounds = [0]
    for ln in seg_lens:
        bounds.append(bounds[-1] + ln)
    n_chunks = (total + chunk_bytes - 1) // chunk_bytes
    out: List[Message] = []
    for idx in range(n_chunks):
        lo = idx * chunk_bytes
        hi = min(lo + chunk_bytes, total)
        cm = copy.copy(m)
        cm.control = Control()
        cm.data_type = []  # a shallow copy shares the original's list
        cm.data_size = 0
        cm.chunk = ChunkInfo(
            xfer=xfer_id, index=idx, total=n_chunks, offset=lo,
            seg_lens=tuple(seg_lens), seg_types=seg_types,
        )
        cmsg = Message(meta=cm)
        for si in range(n_data):
            a, b = max(lo, bounds[si]), min(hi, bounds[si + 1])
            if a < b:
                cmsg.add_data(SArray(raws[si][a - bounds[si]:b - bounds[si]]))
        # Canonical chunk meta: add_data stamped this chunk's segments
        # into data_type/data_size; clear both, so every chunk of a
        # transfer packs to the same meta bytes but sid/index/offset
        # (receivers read raw slices as uint8; the assembler re-derives
        # the table from the extension).
        cm.data_type = []
        cm.data_size = 0
        out.append(cmsg)
    return out


class NativeDescriptor:
    """One data message prepared for the native sender lanes: the packed
    meta template, the pinned contiguous payload arrays, and the chunk
    parameters the core patches per chunk."""

    __slots__ = ("meta_buf", "arrs", "chunk_bytes", "ext_off", "n_chunks",
                 "wire_bytes")

    def __init__(self, meta_buf, arrs, chunk_bytes, ext_off, n_chunks,
                 wire_bytes):
        self.meta_buf = meta_buf
        self.arrs = arrs          # referenced until the ticket is reaped
        self.chunk_bytes = chunk_bytes
        self.ext_off = ext_off    # EXT_CHUNK payload offset in meta_buf
        self.n_chunks = n_chunks
        self.wire_bytes = wire_bytes


def native_descriptor(msg: Message, chunk_bytes: int,
                      xfer_seq) -> NativeDescriptor:
    """The descriptor of one data message: the meta template (the core
    stamps the sid at transmit), the payload arrays, and, when
    :func:`split_message` would chunk the message, the ``EXT_CHUNK``
    template (``xfer_seq`` is drawn from only then).  ``wire_bytes`` is
    the exact byte count of every frame of the transfer, headers, lens
    tables and metas included."""
    m = msg.meta
    arrs = [_flat_u8(d.data) for d in msg.data]
    seg_lens = [a.nbytes for a in arrs]
    total = sum(seg_lens)
    n_data = len(arrs)
    if not (chunk_bytes > 0 and m.chunk is None
            and 0 < n_data <= CHUNK_MAX_SEGS and total > chunk_bytes):
        meta_buf = pack_meta(m)
        wire = FRAME_HEADER_SIZE + 8 * n_data + len(meta_buf) + total
        return NativeDescriptor(meta_buf, arrs, 0, -1, 1, wire)
    seg_types = tuple(m.data_type[i] if i < len(m.data_type) else 2
                      for i in range(n_data))
    cm = copy.copy(m)
    cm.control = Control()
    cm.data_type = []
    cm.data_size = 0
    n_chunks = (total + chunk_bytes - 1) // chunk_bytes
    cm.chunk = ChunkInfo(xfer=next(xfer_seq), index=0, total=n_chunks,
                         offset=0, seg_lens=tuple(seg_lens),
                         seg_types=seg_types)
    meta_buf = pack_meta(cm)
    # pack_meta writes EXT_CHUNK last: its payload ends the template.
    ext_off = len(meta_buf) - chunk_ext_payload_size(n_data)
    bounds = [0]
    for ln in seg_lens:
        bounds.append(bounds[-1] + ln)
    wire = total + n_chunks * (FRAME_HEADER_SIZE + len(meta_buf))
    for idx in range(n_chunks):
        lo, hi = idx * chunk_bytes, min((idx + 1) * chunk_bytes, total)
        wire += 8 * sum(1 for si in range(n_data)
                        if max(lo, bounds[si]) < min(hi, bounds[si + 1]))
    return NativeDescriptor(meta_buf, arrs, chunk_bytes, ext_off, n_chunks,
                            wire)


# ChunkInfo.index of a frame the native core reassembled itself: its
# segments are the whole transfer's.
NATIVE_XFER_COMPLETE = 0xFFFFFFFF


def finalize_native_transfer(msg: Message) -> Message:
    """The original message of a natively reassembled frame: its
    segments (views of the native frame) re-viewed by the ``EXT_CHUNK``
    dtype table, and the meta fields the chunk template blanked
    restored."""
    ck = msg.meta.chunk
    msg.meta.chunk = None
    msg.meta.data_type = list(ck.seg_types)
    msg.meta.data_size = sum(int(ln) for ln in ck.seg_lens)
    for i, seg in enumerate(msg.data):
        raw = seg.data if isinstance(seg, SArray) else seg
        if not isinstance(raw, np.ndarray):
            raw = np.frombuffer(raw, np.uint8)
        msg.data[i] = SArray(raw.view(code_dtype(ck.seg_types[i])))
    return msg


class _Xfer:
    """Reassembly state of one in-flight transfer."""

    __slots__ = ("meta", "bufs", "seg_lens", "seg_types", "total",
                 "total_bytes", "received", "ends", "got", "contig",
                 "k_bytes", "n_keys", "streamable", "emitted_keys",
                 "t_last")

    def __init__(self, ck: ChunkInfo, meta, alloc=None):
        self.meta = meta  # the original meta (chunk stripped, option kept)
        self.seg_lens = ck.seg_lens
        self.seg_types = ck.seg_types
        self.total = ck.total
        self.total_bytes = sum(ck.seg_lens)
        alloc = alloc or (lambda n: np.empty(n, np.uint8))
        self.bufs = [alloc(int(ln)) for ln in ck.seg_lens]
        self.received = [False] * ck.total
        self.ends = [0] * ck.total  # end offset of each received chunk
        self.got = 0
        self.contig = 0  # chunks contiguous from index 0
        self.t_last = time.monotonic()
        # Partials only for a plain fixed-k push request of exactly a
        # keys and a vals segment.
        self.streamable = bool(
            meta.push and meta.request and not meta.pull
            and not meta.simple_app and meta.option == 0
            and meta.codec is None and meta.batch is None
            and len(ck.seg_lens) == 2 and ck.seg_types[0] == _UINT64_CODE
            and ck.seg_lens[0] > 0 and ck.seg_lens[0] % 8 == 0)
        self.n_keys = int(ck.seg_lens[0]) // 8 if self.streamable else 0
        self.k_bytes = 0
        if self.streamable:
            vb = int(ck.seg_lens[1])
            item = np.dtype(code_dtype(ck.seg_types[1])).itemsize
            # An empty vals segment has no per-key stride.
            if (vb > 0 and vb % self.n_keys == 0
                    and (vb // self.n_keys) % item == 0):
                self.k_bytes = vb // self.n_keys
            else:
                self.streamable = False
        self.emitted_keys = 0

    def watermark(self) -> int:
        """Bytes contiguous from the start of the logical stream."""
        return self.ends[self.contig - 1] if self.contig else 0


class ChunkAssembler:
    """Per-(sender, xfer) reassembly table, one per receiving van.

    ``add`` runs on the van's receive thread; the lock guards against
    ``drop_peer``/``clear`` from other threads."""

    MAX_ENTRIES = 256  # the stalest transfer is evicted beyond this

    def __init__(self, ttl_s: float = 120.0, alloc=None, copy_kernel=None):
        self._alloc = alloc
        # Optional (dst, src, nbytes) copy without the GIL
        # (native.scatter_copy_kernel) for the scatter's large pieces.
        self._copy = copy_kernel
        self._mu = threading.Lock()
        self._xfers: Dict[Tuple[int, int], _Xfer] = {}
        # Tombstones of recently completed transfers: a stale duplicate
        # chunk must not re-create state (its partial would re-apply
        # keys the server already applied).
        self._done = BoundedKeySet(4096)
        self._ttl_s = ttl_s
        self._ticks = 0

    def __len__(self) -> int:
        with self._mu:
            return len(self._xfers)

    def clear(self) -> None:
        with self._mu:
            self._xfers.clear()
            self._done = BoundedKeySet(4096)

    def drop_peer(self, node_id: int) -> int:
        """Reclaim a dead or restarted sender's partial transfers and its
        tombstones (a restarted sender counts its xfer ids from 1 again)."""
        with self._mu:
            stale = [k for k in self._xfers if k[0] == node_id]
            for k in stale:
                del self._xfers[k]
            self._done.discard_where(lambda k: k[0] == node_id)
        if stale:
            log.vlog(1, f"reclaimed {len(stale)} partial transfer(s) from "
                        f"node {node_id}")
        return len(stale)

    def _sweep_stale(self) -> None:
        now = time.monotonic()
        with self._mu:
            stale = [k for k, x in self._xfers.items()
                     if now - x.t_last > self._ttl_s]
            for k in stale:
                del self._xfers[k]
        for k in stale:
            log.warning(f"abandoned partial transfer {k[1]} from node "
                        f"{k[0]} reclaimed after {self._ttl_s:.0f}s")

    def add(self, msg: Message) -> List[Message]:
        """Absorb one chunk; returns the messages ready to deliver: at
        most one ``OPT_XFER_PART`` partial and, on the last chunk, the
        reassembled original."""
        ck = msg.meta.chunk
        key = (msg.meta.sender, ck.xfer)
        self._ticks += 1
        if self._ticks % 256 == 0:
            self._sweep_stale()
        with self._mu:
            x = self._xfers.get(key)
            if x is None and key in self._done:
                return []  # stale duplicate of a completed transfer
            if x is None:
                meta = copy.copy(msg.meta)
                meta.chunk = None
                meta.data_type = list(ck.seg_types)
                meta.data_size = sum(ck.seg_lens)
                x = _Xfer(ck, meta, self._alloc)
                if len(self._xfers) >= self.MAX_ENTRIES:
                    victim = min(self._xfers,
                                 key=lambda k: self._xfers[k].t_last)
                    del self._xfers[victim]
                    log.warning(f"reassembly table full: evicted partial "
                                f"transfer {victim[1]} from node "
                                f"{victim[0]}")
                self._xfers[key] = x
        payload = sum(d.nbytes for d in msg.data)
        if (x.total != ck.total or x.seg_lens != ck.seg_lens
                or not 0 <= ck.index < x.total or ck.offset < 0
                or ck.offset + payload > x.total_bytes):
            # Checked before the scatter: a corrupt frame drops its
            # transfer with a warning, never the node.
            log.warning(f"inconsistent chunk for transfer {ck.xfer} from "
                        f"node {msg.meta.sender}; dropping the transfer")
            with self._mu:
                self._xfers.pop(key, None)
            return []
        if x.received[ck.index]:
            return []  # duplicate chunk
        nbytes = self._scatter(x, ck.offset, msg.data)
        x.received[ck.index] = True
        x.ends[ck.index] = ck.offset + nbytes
        x.got += 1
        x.t_last = time.monotonic()
        while x.contig < x.total and x.received[x.contig]:
            x.contig += 1
        out: List[Message] = []
        final = x.got >= x.total
        if final:
            with self._mu:
                self._xfers.pop(key, None)
                self._done.add(key)
        part = self._partial(x, key, final)
        if part is not None:
            out.append(part)
        if final:
            out.append(self._final(x, key))
        return out

    def _scatter(self, x: _Xfer, offset: int, data) -> int:
        """Copy a chunk's slices into the per-segment buffers; returns
        the chunk's byte count."""
        bounds = [0]
        for ln in x.seg_lens:
            bounds.append(bounds[-1] + int(ln))
        pos, si, total = offset, 0, 0
        for seg in data:
            raw = _flat_u8(seg.data if isinstance(seg, SArray) else seg)
            done = 0
            while done < raw.nbytes:
                while si + 1 < len(bounds) and pos >= bounds[si + 1]:
                    si += 1
                take = min(raw.nbytes - done, bounds[si + 1] - pos)
                b0 = pos - bounds[si]
                if self._copy is not None and take >= COPY_KERNEL_MIN:
                    self._copy(x.bufs[si].ctypes.data + b0,
                               raw.ctypes.data + done, take)
                else:
                    x.bufs[si][b0:b0 + take] = raw[done:done + take]
                done += take
                pos += take
            total += raw.nbytes
        return total

    @staticmethod
    def _partial(x: _Xfer, key: Tuple[int, int],
                 final: bool) -> Optional[Message]:
        """The newly completed whole-key prefix of a streamable push as
        an ``OPT_XFER_PART`` message (views of the reassembly buffers),
        or None."""
        if not x.streamable:
            return None
        keys_avail = min(x.watermark(), int(x.seg_lens[0])) // 8
        vals_avail = max(0, x.watermark() - int(x.seg_lens[0]))
        done_keys = x.n_keys if final else min(keys_avail,
                                               vals_avail // x.k_bytes)
        if done_keys <= x.emitted_keys:
            return None
        a, b = x.emitted_keys, done_keys
        x.emitted_keys = done_keys
        pm = copy.copy(x.meta)
        pm.option = OPT_XFER_PART
        pm.data_type = []
        pm.data_size = 0
        msg = Message(meta=pm)
        msg.add_data(SArray(x.bufs[0][a * 8:b * 8].view(np.uint64)))
        msg.add_data(SArray(x.bufs[1][a * x.k_bytes:b * x.k_bytes].view(
            code_dtype(x.seg_types[1]))))
        # In-process routing token for the app (partials never touch
        # the wire).
        msg._xfer_key = key
        msg._xfer_range = (a, b)
        return msg

    @staticmethod
    def _final(x: _Xfer, key: Tuple[int, int]) -> Message:
        meta = copy.copy(x.meta)
        meta.data_type = []
        meta.data_size = 0
        msg = Message(meta=meta)
        for buf, code in zip(x.bufs, x.seg_types):
            msg.add_data(SArray(buf.view(code_dtype(code))))
        msg._xfer_key = key
        msg._xfer_streamed = x.emitted_keys
        return msg
