"""Wire format: Meta <-> bytes, and message framing.

Copy of ``pslite_tpu/wire.py``, byte for byte in what it writes: the
fixed little-endian meta layout (``WIRE_VERSION`` 2), the tagged
extension tail (``EXT_TRACE``, ``EXT_QOS``, ``EXT_BATCH``, ``EXT_CODEC``,
``EXT_CHUNK``, in that order, ``EXT_CHUNK`` always last) and the frame
``u32 magic | u32 meta_len | u32 n_data | u64 data_len[n_data] | meta |
data...``, so frames of this package and of the JAX package are
interchangeable.  The loopback van round-trips every message through
``pack_frame``/``rebuild_message``.  The fixed offsets below
(``META_*_OFF``) are kept for peers that stamp fields in place.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from .message import (
    BatchInfo,
    BatchOp,
    ChunkInfo,
    CodecInfo,
    Command,
    Control,
    Message,
    Meta,
    Node,
    Role,
    code_dtype,
)
from .sarray import SArray

MAGIC = 0x50535450  # "PSTP"
WIRE_VERSION = 2  # v2: priority field (send scheduling echo)

# Optional trailing extension blocks appended after the node list:
# ``u8 tag | u8 len | payload[len]``.  Decoders skip unknown tags by
# length and older decoders (which stop after the node list) ignore the
# tail entirely, so extensions never bump WIRE_VERSION — the native C++
# core frames meta as opaque bytes and is unaffected.
_EXT_HDR = struct.Struct("<BB")
EXT_TRACE = 1  # payload: u64 trace id (telemetry/tracing.py)
_EXT_TRACE_PAYLOAD = struct.Struct("<Q")
# Chunked streaming transfer (docs/chunking.md): xfer id, chunk index,
# chunk count, byte offset, then the original segment table (u64 len +
# u8 dtype code per segment) so any chunk can seed reassembly.  The
# u8 ext length bounds the table at _CHUNK_MAX_SEGS segments — the van
# only chunks messages within that bound.
EXT_CHUNK = 2
_EXT_CHUNK_FIXED = struct.Struct("<QIIQB")  # xfer index total offset nseg
_EXT_CHUNK_SEG = struct.Struct("<QB")       # seg byte len, dtype code
CHUNK_MAX_SEGS = (255 - _EXT_CHUNK_FIXED.size) // _EXT_CHUNK_SEG.size
# Wire compression (docs/compression.md): codec id, flag bits, scale
# block length (elements), uncompressed payload byte count.  ALWAYS
# packed before EXT_CHUNK: the native chunk splitter patches the meta's
# trailing bytes as the chunk extension, so EXT_CHUNK must stay last.
EXT_CODEC = 3
_EXT_CODEC_PAYLOAD = struct.Struct("<BBHQ")  # codec flags block raw_len
# Multi-tenant QoS (docs/qos.md): tenant id + server push-version
# stamp.  Packed (only when either is nonzero) BEFORE EXT_CODEC /
# EXT_CHUNK, preserving the invariant that EXT_CHUNK stays the meta's
# trailing bytes (the native splitter's patch contract).
EXT_QOS = 4
_EXT_QOS_PAYLOAD = struct.Struct("<HQ")  # tenant, stamp
# Small-op aggregation (docs/batching.md): this frame carries N
# independent KV ops.  The u8 ext length cannot hold a per-op table,
# so the payload is just (n_ops, table_len) and the table itself is
# serialized AHEAD of ``meta.body`` (stripped again at unpack — body
# round-trips unchanged).  Packed before EXT_CODEC/EXT_CHUNK so
# EXT_CHUNK stays the trailing bytes (the native splitter's contract).
# Used in BOTH directions with one layout: request frames (worker op
# combiner; per-op option/stamp always 0) and response frames (batched
# group responses + the server's response combiner; per-op option
# carries OPT_APPLY_ERROR/OPT_OVERLOAD result codes, per-op stamp the
# hot-cache push-version).  Capability-gated both ways: senders only
# emit EXT_BATCH toward peers that answered the batch probe, and
# servers only aggregate responses toward senders that probed (or sent
# an EXT_BATCH frame) — old decoders never see these frames.
EXT_BATCH = 5
_EXT_BATCH_PAYLOAD = struct.Struct("<HI")  # n_ops, table_len
_BATCH_OP_FIXED = struct.Struct("<BBiQqqQ")
# flags, nseg, timestamp, key, val_len, option, stamp
# Per-op trace id (telemetry/tracing.py): a u64 appended AFTER the
# codec block when the flag is set — untraced ops (and therefore whole
# untraced frames) stay byte-identical to pre-trace builds.  The
# addition is capability-gated by BATCH_WIRE_VERSION (kv/batching.py):
# peers answering an older version never receive EXT_BATCH frames.
_BATCH_F_PUSH, _BATCH_F_PULL, _BATCH_F_CODEC, _BATCH_F_TRACE = 1, 2, 4, 8
BATCH_MAX_OPS = 0xFFFF  # u16 op count


def _pack_batch_table(info: BatchInfo) -> bytes:
    parts = []
    for op in info.ops:
        flags = (
            (_BATCH_F_PUSH if op.push else 0)
            | (_BATCH_F_PULL if op.pull else 0)
            | (_BATCH_F_CODEC if op.codec is not None else 0)
            | (_BATCH_F_TRACE if op.trace else 0)
        )
        parts.append(_BATCH_OP_FIXED.pack(
            flags, op.nseg & 0xFF, op.timestamp, op.key % (1 << 64),
            op.val_len, op.option, op.stamp % (1 << 64),
        ))
        if op.codec is not None:
            cd = op.codec
            parts.append(_EXT_CODEC_PAYLOAD.pack(
                cd.codec & 0xFF, cd.flags & 0xFF, cd.block & 0xFFFF,
                cd.raw_len % (1 << 64),
            ))
        if op.trace:
            parts.append(_EXT_TRACE_PAYLOAD.pack(op.trace % (1 << 64)))
    return b"".join(parts)


def _unpack_batch_table(table: memoryview, n_ops: int) -> BatchInfo:
    ops = []
    off = 0
    for _ in range(n_ops):
        flags, nseg, ts, key, val_len, option, stamp = (
            _BATCH_OP_FIXED.unpack_from(table, off)
        )
        off += _BATCH_OP_FIXED.size
        codec = None
        if flags & _BATCH_F_CODEC:
            c_id, c_flags, c_block, c_raw = _EXT_CODEC_PAYLOAD.unpack_from(
                table, off
            )
            off += _EXT_CODEC_PAYLOAD.size
            codec = CodecInfo(codec=c_id, raw_len=c_raw, block=c_block,
                              flags=c_flags)
        trace = 0
        if flags & _BATCH_F_TRACE:
            (trace,) = _EXT_TRACE_PAYLOAD.unpack_from(table, off)
            off += _EXT_TRACE_PAYLOAD.size
        ops.append(BatchOp(
            push=bool(flags & _BATCH_F_PUSH),
            pull=bool(flags & _BATCH_F_PULL),
            timestamp=ts, key=key, val_len=val_len, option=option,
            stamp=stamp, nseg=nseg, codec=codec, trace=trace,
        ))
    return BatchInfo(ops=tuple(ops))

_META_FIXED = struct.Struct(
    "<B"  # version
    "iiiii i"  # head app_id customer_id timestamp sender recver
    "B"  # flags: request|push|pull|simple_app
    "Q Q q q i q i"  # key addr val_len option sid data_size priority
    "b i b i"  # src_dev_type src_dev_id dst_dev_type dst_dev_id
    "B i Q"  # control_cmd barrier_group msg_sig
    "H H I"  # num_nodes num_data_types body_len
)

# Fixed byte offsets inside _META_FIXED consumed by the native core
# (cpp/pslite_core.cc): the sender lanes stamp ``sid`` at transmit time
# and patch the chunk extension per chunk, the express receive lane
# peeks ``priority``/``control_cmd``.  Asserted against the struct
# layout in tests/test_wire.py — keep in sync with the kMeta* constants
# in pslite_core.cc.
META_SID_OFF = 58
META_PRIORITY_OFF = 70
META_CONTROL_CMD_OFF = 84
META_FIXED_SIZE = _META_FIXED.size  # 105


def chunk_ext_payload_size(nseg: int) -> int:
    """Byte length of an EXT_CHUNK payload with ``nseg`` segments —
    the native chunk splitter locates the extension as the trailing
    ``payload`` bytes of the packed meta (pack_meta appends it last)."""
    return _EXT_CHUNK_FIXED.size + nseg * _EXT_CHUNK_SEG.size

_NODE_FIXED = struct.Struct("<B i i B i H H H H")  # role id customer_id
# is_recovery aux_id hostname_len num_ports num_devs endpoint_len

_F_REQUEST, _F_PUSH, _F_PULL, _F_SIMPLE, _F_SHM = 1, 2, 4, 8, 16


def _pack_node(n: Node) -> bytes:
    host = n.hostname.encode()
    ndev = len(n.dev_types)
    out = [
        _NODE_FIXED.pack(
            int(n.role),
            n.id,
            n.customer_id,
            int(n.is_recovery),
            n.aux_id,
            len(host),
            len(n.ports),
            ndev,
            len(n.endpoint_name),
        ),
        host,
        struct.pack(f"<{len(n.ports)}i", *n.ports),
        struct.pack(f"<{ndev}i", *n.dev_types),
        struct.pack(f"<{ndev}i", *n.dev_ids),
        bytes(n.endpoint_name),
    ]
    return b"".join(out)


def _unpack_node(buf: memoryview, off: int) -> Tuple[Node, int]:
    (role, nid, cust, is_rec, aux, hlen, nports, ndev, elen) = _NODE_FIXED.unpack_from(
        buf, off
    )
    off += _NODE_FIXED.size
    host = bytes(buf[off : off + hlen]).decode()
    off += hlen
    ports = list(struct.unpack_from(f"<{nports}i", buf, off))
    off += 4 * nports
    dev_types = list(struct.unpack_from(f"<{ndev}i", buf, off))
    off += 4 * ndev
    dev_ids = list(struct.unpack_from(f"<{ndev}i", buf, off))
    off += 4 * ndev
    endpoint = bytes(buf[off : off + elen])
    off += elen
    node = Node(
        role=Role(role),
        id=nid,
        customer_id=cust,
        hostname=host,
        ports=ports,
        dev_types=dev_types,
        dev_ids=dev_ids,
        is_recovery=bool(is_rec),
        endpoint_name=endpoint,
        aux_id=aux,
    )
    return node, off


def pack_meta(meta: Meta) -> bytes:
    flags = (
        (_F_REQUEST if meta.request else 0)
        | (_F_PUSH if meta.push else 0)
        | (_F_PULL if meta.pull else 0)
        | (_F_SIMPLE if meta.simple_app else 0)
        | (_F_SHM if meta.shm_data else 0)
    )
    ctrl = meta.control
    # Small-op aggregation (docs/batching.md): the per-op table rides
    # ahead of the caller's body bytes; EXT_BATCH records (n_ops,
    # table_len) so the decoder strips it back out — meta.body itself
    # round-trips unchanged.
    body = bytes(meta.body)
    batch_table = b""
    if meta.batch is not None:
        batch_table = _pack_batch_table(meta.batch)
        body = batch_table + body
    fixed = _META_FIXED.pack(
        WIRE_VERSION,
        meta.head,
        meta.app_id,
        meta.customer_id,
        meta.timestamp,
        meta.sender,
        meta.recver,
        flags,
        meta.key % (1 << 64),
        meta.addr % (1 << 64),
        meta.val_len,
        meta.option,
        meta.sid,
        meta.data_size,
        meta.priority,
        meta.src_dev_type,
        meta.src_dev_id,
        meta.dst_dev_type,
        meta.dst_dev_id,
        int(ctrl.cmd),
        ctrl.barrier_group,
        ctrl.msg_sig % (1 << 64),
        len(ctrl.node),
        len(meta.data_type),
        len(body),
    )
    parts = [fixed]
    parts.append(bytes(bytearray(min(c, 255) for c in meta.data_type)))
    parts.append(body)
    for n in ctrl.node:
        parts.append(_pack_node(n))
    if meta.trace:
        parts.append(_EXT_HDR.pack(EXT_TRACE, _EXT_TRACE_PAYLOAD.size))
        parts.append(_EXT_TRACE_PAYLOAD.pack(meta.trace % (1 << 64)))
    if meta.tenant or meta.stamp:
        parts.append(_EXT_HDR.pack(EXT_QOS, _EXT_QOS_PAYLOAD.size))
        parts.append(_EXT_QOS_PAYLOAD.pack(
            meta.tenant & 0xFFFF, meta.stamp % (1 << 64),
        ))
    if meta.batch is not None:
        parts.append(_EXT_HDR.pack(EXT_BATCH, _EXT_BATCH_PAYLOAD.size))
        parts.append(_EXT_BATCH_PAYLOAD.pack(
            len(meta.batch.ops) & 0xFFFF, len(batch_table),
        ))
    if meta.codec is not None:
        cd = meta.codec
        parts.append(_EXT_HDR.pack(EXT_CODEC, _EXT_CODEC_PAYLOAD.size))
        parts.append(_EXT_CODEC_PAYLOAD.pack(
            cd.codec & 0xFF, cd.flags & 0xFF, cd.block & 0xFFFF,
            cd.raw_len % (1 << 64),
        ))
    if meta.chunk is not None:
        ck = meta.chunk
        nseg = len(ck.seg_lens)
        payload = [_EXT_CHUNK_FIXED.pack(
            ck.xfer % (1 << 64), ck.index, ck.total, ck.offset, nseg,
        )]
        for ln, code in zip(ck.seg_lens, ck.seg_types):
            payload.append(_EXT_CHUNK_SEG.pack(int(ln), int(code)))
        blob = b"".join(payload)
        parts.append(_EXT_HDR.pack(EXT_CHUNK, len(blob)))
        parts.append(blob)
    return b"".join(parts)


def unpack_meta(buf: bytes) -> Meta:
    view = memoryview(buf)
    fields = _META_FIXED.unpack_from(view, 0)
    (
        version,
        head,
        app_id,
        customer_id,
        timestamp,
        sender,
        recver,
        flags,
        key,
        addr,
        val_len,
        option,
        sid,
        data_size,
        priority,
        src_dt,
        src_di,
        dst_dt,
        dst_di,
        ctrl_cmd,
        barrier_group,
        msg_sig,
        num_nodes,
        num_dtypes,
        body_len,
    ) = fields
    if version != WIRE_VERSION:
        raise ValueError(f"wire version mismatch: {version} != {WIRE_VERSION}")
    off = _META_FIXED.size
    data_type = list(view[off : off + num_dtypes])
    off += num_dtypes
    body = bytes(view[off : off + body_len])
    off += body_len
    nodes = []
    for _ in range(num_nodes):
        node, off = _unpack_node(view, off)
        nodes.append(node)
    trace = 0
    chunk = None
    codec = None
    batch = None
    tenant = 0
    stamp = 0
    while off + _EXT_HDR.size <= len(view):
        tag, ext_len = _EXT_HDR.unpack_from(view, off)
        off += _EXT_HDR.size
        if off + ext_len > len(view):
            break  # truncated tail: ignore, extensions are optional
        if tag == EXT_TRACE and ext_len == _EXT_TRACE_PAYLOAD.size:
            (trace,) = _EXT_TRACE_PAYLOAD.unpack_from(view, off)
        elif tag == EXT_QOS and ext_len == _EXT_QOS_PAYLOAD.size:
            tenant, stamp = _EXT_QOS_PAYLOAD.unpack_from(view, off)
        elif tag == EXT_BATCH and ext_len == _EXT_BATCH_PAYLOAD.size:
            n_ops, table_len = _EXT_BATCH_PAYLOAD.unpack_from(view, off)
            # The per-op table rode ahead of the caller's body bytes
            # (see pack_meta): strip it back out so body round-trips.
            if table_len <= len(body):
                batch = _unpack_batch_table(
                    memoryview(body)[:table_len], n_ops
                )
                body = body[table_len:]
        elif tag == EXT_CODEC and ext_len == _EXT_CODEC_PAYLOAD.size:
            c_id, c_flags, c_block, c_raw = _EXT_CODEC_PAYLOAD.unpack_from(
                view, off
            )
            codec = CodecInfo(codec=c_id, raw_len=c_raw, block=c_block,
                              flags=c_flags)
        elif tag == EXT_CHUNK and ext_len >= _EXT_CHUNK_FIXED.size:
            xfer, index, total, c_off, nseg = _EXT_CHUNK_FIXED.unpack_from(
                view, off
            )
            if ext_len == _EXT_CHUNK_FIXED.size + nseg * _EXT_CHUNK_SEG.size:
                so = off + _EXT_CHUNK_FIXED.size
                seg_lens, seg_types = [], []
                for _ in range(nseg):
                    ln, code = _EXT_CHUNK_SEG.unpack_from(view, so)
                    so += _EXT_CHUNK_SEG.size
                    seg_lens.append(ln)
                    seg_types.append(code)
                chunk = ChunkInfo(
                    xfer=xfer, index=index, total=total, offset=c_off,
                    seg_lens=tuple(seg_lens), seg_types=tuple(seg_types),
                )
        off += ext_len  # unknown tags skip by length
    meta = Meta(
        head=head,
        app_id=app_id,
        customer_id=customer_id,
        timestamp=timestamp,
        sender=sender,
        recver=recver,
        request=bool(flags & _F_REQUEST),
        push=bool(flags & _F_PUSH),
        pull=bool(flags & _F_PULL),
        simple_app=bool(flags & _F_SIMPLE),
        shm_data=bool(flags & _F_SHM),
        body=body,
        data_type=data_type,
        control=Control(
            cmd=Command(ctrl_cmd), node=nodes, barrier_group=barrier_group,
            msg_sig=msg_sig,
        ),
        key=key,
        addr=addr,
        val_len=val_len,
        option=option,
        sid=sid,
        data_size=data_size,
        priority=priority,
        trace=trace,
        chunk=chunk,
        codec=codec,
        batch=batch,
        tenant=tenant,
        stamp=stamp,
        src_dev_type=src_dt,
        src_dev_id=src_di,
        dst_dev_type=dst_dt,
        dst_dev_id=dst_di,
    )
    return meta


# -- stream framing ----------------------------------------------------------

_FRAME_HDR = struct.Struct("<III")  # magic, meta_len, n_data


def pack_frame(msg: Message) -> List[bytes]:
    """Serialize a message into an iovec-style list of byte chunks.

    Data segments are passed through zero-copy (memoryviews over the numpy
    buffers) so large tensors are never copied on the send path.
    """
    meta_buf = pack_meta(msg.meta)
    lens = struct.pack(f"<{len(msg.data)}Q", *[d.nbytes for d in msg.data])
    hdr = _FRAME_HDR.pack(MAGIC, len(meta_buf), len(msg.data))
    chunks: List[bytes] = [hdr, lens, meta_buf]
    for d in msg.data:
        arr = d.data
        # Fast path: already-contiguous arrays (the overwhelmingly
        # common case — every KVPairs slice is) go straight to a
        # memoryview; ascontiguousarray is reserved for the rare
        # strided view, where it actually has to copy.
        if not (isinstance(arr, np.ndarray) and arr.flags["C_CONTIGUOUS"]):
            arr = np.ascontiguousarray(arr)
        chunks.append(memoryview(arr).cast("B"))
    return chunks


def unpack_frame_header(hdr: bytes) -> Tuple[int, int]:
    magic, meta_len, n_data = _FRAME_HDR.unpack(hdr)
    if magic != MAGIC:
        raise ValueError(f"bad frame magic: {magic:#x}")
    return meta_len, n_data


FRAME_HEADER_SIZE = _FRAME_HDR.size


def rebuild_message(meta: Meta, data_bufs: List[bytes]) -> Message:
    """Reassemble a Message from unpacked meta + raw data segments.

    Segments may be bytes-like (frombuffer view) or uint8 ndarrays (the
    tcp van's pooled receive arena — a .view keeps every derived array's
    ``base`` collapsed onto the pool-owned block, which is what lets the
    pool's refcount probe prove the block is free again).
    """
    msg = Message(meta=meta)
    for i, raw in enumerate(data_bufs):
        code = meta.data_type[i] if i < len(meta.data_type) else 2
        if isinstance(raw, np.ndarray):
            arr = raw.view(code_dtype(code))
        else:
            arr = np.frombuffer(raw, dtype=code_dtype(code))
        msg.data.append(SArray(arr))
    return msg
