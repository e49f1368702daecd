"""Message model: Node, Control, Meta, Message.

Copy of ``pslite_tpu/message.py`` (the reference's
``include/ps/internal/message.h``): ``Meta`` carries head/app/customer/
timestamp/routing/flags plus the zero-copy fields (``key``, ``addr``,
``val_len``, ``option``, ``sid``); ``Control`` carries the bootstrap/
barrier/heartbeat plane; ``Node`` describes a process.  The extension
records (``CodecInfo``, ``BatchInfo``, ``ChunkInfo``) and the option
markers are kept because the wire format carries them; this package
sends chunks (``vans/chunking.py``), codec payloads (``ops/codecs.py``),
batched frames (``kv/batching.py``) and ``EXT_QOS`` tenants and stamps.
``OPT_REPLICA`` and ``OPT_WRONG_OWNER`` belong to replication and
elastic routing, ROADMAP Queue 1 item 8(b): the port never sends them.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .base import EMPTY_ID
from .sarray import DeviceType, SArray


class Role(enum.IntEnum):
    SERVER = 0
    WORKER = 1
    SCHEDULER = 2
    JOINT = 3  # worker + server hosted in one process (reference: ps.h:59-76)


class Command(enum.IntEnum):
    """Control commands (reference: message.h:163-164)."""

    EMPTY = 0
    TERMINATE = 1
    ADD_NODE = 2
    BARRIER = 3
    ACK = 4
    HEARTBEAT = 5
    BOOTSTRAP = 6
    ADDR_REQUEST = 7
    ADDR_RESOLVED = 8
    INSTANCE_BARRIER = 9
    # Active failure detection (docs/fault_tolerance.md): the scheduler's
    # detector thread broadcasts the dead node's identity to surviving
    # peers, which mark it down and fail its parked sends fast.
    NODE_FAILURE = 10
    # Cluster telemetry pull (docs/observability.md): the scheduler asks
    # a node for its metrics-registry snapshot; the reply carries it as
    # JSON in meta.body.  Rides the control plane like BARRIER.
    METRICS_PULL = 11
    # Elastic membership (docs/elasticity.md): the scheduler's versioned
    # routing-table broadcast (RoutingTable JSON in meta.body), and a
    # node's table pull (request=True, stale-epoch self-heal).
    ROUTING = 12
    # Graceful decommission (docs/elasticity.md): a server asks the
    # scheduler to leave the running cluster; the scheduler reassigns
    # its key ranges (ROUTING epoch), the server migrates them, reports
    # completion (REMOVE_DONE_OPT), and the scheduler retires it.
    REMOVE_NODE = 13
    # Tail-trace pull (docs/observability.md): the scheduler drains a
    # node's bounded span ring (the reply carries it as JSON in
    # meta.body, plus trace-correlated flight events); the request body
    # piggybacks windowed-quantile threshold hints for the node's
    # tail-keep policy.  Same broadcast+gather shape as METRICS_PULL.
    TRACE_PULL = 14
    # Coordinated cluster snapshot (docs/durability.md): the scheduler
    # asks every server to fence a consistent cut (apply-pool quiesce)
    # and stream its owned ranges to per-range segment files under the
    # snapshot directory; the reply carries the per-range digests as
    # JSON in meta.body, and the scheduler commits the cut by writing
    # the cluster MANIFEST.  Same broadcast+gather shape as
    # METRICS_PULL.
    SNAPSHOT = 15


# Wire dtype codes (stable across hosts; independent of numpy internals).
_DTYPE_TO_CODE = {
    np.dtype(np.int8): 1,
    np.dtype(np.uint8): 2,
    np.dtype(np.int16): 3,
    np.dtype(np.uint16): 4,
    np.dtype(np.int32): 5,
    np.dtype(np.uint32): 6,
    np.dtype(np.int64): 7,
    np.dtype(np.uint64): 8,
    np.dtype(np.float16): 9,
    np.dtype(np.float32): 10,
    np.dtype(np.float64): 11,
}
_CODE_TO_DTYPE = {v: k for k, v in _DTYPE_TO_CODE.items()}
# bfloat16 rides as code 12 when ml_dtypes is present.
try:  # pragma: no cover - availability depends on environment
    import ml_dtypes

    _DTYPE_TO_CODE[np.dtype(ml_dtypes.bfloat16)] = 12
    _CODE_TO_DTYPE[12] = np.dtype(ml_dtypes.bfloat16)
except ImportError:  # pragma: no cover
    pass


# Zero-copy pull option (is_worker_zpull_): when meta.option == OPT_ZPULL
# on a pull request/response, meta.addr encodes the worker's registered
# pull buffer as (buf_id << ZPULL_OFF_BITS) | slice_byte_offset.  Lives
# here (not the app layer) so transports can consume it without importing
# kv_app.
OPT_ZPULL = 2
ZPULL_OFF_BITS = 40

# meta.option marker: vals travel as int8 blocks + fp32 scales (gradient
# compression for DCN-class links; ops/quantize.py scheme).  Lives here
# for the same layering reason as OPT_ZPULL.
OPT_COMPRESS_INT8 = 1

# meta.option marker on an (empty) response: the server-side handler
# raised while applying this request.  The waiting worker still gets its
# response counted — so ``wait`` unblocks — and ``KVWorker.wait`` raises
# instead of returning silently-unapplied data.  Without this, a handler
# bug left the remote waiter hanging until timeout.
OPT_APPLY_ERROR = 3

# meta.option marker on a LOCALLY synthesized (empty) response: the van
# gave up delivering the request (resender retry budget exhausted, or
# the destination was declared dead with the message still parked in
# its send lane).  The owning ``KVWorker.wait`` raises ``TimeoutError``
# instead of hanging on a message the transport already abandoned.
OPT_SEND_FAILED = 4

# meta.option marker on a server→server forwarded push (chain
# replication, kv/replication.py): the receiver applies the payload but
# never re-forwards it and never emits an app-level response; meta.addr
# carries the ORIGIN worker id and meta.timestamp the origin timestamp
# so a worker's failover retry of the same request dedups exactly once.
OPT_REPLICA = 5

# meta.option marker on a LOCALLY constructed partial delivery of a
# chunked streaming transfer (docs/chunking.md): the van's reassembler
# hands the newly completed whole-key prefix of an in-flight push to
# the app layer so apply overlaps the remaining wire time.  Never on
# the wire (chunks are identified by the ChunkInfo meta extension);
# consumers that can't stream simply drop these — the final complete
# message always follows.
OPT_XFER_PART = 6

# meta.option marker on an (empty) response: the server SHED this
# request under admission control (docs/qos.md — the tenant's bounded
# queue was full).  Nothing was applied; the waiting worker's
# ``wait()`` raises a retryable ``OverloadError`` (back off and retry)
# instead of hanging, and completion callbacks are suppressed.
OPT_OVERLOAD = 7

# meta.option marker on an (empty) response: the receiving server does
# NOT own the request's key range under its current routing epoch
# (docs/elasticity.md — the worker raced a membership change with a
# stale table).  Nothing was applied; ``meta.val_len`` carries the
# server's epoch so the worker can pull a fresher table, and the
# deadline sweeper re-slices + re-routes the slice — never a hang,
# never a silent apply at the wrong server.
OPT_WRONG_OWNER = 8


@dataclass(frozen=True)
class CodecInfo:
    """Wire-compression extension (docs/compression.md): the payload's
    vals travel as ``[codes(u8), scales(f32)(, lens(i32))]`` encoded by
    the codec registry (``ops/codecs.py``).  Rides the tagged
    ``EXT_CODEC`` meta extension — NOT ``meta.option`` — so it composes
    with OPT_REPLICA forwards, OPT_ZPULL, and re-chunking, and the
    native lanes' template packing carries it untouched (EXT_CHUNK
    stays the trailing extension).

    On a pull REQUEST, ``raw_len == 0`` means "encode your response
    slice with this codec"; on a push request / pull response,
    ``raw_len`` is the uncompressed payload byte count the decoder
    sizes from."""

    codec: int = 0     # registry wire id (codecs.by_wire_id)
    raw_len: int = 0   # uncompressed vals byte count (0 = request)
    block: int = 0     # elements per scale block (0 = scale-free)
    flags: int = 0     # codecs.FLAG_* bits (e.g. int8 NaN sentinels)


@dataclass(frozen=True)
class BatchOp:
    """One sub-op of a multi-op batched frame (docs/batching.md).

    A batched frame's data section is the concatenation of its sub-ops'
    data segments in op order; ``nseg`` says how many segments this op
    consumed, so the decoder re-slices without byte arithmetic (the
    frame header's per-segment length table already delimits each
    segment).  Every sub-op keeps its OWN timestamp (completion
    accounting), key (slice identity), option (per-op error/overload
    codes on responses), hot-cache ``stamp``, and codec identity —
    batching changes how ops travel, never what they mean."""

    push: bool = False
    pull: bool = False
    timestamp: int = 0
    key: int = 0
    val_len: int = 0
    option: int = 0    # per-op response code (OPT_APPLY_ERROR/OVERLOAD)
    stamp: int = 0     # per-op hot-cache push-version (kv/hot_cache.py)
    nseg: int = 0      # data segments this op owns in the frame
    codec: Optional["CodecInfo"] = None
    # Per-op trace id (telemetry/tracing.py): traced ops MERGE like any
    # other — the id rides the table (packed only when nonzero, so
    # untraced frames are byte-identical to pre-trace builds) and is
    # echoed on the batched response, killing the old observer effect
    # where sampled ops were forced out of the batch plane.
    trace: int = 0


@dataclass(frozen=True)
class BatchInfo:
    """Multi-op aggregation extension (docs/batching.md): this frame
    carries ``len(ops)`` independent small KV ops to one destination.
    Rides the tagged ``EXT_BATCH`` meta extension (wire.py) with the
    per-op table serialized ahead of ``meta.body``; packed BEFORE
    EXT_CODEC/EXT_CHUNK so EXT_CHUNK stays the meta's trailing bytes
    (the native splitter's patch contract)."""

    ops: tuple = ()  # tuple[BatchOp]


@dataclass(frozen=True)
class ChunkInfo:
    """Chunked-transfer wire extension (docs/chunking.md): one large
    data message travels as ``total`` chunk messages, each carrying a
    contiguous byte range of the logical concatenation of the original
    data segments.  Every chunk repeats the segment table (lens +
    dtype codes) so reassembly can start from whichever chunk a
    multi-rail stripe lands first."""

    xfer: int = 0       # per-sender transfer id (unique per message)
    index: int = 0      # this chunk's position, 0..total-1
    total: int = 1      # chunks in the transfer
    offset: int = 0     # byte offset of this chunk in the logical stream
    seg_lens: tuple = ()   # original per-segment byte lengths
    seg_types: tuple = ()  # original per-segment wire dtype codes


def dtype_code(dt) -> int:
    return _DTYPE_TO_CODE.get(np.dtype(dt), 2)  # default: raw bytes


def code_dtype(code: int):
    return _CODE_TO_DTYPE.get(code, np.dtype(np.uint8))


@dataclass
class Node:
    """One process in the cluster (reference: message.h:66-134)."""

    role: Role = Role.SCHEDULER
    id: int = EMPTY_ID
    customer_id: int = 0
    hostname: str = ""
    ports: List[int] = field(default_factory=list)
    dev_types: List[int] = field(default_factory=list)
    dev_ids: List[int] = field(default_factory=list)
    is_recovery: bool = False
    # Opaque transport endpoint name (libfabric-style); unused by tcp/ici.
    endpoint_name: bytes = b""
    # Preferred rank (or transport-specific connection-tracking value).
    aux_id: int = EMPTY_ID

    @property
    def port(self) -> int:
        return self.ports[0] if self.ports else 0

    def addr_key(self) -> str:
        return f"{self.hostname}:{self.port}"

    def short_debug(self) -> str:
        return (
            f"[role={self.role.name}, id={self.id}, ip={self.hostname}, "
            f"ports={self.ports}, is_recovery={self.is_recovery}, "
            f"aux_id={self.aux_id}]"
        )


@dataclass
class Control:
    """System control plane payload (reference: message.h:136-175)."""

    cmd: Command = Command.EMPTY
    node: List[Node] = field(default_factory=list)
    barrier_group: int = 0
    msg_sig: int = 0

    def empty(self) -> bool:
        return self.cmd == Command.EMPTY


@dataclass
class Meta:
    """Message metadata (reference: message.h:177-258)."""

    head: int = EMPTY_ID
    app_id: int = EMPTY_ID
    customer_id: int = 0
    timestamp: int = EMPTY_ID
    sender: int = EMPTY_ID
    recver: int = EMPTY_ID
    request: bool = False
    push: bool = False
    pull: bool = False
    simple_app: bool = False
    # Transport-internal: payload rides out-of-band (shm segment descriptor
    # in body) rather than in the frame's data section.
    shm_data: bool = False
    body: bytes = b""
    data_type: List[int] = field(default_factory=list)
    control: Control = field(default_factory=Control)
    # Zero-copy routing: logical key, destination address token, value length,
    # transport option (rkey-equivalent), and per-peer sequence id.
    key: int = 0
    addr: int = 0
    val_len: int = 0
    option: int = 0
    sid: int = EMPTY_ID
    data_size: int = 0
    # Send-scheduling hint (KVPairs.priority): consumed by the sender's
    # PS_PRIORITY_SCHED heap, and carried on the wire so a server can
    # echo the request's priority into its (bulk) pull response.
    priority: int = 0
    # Distributed tracing (telemetry/tracing.py): nonzero = this request
    # was sampled; every process touching the message records lifecycle
    # spans against this id.  Travels as a backward-compatible wire
    # extension (wire.py) and is echoed on responses.
    trace: int = 0
    # Chunked streaming transfer (docs/chunking.md): non-None marks this
    # message as ONE chunk of a larger transfer.  Travels as a tagged
    # wire extension like ``trace`` — old decoders skip it by length.
    chunk: Optional[ChunkInfo] = None
    # Small-op aggregation (docs/batching.md): non-None marks this
    # frame as a MULTI-OP batch — N independent KV ops to one
    # destination, each with its own timestamp/key/option/stamp/codec
    # in the per-op table.  Request direction (worker op combiner) and
    # response direction (batched group responses + the server's
    # response combiner) share the layout; on responses the per-op
    # option/stamp carry result codes and hot-cache versions.  Tagged
    # EXT_BATCH extension; only ever sent to peers whose batch
    # capability was negotiated/proved (old decoders never see these
    # frames).
    batch: Optional[BatchInfo] = None
    # Wire compression (docs/compression.md): non-None marks the vals
    # payload as codec-encoded (or, on a pull request with raw_len=0,
    # asks the server to encode its response).  Tagged EXT_CODEC
    # extension, packed BEFORE the chunk extension so EXT_CHUNK stays
    # the meta's trailing bytes (the native splitter's patch contract).
    codec: Optional[CodecInfo] = None
    # Multi-tenant QoS (docs/qos.md): the named tenant this message's
    # traffic is accounted to — weighted-fair scheduling in the send
    # lanes / receive intake / apply shards, and per-tenant admission
    # control.  Travels with ``stamp`` in the tagged EXT_QOS extension
    # (packed only when either is nonzero, so default traffic's frames
    # are byte-identical to pre-tenant builds).
    tenant: int = 0
    # Server push-version stamp (kv/hot_cache.py): piggybacked on
    # responses so the worker-side hot-key cache can invalidate —
    # bumped after each push fully applies, echoed at a value every
    # concurrently-snapshotted pull is guaranteed to have observed.
    stamp: int = 0
    src_dev_type: int = int(DeviceType.UNK)
    src_dev_id: int = -1
    dst_dev_type: int = int(DeviceType.UNK)
    dst_dev_id: int = -1


@dataclass
class Message:
    """Meta plus zero-copy data segments (reference: message.h:260-301)."""

    meta: Meta = field(default_factory=Meta)
    data: List[SArray] = field(default_factory=list)

    def add_data(self, arr) -> None:
        sa = arr if isinstance(arr, SArray) else SArray(np.asarray(arr))
        self.data.append(sa)
        self.meta.data_type.append(dtype_code(sa.dtype))
        self.meta.data_size += sa.nbytes

    def debug_string(self) -> str:
        m = self.meta
        parts = [
            f"Meta: request={m.request}",
            f"timestamp={m.timestamp}",
            f"sender={m.sender}",
            f"recver={m.recver}",
        ]
        if not m.control.empty():
            parts.append(f"control={{cmd={m.control.cmd.name}, "
                         f"barrier_group={m.control.barrier_group}, "
                         f"nodes={[n.short_debug() for n in m.control.node]}}}")
        else:
            parts.append(
                f"app={m.app_id} customer={m.customer_id} push={m.push} "
                f"simple_app={m.simple_app} key={m.key}"
            )
        if m.body:
            parts.append(f"body={m.body[:64]!r}")
        if self.data:
            parts.append(f"data_bytes={[d.nbytes for d in self.data]}")
        return " ".join(parts)
