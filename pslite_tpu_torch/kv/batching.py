"""Small-op aggregation plane (``PS_BATCH_BYTES``, ``EXT_BATCH``).

Copy of ``pslite_tpu/kv/batching.py``.  For small transfers the
per-message software cost (one frame, one lane handoff, one customer
dispatch, one response) dominates, not the bytes.  One ``EXT_BATCH``
frame carries N independent small KV ops to one destination; the
server decodes it once, fans the sub-ops into the apply pool as a group
and answers with one response frame carrying every sub-op's result
(per-op error/overload codes and hot-cache stamps in the per-op table).

Worker side, :class:`OpCombiner` is a per-``(destination, tenant,
priority)`` coalescer behind ``KVWorker._send``: ops queue per group, a
dispatcher thread drains whole groups and sends each run of
merge-compatible ops (same app, customer and codec) as one frame,
unmergeable ops in position as their original messages.  With
``PS_BATCH_WINDOW_US=0`` (the default) a cold group closes at the next
pickup; a group that flushed within the last 500 us is mid-storm and
holds its frame open until ``PS_BATCH_MIN_OPS`` ops or
``PS_BATCH_HOLD_US`` (the adaptive hold).  ``PS_BATCH_BYTES`` caps a
frame.  A group of one op is sent as the original message, so low-load
frames are byte-identical to an unbatched build.  ``submit_many``
(``KVWorker.multi_get``) queues a whole fan-out at once and flushes it
at the next pickup.

Declines: codec-mismatched ops never merge; batching never crosses
tenant or priority; zero-copy, ragged ``lens`` and custom ``cmd`` ops
ride unbatched in position; chunking applies above the batch plane (a
big batch frame splits like any data message; its chunks never
stream-apply).

Capability: frames go only to peers that answered the
``BATCH_PROBE_CMD`` probe (``PS_BATCH_NEGOTIATE=0`` skips the probe and
asserts a homogeneous cluster).  The server runs the same combiner with
``response=True`` (``PS_RESP_BATCH_BYTES``) toward senders that proved
batch awareness.  A traced op's wait in the combiner is a
``combine_wait`` span on the node's tracer.
"""

from __future__ import annotations

import copy
import threading
from typing import Callable, Dict, List, Optional, Tuple

from ..message import BatchInfo, BatchOp, Message
from ..utils import logging as log
from ..wire import BATCH_MAX_OPS

# meta.head marker of the batch capability probe (docs/batching.md):
# a tiny pull answered BEFORE the handler — the response's vals carry
# the responder's BATCH_WIRE_VERSION.  A peer that errors (or never
# parses the cmd) is recorded incapable and only ever receives plain
# unbatched frames.  Distinct from HOT_KEYS_CMD (0x407C), MIGRATE_CMD
# (0x314D), and REPLICA_FETCH_CMD (0x5EED).
BATCH_PROBE_CMD = 0x6BA7

# Protocol generation answered by the probe; bump when the per-op
# table layout changes incompatibly.  v2: optional per-op trace id
# (flag-gated u64 after the codec block — wire._BATCH_F_TRACE); a v1
# decoder would misparse a traced table, so v1 peers read as incapable
# and keep receiving plain frames.
BATCH_WIRE_VERSION = 2

# Hard cap on ops per frame.  The u16 wire field is the formal
# ceiling; the binding bound is the kernel's UIO_MAXIOV (1024 iovecs
# per sendmsg/writev): at <= 3 data segments per op, 256 ops keeps a
# frame's iovec list comfortably under it on every transport (the
# native core already writes in 64-iovec batches; the Python sendmsg
# path also slices, but never needs to at this cap).
MAX_OPS_PER_FRAME = min(256, BATCH_MAX_OPS)


def batchable(msg: Message, response: bool = False) -> bool:
    """Structural MERGE eligibility of one already-sliced op message
    (the caller checks capability/config separately): a plain request
    with a default head, no zero-copy placement, no trace id, and a
    fixed-k segment layout — ``keys+vals`` raw (2 segments) or
    ``keys+codes+scales`` codec (3 segments).  Ragged ``lens``
    payloads carry an extra segment either way and are declined: the
    batched server intake and response tables are fixed-k contracts.

    ``response=True`` evaluates the RESPONSE-direction twin (the
    server's response combiner, docs/batching.md): same shape rules,
    but the message must be a response, and empty-data frames (push
    acks, empty pull results — the unbatched ``response()`` sends no
    segments for those either) are mergeable with ``nseg=0``."""
    m = msg.meta
    return (
        m.control.empty()
        and m.request != response
        and m.head == 0
        and m.option == 0
        and not m.shm_data
        and m.chunk is None
        and m.batch is None
        and (0 if response else 1)
        <= len(msg.data) <= (2 if m.codec is None else 3)
    )


def op_wire_cost(msg: Message, response: bool = False) -> int:
    """Bytes one op contributes to a batch frame plus the response
    bytes it will pull back — the quantity ``PS_BATCH_BYTES`` caps.
    Response-direction frames carry the result bytes themselves, so
    only the actual segment bytes count (``val_len`` echoes the
    request's byte budget and would double-charge)."""
    sent = sum(d.nbytes for d in msg.data)
    m = msg.meta
    if not response and m.pull and not m.push:
        return sent + max(0, m.val_len)  # val_len = response nbytes
    return sent


def build_batch_message(msgs: List[Message]) -> Message:
    """Merge N sliced op messages for ONE destination into a single
    EXT_BATCH frame.  The envelope inherits the group-uniform routing
    fields (recver, tenant, priority) from the members; per-op
    identity (timestamp, key, flags, codec) moves into the table."""
    log.check(len(msgs) >= 2, "a batch needs >= 2 ops")
    head = msgs[0].meta
    env = Message()
    m = env.meta
    m.app_id = head.app_id
    m.customer_id = head.customer_id
    m.request = head.request  # False on the response-direction twin
    m.head = 0  # only plain-cmd ops are batchable
    m.recver = head.recver
    m.priority = head.priority
    m.tenant = head.tenant
    m.timestamp = head.timestamp
    m.key = head.key
    ops = []
    data = env.data
    dtypes = m.data_type
    size = 0
    for sub in msgs:
        sm = sub.meta
        m.push = m.push or sm.push
        m.pull = m.pull or sm.pull
        # Splice the member's segments directly: they were built by
        # add_data already, so their dtype codes and byte counts are
        # in the member meta — re-deriving per segment would double
        # the combiner's per-op cost.
        data.extend(sub.data)
        dtypes.extend(sm.data_type)
        size += sm.data_size
        # option/stamp carry through: always 0 on the request
        # direction (batchable() filters), per-op result codes and
        # hot-cache stamps on the response direction.  The trace id
        # moves into the table — the ENVELOPE stays untraced, so span
        # recording stays per-op, never per-frame.
        ops.append(BatchOp(
            push=sm.push, pull=sm.pull, timestamp=sm.timestamp,
            key=sm.key, val_len=sm.val_len, option=sm.option,
            stamp=sm.stamp, nseg=len(sub.data), codec=sm.codec,
            trace=sm.trace,
        ))
    m.data_size = size
    m.batch = BatchInfo(ops=tuple(ops))
    return env


def split_batch_message(msg: Message) -> List[Message]:
    """Re-slice one EXT_BATCH frame into per-op messages (the inverse
    of :func:`build_batch_message`): each sub-message carries its op's
    meta fields with ``batch=None`` and exactly its ``nseg`` data
    segments.  Used for batched RESPONSES on the worker and as the
    server's conservative fallback for configurations the group apply
    declines (elastic gates, registered recv buffers)."""
    info = msg.meta.batch
    out: List[Message] = []
    di = 0
    for op in info.ops:
        sm = Message(meta=copy.copy(msg.meta))
        mm = sm.meta
        mm.batch = None
        mm.push = op.push
        mm.pull = op.pull
        mm.timestamp = op.timestamp
        mm.key = op.key
        mm.val_len = op.val_len
        mm.option = op.option
        mm.stamp = op.stamp
        mm.codec = op.codec
        mm.trace = op.trace
        mm.data_type = []
        mm.data_size = 0
        for seg in msg.data[di:di + op.nseg]:
            sm.add_data(seg)
        di += op.nseg
        out.append(sm)
    return out


class OpCombiner:
    """Per-(destination, tenant, priority, codec) op coalescer (module
    docstring).  ``send`` is the van-send callable; ``on_error(msgs,
    exc)`` fails the member ops when a flush's transport send raises
    (the combiner runs off the caller thread, so exceptions cannot
    propagate to ``push``/``pull``)."""

    def __init__(self, send: Callable[[Message], int],
                 on_error: Callable[[List[Message], Exception], None],
                 max_bytes: int, window_us: float = 0.0,
                 max_ops: int = MAX_OPS_PER_FRAME,
                 min_ops: int = 32, hold_max_us: float = 2000.0,
                 on_sent: Optional[Callable[[List[Message], Message],
                                            None]] = None,
                 response: bool = False, tracer=None):
        self._send = send
        self._on_error = on_error
        # Traced ops record their combiner dwell as a ``combine_wait``
        # span (the batch-plane analog of the van's lane_wait) — the
        # worker-queue checkpoint critical_path.py attributes from.
        if tracer is None:
            from ..telemetry import NULL_TRACER

            tracer = NULL_TRACER
        self._tracer = tracer
        # Response-direction mode (the server's response combiner,
        # docs/batching.md): eligibility and cost use the response
        # rules; everything else — lanes, order, adaptive hold — is
        # direction-agnostic.
        self._response = bool(response)
        # on_sent(members, wire_msg): the frame that actually left —
        # the worker records it per member slice so failover can
        # resender.forget() the right (possibly merged) message.
        self._on_sent = on_sent
        self.max_bytes = int(max_bytes)
        self._window_s = max(0.0, float(window_us)) / 1e6
        self._max_ops = max(2, int(max_ops))
        self._min_ops = max(2, int(min_ops))
        self._hold_max_s = max(0.0, float(hold_max_us)) / 1e6
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        # group key -> [(msg, cost)]; insertion-ordered dict gives the
        # dispatcher a fair FIFO over groups.
        self._groups: Dict[Tuple, List[Tuple[Message, int]]] = {}
        self._bytes: Dict[Tuple, int] = {}
        self._first_enq: Dict[Tuple, float] = {}
        # Groups a submit_many() marked flush-ready: a whole fan-out
        # was queued atomically, so the dispatcher emits it NOW as one
        # run (one frame per lane up to the caps) — no adaptive hold.
        self._ready: set = set()
        # Adaptive hold (window 0 mode): a group that flushed within
        # _HOT_S is mid-storm — hold its next frame open _HOLD_S so the
        # producer's back-to-back ops coalesce.  A group idle longer
        # than _HOT_S never waits, so sporadic single ops dispatch at
        # the next pickup with zero timer latency.
        self._last_flush: Dict[Tuple, float] = {}
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        # Counters read by tests/psmon via the worker.
        self.submitted_ops = 0
        self.flushed_frames = 0
        self.flushed_ops = 0

    @staticmethod
    def group_key(msg: Message) -> Tuple:
        """Group identity = the LANE identity: (destination, tenant,
        priority).  Everything a worker sends toward one lane flows
        through its group in submission order — including ops that can
        never MERGE (codec-mismatched, traced, oversized, zpull, custom
        cmds): those ride the stream as single frames in position, so
        an unbatchable op can never overtake queued batchable siblings
        (order-sensitive handles stay bit-exact).  Cross-group order is
        the lanes' existing cross-priority/tenant relaxation."""
        m = msg.meta
        return (m.recver, m.tenant, m.priority)

    @staticmethod
    def _merge_sig(msg: Message):
        """Frame-compatibility signature: codec-mismatched sub-ops
        never merge (docs/batching.md) — but they DO share the group's
        FIFO, emitting as separate consecutive frames.  app/customer
        ride the ENVELOPE (not the per-op table), so two customers'
        ops — possible on the response direction, where one server
        answers every app on a node — must never share a frame."""
        m = msg.meta
        ci = m.codec
        return (m.app_id, m.customer_id,
                None if ci is None else (ci.codec, ci.raw_len == 0))

    def submit(self, msg: Message) -> None:
        """Queue one sliced op for the dispatcher (the SINGLE flusher —
        per-group frame order is exactly submission order, which is
        what keeps order-sensitive handles bit-exact).  A group at the
        byte/op cap dispatches at the very next pickup; a producer that
        outruns the dispatcher far past the cap blocks briefly
        (bounded memory, natural backpressure)."""
        flush_now = None
        with self._cv:
            if self._stop:
                flush_now = [(msg, 0, False)]  # late: send inline
            else:
                import time as _time

                key, grp, nbytes = self._enqueue_locked(
                    msg, _time.monotonic())
                self._ensure_thread_locked()
                # Wake the dispatcher only when it matters — first op
                # of the group (it may be idle-waiting) or cap reached
                # (flush now); mid-hold submits would only churn its
                # timed wait.
                if (len(grp) == 1 or nbytes >= self.max_bytes
                        or len(grp) >= self._max_ops):
                    self._cv.notify_all()
                # Backpressure: far past the cap, wait for the
                # dispatcher to drain rather than balloon the queue.
                while (not self._stop
                       and self._bytes.get(key, 0) >= 4 * self.max_bytes):
                    self._cv.wait(0.05)
        if flush_now is not None:
            self._flush(flush_now)

    def submit_many(self, msgs: List[Message]) -> None:
        """Queue a whole fan-out ATOMICALLY (``KVWorker.multi_get``):
        every op lands in its lane's group under one lock acquisition,
        and each touched group is marked flush-READY — the dispatcher
        emits it at the very next pickup as one contiguous run (one
        EXT_BATCH frame per lane up to the byte/op caps), skipping the
        adaptive hold.  A serving fan-out thus costs ~one frame per
        contacted destination with no timer latency, instead of
        trickling out while the hold waits for depth."""
        if not msgs:
            return
        late: List[Message] = []
        with self._cv:
            if self._stop:
                late = list(msgs)
            else:
                import time as _time

                now = _time.monotonic()
                touched = set()
                for msg in msgs:
                    key, _grp, _nbytes = self._enqueue_locked(msg, now)
                    self._ready.add(key)
                    touched.add(key)
                self._ensure_thread_locked()
                self._cv.notify_all()
                # Same bounded-memory backpressure as submit(): a
                # producer outrunning the dispatcher blocks until its
                # touched lanes drain rather than balloon the queue.
                while (not self._stop
                       and any(self._bytes.get(k, 0) >= 4 * self.max_bytes
                               for k in touched)):
                    self._cv.wait(0.05)
        for msg in late:
            self._flush([(msg, 0, False)])

    def _enqueue_locked(self, msg: Message, now: float):
        """One op's enqueue bookkeeping (``_cv`` held) — the SINGLE
        implementation behind ``submit`` and ``submit_many``, so the
        two entry points cannot drift.  Returns ``(key, group,
        group_bytes)``."""
        key = self.group_key(msg)
        cost = op_wire_cost(msg, response=self._response)
        mergeable = (batchable(msg, response=self._response)
                     and cost <= self.max_bytes)
        if msg.meta.trace and self._tracer.active:
            msg._comb_enq = now  # combine_wait stamp, read at flush
        grp = self._groups.setdefault(key, [])
        if not grp:
            self._first_enq[key] = now
        grp.append((msg, cost, mergeable))
        self.submitted_ops += 1
        nbytes = self._bytes.get(key, 0) + cost
        self._bytes[key] = nbytes
        if not mergeable and self._response:
            # Response lanes: an unmergeable frame (above all a
            # response_batch envelope — the serving fan-in's dominant
            # return traffic) can never profit from the adaptive hold;
            # holding it would add up to hold_max_us of pure latency
            # per serving request.  Mark the lane flush-ready: the
            # dispatcher emits the whole group (in position, earlier
            # mergeable runs still merge) at the next pickup.  Request
            # lanes keep the hold — there, flushing early would cut
            # the accumulation window of mergeable siblings queued
            # behind sparse unmergeables (traced/oversized ops).
            self._ready.add(key)
        return key, grp, nbytes

    def flush_all(self) -> None:
        """Synchronously drain every queued group (stop path)."""
        while True:
            with self._cv:
                key = next(iter(self._groups), None)
                batch = self._take_locked(key) if key is not None else None
            if batch is None:
                return
            self._flush(batch)

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.flush_all()

    # -- internals -----------------------------------------------------------

    def _ensure_thread_locked(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        t = threading.Thread(target=self._loop, name="kv-op-combiner",
                             daemon=True)
        self._thread = t
        t.start()

    def _take_locked(self, key: Tuple):
        grp = self._groups.pop(key, None)
        self._bytes.pop(key, None)
        self._first_enq.pop(key, None)
        self._ready.discard(key)
        return grp

    # Adaptive-hold parameters (window 0 mode — "close at next
    # pickup").  A group is MID-STORM when ops queued behind the
    # dispatcher's back (>= 2 at pickup) or its previous flush was
    # moments ago: its frame then stays open until it reaches
    # ``min_ops`` (or ``hold_max_us`` passes, or the byte/op cap
    # trips), so back-to-back producer ops coalesce into frames deep
    # enough to amortize the per-frame tax.  A LONE op on a cold group
    # — the low-load case — never waits: it dispatches at the very
    # next pickup, so an idle worker pays only a thread wakeup.
    _HOT_S = 500e-6
    _HOLD_TICK_S = 150e-6

    def _ready_key(self, now: float):
        """Pick a flushable group (lock held): any CAPPED group first
        (its producers may be blocked in submit's backpressure loop),
        then any cold / due group — one holding group must never
        head-of-line-block an unrelated destination's traffic.
        Returns ``(key, None)`` or ``(None, nap_s)`` with the shortest
        sleep until some group becomes due."""
        for key, grp in self._groups.items():
            if (key in self._ready
                    or self._bytes.get(key, 0) >= self.max_bytes
                    or len(grp) >= self._max_ops):
                return key, None
        nap = None
        for key, grp in self._groups.items():
            first = self._first_enq.get(key, now)
            if self._window_s > 0:
                due = first + self._window_s
            else:
                hot = (len(grp) >= 2
                       or now - self._last_flush.get(key, 0.0)
                       < self._HOT_S)
                if not hot or len(grp) >= self._min_ops:
                    return key, None
                due = first + self._hold_max_s
            if now >= due:
                return key, None
            nap = due - now if nap is None else min(nap, due - now)
        return None, nap

    def _loop(self) -> None:
        import time as _time

        while True:
            with self._cv:
                while not self._stop and not self._groups:
                    self._cv.wait()
                if self._stop:
                    return
                key, nap = self._ready_key(_time.monotonic())
                if key is None:
                    # Every group is holding: nap until the earliest
                    # deadline, tick-bounded so a group reaching
                    # min_ops mid-nap flushes within one tick.
                    self._cv.wait(min(nap, self._HOLD_TICK_S))
                    continue  # re-evaluate
                batch = self._take_locked(key)
                if batch:
                    self._last_flush[key] = _time.monotonic()
                    if len(self._last_flush) > 256:
                        self._last_flush.pop(next(iter(self._last_flush)))
                    self._cv.notify_all()  # release backpressured producers
            if batch:
                self._flush(batch)

    def _flush(self, batch: List[Tuple[Message, int, bool]]) -> None:
        """Emit one group's taken items IN ORDER as consecutive
        frames: maximal runs of merge-compatible ops (same codec
        signature, within the byte/op caps) become one EXT_BATCH
        frame; unmergeable items ride as their original single
        messages in position — the stream's order never relaxes."""
        i, n = 0, len(batch)
        while i < n:
            msg, cost, mergeable = batch[i]
            run = [msg]
            i += 1
            if mergeable:
                sig = self._merge_sig(msg)
                run_bytes = cost
                while i < n and batch[i][2] and len(run) < self._max_ops:
                    nmsg, ncost, _m = batch[i]
                    if (self._merge_sig(nmsg) != sig
                            or run_bytes + ncost > 2 * self.max_bytes):
                        break
                    run.append(nmsg)
                    run_bytes += ncost
                    i += 1
            if self._tracer.active:
                import time as _time

                now_m = _time.monotonic()
                for rm in run:
                    enq = getattr(rm, "_comb_enq", None)
                    if enq is None or not rm.meta.trace:
                        continue
                    wait_us = max(0.0, (now_m - enq) * 1e6)
                    self._tracer.span(
                        rm.meta.trace, "combine_wait",
                        self._tracer.now_us() - wait_us, wait_us,
                        args={"dst": rm.meta.recver, "run": len(run)},
                    )
            try:
                if len(run) == 1:
                    # Parity: a lone op travels as its ORIGINAL
                    # unbatched message — low-load frames are identical
                    # to an unbatched build, and single-op latency pays
                    # only the dispatcher wakeup.
                    wire_msg = run[0]
                    self._send(wire_msg)
                else:
                    self.flushed_frames += 1
                    self.flushed_ops += len(run)
                    wire_msg = build_batch_message(run)
                    self._send(wire_msg)
                if self._on_sent is not None:
                    self._on_sent(run, wire_msg)
            except Exception as exc:  # noqa: BLE001 - fail the members
                try:
                    self._on_error(run, exc)
                except Exception as hook_exc:  # noqa: BLE001
                    log.warning(
                        f"combiner error hook failed: {hook_exc!r}"
                    )
