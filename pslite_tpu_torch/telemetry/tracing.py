# The port's copy of pslite_tpu/telemetry/tracing.py (it imports nothing
# of JAX); names and numbers match the JAX package's.
"""Distributed request tracing — tail-based capture over span rings.

Two capture modes share one span vocabulary:

- **Tail-based** (``PS_TRACE_TAIL``, docs/observability.md): EVERY
  request mints a trace id up front (a counter, not a coin flip) and
  every node records its lifecycle spans into a bounded ring; at
  completion the WORKER keeps the trace only if it is *interesting* —
  slower than a rolling per-path quantile, a failure outcome, or a
  small uniform floor (:class:`~.trace_store.TailPolicy`).  Rings are
  drained live by the scheduler's ``TRACE_PULL`` broadcast
  (``Postoffice.collect_cluster_traces``) and stitched into complete
  request trees by :class:`~.trace_store.TraceCollector`; unkept
  requests' ambient spans simply age out.
- **Head-sampled** (``PS_TRACE_SAMPLE``, the legacy knob): the id is
  minted with probability p at ``KVWorker.push/pull`` and every
  downstream stage keys on it — unchanged behavior, same ring.

A trace id rides in ``Message.meta.trace`` (a backward-compatible
tagged wire extension — wire.py) and, for ops merged into ``EXT_BATCH``
frames, in the per-op table, so traced ops batch exactly like untraced
ones (no observer effect).  Timestamps are ``monotonic_ns`` offsets
re-based onto a per-node wall anchor, so spans from different nodes
share one timeline — both for the live collector and for the per-node
Chrome trace-event JSON exports (``PS_TRACE_DIR``), which a periodic
background flush keeps crash-safe (``PS_TRACE_FLUSH_S``).
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import random
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..utils.profiling import MonotonicAnchor
from .trace_store import TailPolicy


class Tracer:
    """Per-node span recorder.  ``active`` is False unless head
    sampling (``PS_TRACE_SAMPLE > 0``) or tail capture
    (``PS_TRACE_TAIL``) is configured — every recording call no-ops
    then, so the tracer costs one attribute check on untraced
    deployments."""

    MAX_EVENTS = 65536

    # How long a TRACE_PULL threshold hint outranks the local-histogram
    # fallback (the scheduler's windowed p-quantile is the better
    # signal, but a dead scheduler must not freeze the keep policy).
    HINT_TTL_S = 30.0

    def __init__(self, env, role: str, metrics=None):
        self.sample = env.find_float("PS_TRACE_SAMPLE", 0.0)
        # Tail-based capture (trace_store.TailPolicy): parsed once;
        # None = tail mode off (head sampling only).
        self.tail = TailPolicy.parse(env.find("PS_TRACE_TAIL"))
        self.active = self.sample > 0.0 or self.tail is not None
        self.role = role
        self.node_id = -1  # assigned at bootstrap (export-time pid)
        # Default export into the system tempdir, NOT the cwd: traced
        # clusters launched from a checkout were littering (and once
        # committing) pslite_trace_*.json at the repo root.  The files
        # are also gitignored; set PS_TRACE_DIR to collect them.
        self._dir = env.find("PS_TRACE_DIR") or tempfile.gettempdir()
        ring = env.find_int("PS_TRACE_RING", 0)
        if ring > 0:
            self.MAX_EVENTS = ring  # instance shadow
        self._mu = threading.Lock()
        self._events: collections.deque = collections.deque()
        self.dropped = 0
        # Silent span loss made visible (docs/observability.md):
        # head-sampled mode DROPS the newest span on a full buffer and
        # counts it as ``trace.dropped_events`` (psmon warns the export
        # is incomplete).  Tail mode instead EVICTS the oldest — the
        # ring is a window the TRACE_PULL drain keeps emptying, and
        # overwrite is by design — counted as ``trace.ring_evictions``
        # (no warning; a high rate means pull more often or grow
        # PS_TRACE_RING).
        if metrics is not None:
            self._c_dropped = metrics.counter("trace.dropped_events")
            self._c_evicted = metrics.counter("trace.ring_evictions")
        else:
            from .metrics import NULL_REGISTRY

            self._c_dropped = NULL_REGISTRY.counter("trace.dropped_events")
            self._c_evicted = NULL_REGISTRY.counter("trace.ring_evictions")
        # Cross-node clock alignment: durations come from monotonic_ns,
        # absolute timestamps re-base onto ONE wall anchor per tracer
        # (the Profiler's timebase — utils/profiling.MonotonicAnchor).
        self._anchor = MonotonicAnchor()
        # Tail id minting: node-unique ids without an RNG call per op —
        # a random per-tracer salt in the high bits, a counter below.
        # 30 salt bits keep cross-node collision odds negligible even
        # for hundreds of (restarting) workers (birthday over 2^30),
        # and 33 sequence bits outlast any realistic ring lifetime;
        # ids stay under 2^63 like the head-sampled ones.
        self._id_salt = random.getrandbits(30) | 1
        self._id_seq = itertools.count(1)
        # Tail keep thresholds per path ("push"/"pull"): TRACE_PULL
        # hints (wall-stamped) outrank the local histogram fallback
        # (set_tail_source) for HINT_TTL_S.
        self._thr_mu = threading.Lock()
        self._hints: Dict[str, Tuple[float, float]] = {}  # path->(v, t)
        self._sources: Dict[str, object] = {}
        self._local_thr: Dict[str, Tuple[Optional[float], int]] = {}
        self._evicted_since_drain = 0
        # Crash-safe exports: a background thread rewrites this node's
        # trace file every PS_TRACE_FLUSH_S seconds (tail default 15;
        # 0 disables), so a SIGKILL'd node still leaves its spans.
        self._flush_s = env.find_float(
            "PS_TRACE_FLUSH_S", 15.0 if self.tail is not None else 0.0
        )
        self._flush_thread: Optional[threading.Thread] = None

    # -- ids & clock ---------------------------------------------------------

    def maybe_trace(self) -> int:
        """Legacy head sampling: a fresh nonzero trace id with
        probability ``PS_TRACE_SAMPLE``, else 0 (untraced — every
        downstream stage checks the id, not the sampling knob, so the
        decision is made exactly once)."""
        if self.sample <= 0.0 or random.random() >= self.sample:
            return 0
        return random.getrandbits(63) | 1

    def begin_request(self) -> int:
        """Trace id for a NEW request.  Tail mode: every request gets
        one (cheap counter — the keep/drop decision moves to
        completion, see :meth:`tail_keep`); otherwise the head-sampled
        legacy decision."""
        if self.tail is not None:
            return (self._id_salt << 33) | (next(self._id_seq)
                                            & ((1 << 33) - 1))
        return self.maybe_trace()

    def now_us(self) -> float:
        """Wall-aligned monotonic microseconds (the event timebase)."""
        return self._anchor.now_ns() / 1000.0

    # -- tail keep policy ----------------------------------------------------

    def set_tail_source(self, path: str, hist) -> None:
        """Register the local latency histogram backing ``path``'s
        rolling slow threshold (the fallback when no TRACE_PULL hint
        is fresh) — KVWorker hands over its push/pull histograms."""
        self._sources[path] = hist

    def note_hints(self, hints: dict) -> None:
        """Absorb scheduler-side threshold hints (TRACE_PULL request
        body): ``{"push": {"p95": s, ...}, "pull": {...}}`` from the
        ClusterHistory windowed quantiles."""
        if self.tail is None or self.tail.slow_q is None:
            return
        key = f"p{round(self.tail.slow_q * 100):d}"
        now = time.monotonic()
        with self._thr_mu:
            for path in ("push", "pull"):
                v = (hints.get(path) or {}).get(key)
                if isinstance(v, (int, float)) and v > 0:
                    self._hints[path] = (float(v), now)

    _THR_RECOMPUTE_EVERY = 64
    _THR_MIN_COUNT = 32

    def tail_threshold(self, path: str) -> Optional[float]:
        """Current slow threshold (seconds) for one path: a fresh
        TRACE_PULL hint, else the local histogram's quantile
        (recomputed every few calls, needs a minimum population),
        else None (slow rule inactive while cold)."""
        if self.tail is None or self.tail.slow_q is None:
            return None
        now = time.monotonic()
        with self._thr_mu:
            hint = self._hints.get(path)
            if hint is not None and now - hint[1] < self.HINT_TTL_S:
                return hint[0]
            cached, left = self._local_thr.get(path, (None, 0))
            if left > 0:
                self._local_thr[path] = (cached, left - 1)
                return cached
            hist = self._sources.get(path)
            value = None
            if hist is not None and getattr(hist, "count", 0) \
                    >= self._THR_MIN_COUNT:
                try:
                    value = hist.quantile(self.tail.slow_q)
                except Exception:  # noqa: BLE001 - null instruments
                    value = None
            self._local_thr[path] = (value, self._THR_RECOMPUTE_EVERY)
            return value

    def tail_keep(self, dur_s: float, path: str,
                  outcome: Optional[str] = None) -> Optional[str]:
        """Keep decision for one completed request: a reason string
        ("slow>p95" / the outcome / "floor") when the trace should be
        kept, None to drop.  Head-sampled ids (tail mode off) are
        always kept — their decision was made up front."""
        if self.tail is None:
            return "sampled"
        return self.tail.keep(dur_s, outcome, self.tail_threshold(path))

    # -- recording -----------------------------------------------------------

    def _append(self, ev: dict) -> None:
        with self._mu:
            if len(self._events) >= self.MAX_EVENTS:
                if self.tail is not None:
                    # Ring semantics: oldest out, newest in.
                    self._events.popleft()
                    self._evicted_since_drain += 1
                    self._c_evicted.inc()
                else:
                    self.dropped += 1
                    self._c_dropped.inc()
                    return
            self._events.append(ev)
        if self._flush_s > 0 and self._flush_thread is None:
            self._ensure_flush_thread()

    def span(self, trace_id: int, name: str, t0_us: float,
             dur_us: Optional[float] = None, args: Optional[dict] = None)\
            -> None:
        """A complete ("X") span: ``[t0_us, t0_us + dur_us]``.  With
        ``dur_us`` omitted, the span ends now."""
        if not trace_id or not self.active:
            return
        if dur_us is None:
            dur_us = max(0.0, self.now_us() - t0_us)
        a = {"trace": f"{trace_id:x}"}
        if args:
            a.update(args)
        self._append({
            "name": name, "cat": "pslite", "ph": "X",
            "ts": t0_us, "dur": dur_us,
            "tid": threading.get_ident() & 0xFFFF,
            "args": a,
        })

    def instant(self, trace_id: int, name: str,
                args: Optional[dict] = None) -> None:
        if not trace_id or not self.active:
            return
        a = {"trace": f"{trace_id:x}"}
        if args:
            a.update(args)
        self._append({
            "name": name, "cat": "pslite", "ph": "i",
            "ts": self.now_us(), "s": "t",
            "tid": threading.get_ident() & 0xFFFF,
            "args": a,
        })

    # -- draining (TRACE_PULL) -----------------------------------------------

    def drain(self) -> Tuple[List[dict], int]:
        """Hand the buffered spans to a collector and clear the ring;
        returns ``(events, evictions since the previous drain)`` — the
        eviction count tells the scheduler its pull cadence is losing
        spans."""
        with self._mu:
            events = list(self._events)
            self._events.clear()
            evicted = self._evicted_since_drain
            self._evicted_since_drain = 0
        return events, evicted

    # -- export --------------------------------------------------------------

    @property
    def num_events(self) -> int:
        with self._mu:
            return len(self._events)

    def default_path(self) -> str:
        return os.path.join(
            self._dir, f"pslite_trace_{self.role}_{self.node_id}.json"
        )

    def export(self, path: Optional[str] = None) -> Optional[str]:
        """Write the buffered spans as Chrome trace-event JSON; returns
        the path, or None when nothing was recorded.  Idempotent: the
        buffer is kept, a later export rewrites the same file with any
        additional spans."""
        with self._mu:
            events = list(self._events)
        if not events:
            return None
        pid = self.node_id
        label = f"{self.role} {pid}"
        out = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": label},
        }]
        for ev in events:
            ev = dict(ev)
            ev["pid"] = pid
            out.append(ev)
        path = path or self.default_path()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump({"traceEvents": out, "displayTimeUnit": "ms"}, fh)
        os.replace(tmp, path)
        return path

    def export_if_any(self) -> Optional[str]:
        if not self.active or self.num_events == 0:
            return None
        return self.export()

    def _ensure_flush_thread(self) -> None:
        with self._mu:
            if self._flush_thread is not None:
                return
            t = threading.Thread(target=self._flush_loop,
                                 name="trace-flush", daemon=True)
            self._flush_thread = t
        t.start()

    def _flush_loop(self) -> None:
        # Crash-safety, not lifecycle: the daemon thread just rewrites
        # the export periodically so a killed node leaves its spans.
        while True:
            time.sleep(self._flush_s)
            try:
                self.export_if_any()
            except Exception:  # noqa: BLE001 - flush must never die
                pass


class _NullTracer:
    """Do-nothing tracer for stub postoffices (benches)."""

    active = False
    sample = 0.0
    tail = None
    node_id = -1
    num_events = 0

    def maybe_trace(self) -> int:
        return 0

    def begin_request(self) -> int:
        return 0

    def tail_keep(self, dur_s, path, outcome=None):
        return None

    def tail_threshold(self, path):
        return None

    def set_tail_source(self, path, hist) -> None:
        pass

    def note_hints(self, hints) -> None:
        pass

    def now_us(self) -> float:
        return 0.0

    def span(self, *a, **kw) -> None:
        pass

    def instant(self, *a, **kw) -> None:
        pass

    def drain(self):
        return [], 0

    def export(self, path=None):
        return None

    def export_if_any(self):
        return None


NULL_TRACER = _NullTracer()
