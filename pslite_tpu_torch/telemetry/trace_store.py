# The port's copy of pslite_tpu/telemetry/trace_store.py (it imports nothing
# of JAX); names and numbers match the JAX package's.
"""Tail-based trace plane: the keep policy and the cross-node collector.

The tracing tier (telemetry/tracing.py) captures a lightweight span
record for EVERY request when ``PS_TRACE_TAIL`` is configured — no
up-front sampling decision — and the WORKER decides at completion
whether the trace is worth keeping (:class:`TailPolicy`): latency above
a rolling per-path quantile threshold, an error/shed/timeout/failover/
wrong-owner outcome, or a small uniform floor.  Only kept traces get a
``request`` root span; everything else ages out of the bounded
per-node rings.

The scheduler side of the plane lives here too:
:class:`TraceCollector` ingests the rings drained by ``TRACE_PULL``
(``Postoffice.collect_cluster_traces``) and stitches spans by trace id
into complete request trees — per-node wall anchors already align the
timestamps — retiring rootless partials on a TTL.  Assembled traces
feed ``telemetry/critical_path.py`` for the per-stage attribution
``tools/pstrace.py`` renders.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional

from ..utils import logging as log

# The spec PS_TRACE_TAIL expands to when set to a bare truthy value.
DEFAULT_TAIL_SPEC = "slow:p95,errors,floor:0.001"


class TailPolicy:
    """Parsed ``PS_TRACE_TAIL`` spec: which completed requests KEEP
    their trace.  Components (comma-separated):

    - ``slow:pNN`` — keep requests slower than the rolling per-path
      NN-th percentile (threshold fed by the scheduler's windowed
      history via TRACE_PULL hints, local histogram fallback);
    - ``errors`` — always keep error/shed/timeout/failover/wrong-owner
      outcomes;
    - ``floor:R`` — uniform floor: keep a fraction R of everything
      (the unbiased background sample).

    ``PS_TRACE_TAIL=1`` (or ``on``) expands to ``slow:p95,errors,
    floor:0.001``.  Unknown components fail loudly."""

    __slots__ = ("spec", "slow_q", "errors", "floor")

    def __init__(self, spec: str):
        self.spec = spec
        self.slow_q: Optional[float] = None
        self.errors = False
        self.floor = 0.0
        for tok in spec.split(","):
            tok = tok.strip().lower()
            if not tok:
                continue
            if tok == "errors":
                self.errors = True
            elif tok.startswith("slow:p"):
                q = float(tok[len("slow:p"):]) / 100.0
                log.check(0.0 < q < 1.0,
                          f"bad PS_TRACE_TAIL slow quantile: {tok!r}")
                self.slow_q = q
            elif tok.startswith("floor:"):
                r = float(tok[len("floor:"):])
                log.check(0.0 <= r <= 1.0,
                          f"bad PS_TRACE_TAIL floor rate: {tok!r}")
                self.floor = r
            else:
                log.check(False, f"unknown PS_TRACE_TAIL component "
                                 f"{tok!r} (want slow:pNN, errors, "
                                 f"floor:R)")

    @classmethod
    def parse(cls, raw: Optional[str]) -> Optional["TailPolicy"]:
        if raw is None or not str(raw).strip():
            return None
        raw = str(raw).strip()
        if raw.lower() in ("0", "off", "false", "no"):
            return None
        if raw.lower() in ("1", "on", "true", "yes"):
            raw = DEFAULT_TAIL_SPEC
        return cls(raw)

    def keep(self, dur_s: float, outcome: Optional[str],
             threshold_s: Optional[float]) -> Optional[str]:
        """The keep decision for one completed request: a reason
        string when the trace is interesting, else None (drop).  The
        decision order matters — an errored slow request reads as the
        error, the rarer (and more actionable) signal."""
        if outcome is not None and self.errors:
            return outcome
        # Strictly ABOVE the quantile: a uniform population must not
        # read as 100% slow because every value equals its own p95.
        if (self.slow_q is not None and threshold_s is not None
                and dur_s > threshold_s):
            return f"slow>p{round(self.slow_q * 100):d}"
        if self.floor > 0.0 and random.random() < self.floor:
            return "floor"
        return None


class AssembledTrace:
    """One trace id's spans gathered across nodes, plus any flight-
    recorder events that named it."""

    __slots__ = ("tid", "spans", "roles", "flight", "first_seen",
                 "_root")

    def __init__(self, tid: str, first_seen: float):
        self.tid = tid
        self.spans: List[dict] = []
        self.roles: Dict[int, str] = {}  # node id -> role
        self.flight: List[dict] = []
        self.first_seen = first_seen
        # Cached at ingest: eviction/retirement scan every trace under
        # the collector lock, and re-walking each trace's span list
        # there would make a full table O(traces x spans) per sweep.
        self._root: Optional[dict] = None

    def _add_span(self, ev: dict) -> None:
        self.spans.append(ev)
        if self._root is None and ev.get("name") == "request":
            self._root = ev

    @property
    def root(self) -> Optional[dict]:
        """The worker's ``request`` root span (present = KEPT)."""
        return self._root

    def breakdown(self) -> Optional[dict]:
        from .critical_path import breakdown

        return breakdown(self)

    def chrome(self) -> dict:
        """This trace as a standalone Chrome trace-event document
        (one process per node, Perfetto-mergeable)."""
        out = []
        for pid in sorted(self.roles):
            out.append({"name": "process_name", "ph": "M", "pid": pid,
                        "tid": 0,
                        "args": {"name": f"{self.roles[pid]} {pid}"}})
        out.extend(sorted(self.spans, key=lambda e: e.get("ts", 0.0)))
        return {"traceEvents": out, "displayTimeUnit": "ms"}


class TraceCollector:
    """Scheduler-side cross-node trace assembly (module docstring).

    ``ingest`` takes one node's drained span ring; spans group by the
    ``trace`` arg every recording carries.  A trace is ASSEMBLED once
    its worker root (``request`` span — recorded only for kept traces)
    has arrived; rootless partials (unkept requests' ambient spans, or
    a kept trace whose worker ring was never pulled) retire after
    ``ttl_s``.  The table is bounded: oldest traces evict first."""

    def __init__(self, ttl_s: float = 30.0, max_traces: int = 4096):
        self.ttl_s = max(1.0, float(ttl_s))
        self.max_traces = max(16, int(max_traces))
        self._mu = threading.Lock()
        self._traces: Dict[str, AssembledTrace] = {}
        self.retired_partials = 0
        self.evicted = 0
        # Spans the NODES' rings overwrote before a pull could drain
        # them (the per-reply "evicted" counts, accumulated): nonzero
        # means the pull cadence is losing spans — pstrace warns.
        self.lost_spans = 0

    def __len__(self) -> int:
        with self._mu:
            return len(self._traces)

    def ingest(self, node_id: int, role: str, spans: List[dict],
               flight: Optional[List[dict]] = None,
               now: Optional[float] = None, evicted: int = 0) -> int:
        """Absorb one node's drained spans (and trace-correlated
        flight events; ``evicted`` = spans that node's ring overwrote
        since its last drain); returns how many spans landed."""
        now = time.monotonic() if now is None else now
        n = 0
        with self._mu:
            self.lost_spans += max(0, int(evicted))
            for ev in spans:
                tid = (ev.get("args") or {}).get("trace")
                if not tid:
                    continue
                tr = self._traces.get(tid)
                if tr is None:
                    tr = self._traces[tid] = AssembledTrace(tid, now)
                ev = dict(ev)
                ev["pid"] = node_id
                tr._add_span(ev)
                tr.roles[node_id] = role
                n += 1
            for ev in flight or []:
                tid = ev.get("trace")
                if not tid:
                    continue
                tr = self._traces.get(tid)
                if tr is None:
                    tr = self._traces[tid] = AssembledTrace(tid, now)
                if ev not in tr.flight:
                    tr.flight.append(dict(ev))
            self._evict_locked()
        return n

    def _evict_locked(self) -> None:
        while len(self._traces) > self.max_traces:
            victim = min(self._traces.values(),
                         key=lambda t: (t.root is not None, t.first_seen))
            del self._traces[victim.tid]
            self.evicted += 1

    def retire(self, now: Optional[float] = None) -> int:
        """Drop ROOTLESS traces older than the TTL: their worker never
        kept them (or died) — no further pull can complete them into a
        request tree worth holding."""
        now = time.monotonic() if now is None else now
        dropped = 0
        with self._mu:
            for tid in list(self._traces):
                tr = self._traces[tid]
                if tr.root is None and now - tr.first_seen >= self.ttl_s:
                    del self._traces[tid]
                    dropped += 1
        self.retired_partials += dropped
        return dropped

    def get(self, tid: str) -> Optional[AssembledTrace]:
        with self._mu:
            return self._traces.get(tid)

    def assembled(self) -> List[AssembledTrace]:
        """Every trace with a worker root, oldest first."""
        with self._mu:
            out = [t for t in self._traces.values() if t.root is not None]
        out.sort(key=lambda t: t.root["ts"])
        return out

    def breakdowns(self) -> List[dict]:
        return [b for b in (t.breakdown() for t in self.assembled())
                if b is not None]

    def aggregate(self, slow_frac: float = 0.25) -> dict:
        """The "where does the tail live" table (critical_path.py)."""
        from .critical_path import aggregate

        return aggregate(self.breakdowns(), slow_frac=slow_frac)

    def clear(self) -> None:
        with self._mu:
            self._traces.clear()
