# The port's copy of pslite_tpu/telemetry/flight.py (it imports nothing
# of JAX); names and numbers match the JAX package's.
"""Per-node fault flight recorder (docs/observability.md).

A bounded ring of health-relevant events — overload sheds, failovers,
retransmit give-ups, epoch changes, apply-pool stalls, van/receive
errors, chaos crashes — stamped on the same monotonic/wall anchor as
the tracer and the profiler, so a flight dump, a Chrome trace, and the
``ENABLE_PROFILING`` event log line up on one timeline.

Unlike metrics (aggregates) and traces (sampled request lifecycles),
the recorder keeps the *last N discrete faults with their context*:
when a chaos run dies, the dump answers "what happened in the seconds
before" without re-running anything.  It is always on — events are
recorded only on fault paths, so a healthy node pays nothing — and the
ring (``PS_FLIGHT_EVENTS``, default 1024) bounds memory.

The dump (`PS_TRACE_DIR/pslite_flight_<role>_<id>.json`) is written on
demand via :meth:`FlightRecorder.dump`, and automatically by
``Van.stop()`` when the shutdown is ABNORMAL: a CHECK failure killed
the pump, the receive loop gave up on repeated decode failures, a
chaos crash tripped, or any CRIT-severity event was recorded.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import threading
import time
from typing import Optional

from ..utils.profiling import MonotonicAnchor

SEVERITIES = ("info", "warn", "crit")


class FlightRecorder:
    """Bounded per-node fault-event ring.  ``record`` is cheap (one
    dict + deque append under a lock) and only ever called on fault /
    membership paths, never per-message."""

    def __init__(self, env, role: str):
        self.role = role
        self.node_id = -1  # assigned at bootstrap
        self.cap = max(16, env.find_int("PS_FLIGHT_EVENTS", 1024))
        self._dir = env.find("PS_TRACE_DIR") or tempfile.gettempdir()
        self._mu = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=self.cap)
        self.dropped = 0  # events overwritten by the bounded ring
        self.abnormal = False
        self.abnormal_reason: Optional[str] = None
        # Same timebase as Tracer/Profiler: wall-anchored monotonic.
        self._anchor = MonotonicAnchor()

    # -- recording -----------------------------------------------------------

    def record(self, kind: str, severity: str = "warn", **detail) -> None:
        """Append one event.  ``severity`` in {info, warn, crit}; a
        CRIT event also marks the shutdown abnormal (``Van.stop()``
        then dumps the ring)."""
        ev = {
            "ts_us": self._anchor.now_ns() / 1000.0,
            "kind": kind,
            "severity": severity if severity in SEVERITIES else "warn",
        }
        if detail:
            ev.update(detail)
        with self._mu:
            if len(self._ring) == self.cap:
                self.dropped += 1
            self._ring.append(ev)
            if ev["severity"] == "crit" and not self.abnormal:
                self.abnormal = True
                self.abnormal_reason = f"{kind} (crit event)"

    def mark_abnormal(self, reason: str) -> None:
        """Flag this node's shutdown as abnormal: ``Van.stop()`` will
        dump the ring even if no individual event was CRIT."""
        with self._mu:
            if not self.abnormal:
                self.abnormal = True
                self.abnormal_reason = reason

    # -- queries -------------------------------------------------------------

    @property
    def num_events(self) -> int:
        with self._mu:
            return len(self._ring)

    def events(self, kind: Optional[str] = None) -> list:
        with self._mu:
            evs = list(self._ring)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs

    # -- export --------------------------------------------------------------

    def default_path(self) -> str:
        return os.path.join(
            self._dir, f"pslite_flight_{self.role}_{self.node_id}.json"
        )

    def dump(self, path: Optional[str] = None) -> Optional[str]:
        """Write the ring as JSON; returns the path, or None when
        nothing was ever recorded.  Idempotent — a later dump rewrites
        the same file with any additional events."""
        with self._mu:
            events = list(self._ring)
            abnormal = self.abnormal
            reason = self.abnormal_reason
            dropped = self.dropped
        if not events:
            return None
        doc = {
            "node_id": self.node_id,
            "role": self.role,
            "wall_time": time.time(),
            "abnormal": abnormal,
            "abnormal_reason": reason,
            "dropped_events": dropped,
            "events": events,
        }
        path = path or self.default_path()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(doc, fh)
        os.replace(tmp, path)
        return path

    def dump_if_abnormal(self) -> Optional[str]:
        with self._mu:
            abnormal = self.abnormal
        return self.dump() if abnormal else None


class _NullFlightRecorder:
    """Do-nothing recorder for stub postoffices (bench/test doubles)."""

    role = "<null>"
    node_id = -1
    num_events = 0
    abnormal = False
    abnormal_reason = None
    dropped = 0

    def record(self, kind: str, severity: str = "warn", **detail) -> None:
        pass

    def mark_abnormal(self, reason: str) -> None:
        pass

    def events(self, kind=None) -> list:
        return []

    def dump(self, path=None):
        return None

    def dump_if_abnormal(self):
        return None


NULL_FLIGHT = _NullFlightRecorder()
