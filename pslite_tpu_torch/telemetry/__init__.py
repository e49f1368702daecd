"""Telemetry stand-ins: no-op objects with the call surface of the JAX
package's telemetry plane that this package's control plane calls.

``pslite_tpu``'s van and Postoffice record into a metrics ``Registry``
(``telemetry/metrics.py``), a span ``Tracer`` (``telemetry/tracing.py``),
a fault ``FlightRecorder`` (``telemetry/flight.py``) and an event
``Profiler`` (``utils/profiling.py``).  This package keeps those call
sites so the control plane reads like its reference, but every object
here records nothing: these are stand-ins, not ports.  ROADMAP Queue 1
item 8(c) ports the real ones.

One piece is real: ``TopK`` (``telemetry/metrics.py:223-258``), the
Space-Saving hot-key tracker a server's ``HOT_KEYS_CMD`` answer reads,
returned by ``Registry.topk``.  ``LocalCounts`` holds the counters that
tests and benchmarks read where JAX reads its registry (replication,
the tiered store, replica reads) until the registry is ported.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple


class _NullCounter:
    def inc(self, n: int = 1) -> None:
        pass


class _NullHistogram:
    def observe(self, value: float) -> None:
        pass


class _LocalCounter:
    __slots__ = ("_counts", "_key")

    def __init__(self, counts: "LocalCounts", key: str):
        self._counts = counts
        self._key = key

    def inc(self, n: int = 1) -> None:
        self._counts.inc(self._key, n)


class LocalCounts:
    """Named integer counters in a dict under a lock: ``inc(name)``,
    ``counts[name]`` (an unseen name reads 0), and ``counter(name)``, an
    object with the ``inc`` of JAX's registry counters."""

    def __init__(self):
        self._mu = threading.Lock()
        self._counts: Dict[str, int] = {}

    def inc(self, key: str, n: int = 1) -> None:
        with self._mu:
            self._counts[key] = self._counts.get(key, 0) + n

    def __getitem__(self, key: str) -> int:
        with self._mu:
            return self._counts.get(key, 0)

    def counter(self, key: str) -> _LocalCounter:
        return _LocalCounter(self, key)


class TopK:
    """Bounded hot-key tracker (Space-Saving-lite): a dict capped at
    ``cap`` entries; when full, a new key evicts the current minimum and
    inherits its count (an overestimate that never misses a heavy
    key)."""

    __slots__ = ("name", "_cap", "_mu", "_d")

    def __init__(self, name: str, cap: int = 128):
        self.name = name
        self._cap = max(1, cap)
        self._mu = threading.Lock()
        self._d: Dict[int, int] = {}

    def add(self, key: int, n: int = 1) -> None:
        with self._mu:
            cur = self._d.get(key)
            if cur is not None:
                self._d[key] = cur + n
            elif len(self._d) < self._cap:
                self._d[key] = n
            else:
                victim = min(self._d, key=self._d.__getitem__)
                floor = self._d.pop(victim)
                self._d[key] = floor + n

    def top(self, k: int = 10) -> List[Tuple[int, int]]:
        with self._mu:
            items = sorted(self._d.items(), key=lambda kv: -kv[1])
        return items[:k]

    def reset(self) -> None:
        with self._mu:
            self._d.clear()


class Registry:
    """Stand-in for ``pslite_tpu.telemetry.metrics.Registry``; only
    ``topk`` returns a live instrument (one per name)."""

    def __init__(self):
        self._topks: Dict[str, TopK] = {}
        self._mu = threading.Lock()

    def counter(self, name: str) -> _NullCounter:
        return _NullCounter()

    def histogram(self, name: str) -> _NullHistogram:
        return _NullHistogram()

    def gauge(self, name: str, fn: Optional[Callable[[], float]] = None
              ) -> None:
        pass

    def topk(self, name: str, cap: int = 128) -> TopK:
        with self._mu:
            inst = self._topks.get(name)
            if inst is None:
                inst = self._topks[name] = TopK(name, cap)
            return inst


NULL_REGISTRY = Registry()


def node_registry(maybe_reg: Optional[Registry]) -> Registry:
    """``maybe_reg`` when given, else a registry of one's own (the JAX
    package's ``telemetry.metrics.node_registry``)."""
    return maybe_reg if maybe_reg is not None else Registry()


class Tracer:
    """Stand-in for ``pslite_tpu.telemetry.tracing.Tracer``: samples
    nothing (``active`` stays False)."""

    active = False

    def __init__(self):
        self.node_id = -1

    # The call surface ``kv/batching.py`` reaches only while ``active``.
    def now_us(self) -> float:
        return 0.0

    def span(self, trace: int, name: str, start_us: float,
             dur_us: Optional[float] = None, args=None) -> None:
        pass


NULL_TRACER = Tracer()


class FlightRecorder:
    """Stand-in for ``pslite_tpu.telemetry.flight.FlightRecorder``."""

    def __init__(self):
        self.node_id = -1

    def record(self, kind: str, **detail) -> None:
        pass


class Profiler:
    """Stand-in for ``pslite_tpu.utils.profiling.Profiler``."""

    def record(self, key: int, kind: str, push: bool) -> None:
        pass

    def close(self) -> None:
        pass
