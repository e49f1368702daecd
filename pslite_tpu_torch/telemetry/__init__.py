"""Telemetry stand-ins: no-op objects with the call surface of the JAX
package's telemetry plane that this package's control plane calls.

``pslite_tpu``'s van and Postoffice record into a metrics ``Registry``
(``telemetry/metrics.py``), a span ``Tracer`` (``telemetry/tracing.py``),
a fault ``FlightRecorder`` (``telemetry/flight.py``) and an event
``Profiler`` (``utils/profiling.py``).  This package keeps those call
sites so the control plane reads like its reference, but every object
here records nothing: these are stand-ins, not ports.  ROADMAP Queue 1
item 8 ports the real ones.
"""

from __future__ import annotations


class _NullCounter:
    def inc(self, n: int = 1) -> None:
        pass


class Registry:
    """Stand-in for ``pslite_tpu.telemetry.metrics.Registry``."""

    def counter(self, name: str) -> _NullCounter:
        return _NullCounter()


NULL_REGISTRY = Registry()


class Tracer:
    """Stand-in for ``pslite_tpu.telemetry.tracing.Tracer``: samples
    nothing."""

    def __init__(self):
        self.node_id = -1


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
