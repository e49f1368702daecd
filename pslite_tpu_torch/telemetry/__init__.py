"""Cluster-wide telemetry: metrics registry + distributed tracing.

The port's own copy of ``pslite_tpu/telemetry`` (whose modules import
nothing of JAX): metric, span and event names are the JAX package's, so
a scheduler of either package pulls and reads nodes of both.

The read-side mirror of the perf/fault tiers (send lanes, sharded
apply, deadlines/failover, replication): every hot path publishes
counters/gauges/histograms into a per-node :class:`~.metrics.Registry`,
request lifecycles are stitched across processes by
:class:`~.tracing.Tracer` trace ids carried in ``Message.meta``, and
the scheduler can snapshot every node's registry over the control plane
(``Command.METRICS_PULL`` — see ``tools/psmon.py``).

On top of the point-in-time plane sits the CONTINUOUS tier
(docs/observability.md): :class:`~.timeseries.ClusterHistory` (a
scheduler-side sampler deriving windowed rates/quantiles from snapshot
deltas), the :class:`~.health.Watchdog` SLO rules it feeds
(``Postoffice.health()``), and the per-node
:class:`~.flight.FlightRecorder` fault ring dumped on abnormal
shutdown.

Env knobs (docs/observability.md):

- ``PS_TELEMETRY`` (default 1): 0 swaps every instrument for a shared
  no-op singleton — near-zero cost, empty snapshots.
- ``PS_TRACE_SAMPLE`` (default 0): probability in [0, 1] that a
  ``KVWorker.push/pull`` mints a trace id (legacy head sampling).
- ``PS_TRACE_TAIL`` (default off): tail-based capture spec
  (``slow:p95,errors,floor:0.001``) — every request is stamped, the
  worker keeps only interesting traces at completion, and the
  scheduler assembles them live over ``Command.TRACE_PULL``
  (:class:`~.trace_store.TraceCollector`, ``tools/pstrace.py``).
- ``PS_TRACE_DIR``: directory for the per-node Chrome trace-event JSON
  exports and flight-recorder dumps (default: system tempdir).
- ``PS_TRACE_RING`` / ``PS_TRACE_FLUSH_S``: span-ring capacity and the
  crash-safe periodic export interval.
- ``PS_METRICS_INTERVAL`` (default 0 = off): the scheduler's
  background METRICS_PULL sampling period in seconds.
- ``PS_METRICS_HISTORY`` (default 512): snapshots retained per node.
- ``PS_SLO``: watchdog threshold overrides (``rule=warn:crit``).
- ``PS_FLIGHT_EVENTS`` (default 1024): flight-recorder ring size.
"""

from .flight import FlightRecorder, NULL_FLIGHT  # noqa: F401
from .health import (  # noqa: F401
    CRIT,
    HealthEvent,
    INFO,
    Rule,
    WARN,
    Watchdog,
    parse_slo,
)
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    NULL_REGISTRY,
    Registry,
    TopK,
    bucket_quantile,
    merge_bucket_lists,
    node_registry,
)
from .timeseries import ClusterHistory, NodeSeries  # noqa: F401
from .trace_store import (  # noqa: F401
    AssembledTrace,
    TailPolicy,
    TraceCollector,
)
from .tracing import NULL_TRACER, Tracer  # noqa: F401
