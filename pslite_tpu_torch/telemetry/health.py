# The port's copy of pslite_tpu/telemetry/health.py (it imports nothing
# of JAX); names and numbers match the JAX package's.
"""SLO watchdog — declarative health rules over the cluster history.

Evaluated on every :class:`~.timeseries.ClusterHistory` sample, the
watchdog grades each node's **windowed** signals (rates from counter
deltas, quantiles from bucket deltas — never uptime averages) against
a small default rule set, overridable with ``PS_SLO``:

    PS_SLO="shed_rate=0.5:5,req_p99=0.2:1,queue_growth=off"

Each entry is ``rule=warn:crit`` (``off`` disables the rule).  Default
rules and thresholds:

=================  ==========================================  ===========
rule               signal (per node, windowed)                 warn : crit
=================  ==========================================  ===========
shed_rate          ``tenant.<t>.shed`` rate per tenant, plus        1 : 10
                   node-wide ``qos.shed_requests`` (sheds/s)
req_p99            merged push+pull latency p99 (seconds)         0.5 : 2
repl_lag           ``replication.lag`` gauge (queued fwds)         64 : 512
queue_growth       lane + apply queue depth GROWTH across         256 : 4096
                   the window (messages/tasks)
heartbeat_gap      windowed max ``heartbeat.gap_s`` (s)             2 : 10
retransmit_burst   ``resender.retransmits`` rate (/s)              50 : 500
node_stale         sample rounds missed (last-seen age in           2 : 5
                   units of the sampler interval)
snapshot_age       ``snapshot.age_s`` gauge: seconds since     600 : 86400
                   the newest committed snapshot manifest
                   (docs/durability.md); exported only by
                   servers with ``PS_SNAPSHOT_DIR``, and a
                   never-snapshotted cluster (age < 0) is
                   skipped, not alarmed
replica_fallbacks  ``replica_read.fallbacks`` rate (/s) on          5 : 50
                   workers — stale-replica re-pulls
                   (docs/serving_reads.md); a sustained rate
                   means replicas trail their primary and the
                   read spread is quietly collapsing onto it
syscalls_per_op    windowed wire-plane syscalls per op, both        8 : 64
                   Python and native planes summed
                   (docs/observability.md); graded only once
                   the window holds >= 16 ops
=================  ==========================================  ===========

Breaches emit structured :class:`HealthEvent`\\ s (INFO/WARN/CRIT) with
the offending node/tenant/metric, the measured value, the threshold,
and the window that tripped it — queryable via ``Postoffice.health()``
and rendered in psmon ``--watch``'s footer.  A per-(rule, node,
tenant) holdoff of one window stops a sustained breach from flooding
the ring; severity ESCALATION (warn -> crit) always emits.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional

from ..utils import logging as log

INFO, WARN, CRIT = "info", "warn", "crit"
_SEV_ORD = {INFO: 0, WARN: 1, CRIT: 2}


class HealthEvent:
    """One structured watchdog finding."""

    __slots__ = ("wall", "severity", "rule", "node_id", "role", "tenant",
                 "metric", "value", "threshold", "window_s", "message")

    def __init__(self, wall, severity, rule, node_id, role, metric,
                 value, threshold, window_s, message, tenant=None):
        self.wall = wall
        self.severity = severity
        self.rule = rule
        self.node_id = node_id
        self.role = role
        self.tenant = tenant
        self.metric = metric
        self.value = value
        self.threshold = threshold
        self.window_s = window_s
        self.message = message

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}

    def __repr__(self) -> str:
        who = f"node {self.node_id} ({self.role})"
        if self.tenant:
            who += f" tenant {self.tenant}"
        return (f"[{self.severity.upper()}] {self.rule}: {who} "
                f"{self.metric}={self.value:.4g} (>{self.threshold:g} "
                f"over {self.window_s:.1f}s)")


class Rule:
    __slots__ = ("name", "warn", "crit", "enabled")

    def __init__(self, name: str, warn: float, crit: float,
                 enabled: bool = True):
        self.name = name
        self.warn = warn
        self.crit = crit
        self.enabled = enabled

    def grade(self, value: Optional[float]) -> Optional[str]:
        """CRIT/WARN when the value breaches, else None."""
        if not self.enabled or value is None:
            return None
        if value >= self.crit:
            return CRIT
        if value >= self.warn:
            return WARN
        return None


DEFAULT_THRESHOLDS: Dict[str, tuple] = {
    "shed_rate": (1.0, 10.0),
    "req_p99": (0.5, 2.0),
    "repl_lag": (64.0, 512.0),
    "queue_growth": (256.0, 4096.0),
    "heartbeat_gap": (2.0, 10.0),
    "retransmit_burst": (50.0, 500.0),
    "node_stale": (2.0, 5.0),
    "snapshot_age": (600.0, 86400.0),
    "replica_fallbacks": (5.0, 50.0),
    "syscalls_per_op": (8.0, 64.0),
}

# syscalls_per_op needs a minimum op population before it grades: a
# window with three control round-trips and no data traffic would
# otherwise read as a catastrophic ratio.
_WIRE_MIN_OPS = 16


def parse_slo(spec: Optional[str]) -> Dict[str, Rule]:
    """``PS_SLO`` -> rule table.  Unknown rule names fail loudly (a
    typo'd override silently keeping the default is the watchdog
    equivalent of a disconnected smoke alarm)."""
    rules = {name: Rule(name, w, c)
             for name, (w, c) in DEFAULT_THRESHOLDS.items()}
    if not spec:
        return rules
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        log.check("=" in part, f"bad PS_SLO entry {part!r} "
                               f"(want rule=warn:crit or rule=off)")
        name, _, val = part.partition("=")
        name = name.strip()
        log.check(name in rules, f"unknown PS_SLO rule {name!r} "
                                 f"(known: {sorted(rules)})")
        val = val.strip()
        if val.lower() == "off":
            rules[name].enabled = False
            continue
        warn_s, _, crit_s = val.partition(":")
        warn = float(warn_s)
        crit = float(crit_s) if crit_s else float("inf")
        log.check(warn <= crit, f"PS_SLO {name}: warn {warn} > crit {crit}")
        rules[name] = Rule(name, warn, crit)
    return rules


class Watchdog:
    """Per-sample rule evaluator with a bounded event ring."""

    def __init__(self, env=None, interval_s: float = 1.0, cap: int = 1024):
        spec = env.find("PS_SLO") if env is not None else None
        self.rules = parse_slo(spec)
        self.interval_s = max(interval_s, 1e-3)
        self._mu = threading.Lock()
        self._events: collections.deque = collections.deque(
            maxlen=max(16, cap)
        )
        # (rule, node, tenant) -> (wall of last emit, severity)
        self._last_emit: Dict[tuple, tuple] = {}

    # -- queries -------------------------------------------------------------

    def events(self, min_severity: str = WARN,
               since: Optional[float] = None) -> List[HealthEvent]:
        floor = _SEV_ORD.get(min_severity, 1)
        with self._mu:
            evs = list(self._events)
        return [e for e in evs
                if _SEV_ORD[e.severity] >= floor
                and (since is None or e.wall >= since)]

    def clear(self) -> None:
        with self._mu:
            self._events.clear()
            self._last_emit.clear()

    # -- evaluation ----------------------------------------------------------

    def _emit(self, wall, severity, rule, node_id, role, metric, value,
              threshold, window_s, message, tenant=None,
              out: Optional[list] = None) -> None:
        key = (rule, node_id, tenant)
        with self._mu:
            last = self._last_emit.get(key)
            if last is not None:
                last_wall, last_sev = last
                # Holdoff: one event per key per window — unless the
                # severity escalated, which always surfaces.
                if (wall - last_wall < window_s
                        and _SEV_ORD[severity] <= _SEV_ORD[last_sev]):
                    return
            self._last_emit[key] = (wall, severity)
            ev = HealthEvent(
                wall, severity, rule, node_id, role, metric, value,
                threshold, window_s, message, tenant=tenant,
            )
            self._events.append(ev)
        if out is not None:
            out.append(ev)

    def _check(self, wall, rule_name, node_id, role, metric, value,
               window_s, tenant=None, fmt=None,
               out: Optional[list] = None) -> None:
        rule = self.rules[rule_name]
        sev = rule.grade(value)
        if sev is None:
            return
        threshold = rule.crit if sev == CRIT else rule.warn
        message = (fmt or "{metric} at {value:.4g} (threshold {thr:g})")\
            .format(metric=metric, value=value, thr=threshold)
        self._emit(wall, sev, rule_name, node_id, role, metric, value,
                   threshold, window_s, message, tenant=tenant, out=out)

    def evaluate(self, history, wall: Optional[float] = None)\
            -> List[HealthEvent]:
        """Grade every node's windowed signals; returns the events
        emitted by THIS evaluation (all events stay queryable via
        :meth:`events`)."""
        wall = time.time() if wall is None else wall
        out: List[HealthEvent] = []
        window = history.default_window_s
        interval = history.interval_s or self.interval_s
        for node_id in history.node_ids():
            role = history.role_of(node_id)
            latest = history.latest(node_id)
            if latest is None:
                continue
            counters = latest.get("counters", {})
            gauges = latest.get("gauges", {})

            # shed_rate: per tenant, plus the node-wide aggregate.
            for cname in counters:
                if cname.startswith("tenant.") and cname.endswith(".shed"):
                    tenant = cname[len("tenant."):-len(".shed")]
                    self._check(
                        wall, "shed_rate", node_id, role, cname,
                        history.rate(node_id, cname, window), window,
                        tenant=tenant, out=out,
                        fmt="tenant shed rate {value:.4g}/s "
                            "(threshold {thr:g}/s)",
                    )
            self._check(
                wall, "shed_rate", node_id, role, "qos.shed_requests",
                history.rate(node_id, "qos.shed_requests", window), window,
                out=out,
                fmt="shed rate {value:.4g}/s (threshold {thr:g}/s)",
            )

            # req_p99: merged push+pull windowed quantile (seconds).
            self._check(
                wall, "req_p99", node_id, role, "kv.request_p99_s",
                history.window_quantile(
                    node_id, ["kv.push_latency_s", "kv.pull_latency_s"],
                    0.99, window),
                window, out=out,
                fmt="request p99 {value:.4g}s (threshold {thr:g}s)",
            )

            # repl_lag: level of the replication.lag gauge.
            if "replication.lag" in gauges:
                self._check(
                    wall, "repl_lag", node_id, role, "replication.lag",
                    float(gauges.get("replication.lag", 0.0)), window,
                    out=out,
                    fmt="replication lag {value:.4g} queued forwards "
                        "(threshold {thr:g})",
                )

            # snapshot_age: seconds since the newest committed
            # snapshot manifest (docs/durability.md).  Exported only
            # by servers running with PS_SNAPSHOT_DIR; a negative age
            # means "never snapshotted", which the rule skips — an
            # un-configured cluster must not page.
            snap_age = gauges.get("snapshot.age_s")
            if snap_age is not None and float(snap_age) >= 0:
                self._check(
                    wall, "snapshot_age", node_id, role,
                    "snapshot.age_s", float(snap_age), window, out=out,
                    fmt="newest snapshot manifest is {value:.0f}s old "
                        "(threshold {thr:g}s)",
                )

            # queue_growth: lane depth + apply shard depth growth
            # across the window (a high-but-draining queue is load; a
            # GROWING one is a stall).
            gpair = history.gauges_window(node_id, window)
            if gpair is not None:
                def _depth(g: dict) -> float:
                    return float(g.get("van.lane_depth", 0.0)) + sum(
                        v for k, v in g.items()
                        if k.startswith("apply.shard")
                        and k.endswith(".depth")
                    )

                growth = _depth(gpair[1]) - _depth(gpair[0])
                self._check(
                    wall, "queue_growth", node_id, role, "queue.depth",
                    growth if growth > 0 else None, window, out=out,
                    fmt="queue depth grew by {value:.4g} over the window "
                        "(threshold {thr:g})",
                )

            # heartbeat_gap: windowed MAX beat gap (scheduler node).
            wb = history.window_buckets(node_id, "heartbeat.gap_s", window)
            if wb and wb["count"] > 0:
                top = max(wb["buckets"])
                gap = min(wb["lo"] * (2.0 ** top), wb["max"] or float("inf"))
                self._check(
                    wall, "heartbeat_gap", node_id, role,
                    "heartbeat.gap_s", gap, window, out=out,
                    fmt="heartbeat gap up to {value:.4g}s "
                        "(threshold {thr:g}s)",
                )

            # replica_fallbacks: stale-replica re-pull rate on
            # workers (docs/serving_reads.md).  Every fallback is a
            # wasted round trip AND a read that landed on the primary
            # anyway — a sustained rate means the replicas' applied
            # stamps trail the push stream and the spread is quietly
            # collapsing back into the primary funnel.
            self._check(
                wall, "replica_fallbacks", node_id, role,
                "replica_read.fallbacks",
                history.rate(node_id, "replica_read.fallbacks", window),
                window, out=out,
                fmt="stale-replica fallbacks at {value:.4g}/s "
                    "(threshold {thr:g}/s)",
            )

            # retransmit_burst: windowed retransmit rate.
            self._check(
                wall, "retransmit_burst", node_id, role,
                "resender.retransmits",
                history.rate(node_id, "resender.retransmits", window),
                window, out=out,
                fmt="retransmits at {value:.4g}/s (threshold {thr:g}/s)",
            )

            # syscalls_per_op: windowed wire-plane efficiency, both
            # planes summed (docs/observability.md).  A drifting ratio
            # is usually batching regressing to singletons or the
            # vectored writer degenerating into per-chunk writes — the
            # op stream looks healthy while the kernel does 10x the
            # work.  Skipped below a minimum op population.
            ws = history.wire_summary(node_id, window)
            if ws is not None and ws["ops"] >= _WIRE_MIN_OPS:
                self._check(
                    wall, "syscalls_per_op", node_id, role,
                    "wire.syscalls_per_op", ws["syscalls_per_op"],
                    window, out=out,
                    fmt="{value:.4g} syscalls per op over the window "
                        "(threshold {thr:g})",
                )

        # node_stale: nodes that missed recent sample rounds (value in
        # units of the sampler interval, so thresholds read "rounds").
        for node_id, age in history.stale_ages(now=wall).items():
            self._check(
                wall, "node_stale", node_id, history.role_of(node_id),
                "metrics.last_seen_age_s", age / interval, window, out=out,
                fmt="no METRICS_PULL reply for {value:.1f} sample "
                    "intervals (threshold {thr:g})",
            )
        return out
