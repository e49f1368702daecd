# The port's copy of pslite_tpu/telemetry/metrics.py (it imports nothing
# of JAX); names and numbers match the JAX package's.
"""Metrics registry: lock-cheap Counter / Gauge / Histogram / TopK.

One :class:`Registry` per NODE (attached to its ``Postoffice``), not
per process: the in-process test clusters host many logical nodes, and
``METRICS_PULL`` snapshots must stay per-node there too.  Code without
a postoffice (stub benches) falls back to :data:`NULL_REGISTRY`.

Cost model:

- **Counters** are a bare Python ``int +=`` with no lock — callers on
  hot paths already hold their own locks (``_bytes_mu``, lane transmit
  locks, the single apply-dispatch thread), and telemetry tolerates the
  rare lost increment a GIL switch could cause elsewhere.
- **Histograms** take a tiny per-histogram lock: they update several
  fields and are observed per *request*, not per byte.
- **Disabled** (``PS_TELEMETRY=0``): every constructor returns a shared
  no-op singleton, so instrumented call sites pay one attribute call on
  a do-nothing method and the registry snapshots empty.

Histogram buckets are fixed log-scale (powers of ``2`` above a floor),
so latencies (seconds) and sizes (bytes) both fit one shape and
quantiles come from a 64-slot array walk, never a sample buffer.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple


class Counter:
    """Monotonic counter.  ``inc`` is a bare int add — see the module
    docstring for why that is the right cost/accuracy trade."""

    __slots__ = ("name", "_v")

    def __init__(self, name: str):
        self.name = name
        self._v = 0

    def inc(self, n: int = 1) -> None:
        self._v += n

    @property
    def value(self) -> int:
        return self._v

    def reset(self) -> None:
        self._v = 0


class Gauge:
    """Point-in-time value: either ``set()`` by the owner, or backed by
    a ``fn`` sampled lazily at snapshot time (queue depths — reading a
    live structure at snapshot beats updating a gauge on every push)."""

    __slots__ = ("name", "_v", "_fn")

    def __init__(self, name: str, fn: Optional[Callable[[], float]] = None):
        self.name = name
        self._v = 0.0
        self._fn = fn

    def set(self, v: float) -> None:
        self._v = v

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:  # noqa: BLE001 - a dying gauge must not
                return 0.0     # break an unrelated snapshot
        return self._v

    def reset(self) -> None:
        self._v = 0.0


class Histogram:
    """Fixed log2-bucket histogram.

    Bucket ``i`` covers ``[lo * 2**(i-1), lo * 2**i)`` (bucket 0 is
    everything ``<= lo``; the last bucket is open-ended).  ``lo``
    defaults to 1 µs for latencies in seconds; use ``lo=1.0`` for byte
    sizes.  Quantiles interpolate geometrically inside the bucket.
    """

    NBUCKETS = 64
    # Bounded exemplar slots (docs/observability.md): at most this
    # many buckets hold a (trace id, value, wall) exemplar at once —
    # the hook that links a Prometheus histogram panel straight to the
    # tail trace that produced the bucket's latest observation.
    EXEMPLAR_SLOTS = 8

    __slots__ = ("name", "lo", "_mu", "count", "sum", "min", "max",
                 "buckets", "_exemplars")

    def __init__(self, name: str, lo: float = 1e-6):
        self.name = name
        self.lo = lo
        self._mu = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = 0.0
        self.buckets = [0] * self.NBUCKETS
        # bucket index -> (trace id hex, value, wall time); bounded at
        # EXEMPLAR_SLOTS distinct buckets, oldest wall evicted.
        self._exemplars: Dict[int, tuple] = {}

    def bucket_index(self, v: float) -> int:
        if v <= self.lo:
            return 0
        # int(v/lo).bit_length() is ceil(log2(v/lo)) +- 1 step; exact
        # powers land on the boundary bucket, which is all quantile
        # estimation needs from a log-scale histogram.
        return min(self.NBUCKETS - 1, int(v / self.lo).bit_length())

    def bucket_bound(self, i: int) -> float:
        """Upper bound of bucket ``i``."""
        return self.lo * (2.0 ** i)

    def observe(self, v: float) -> None:
        i = self.bucket_index(v)
        with self._mu:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            self.buckets[i] += 1

    def attach_exemplar(self, v: float, trace_id: int,
                        wall: Optional[float] = None) -> None:
        """Attach a KEPT trace id to the bucket its latency landed in
        (OpenMetrics exemplars — psmon ``--serve`` renders them as
        ``# {trace_id=...}`` suffixes).  Same-bucket exemplars
        overwrite (newest wins); past ``EXEMPLAR_SLOTS`` distinct
        buckets the oldest-walled slot evicts, so the table stays a
        bounded sketch, not a trace store."""
        if not trace_id:
            return
        i = self.bucket_index(v)
        wall = time.time() if wall is None else wall
        with self._mu:
            self._exemplars[i] = (f"{trace_id:x}", float(v), wall)
            while len(self._exemplars) > self.EXEMPLAR_SLOTS:
                victim = min(self._exemplars,
                             key=lambda b: self._exemplars[b][2])
                del self._exemplars[victim]

    def exemplars(self) -> Dict[int, tuple]:
        with self._mu:
            return dict(self._exemplars)

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0..1) from the bucket counts; 0.0 when
        empty.  Clamped into [min, max] so tiny populations don't report
        a bucket bound wider than anything actually observed."""
        with self._mu:
            if self.count == 0:
                return 0.0
            target = q * self.count
            acc = 0
            for i, n in enumerate(self.buckets):
                acc += n
                if acc >= target and n:
                    # Geometric midpoint of the bucket's span.
                    hi = self.bucket_bound(i)
                    lo = hi / 2.0 if i else 0.0
                    est = (lo * hi) ** 0.5 if lo > 0 else hi / 2.0
                    return min(max(est, self.min), self.max)
            return self.max

    def snapshot(self) -> dict:
        with self._mu:
            count, total = self.count, self.sum
            mn = self.min if self.count else 0.0
            mx = self.max
            nonzero = [[i, n] for i, n in enumerate(self.buckets) if n]
            ex = [[i, t, v, w]
                  for i, (t, v, w) in sorted(self._exemplars.items())]
        out = {"count": count, "sum": total, "min": mn, "max": mx,
               "lo": self.lo, "buckets": nonzero}
        if ex:
            out["exemplars"] = ex
        for q, label in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
            out[label] = self.quantile(q)
        return out

    def merge_shard(self, count: int, total: float, mn: float, mx: float,
                    buckets: Dict[int, int]) -> None:
        """Fold a pre-bucketed shard (same ``lo`` geometry) in under one
        lock acquisition — the flush half of the wire-plane thread-local
        shards, which observe into private bucket arrays off the hot
        path and merge here every few dozen ops."""
        if count <= 0:
            return
        with self._mu:
            self.count += count
            self.sum += total
            if mn < self.min:
                self.min = mn
            if mx > self.max:
                self.max = mx
            for i, n in buckets.items():
                if 0 <= i < self.NBUCKETS and n > 0:
                    self.buckets[i] += n

    def reset(self) -> None:
        with self._mu:
            self.count = 0
            self.sum = 0.0
            self.min = float("inf")
            self.max = 0.0
            self.buckets = [0] * self.NBUCKETS
            self._exemplars.clear()


class TopK:
    """Bounded hot-key tracker (Space-Saving-lite): a dict capped at
    ``cap`` entries; when full, a new key evicts the current minimum and
    inherits its count (the classic overestimate-but-never-miss
    trade)."""

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


class _NullInstrument:
    """Shared do-nothing stand-in for every instrument type when
    telemetry is disabled: one attribute call on a no-op method."""

    name = "<null>"
    value = 0
    count = 0
    sum = 0.0

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def attach_exemplar(self, v: float, trace_id: int, wall=None) -> None:
        pass

    def merge_shard(self, count, total, mn, mx, buckets) -> None:
        pass

    def exemplars(self) -> dict:
        return {}

    def add(self, key: int, n: int = 1) -> None:
        pass

    def top(self, k: int = 10) -> list:
        return []

    def quantile(self, q: float) -> float:
        return 0.0

    def snapshot(self) -> dict:
        return {}

    def reset(self) -> None:
        pass


_NULL = _NullInstrument()


class Registry:
    """Per-node instrument registry.  ``counter``/``gauge``/
    ``histogram``/``topk`` are idempotent get-or-create (thread-safe),
    so call sites never coordinate creation; a name can hold exactly
    one instrument type."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._mu = threading.Lock()
        self._instruments: Dict[str, object] = {}
        self._created = time.monotonic()

    def _get_or_create(self, name: str, cls, *args, **kw):
        if not self.enabled:
            return _NULL
        with self._mu:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name, *args, **kw)
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}"
                )
            return inst

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str,
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        g = self._get_or_create(name, Gauge)
        if fn is not None and isinstance(g, Gauge):
            g._fn = fn
        return g

    def histogram(self, name: str, lo: float = 1e-6) -> Histogram:
        return self._get_or_create(name, Histogram, lo)

    def topk(self, name: str, cap: int = 128) -> TopK:
        return self._get_or_create(name, TopK, cap)

    @property
    def uptime_s(self) -> float:
        return time.monotonic() - self._created

    def counters_with_prefix(self, prefix: str) -> Dict[str, int]:
        with self._mu:
            return {
                name: inst.value for name, inst in self._instruments.items()
                if isinstance(inst, Counter) and name.startswith(prefix)
            }

    def snapshot(self) -> dict:
        """JSON-serializable point-in-time view: counters, sampled
        gauges, histogram summaries (count/sum/min/max/quantiles), and
        top-k tables, plus registry uptime for rate derivation."""
        with self._mu:
            items = list(self._instruments.items())
        counters: Dict[str, int] = {}
        gauges: Dict[str, float] = {}
        hists: Dict[str, dict] = {}
        topks: Dict[str, list] = {}
        for name, inst in items:
            if isinstance(inst, Counter):
                counters[name] = inst.value
            elif isinstance(inst, Gauge):
                gauges[name] = inst.value
            elif isinstance(inst, Histogram):
                hists[name] = inst.snapshot()
            elif isinstance(inst, TopK):
                topks[name] = [[int(k), int(n)] for k, n in inst.top(10)]
        return {
            "uptime_s": round(self.uptime_s, 3),
            "counters": counters,
            "gauges": gauges,
            "histograms": hists,
            "topk": topks,
        }

    def reset(self) -> None:
        with self._mu:
            items = list(self._instruments.values())
            self._created = time.monotonic()
        for inst in items:
            inst.reset()


def merge_bucket_lists(*bucket_lists) -> Dict[int, int]:
    """Sum several snapshot ``buckets`` lists (``[[index, count], ...]``
    — the raw log2 buckets every histogram snapshot carries) into one
    ``{index: count}`` table.  The exact-merge primitive behind psmon's
    combined push+pull quantile and the windowed quantiles of
    ``timeseries.ClusterHistory`` (two histograms with the same ``lo``
    share bucket geometry, so merging counts IS merging populations)."""
    out: Dict[int, int] = {}
    for buckets in bucket_lists:
        for item in buckets or []:
            try:
                i, n = int(item[0]), int(item[1])
            except (TypeError, ValueError, IndexError):
                continue
            if n > 0:
                out[i] = out.get(i, 0) + n
    return out


def bucket_quantile(counts: Dict[int, int], lo: float, q: float,
                    clamp_lo: Optional[float] = None,
                    clamp_hi: Optional[float] = None) -> float:
    """Estimated q-quantile from a ``{bucket_index: count}`` table with
    bucket geometry ``lo`` (the same log2 layout as :class:`Histogram`;
    same geometric-midpoint estimate as :meth:`Histogram.quantile`).
    Returns 0.0 for an empty table.  ``clamp_lo``/``clamp_hi`` bound
    the estimate like the live histogram's observed min/max do."""
    total = sum(n for n in counts.values() if n > 0)
    if total <= 0:
        return 0.0
    target = q * total
    acc = 0
    est = 0.0
    # acc always reaches total >= target for q <= 1, so the break is
    # guaranteed; est stays 0.0 (then clamps) for a degenerate q > 1.
    for i in sorted(counts):
        n = counts[i]
        if n <= 0:
            continue
        acc += n
        if acc >= target:
            hi = lo * (2.0 ** i)
            lo_b = hi / 2.0 if i else 0.0
            est = (lo_b * hi) ** 0.5 if lo_b > 0 else hi / 2.0
            break
    if clamp_lo is not None:
        est = max(est, clamp_lo)
    if clamp_hi is not None:
        est = min(est, clamp_hi)
    return est


NULL_REGISTRY = Registry(enabled=False)


def node_registry(maybe_reg: Optional[Registry]) -> Registry:
    """``maybe_reg`` when present — even disabled — else a PRIVATE
    enabled registry for registry-less harnesses (stub postoffices).

    This replaced ``enabled_registry``: components whose counters
    pre-date telemetry (``van._send_syscalls``, ``pool.sharded_requests``,
    ``replicator.forwarded``, ``van.chaos_stats``) used to get a private
    always-on registry under ``PS_TELEMETRY=0`` so their legacy
    attributes kept counting while the node snapshot stayed empty.  Those
    counters now live in the node registry proper (the attributes are
    thin read-throughs), so the knob means one thing everywhere: off is
    off, and the export path has no special case to skip the private
    shadow registries."""
    return maybe_reg if maybe_reg is not None else Registry()
