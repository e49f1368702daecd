# The port's copy of pslite_tpu/telemetry/timeseries.py (it imports nothing
# of JAX); names and numbers match the JAX package's.
"""Cluster time-series history — the continuous telemetry plane.

``METRICS_PULL`` is point-in-time: one snapshot, counters since boot,
quantiles since boot.  :class:`ClusterHistory` turns it continuous: a
scheduler-side background sampler pulls the whole cluster every
``PS_METRICS_INTERVAL`` seconds (default off — psmon ``--watch``,
``--serve`` and the tests turn it on), keeps a bounded ring of
snapshots per node, and derives **windowed** signals from deltas:

- **rates** from counter deltas over the window (a shed *rate* an hour
  into a run, not a shed count divided by uptime),
- **quantiles** from histogram bucket deltas (snapshots carry the raw
  log2 ``buckets``, so the p99 *of the last few seconds* is exact
  bucket math, not an approximation),
- an **epoch/membership change log** from the routing block and the
  set of replying nodes (join/leave/stale transitions, timestamped).

Every ingested sample is handed to the :mod:`~.health` watchdog, whose
events are queryable via ``Postoffice.health()`` and rendered by psmon
``--watch``'s footer.

The sampler thread is the ONLY caller of ``collect_cluster_metrics``
it needs; everything else (tests, synthetic replay) can feed
:meth:`ClusterHistory.ingest` directly with ``{node_id: snapshot}``
dicts and an explicit wall time.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional

from ..base import id_to_rank, is_server_id
from ..utils import logging as log
from .health import Watchdog
from .metrics import bucket_quantile, merge_bucket_lists


class NodeSeries:
    """Bounded snapshot ring for one node."""

    __slots__ = ("node_id", "role", "samples", "last_seen")

    def __init__(self, node_id: int, depth: int):
        self.node_id = node_id
        self.role = "?"
        # (wall_time, metrics dict, routing dict-or-None)
        self.samples: collections.deque = collections.deque(maxlen=depth)
        self.last_seen = 0.0

    def append(self, wall: float, snap: dict) -> None:
        self.role = snap.get("role", self.role)
        self.samples.append(
            (wall, snap.get("metrics", {}) or {}, snap.get("routing"))
        )
        self.last_seen = wall

    def latest(self) -> Optional[tuple]:
        return self.samples[-1] if self.samples else None


def _window_pair(samples: list, window_s: float) -> Optional[tuple]:
    """(older, newer) samples spanning ~``window_s`` back from the
    newest; None with fewer than two samples.  The older edge is the
    newest sample at least ``window_s`` old — or the oldest held, so a
    young history still yields a (shorter) window."""
    if len(samples) < 2:
        return None
    newer = samples[-1]
    older = None
    for s in samples:
        if s[0] <= newer[0] - window_s:
            older = s
        else:
            break
    if older is None or older is newer:
        older = samples[0]
    if older[0] >= newer[0]:
        return None
    return older, newer


class ClusterHistory:
    """Scheduler-side continuous cluster telemetry (module docstring).

    Thread-safe: the sampler thread ingests while psmon/watchdog
    readers derive windows.
    """

    def __init__(self, po=None, env=None, interval_s: Optional[float] = None,
                 depth: Optional[int] = None,
                 watchdog: Optional[Watchdog] = None):
        self.po = po
        env = env if env is not None else getattr(po, "env", None)
        if interval_s is None:
            interval_s = (env.find_float("PS_METRICS_INTERVAL", 0.0)
                          if env is not None else 0.0)
        self.interval_s = max(0.0, float(interval_s))
        if depth is None:
            depth = (env.find_int("PS_METRICS_HISTORY", 512)
                     if env is not None else 512)
        self.depth = max(2, int(depth))
        self.watchdog = watchdog or Watchdog(
            env, interval_s=self.interval_s or 1.0
        )
        # Optional policy engine (cluster/autopilot.py): observes every
        # ingest round after the watchdog.  None (the default) keeps
        # ingestion bit-identical to a build without an autopilot.
        self.autopilot = None
        self._mu = threading.Lock()
        self._nodes: Dict[int, NodeSeries] = {}
        self._membership: collections.deque = collections.deque(maxlen=256)
        self._last_epoch: Optional[int] = None
        self.samples = 0  # ingest rounds completed
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- default window: long enough to smooth jitter, short enough
    # that the watchdog trips within ~2 sample intervals.
    @property
    def default_window_s(self) -> float:
        return max(2.5 * (self.interval_s or 1.0), 1e-3)

    # -- sampler lifecycle ---------------------------------------------------

    def start(self) -> None:
        """Spawn the background sampler (requires a scheduler
        postoffice and a positive interval)."""
        if self._thread is not None and self._thread.is_alive():
            return
        log.check(self.po is not None, "ClusterHistory sampler needs a "
                                       "scheduler postoffice")
        log.check(self.interval_s > 0, "PS_METRICS_INTERVAL must be > 0 "
                                       "to start the sampler")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._sample_loop, name="metrics-sampler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
        self._thread = None

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def _sample_loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            van = getattr(self.po, "van", None)
            if van is None or not van.ready.is_set():
                continue
            try:
                self.sample_once()
            except Exception as exc:  # noqa: BLE001 - one failed pull
                # (mid-teardown van, slow peer) must not kill sampling.
                log.vlog(1, f"metrics sample failed: {exc!r}")

    def sample_once(self, timeout_s: Optional[float] = None) -> dict:
        """One METRICS_PULL round ingested into the history."""
        timeout = timeout_s if timeout_s is not None else max(
            1.0, 2.0 * self.interval_s
        )
        snap = self.po.collect_cluster_metrics(timeout_s=timeout)
        self.ingest(snap)
        return snap

    # -- ingestion -----------------------------------------------------------

    def ingest(self, cluster_snap: Dict[int, dict],
               wall: Optional[float] = None) -> None:
        """Record one ``{node_id: snapshot}`` round (the sampler's, or
        a synthetic one in tests) and run the watchdog over it."""
        wall = time.time() if wall is None else float(wall)
        live_ranks = None  # server ranks still in the cluster (elastic)
        with self._mu:
            for node_id, snap in cluster_snap.items():
                series = self._nodes.get(node_id)
                if series is None:
                    series = self._nodes[node_id] = NodeSeries(
                        node_id, self.depth
                    )
                    if self.samples > 0:
                        self._membership.append({
                            "wall": wall, "change": "node_appeared",
                            "node_id": node_id,
                            "role": snap.get("role", "?"),
                        })
                series.append(wall, snap)
                routing = snap.get("routing")
                if routing and "active" in routing:
                    epoch = routing.get("epoch")
                    if epoch is not None and epoch != self._last_epoch:
                        self._membership.append({
                            "wall": wall, "change": "epoch",
                            "epoch": epoch,
                            "active": routing.get("active"),
                            "leaving": routing.get("leaving"),
                        })
                        self._last_epoch = epoch
                    live_ranks = set(routing["active"]) | set(
                        routing.get("leaving") or [])
            # Elastic membership is authoritative: retire the series of
            # servers that cleanly LEFT the cluster (a departed node
            # must not read as perpetually stale — node_stale is for
            # nodes that SHOULD be answering).  Crashed-but-not-retired
            # nodes stay, correctly flagged, until membership drops
            # them.  (Elastic implies group_size 1: id rank == rank.)
            if live_ranks is not None:
                for nid in list(self._nodes):
                    if (is_server_id(nid)
                            and id_to_rank(nid) not in live_ranks):
                        del self._nodes[nid]
                        self._membership.append({
                            "wall": wall, "change": "node_departed",
                            "node_id": nid, "role": "server",
                        })
            # Nodes absent from this round keep their old last_seen —
            # the watchdog's node_stale rule grades the silence and
            # psmon renders the age instead of dropping the row.
            self.samples += 1
        self.watchdog.evaluate(self, wall=wall)
        ap = self.autopilot
        if ap is not None:
            # Sense→decide→act rides the same cadence as the watchdog;
            # a broken policy engine must never kill the sampler.
            try:
                ap.observe(self, wall=wall)
            except Exception as exc:  # noqa: BLE001
                log.warning(f"autopilot observe failed: {exc!r}")

    # -- node access ---------------------------------------------------------

    def node_ids(self) -> List[int]:
        with self._mu:
            return sorted(self._nodes)

    def series(self, node_id: int) -> Optional[NodeSeries]:
        with self._mu:
            return self._nodes.get(node_id)

    def latest(self, node_id: int) -> Optional[dict]:
        """Newest metrics dict for a node (None if never seen)."""
        s = self.series(node_id)
        cur = s.latest() if s else None
        return cur[1] if cur else None

    def role_of(self, node_id: int) -> str:
        s = self.series(node_id)
        return s.role if s else "?"

    def stale_ages(self, now: Optional[float] = None) -> Dict[int, float]:
        """``{node_id: seconds since its last reply}`` for every node
        that missed the most recent ingest round (psmon renders these
        as last-seen ages instead of dropping the row)."""
        with self._mu:
            if not self._nodes:
                return {}
            newest = max(s.last_seen for s in self._nodes.values())
            ref = now if now is not None else newest
            return {
                nid: round(ref - s.last_seen, 3)
                for nid, s in self._nodes.items()
                if s.last_seen < newest
            }

    def membership_log(self) -> List[dict]:
        with self._mu:
            return list(self._membership)

    # -- windowed derivations ------------------------------------------------

    def _samples_of(self, node_id: int) -> list:
        """Consistent sample-list snapshot (the sampler thread appends
        concurrently; iterating the live deque would race)."""
        with self._mu:
            s = self._nodes.get(node_id)
            return list(s.samples) if s is not None else []

    def sample_pair(self, node_id: int,
                    window_s: Optional[float] = None) -> Optional[tuple]:
        """(older, newer) ``(wall, metrics, routing)`` samples spanning
        the window; None with fewer than two samples."""
        return _window_pair(self._samples_of(node_id),
                            window_s or self.default_window_s)

    def rate(self, node_id: int, counter: str,
             window_s: Optional[float] = None) -> Optional[float]:
        """Windowed rate of a counter: delta over the window / actual
        elapsed.  None with fewer than two samples; a NEGATIVE delta
        (registry reset between samples) reads as None too — one
        poisoned window beats a bogus huge rate."""
        pair = self.sample_pair(node_id, window_s)
        if pair is None:
            return None
        (w0, m0, _r0), (w1, m1, _r1) = pair
        c0 = m0.get("counters", {}).get(counter, 0)
        c1 = m1.get("counters", {}).get(counter, 0)
        delta = c1 - c0
        if delta < 0:
            return None
        return delta / max(w1 - w0, 1e-9)

    def counter_delta(self, node_id: int, counter: str,
                      window_s: Optional[float] = None) -> Optional[int]:
        pair = self.sample_pair(node_id, window_s)
        if pair is None:
            return None
        (_w0, m0, _), (_w1, m1, _) = pair
        delta = (m1.get("counters", {}).get(counter, 0)
                 - m0.get("counters", {}).get(counter, 0))
        return delta if delta >= 0 else None

    def gauges_window(self, node_id: int,
                      window_s: Optional[float] = None) -> Optional[tuple]:
        """(gauges at window start, gauges now) dicts — the growth
        signal the queue-depth watchdog rule keys on."""
        pair = self.sample_pair(node_id, window_s)
        if pair is None:
            return None
        (_w0, m0, _), (_w1, m1, _) = pair
        return m0.get("gauges", {}), m1.get("gauges", {})

    def window_buckets(self, node_id: int, hist: str,
                       window_s: Optional[float] = None) -> Optional[dict]:
        """Histogram bucket DELTAS over the window:
        ``{"lo", "count", "buckets": {index: delta}, "max"}`` — the
        population observed inside the window only.  None without two
        samples or when the histogram is absent/reset."""
        pair = self.sample_pair(node_id, window_s)
        if pair is None:
            return None
        (_w0, m0, _), (_w1, m1, _) = pair
        h1 = m1.get("histograms", {}).get(hist)
        if not h1:
            return None
        h0 = m0.get("histograms", {}).get(hist) or {}
        new = merge_bucket_lists(h1.get("buckets"))
        old = merge_bucket_lists(h0.get("buckets"))
        if h1.get("count", 0) < h0.get("count", 0):
            return None  # registry reset mid-window
        deltas = {}
        for i, n in new.items():
            d = n - old.get(i, 0)
            if d > 0:
                deltas[i] = d
        return {
            "lo": h1.get("lo", 1e-6),
            "count": sum(deltas.values()),
            "buckets": deltas,
            "max": h1.get("max", 0.0),
        }

    def window_quantile(self, node_id: int, hists, q: float,
                        window_s: Optional[float] = None) -> Optional[float]:
        """Windowed quantile over one histogram name or a LIST of names
        merged (psmon's combined push+pull latency): exact bucket-delta
        math, clamped by the live histograms' observed max.  None when
        the window saw no observations."""
        if isinstance(hists, str):
            hists = [hists]
        merged: Dict[int, int] = {}
        lo = None
        hi_clamp = 0.0
        for name in hists:
            wb = self.window_buckets(node_id, name, window_s)
            if wb is None or wb["count"] == 0:
                continue
            if lo is None:
                lo = wb["lo"]
            elif abs(lo - wb["lo"]) > 1e-18:
                continue  # incompatible geometry; skip rather than lie
            for i, n in wb["buckets"].items():
                merged[i] = merged.get(i, 0) + n
            hi_clamp = max(hi_clamp, wb["max"])
        if not merged or lo is None:
            return None
        return bucket_quantile(merged, lo, q,
                               clamp_hi=hi_clamp if hi_clamp > 0 else None)

    def trend(self, node_id: int, counter: str,
              points: int = 12) -> List[Optional[float]]:
        """Per-sample rate series for sparklines: the newest ``points``
        consecutive-sample rates of one counter (None where a sample
        gap or reset poisons a step)."""
        samples = self._samples_of(node_id)[-(points + 1):]
        out: List[Optional[float]] = []
        for (w0, m0, _), (w1, m1, _) in zip(samples, samples[1:]):
            d = (m1.get("counters", {}).get(counter, 0)
                 - m0.get("counters", {}).get(counter, 0))
            dt = w1 - w0
            out.append(d / dt if d >= 0 and dt > 0 else None)
        return out

    def wire_summary(self, node_id: int,
                     window_s: Optional[float] = None) -> Optional[dict]:
        """Windowed wire-plane digest for one node — the ``wire``
        section psmon/pssoak render.  Sums the Python shards
        (``wire.tx.*``) and the native core's block
        (``wire.native.tx.*``) so a van is judged by its whole data
        plane, whichever half carried the traffic.  Ratios are None
        when the window saw no ops; returns None entirely without two
        samples."""
        def d(counter: str) -> int:
            v = self.counter_delta(node_id, counter, window_s)
            return v if v is not None and v > 0 else 0

        def both(suffix: str) -> int:
            return d("wire." + suffix) + d("wire.native." + suffix)

        if self.sample_pair(node_id, window_s) is None:
            return None
        tx_ops = both("tx.ops")
        rx_ops = d("wire.rx.ops")          # pump-side: counts both planes
        ops = tx_ops + rx_ops
        syscalls = both("tx.syscalls") + both("rx.syscalls")
        frames = both("tx.frames") + d("wire.rx.frames") \
            + d("wire.native.rx.frames")
        bytes_zc = (both("tx.bytes_zc") + d("wire.rx.bytes_zc")
                    + d("wire.native.rx.bytes_zc"))
        bytes_copy = (d("wire.tx.bytes_copy") + d("wire.rx.bytes_copy")
                      + d("wire.native.rx.bytes_copy"))
        occ = self.window_buckets(node_id, "wire.batch_occupancy", window_s)
        batch_fill = None
        if occ and occ["count"]:
            # Mean ops per flushed frame: tx+rx ops over occupancy count
            # understates under partial windows, so derive from the
            # bucket mass itself (bucket i holds values <= lo * 2**i).
            total = sum(n * (occ["lo"] * (2 ** max(i - 1, 0)) *
                             (1.5 if i > 0 else 1.0))
                        for i, n in occ["buckets"].items())
            batch_fill = total / occ["count"]
        return {
            "ops": ops,
            "tx_ops": tx_ops,
            "rx_ops": rx_ops,
            "syscalls": syscalls,
            "frames": frames,
            "bytes_zc": bytes_zc,
            "bytes_copy": bytes_copy,
            "syscalls_per_op": (syscalls / ops) if ops else None,
            "frames_per_op": (frames / ops) if ops else None,
            "batch_fill": batch_fill,
            "zc_share": (bytes_zc / (bytes_zc + bytes_copy)
                         if (bytes_zc + bytes_copy) else None),
            "residency_p99": self.window_quantile(
                node_id, "wire.lane_residency_s", 0.99, window_s),
        }
