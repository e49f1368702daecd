"""psmon — live cluster-wide telemetry monitor (docs/observability.md).

(The port's copy of ``tools/psmon.py``: the same text from the port's
scheduler, the port's demo cluster.)

Asks the scheduler for a ``METRICS_PULL`` snapshot of every node's
metrics registry and renders one table row per node (request-latency
quantiles, lane depth, apply-shard throughput, retransmits, replication
forwards/lag) plus per-role rollups and each server's hottest keys.

On top of the one-shot table sit the CONTINUOUS modes, backed by the
scheduler's :class:`~pslite_tpu_torch.telemetry.ClusterHistory` sampler:

- ``--watch``: a live refreshing table with **windowed** rates (counter
  deltas over the sampling window, not uptime averages), sparkline
  trend columns, and a health-event footer from the SLO watchdog.
- ``--serve PORT``: an OpenMetrics/Prometheus text endpoint over
  ``http.server`` — counters, gauges, and the log2 histogram buckets
  mapped to cumulative ``le`` buckets, so any standard scraper attaches
  to any cluster.

Library use (in-process clusters, tests, notebooks)::

    from pslite_tpu_torch.tools import psmon
    snap = psmon.collect(scheduler_postoffice)   # {node_id: snapshot}
    print(psmon.format_table(snap))              # or psmon.to_json(snap)
    hist = scheduler_postoffice.start_history(interval_s=1.0)
    print(psmon.format_watch(hist))              # windowed rates + health
    print(psmon.to_prometheus(snap))             # exposition text

CLI: ``python -m pslite_tpu_torch.tools.psmon [--json|--watch|--serve
PORT]`` boots a
live demo LoopbackCluster (2 workers, 2 servers, scheduler), drives a
short push/pull storm, and renders through the chosen mode — the
end-to-end proof of the pull plane without an external deployment.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from typing import Dict, List, Optional


def collect(scheduler_po, timeout_s: float = 5.0) -> Dict[int, dict]:
    """Cluster snapshot via the scheduler's METRICS_PULL broadcast:
    ``{node_id: telemetry_snapshot}`` (nodes that failed to answer
    within the timeout are absent — pair with
    :func:`stale_ages` / ``format_table(..., stale=...)`` to render
    them as last-seen ages instead of silently dropping the row)."""
    return scheduler_po.collect_cluster_metrics(timeout_s=timeout_s)


def stale_ages(scheduler_po, snap: Dict[int, dict]) -> Dict[int, float]:
    """``{node_id: seconds since last METRICS_PULL reply}`` for every
    node the scheduler has EVER heard from that is missing from
    ``snap`` (it was asked and did not answer in time)."""
    now = time.time()
    return {
        nid: round(now - t, 3)
        for nid, t in scheduler_po.metrics_last_seen().items()
        if nid not in snap
    }


def to_json(snap: Dict[int, dict]) -> str:
    return json.dumps({str(k): v for k, v in sorted(snap.items())},
                      indent=2, sort_keys=True)


def _c(m: dict, name: str) -> int:
    return int(m.get("counters", {}).get(name, 0))


def _g(m: dict, name: str) -> float:
    return float(m.get("gauges", {}).get(name, 0.0))


def _req_quantiles(m: dict) -> tuple:
    """Merged push/pull request-latency (p50, p99) in ms — worker side.

    TRUE merged quantiles: both histogram snapshots carry their raw
    log2 ``buckets``, so the two populations merge exactly (same
    bucket geometry) instead of the old "busier path wins"
    approximation that hid a slow-but-quieter path entirely."""
    from ..telemetry.metrics import bucket_quantile, merge_bucket_lists

    hp = m.get("histograms", {}).get("kv.push_latency_s") or {}
    hl = m.get("histograms", {}).get("kv.pull_latency_s") or {}
    lo_p, lo_l = hp.get("lo", 1e-6), hl.get("lo", 1e-6)
    if hp and hl and abs(lo_p - lo_l) > 1e-18:
        # Different bucket geometry cannot merge exactly — fall back
        # to the busier path (never happens for the stock histograms).
        busy = hp if hp.get("count", 0) >= hl.get("count", 0) else hl
        return busy.get("p50", 0.0) * 1e3, busy.get("p99", 0.0) * 1e3
    merged = merge_bucket_lists(hp.get("buckets"), hl.get("buckets"))
    if not merged:
        return 0.0, 0.0
    mins = [h["min"] for h in (hp, hl) if h.get("count", 0) > 0]
    maxs = [h["max"] for h in (hp, hl) if h.get("count", 0) > 0]
    clamp_lo = min(mins) if mins else None
    clamp_hi = max(maxs) if maxs else None
    return (
        bucket_quantile(merged, lo_p, 0.5, clamp_lo, clamp_hi) * 1e3,
        bucket_quantile(merged, lo_p, 0.99, clamp_lo, clamp_hi) * 1e3,
    )


def _fmt_bytes(v: float) -> str:
    """Compact byte count for fixed-width columns (999, 12K, 3.4M, 2G)."""
    v = float(v)
    for div, suffix in ((1 << 30, "G"), (1 << 20, "M"), (1 << 10, "K")):
        if v >= div:
            q = v / div
            return f"{q:.1f}{suffix}" if q < 10 else f"{q:.0f}{suffix}"
    return f"{v:.0f}"


def _tier_cells(m: dict) -> tuple:
    """(ram/cold bytes, cold-hit-rate) cells of the tiered store
    (docs/durability.md): '-' on nodes without a TieredStore (the
    gauges only exist under PS_STORE_RAM_MB) or with PS_TELEMETRY=0."""
    gauges = m.get("gauges", {})
    if ("kv.tier_ram_bytes" not in gauges
            and "kv.tier_cold_bytes" not in gauges):
        return f"{'-':>13}", f"{'-':>6}"
    tier = (f"{_fmt_bytes(_g(m, 'kv.tier_ram_bytes'))}/"
            f"{_fmt_bytes(_g(m, 'kv.tier_cold_bytes'))}")
    gets = _c(m, "kv.tier_gets")
    cold = _c(m, "kv.cold_hits")
    rate = (f"{100.0 * cold / gets:>5.1f}%" if gets > 0
            else f"{'-':>6}")
    return f"{tier:>13}", rate


def _apply_row(m: dict, uptime: float) -> tuple:
    n = _c(m, "apply.sharded_requests") + _c(m, "apply.global_requests")
    rate = n / uptime if uptime > 0 else 0.0
    depth = sum(
        v for k, v in m.get("gauges", {}).items()
        if k.startswith("apply.shard") and k.endswith(".depth")
    )
    return n, rate, depth


def format_table(snap: Dict[int, dict], top_keys: int = 3,
                 stale: Optional[Dict[int, float]] = None,
                 health: Optional[list] = None) -> str:
    """Human-readable per-node table + per-role and per-tenant
    rollups (docs/qos.md).  ``stale`` ({node_id: last-seen age s})
    renders nodes that missed the pull as aged rows instead of
    dropping them; ``health`` (HealthEvent list) appends the
    watchdog footer."""
    # ``epoch`` (elastic membership), ``ops/F`` (small-op batching),
    # the tiered-store cells (``ram/cold`` bytes + cold-hit-rate —
    # docs/durability.md), and ``read%`` (each server's share of the
    # cluster's served pulls — docs/serving_reads.md; with replica
    # reads on, a healthy spread reads near-even across a chain, and
    # 100% on one rank is the primary funnel) ride LAST, in landing
    # order: existing consumers parse earlier columns by index.
    hdr = (f"{'node':>5} {'role':>9} {'up_s':>7} {'req_p50ms':>9} "
           f"{'req_p99ms':>9} {'lane_q':>6} {'xfers':>6} {'apply_n':>8} "
           f"{'apply/s':>8} {'retx':>6} {'repl_fwd':>8} {'repl_lag':>8} "
           f"{'cmpr':>6} {'cache%':>6} {'sent':>7} {'recv':>7} "
           f"{'epoch':>5} {'ops/F':>6} {'resp ops/F':>10} "
           f"{'ram/cold':>13} {'cold%':>6} {'read%':>6}")
    total_pulls = sum(
        _c(s.get("metrics", {}), "kv.server_pull_requests")
        for s in snap.values()
    )
    lines = [hdr, "-" * len(hdr)]
    rollup: Dict[str, Dict[str, float]] = {}
    # Elastic membership (docs/elasticity.md): per-node routing epoch
    # and, for servers, the key ranges they own under it.
    membership_lines: List[str] = []
    # Per-tenant request/shed totals across the cluster (the server-
    # side ``tenant.<name>.requests`` / ``.shed`` counters).
    tenants: Dict[str, Dict[str, int]] = {}
    hot_lines: List[str] = []
    warn_lines: List[str] = []
    for node_id in sorted(snap):
        s = snap[node_id]
        m = s.get("metrics", {})
        uptime = float(m.get("uptime_s", 0.0))
        p50, p99 = _req_quantiles(m)
        apply_n, apply_rate, _apply_depth = _apply_row(m, uptime)
        lane_q = _g(m, "van.lane_depth")
        # In-flight chunked transfers (partially reassembled) on this
        # node — docs/chunking.md; a persistently nonzero value with
        # idle traffic means leaked reassembly state.
        xfers = _g(m, "van.xfers_inflight")
        retx = _c(m, "resender.retransmits")
        fwd = _c(m, "replication.forwards")
        lag = _g(m, "replication.lag")
        sent = _c(m, "van.sent_messages")
        recv = _c(m, "van.recv_messages")
        # Wire-compression ratio this node ENCODED at (codec tier,
        # docs/compression.md): raw payload bytes / wire bytes.  "-"
        # when the node encoded nothing (or PS_TELEMETRY=0).
        craw = _c(m, "codec.raw_bytes")
        cwire = _c(m, "codec.wire_bytes")
        cmpr = f"{craw / cwire:>6.1f}" if cwire > 0 else f"{'-':>6}"
        # Hot-key cache hit rate (kv/hot_cache.py): worker-side; "-"
        # when the node never consulted a cache (PS_HOT_CACHE off).
        hits = _c(m, "kv.hot_cache.hits")
        misses = _c(m, "kv.hot_cache.misses")
        cache = (f"{100.0 * hits / (hits + misses):>5.1f}%"
                 if hits + misses > 0 else f"{'-':>6}")
        role = s.get("role", "?")
        routing = s.get("routing") or {}
        epoch = (f"{routing['epoch']:>5}" if "epoch" in routing
                 else f"{'-':>5}")
        # Small-op aggregation depth this node SENT at (docs/
        # batching.md): sub-ops per multi-op frame, split by
        # direction — request frames (worker op combiner) and
        # response frames (server batched group responses + response
        # combiner, the serving fan-in plane).  "-" when the node
        # never emitted an EXT_BATCH frame in that direction
        # (combiner off, nothing coalesced, or PS_TELEMETRY=0).
        bframes = _c(m, "van.batched_frames")
        bops = _c(m, "van.batch_ops")
        opsf = (f"{bops / bframes:>6.1f}" if bframes > 0 else f"{'-':>6}")
        rframes = _c(m, "van.resp_batched_frames")
        rops = _c(m, "van.resp_batch_ops")
        ropsf = (f"{rops / rframes:>10.1f}" if rframes > 0
                 else f"{'-':>10}")
        tier, coldp = _tier_cells(m)
        # Read share (docs/serving_reads.md): this node's slice of all
        # served pulls cluster-wide.  "-" on non-servers or before the
        # first pull.
        served = _c(m, "kv.server_pull_requests")
        readp = (f"{100.0 * served / total_pulls:>5.1f}%"
                 if served > 0 and total_pulls > 0 else f"{'-':>6}")
        lines.append(
            f"{node_id:>5} {role:>9} {uptime:>7.1f} {p50:>9.3f} "
            f"{p99:>9.3f} {lane_q:>6.0f} {xfers:>6.0f} {apply_n:>8} "
            f"{apply_rate:>8.1f} {retx:>6} {fwd:>8} {lag:>8.0f} "
            f"{cmpr} {cache} {sent:>7} {recv:>7} {epoch} {opsf} {ropsf} "
            f"{tier} {coldp} {readp}"
        )
        # Silent span loss made loud (docs/observability.md): a
        # nonzero trace.dropped_events means this node's exported
        # Chrome trace is INCOMPLETE — say so instead of letting a
        # truncated trace masquerade as a quiet one.
        dropped = _c(m, "trace.dropped_events")
        if dropped > 0:
            warn_lines.append(
                f"  WARNING node {node_id} ({role}): tracer dropped "
                f"{dropped} span(s) — its trace export is incomplete "
                f"(raise Tracer.MAX_EVENTS or lower PS_TRACE_SAMPLE)"
            )
        if routing:
            owned = routing.get("owned")
            if owned is not None:
                pretty = (", ".join(f"[{b:#x}, {e:#x})" for b, e in owned)
                          or "(none)")
                membership_lines.append(
                    f"  node {node_id} ({role}) epoch "
                    f"{routing.get('epoch')}: owns {pretty}"
                )
            elif role == "scheduler":
                membership_lines.append(
                    f"  active ranks: {routing.get('active')}  leaving: "
                    f"{routing.get('leaving')}  (epoch "
                    f"{routing.get('epoch')})"
                )
        # Published model namespace (docs/serving_reads.md): which
        # immutable model version this server is flipped to — the
        # cluster-wide A/B answer at a glance.
        ns = s.get("namespace")
        if ns:
            membership_lines.append(
                f"  node {node_id} ({role}) serving namespace "
                f"{ns.get('name')!r} version {ns.get('version')!r}"
            )
        for cname, cval in m.get("counters", {}).items():
            # tenant.<name>.<kind> — names are identifier-like (the
            # PS_TENANTS parser rejects dots), but rsplit keeps this
            # robust to any counter shape regardless.
            if cname.startswith("tenant.") and cname.count(".") >= 2:
                tname, kind = cname[len("tenant."):].rsplit(".", 1)
                t = tenants.setdefault(tname, {"requests": 0, "shed": 0})
                if kind in t:
                    t[kind] += int(cval)
        r = rollup.setdefault(role, {"nodes": 0, "sent": 0, "recv": 0,
                                     "apply": 0, "retx": 0, "fwd": 0})
        r["nodes"] += 1
        r["sent"] += sent
        r["recv"] += recv
        r["apply"] += apply_n
        r["retx"] += retx
        r["fwd"] += fwd
        top = m.get("topk", {}).get("kv.hot_keys") or []
        if top:
            pretty = ", ".join(f"{k}:{n}" for k, n in top[:top_keys])
            hot_lines.append(f"  node {node_id} ({role}) hot keys: {pretty}")
    # Nodes that were asked but never answered: a STALE row with the
    # last-seen age — an absent node is a finding, not a blank.
    for node_id in sorted(stale or {}):
        if node_id in snap:
            continue
        lines.append(
            f"{node_id:>5} {'STALE':>9}  no METRICS_PULL reply — last "
            f"seen {stale[node_id]:.1f}s ago"
        )
    if warn_lines:
        lines.append("")
        lines.extend(warn_lines)
    lines.append("")
    lines.append("per-role rollup:")
    for role in sorted(rollup):
        r = rollup[role]
        lines.append(
            f"  {role:>9}: {int(r['nodes'])} node(s), "
            f"sent={int(r['sent'])} recv={int(r['recv'])} "
            f"apply={int(r['apply'])} retx={int(r['retx'])} "
            f"repl_fwd={int(r['fwd'])}"
        )
    if tenants:
        lines.append("")
        lines.append("per-tenant rollup (docs/qos.md):")
        for tname in sorted(tenants):
            t = tenants[tname]
            total = t["requests"]
            shed_pct = 100.0 * t["shed"] / total if total else 0.0
            lines.append(
                f"  {tname:>9}: requests={total} shed={t['shed']} "
                f"({shed_pct:.1f}%)"
            )
    if membership_lines:
        lines.append("")
        lines.append("elastic membership (docs/elasticity.md):")
        lines.extend(membership_lines)
    if hot_lines:
        lines.append("")
        lines.extend(hot_lines)
    if health:
        lines.append("")
        lines.append("health events (SLO watchdog, docs/observability.md):")
        lines.extend(_health_lines(health))
    return "\n".join(lines)


# -- wire-plane table (docs/observability.md) --------------------------------


def _hist(m: dict, name: str) -> dict:
    return m.get("histograms", {}).get(name) or {}


def format_wire(snap: Dict[int, dict]) -> str:
    """Per-(node, plane) wire-plane table: syscalls/op, frames/op,
    combiner batch fill, lane-queue residency p99, and the zero-copy
    byte share.  One row per plane that actually carried traffic —
    the Python shards (``wire.*``) and the native core's counter
    block (``wire.native.*``) are judged side by side, so a regressed
    fallback path can't hide behind a healthy native plane."""
    header = (f"{'node':>5} {'role':>9} {'plane':>6} {'ops':>9} "
              f"{'sys/op':>7} {'frm/op':>7} {'fill':>6} "
              f"{'resid p99':>10} {'zc%':>6} {'bytes':>8}")
    lines = [header, "-" * len(header)]

    def ratio(num: float, den: float, w: int = 7) -> str:
        return f"{num / den:>{w}.2f}" if den > 0 else f"{'-':>{w}}"

    for node_id in sorted(snap):
        s = snap[node_id]
        m = s.get("metrics", {})
        role = s.get("role", "?")
        planes = []
        py_ops = _c(m, "wire.tx.ops") + _c(m, "wire.rx.ops")
        py_sys = _c(m, "wire.tx.syscalls") + _c(m, "wire.rx.syscalls")
        py_frm = _c(m, "wire.tx.frames") + _c(m, "wire.rx.frames")
        py_zc = _c(m, "wire.tx.bytes_zc") + _c(m, "wire.rx.bytes_zc")
        py_cp = _c(m, "wire.tx.bytes_copy") + _c(m, "wire.rx.bytes_copy")
        if py_ops or py_frm:
            planes.append(("py", py_ops, py_sys, py_frm, py_zc, py_cp))
        nt_ops = _c(m, "wire.native.tx.ops")
        nt_sys = (_c(m, "wire.native.tx.syscalls")
                  + _c(m, "wire.native.rx.syscalls"))
        nt_frm = (_c(m, "wire.native.tx.frames")
                  + _c(m, "wire.native.rx.frames"))
        nt_zc = (_c(m, "wire.native.tx.bytes_zc")
                 + _c(m, "wire.native.rx.bytes_zc"))
        nt_cp = _c(m, "wire.native.rx.bytes_copy")
        if nt_ops or nt_frm:
            planes.append(("native", nt_ops, nt_sys, nt_frm, nt_zc, nt_cp))
        occ = _hist(m, "wire.batch_occupancy")
        fill = (f"{occ['sum'] / occ['count']:>6.2f}"
                if occ.get("count") else f"{'-':>6}")
        res = _hist(m, "wire.lane_residency_s")
        resid = (f"{res.get('p99', 0.0) * 1e3:>8.2f}ms"
                 if res.get("count") else f"{'-':>10}")
        for plane, ops, sys_n, frm, zc, cp in planes:
            tot = zc + cp
            zc_pct = f"{100.0 * zc / tot:>5.1f}%" if tot else f"{'-':>6}"
            lines.append(
                f"{node_id:>5} {role:>9} {plane:>6} {ops:>9} "
                f"{ratio(sys_n, ops)} {ratio(frm, ops)} {fill} "
                f"{resid} {zc_pct} {_fmt_bytes(tot):>8}"
            )
        if not planes:
            lines.append(f"{node_id:>5} {role:>9} {'-':>6} {'-':>9} "
                         f"{'-':>7} {'-':>7} {fill} {resid} "
                         f"{'-':>6} {'-':>8}")
    rec = sum(_c(snap[n].get("metrics", {}), "wire.telemetry.records")
              for n in snap)
    fl = sum(_c(snap[n].get("metrics", {}), "wire.telemetry.flushes")
             for n in snap)
    lines.append("")
    lines.append(f"telemetry self-accounting: {rec} records in {fl} "
                 f"flushes ({rec / fl:.0f} records/flush)" if fl
                 else "telemetry self-accounting: wire plane dark "
                      "(PS_WIRE_TELEMETRY=0 or no traffic)")
    return "\n".join(lines)


# -- live watch (windowed rates + sparklines + health footer) ----------------


_SPARK = "▁▂▃▄▅▆▇█"


def _sparkline(series: List[Optional[float]], width: int = 10) -> str:
    """Unicode mini-chart of one per-sample rate series (None → '·')."""
    series = list(series)[-width:]
    if len(series) < width:
        series = [None] * (width - len(series)) + series
    vals = [v for v in series if v is not None]
    if not vals:
        return "·" * width
    lo, hi = min(vals), max(vals)
    span = hi - lo
    out = []
    for v in series:
        if v is None:
            out.append("·")
        elif span <= 0:
            out.append(_SPARK[3])
        else:
            out.append(_SPARK[min(7, int((v - lo) / span * 7.999))])
    return "".join(out)


def _health_lines(events, limit: int = 8) -> List[str]:
    out = []
    for ev in list(events)[-limit:]:
        who = f"node {ev.node_id} ({ev.role})"
        if ev.tenant:
            who += f" tenant {ev.tenant}"
        out.append(
            f"  [{ev.severity.upper():>4}] "
            f"{time.strftime('%H:%M:%S', time.localtime(ev.wall))} "
            f"{ev.rule}: {who} — {ev.message}"
        )
    return out or ["  (none)"]


def format_watch(history, top_keys: int = 3, traces=None) -> str:
    """One ``--watch`` frame from the scheduler's ClusterHistory:
    per-node WINDOWED rates (counter deltas over the sampling window —
    meaningful an hour into a run, unlike uptime averages), sparkline
    trends, stale-node ages, and the watchdog footer.  ``traces`` (a
    ``telemetry.TraceCollector`` — the scheduler's, kept warm by
    ``collect_cluster_traces``) appends the tail critical-path footer:
    which pipeline stage the assembled slow traces spend their wall
    time in (tools/pstrace.py has the full view)."""
    window = history.default_window_s
    hdr = (f"{'node':>5} {'role':>9} {'req_p50ms':>9} {'req_p99ms':>9} "
           f"{'in/s':>8} {'out/s':>8} {'apply/s':>8} {'shed/s':>7} "
           f"{'retx/s':>7} {'lane_q':>6} {'repl_lag':>8} "
           f"{'trend(out/s)':>12}")
    lines = [
        f"psmon --watch  interval={history.interval_s:g}s "
        f"window={window:.1f}s samples={history.samples}",
        hdr, "-" * len(hdr),
    ]
    stale = history.stale_ages()
    for node_id in history.node_ids():
        role = history.role_of(node_id)
        m = history.latest(node_id) or {}
        p50 = history.window_quantile(
            node_id, ["kv.push_latency_s", "kv.pull_latency_s"], 0.5)
        p99 = history.window_quantile(
            node_id, ["kv.push_latency_s", "kv.pull_latency_s"], 0.99)
        rate = lambda c: history.rate(node_id, c)  # noqa: E731

        def fmt_r(v, w=8):
            return f"{v:>{w}.1f}" if v is not None else f"{'-':>{w}}"

        def fmt_ms(v, w=9):
            return f"{v * 1e3:>{w}.3f}" if v is not None else f"{'-':>{w}}"

        apply_rate = None
        a_sh = rate("apply.sharded_requests")
        a_gl = rate("apply.global_requests")
        if a_sh is not None or a_gl is not None:
            apply_rate = (a_sh or 0.0) + (a_gl or 0.0)
        row = (
            f"{node_id:>5} {role:>9} {fmt_ms(p50)} {fmt_ms(p99)} "
            f"{fmt_r(rate('van.recv_messages'))} "
            f"{fmt_r(rate('van.sent_messages'))} "
            f"{fmt_r(apply_rate)} "
            f"{fmt_r(rate('qos.shed_requests'), 7)} "
            f"{fmt_r(rate('resender.retransmits'), 7)} "
            f"{_g(m, 'van.lane_depth'):>6.0f} "
            f"{_g(m, 'replication.lag'):>8.0f} "
            f"{_sparkline(history.trend(node_id, 'van.sent_messages')):>12}"
        )
        if node_id in stale:
            row += f"  STALE {stale[node_id]:.1f}s"
        lines.append(row)
        dropped = _c(m, "trace.dropped_events")
        if dropped > 0:
            lines.append(f"      ^ WARNING: tracer dropped {dropped} "
                         f"span(s) — trace export incomplete")
    # Snapshot age (docs/durability.md): the durable-tier freshness
    # line.  Only servers configured with PS_SNAPSHOT_DIR export the
    # gauge; a negative age means the directory holds no committed
    # manifest yet.
    snap_ages = []
    for node_id in history.node_ids():
        m = history.latest(node_id) or {}
        age = m.get("gauges", {}).get("snapshot.age_s")
        if age is not None:
            snap_ages.append(float(age))
    if snap_ages:
        committed = [a for a in snap_ages if a >= 0]
        lines.append("")
        if committed:
            lines.append(
                f"snapshot age: {min(committed):.0f}s newest / "
                f"{max(committed):.0f}s oldest across "
                f"{len(snap_ages)} server(s)"
            )
        else:
            lines.append(
                f"snapshot age: no committed manifest yet "
                f"({len(snap_ages)} server(s) configured)"
            )
    changes = history.membership_log()
    if changes:
        lines.append("")
        lines.append("membership/epoch changes:")
        for ch in changes[-5:]:
            when = time.strftime("%H:%M:%S", time.localtime(ch["wall"]))
            if ch["change"] == "epoch":
                lines.append(f"  {when} epoch {ch['epoch']}: active="
                             f"{ch.get('active')} leaving="
                             f"{ch.get('leaving')}")
            else:
                lines.append(f"  {when} {ch['change']}: node "
                             f"{ch.get('node_id')} ({ch.get('role')})")
    lines.append("")
    lines.append("health (SLO watchdog):")
    lines.extend(_health_lines(history.watchdog.events(min_severity="info")))
    lines.extend(_autopilot_lines(history))
    if traces is not None:
        agg = traces.aggregate()
        lines.append("")
        if agg["count"]:
            shares = agg["slow"]
            top = sorted(shares.items(),
                         key=lambda kv: -kv[1]["total_us"])[:4]
            pretty = " | ".join(
                f"{name} {info['share'] * 100:.0f}%"
                for name, info in top if info["total_us"] > 0
            )
            lines.append(
                f"critical path ({agg['count']} tail traces, slowest "
                f"{agg['slow_count']}): {pretty}  "
                f"[pstrace --slowest for detail]"
            )
        else:
            lines.append("critical path: no assembled tail traces "
                         "(PS_TRACE_TAIL off, or nothing kept)")
    return "\n".join(lines)


def _autopilot_lines(history, last: int = 5) -> list:
    """The autopilot decision footer (docs/autopilot.md): mode, outcome
    tallies, and the last few decisions with rule/action/outcome — the
    loop's narration, inline where the operator already looks."""
    ap = getattr(history, "autopilot", None)
    if ap is None:
        return []
    counts = ap.counts()
    tally = " ".join(f"{counts.get(k, 0)} {k}" for k in
                     ("acted", "planned", "vetoed", "failed"))
    lines = ["", f"autopilot ({ap.mode}): {tally}"]
    now = time.time()
    for d in ap.decisions(last):
        age = max(0.0, now - d.wall)
        extra = d.detail.get("veto") or d.detail.get("error") or d.reason
        lines.append(f"  {age:6.1f}s ago  {d.rule:<13} "
                     f"{d.action:<13} {d.outcome:<8} {extra}")
    if not ap.decision_log:
        lines.append("  (no decisions yet)")
    return lines


# -- OpenMetrics / Prometheus exposition -------------------------------------


PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_TENANT_RE = re.compile(r"^tenant\.(?P<tenant>.+)\.(?P<kind>[^.]+)$")


def _prom_name(name: str) -> str:
    return "pslite_" + _NAME_RE.sub("_", name)


def _prom_float(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    return repr(float(v))


def to_prometheus(snap: Dict[int, dict],
                  openmetrics: bool = False) -> str:
    """Render a cluster snapshot as Prometheus text exposition
    (version 0.0.4 by default — what ``--serve`` answers plain
    scrapes with).

    - counters → ``pslite_<name>_total`` (per-tenant counters become
      one family with a ``tenant`` label),
    - gauges → ``pslite_<name>``,
    - histograms → cumulative ``_bucket{le=...}`` series derived from
      the raw log2 buckets (upper bound ``lo * 2^i``; monotone le and
      monotone cumulative counts by construction), plus ``_sum`` and
      ``_count``.

    ``openmetrics=True`` switches to OpenMetrics 1.0 output (what
    ``--serve`` answers when the scraper's Accept header asks for
    ``application/openmetrics-text``): counter TYPE lines drop the
    ``_total`` suffix, the exposition ends with ``# EOF``, and kept
    tail-trace ids render as ``# {trace_id=...}`` EXEMPLARS on the
    histogram bucket lines — exemplar syntax is ONLY legal there, so
    the classic 0.0.4 rendering omits them (a 0.0.4 parser would
    reject the whole scrape otherwise).

    Every sample carries ``node``/``role`` labels, so one scrape of
    the scheduler covers the whole cluster."""
    counters: Dict[str, list] = {}
    gauges: Dict[str, list] = {}
    hists: Dict[str, list] = {}
    for node_id in sorted(snap):
        s = snap[node_id]
        m = s.get("metrics", {})
        base = {"node": str(node_id), "role": s.get("role", "?")}
        for name, v in sorted(m.get("counters", {}).items()):
            labels = dict(base)
            tm = _TENANT_RE.match(name)
            if tm:
                labels["tenant"] = tm.group("tenant")
                fam = _prom_name(f"tenant.{tm.group('kind')}") + "_total"
            else:
                fam = _prom_name(name) + "_total"
            counters.setdefault(fam, []).append((labels, v))
        for name, v in sorted(m.get("gauges", {}).items()):
            gauges.setdefault(_prom_name(name), []).append((base, v))
        for name, h in sorted(m.get("histograms", {}).items()):
            hists.setdefault(_prom_name(name), []).append((base, h))
        up = m.get("uptime_s")
        if up is not None:
            gauges.setdefault("pslite_uptime_seconds", []).append(
                (base, up))
    out: List[str] = []

    def _esc(v) -> str:
        # Exposition-format label escaping (\\, \", \n) — label values
        # here are identifier-like, but a hostile tenant name must not
        # corrupt the whole scrape.
        return (str(v).replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))

    def _labels(d: dict) -> str:
        inner = ",".join(f'{k}="{_esc(v)}"' for k, v in sorted(d.items()))
        return "{" + inner + "}" if inner else ""

    for fam in sorted(counters):
        # OpenMetrics names the counter FAMILY without the _total
        # suffix its samples carry; 0.0.4 types the sample name.
        tname = fam[:-len("_total")] if openmetrics else fam
        out.append(f"# TYPE {tname} counter")
        for labels, v in counters[fam]:
            out.append(f"{fam}{_labels(labels)} {int(v)}")
    for fam in sorted(gauges):
        out.append(f"# TYPE {fam} gauge")
        for labels, v in gauges[fam]:
            out.append(f"{fam}{_labels(labels)} {_prom_float(v)}")
    for fam in sorted(hists):
        out.append(f"# TYPE {fam} histogram")
        for labels, h in hists[fam]:
            lo = h.get("lo", 1e-6)
            acc = 0
            # Histogram exemplars (docs/observability.md): kept tail
            # trace ids attach to the bucket their latency landed in,
            # rendered in OpenMetrics exemplar syntax — a Prometheus
            # p99 panel links straight to the trace that caused it.
            # OPENMETRICS ONLY: the 0.0.4 text format has no exemplar
            # grammar, and a classic parser rejects the whole scrape.
            ex = ({int(i): (t, v, w)
                   for i, t, v, w in h.get("exemplars") or []}
                  if openmetrics else {})
            for i, n in sorted(
                    (int(i), int(n)) for i, n in h.get("buckets") or []):
                acc += n
                le = _prom_float(lo * (2.0 ** i))
                lb = _labels({**labels, "le": le})
                line = f"{fam}_bucket{lb} {acc}"
                if i in ex:
                    t, v, w = ex[i]
                    line += (f' # {{trace_id="{_esc(t)}"}} '
                             f"{_prom_float(v)} {round(float(w), 3)}")
                out.append(line)
            lb = _labels({**labels, "le": "+Inf"})
            out.append(f"{fam}_bucket{lb} {int(h.get('count', acc))}")
            out.append(f"{fam}_sum{_labels(labels)} "
                       f"{_prom_float(h.get('sum', 0.0))}")
            out.append(f"{fam}_count{_labels(labels)} "
                       f"{int(h.get('count', acc))}")
    if openmetrics:
        out.append("# EOF")
    return "\n".join(out) + "\n"


def serve(collect_fn, port: int, host: str = "127.0.0.1"):
    """Start a daemonized ``http.server`` answering ``GET /metrics``
    (and ``/``) with :func:`to_prometheus` over ``collect_fn()``'s
    snapshot.  Returns the live ``ThreadingHTTPServer`` — call
    ``.shutdown()`` to stop; the bound port is ``.server_address[1]``
    (pass ``port=0`` to let the OS pick, e.g. in tests)."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - http.server API
            if self.path.split("?")[0] not in ("/", "/metrics"):
                self.send_error(404)
                return
            # Content negotiation: a scraper asking for OpenMetrics
            # (Prometheus does when exemplar scraping is on) gets the
            # OM rendering WITH exemplars; everyone else gets classic
            # 0.0.4 text, which has no exemplar grammar.
            om = "openmetrics" in (self.headers.get("Accept") or "")
            try:
                body = to_prometheus(collect_fn(),
                                     openmetrics=om).encode()
            except Exception as exc:  # noqa: BLE001 - a failed pull
                self.send_error(500, explain=repr(exc))  # not a crash
                return
            self.send_response(200)
            self.send_header(
                "Content-Type",
                OPENMETRICS_CONTENT_TYPE if om else PROM_CONTENT_TYPE,
            )
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet scraper chatter
            pass

    httpd = ThreadingHTTPServer((host, port), _Handler)
    t = threading.Thread(target=httpd.serve_forever,
                         name="psmon-serve", daemon=True)
    t.start()
    return httpd


# -- CLI demo ----------------------------------------------------------------


def _demo(args) -> int:
    """Boot a live 2w+2s LoopbackCluster, run a short storm, and render
    through the chosen mode.  The standalone proof of the pull plane
    (library callers attach to their own scheduler instead)."""
    import numpy as np

    from ..benchmark import _loopback_cluster, _teardown_cluster
    from ..kv.kv_app import KVServer, KVServerDefaultHandle, KVWorker

    env = {}
    if args.watch:
        # --serve does NOT start the sampler: scrapes pull on demand
        # through collect(), and a background sampler would only burn
        # a cluster-wide METRICS_PULL per interval alongside them.
        env["PS_METRICS_INTERVAL"] = str(args.interval)
        # Tail tracing powers the watch footer's critical-path line
        # (tools/pstrace.py is the full explorer).
        env["PS_TRACE_TAIL"] = "slow:p90,errors,floor:0.05"
    nodes = _loopback_cluster(num_workers=2, num_servers=2,
                              ns="psmon-demo", env_extra=env)
    scheduler, server_pos, worker_pos = nodes[0], nodes[1:3], nodes[3:]
    servers = []
    workers = []
    try:
        for po in server_pos:
            srv = KVServer(0, postoffice=po)
            srv.set_request_handle(KVServerDefaultHandle())
            servers.append(srv)
        workers = [KVWorker(0, 0, postoffice=po) for po in worker_pos]
        keys = np.array([3, 2 ** 62, 2 ** 63 + 9], dtype=np.uint64)
        vals = np.ones(3 * 128, dtype=np.float32)
        out = np.zeros_like(vals)
        for _ in range(20):
            for w in workers:
                w.wait(w.push(keys, vals))
        workers[0].wait(workers[0].pull(keys, out))
        if args.serve is not None:
            httpd = serve(lambda: collect(scheduler), args.serve)
            port = httpd.server_address[1]
            print(f"psmon: serving Prometheus text on "
                  f"http://127.0.0.1:{port}/metrics (Ctrl-C to stop)")
            try:
                while True:
                    for w in workers:  # keep the cluster lively
                        w.wait(w.push(keys, vals))
                    time.sleep(max(args.interval, 0.5))
            except KeyboardInterrupt:
                pass
            finally:
                httpd.shutdown()
        elif args.watch:
            history = scheduler.start_history(interval_s=args.interval)
            try:
                for _ in range(args.rounds):
                    for w in workers:
                        w.wait(w.push(keys, vals))
                    time.sleep(args.interval)
                    traces = scheduler.collect_cluster_traces(
                        timeout_s=args.interval)
                    sys.stdout.write("\x1b[2J\x1b[H")  # clear + home
                    print(format_watch(history, traces=traces))
            except KeyboardInterrupt:
                pass
        else:
            snap = collect(scheduler)
            if args.wire:
                print(format_wire(snap))
            elif args.json:
                print(to_json(snap))
            else:
                print(format_table(snap, stale=stale_ages(scheduler, snap)))
    finally:
        _teardown_cluster(nodes, workers, servers)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", action="store_true",
                    help="dump the raw snapshot as JSON")
    ap.add_argument("--watch", action="store_true",
                    help="live refreshing table with windowed rates, "
                         "sparklines, and the health-event footer")
    ap.add_argument("--wire", action="store_true",
                    help="wire-plane table: syscalls/op, frames/op, "
                         "batch fill, lane residency p99 per node and "
                         "plane (docs/observability.md)")
    ap.add_argument("--serve", type=int, metavar="PORT", default=None,
                    help="serve OpenMetrics/Prometheus text exposition "
                         "on PORT (0 = OS-assigned)")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="sampling interval for --watch/--serve (s)")
    ap.add_argument("--rounds", type=int, default=10,
                    help="--watch refresh count before exiting")
    args = ap.parse_args(argv)
    return _demo(args)


if __name__ == "__main__":
    sys.exit(main())
