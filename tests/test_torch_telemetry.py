"""pslite_tpu_torch's telemetry modules against the JAX package's.

Each case puts the same inputs, made from a seed with numpy (and the
same ``random`` seed where a module draws from it), through the JAX
module and its copy in the port, and compares the results.  Tolerance:
none (equal snapshots, decisions, tables and floats), except where a
line says otherwise: the critical-path stages must sum to the request's
wall within 1e-9 relative (ten float subtractions telescoping).

Covered: the metrics registry (counters, gauges, histograms, their
quantiles, ``merge_bucket_lists``/``bucket_quantile``, ``TopK``
eviction, ``PS_TELEMETRY=0``), ``TailPolicy`` specs and seeded keep
decisions, ``TraceCollector`` assembly/TTL/eviction, ``critical_path``,
``ClusterHistory`` + ``Watchdog``, ``hot_key_hint`` and
``with_join``/``with_rebalance``, the autopilot's decisions, the wire
stats, the flight recorder, the event ``Profiler`` and ``device_trace``,
and one case per telemetry knob set in both packages.
"""

import json
import os
import random
import types

import numpy as np
import pytest

import pslite_tpu as jps
import pslite_tpu_torch as tps
from pslite_tpu.cluster import autopilot as j_ap
from pslite_tpu.environment import Environment as JEnv
from pslite_tpu.routing import RoutingTable as JTable
from pslite_tpu.telemetry import critical_path as j_cp
from pslite_tpu.telemetry import flight as j_flight
from pslite_tpu.telemetry import health as j_health
from pslite_tpu.telemetry import metrics as j_metrics
from pslite_tpu.telemetry import timeseries as j_ts
from pslite_tpu.telemetry import trace_store as j_store
from pslite_tpu.telemetry import tracing as j_tracing
from pslite_tpu.telemetry import wire as j_wire
from pslite_tpu.utils import logging as j_log
from pslite_tpu.utils import profiling as j_prof
from pslite_tpu_torch.cluster import autopilot as t_ap
from pslite_tpu_torch.environment import Environment as TEnv
from pslite_tpu_torch.routing import RoutingTable as TTable
from pslite_tpu_torch.telemetry import critical_path as t_cp
from pslite_tpu_torch.telemetry import flight as t_flight
from pslite_tpu_torch.telemetry import health as t_health
from pslite_tpu_torch.telemetry import metrics as t_metrics
from pslite_tpu_torch.telemetry import timeseries as t_ts
from pslite_tpu_torch.telemetry import trace_store as t_store
from pslite_tpu_torch.telemetry import tracing as t_tracing
from pslite_tpu_torch.telemetry import wire as t_wire
from pslite_tpu_torch.utils import logging as t_log
from pslite_tpu_torch.utils import profiling as t_prof

JAX = types.SimpleNamespace(
    name="jax", metrics=j_metrics, store=j_store, cp=j_cp, ts=j_ts,
    health=j_health, tracing=j_tracing, wire=j_wire, flight=j_flight,
    prof=j_prof, ap=j_ap, Table=JTable, Env=JEnv, log=j_log, pkg=jps)
PORT = types.SimpleNamespace(
    name="port", metrics=t_metrics, store=t_store, cp=t_cp, ts=t_ts,
    health=t_health, tracing=t_tracing, wire=t_wire, flight=t_flight,
    prof=t_prof, ap=t_ap, Table=TTable, Env=TEnv, log=t_log, pkg=tps)
BOTH = (JAX, PORT)


def _both(fn):
    """``fn(api)`` for the JAX package, then the port; both results."""
    return [fn(api) for api in BOTH]


def _no_uptime(snap):
    snap = dict(snap)
    snap.pop("uptime_s", None)
    return snap


# -- the registry ----------------------------------------------------------------


def _registry_stream(api, seed=7):
    rng = np.random.default_rng(seed)
    reg = api.metrics.Registry()
    lat = reg.histogram("kv.push_latency_s")
    size = reg.histogram("van.frame_bytes", lo=1.0)
    gauge_v = {"v": 0.0}
    reg.gauge("van.lane_depth", fn=lambda: gauge_v["v"])
    g2 = reg.gauge("apply.shard0.depth")
    for i in range(2000):
        reg.counter(f"c{int(rng.integers(0, 6))}").inc(
            int(rng.integers(1, 5)))
        lat.observe(float(rng.lognormal(-7.0, 1.5)))
        size.observe(float(rng.integers(1, 1 << 22)))
        if i % 97 == 0:
            gauge_v["v"] = float(rng.integers(0, 100))
            g2.set(float(rng.normal()))
    # A pre-bucketed shard merge (the wire plane's flush path).
    lat.merge_shard(5, 0.01, 0.001, 0.004, {3: 2, 10: 3})
    hot = reg.topk("kv.hot_keys", cap=16)
    for k in rng.zipf(1.3, 3000):
        hot.add(int(k) % 500)
    snap = _no_uptime(reg.snapshot())
    qs = [lat.quantile(q) for q in (0.0, 0.5, 0.9, 0.95, 0.99, 1.0)]
    merged = api.metrics.merge_bucket_lists(
        snap["histograms"]["kv.push_latency_s"]["buckets"],
        snap["histograms"]["van.frame_bytes"]["buckets"], [[1, 2]])
    est = [api.metrics.bucket_quantile(merged, 1e-6, q, clamp_lo=1e-6,
                                       clamp_hi=10.0)
           for q in (0.5, 0.99)]
    return snap, qs, sorted(merged.items()), est, hot.top(16)


def test_registry_snapshot_quantiles_and_topk_match():
    j, t = _both(_registry_stream)
    assert j == t


def test_topk_eviction_order_matches():
    def run(api):
        tk = api.metrics.TopK("kv.hot_keys", cap=8)
        rng = np.random.default_rng(3)
        order = []
        for k in rng.integers(0, 40, 400):
            tk.add(int(k), int(k) % 3 + 1)
            order.append(tuple(tk.top(8)))
        return order

    j, t = _both(run)
    assert j == t


def test_disabled_registry_snapshots_empty():
    def run(api):
        env = api.Env({"PS_TELEMETRY": "0", "DMLC_NUM_WORKER": "1",
                       "DMLC_NUM_SERVER": "1", "PS_VAN_TYPE": "loopback"})
        role = (api.pkg.Role.WORKER if api is JAX else "worker")
        po = api.pkg.Postoffice(role, env=env)
        reg = po.metrics
        reg.counter("kv.pushes").inc(5)
        reg.histogram("kv.push_latency_s").observe(0.1)
        reg.topk("kv.hot_keys").add(3)
        return reg.enabled, _no_uptime(reg.snapshot()), \
            _no_uptime(api.metrics.NULL_REGISTRY.snapshot())

    j, t = _both(run)
    assert j == t
    assert j[0] is False and not j[1]["counters"] and not j[1]["topk"]


# -- tail sampling and trace assembly -----------------------------------------


SPECS = ["slow:p95,errors,floor:0.001", "errors", "floor:0.5",
         "slow:p99", "1", "on", "off", "0", "", " slow:p50 , errors "]
BAD_SPECS = ["slow:p100", "floor:2", "fast:p5", "slow:p0"]


@pytest.mark.parametrize("spec", SPECS)
def test_tail_policy_parses_the_same(spec):
    def run(api):
        p = api.store.TailPolicy.parse(spec)
        return None if p is None else (p.spec, p.slow_q, p.errors, p.floor)

    j, t = _both(run)
    assert j == t


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_tail_policy_refuses_the_same(spec):
    for api in BOTH:
        with pytest.raises(api.log.CheckError):
            api.store.TailPolicy.parse(spec)


def test_tail_keep_decisions_match_under_one_seed():
    rng = np.random.default_rng(11)
    durs = rng.lognormal(-6, 1, 3000)
    outcomes = rng.choice([None, None, None, "error", "shed", "timeout"],
                          3000)
    thr = [None if i % 7 == 0 else float(x)
           for i, x in enumerate(rng.lognormal(-6, 0.5, 3000))]

    def run(api):
        pol = api.store.TailPolicy("slow:p95,errors,floor:0.05")
        random.seed(1234)
        return [pol.keep(float(d), o, th)
                for d, o, th in zip(durs, outcomes, thr)]

    j, t = _both(run)
    assert j == t
    assert {"floor", "slow>p95", "error"} <= set(j)


def _synthetic_trace(tid, t0, wall, wpid=9, spid=8):
    """One kept request's spans as a worker and a server record them."""
    tr = {"trace": tid}
    w = [
        {"name": "lane_wait", "ph": "X", "ts": t0 + 3.0, "dur": 4.0,
         "args": dict(tr)},
        {"name": "recv", "ph": "i", "ts": t0 + wall - 6.0,
         "args": dict(tr, request=False)},
        {"name": "request", "ph": "X", "ts": t0, "dur": wall,
         "args": dict(tr, keep="slow>p95", pull=False)},
    ]
    s = [
        {"name": "server_queue", "ph": "X", "ts": t0 + 20.0, "dur": 5.0,
         "args": dict(tr)},
        {"name": "codec_decode", "ph": "X", "ts": t0 + 26.0, "dur": 2.0,
         "args": dict(tr)},
        {"name": "apply", "ph": "X", "ts": t0 + 31.0, "dur": 11.5,
         "args": dict(tr)},
        {"name": "apply", "ph": "X", "ts": t0 + 33.0, "dur": 12.25,
         "args": dict(tr)},
        {"name": "respond", "ph": "i", "ts": t0 + 47.5, "args": dict(tr)},
    ]
    return {wpid: w, spid: s}


def _collector_run(api):
    coll = api.store.TraceCollector(ttl_s=5.0, max_traces=16)
    rng = np.random.default_rng(5)
    out = []
    for i in range(24):
        tid = f"{0x1000 + i:x}"
        t0 = 1000.0 * i
        wall = float(60.0 + rng.integers(0, 40))
        by_node = _synthetic_trace(tid, t0, wall)
        # Every third trace is a rootless partial (its worker dropped it).
        if i % 3 == 2:
            by_node[9] = [e for e in by_node[9] if e["name"] != "request"]
        coll.ingest(8, "server", by_node[8], now=float(i))
        coll.ingest(9, "worker", by_node[9], now=float(i),
                    flight=[{"kind": "failover", "trace": tid}]
                    if i == 4 else None, evicted=i % 2)
    out.append((len(coll), coll.evicted, coll.lost_spans))
    out.append(coll.retire(now=26.0))
    out.append((coll.retired_partials, len(coll)))
    bds = coll.breakdowns()
    out.append(bds)
    out.append(coll.aggregate(slow_frac=0.25))
    out.append([t.tid for t in coll.assembled()])
    return out, bds


def test_trace_collector_assembles_retires_and_evicts_the_same():
    (j, jb), (t, tb) = _both(_collector_run)
    assert j == t
    assert jb and all(b["server"] == 8 for b in jb)


def test_critical_path_stages_match_and_sum_to_wall():
    (_, jb), (_, tb) = _both(_collector_run)
    assert [b["stages"] for b in jb] == [b["stages"] for b in tb]
    assert tuple(t_cp.STAGES) == tuple(j_cp.STAGES)
    for b in tb:
        assert sum(b["stages"].values()) == pytest.approx(b["wall_us"],
                                                          rel=1e-9)
        assert b["stages"]["apply"] == 45.25 - 31.0
        assert b["stages"]["decode"] == 28.0 - 25.0


# -- history, health, the load hint, the autopilot -----------------------------


def _snap(node_id, role, counters=None, gauges=None, hists=None,
          topk=None):
    return {"node_id": node_id, "role": role,
            "metrics": {"counters": counters or {},
                        "gauges": gauges or {},
                        "histograms": hists or {}, "topk": topk or {},
                        "uptime_s": 10.0}}


def _history_feed(seed=21):
    rng = np.random.default_rng(seed)
    feed = []
    push = pull = shed = retx = 0
    buckets = {}
    for w in range(12):
        push += int(rng.integers(50, 200))
        pull += int(rng.integers(50, 200))
        shed += int(rng.integers(0, 40)) if w > 5 else 0
        retx += int(rng.integers(0, 30))
        for _ in range(50):
            i = int(rng.integers(5, 20))
            buckets[i] = buckets.get(i, 0) + 1
        hist = {"count": sum(buckets.values()), "sum": 0.0, "min": 1e-5,
                "max": 0.5, "lo": 1e-6,
                "buckets": [[k, v] for k, v in sorted(buckets.items())]}
        snaps = {
            8: _snap(8, "server", counters={
                "kv.server_push_requests": push,
                "kv.server_pull_requests": pull,
                "qos.shed_requests": shed,
                "resender.retransmits": retx},
                gauges={"replication.lag": float(rng.integers(0, 3000)),
                        "apply.shard0.depth": float(w * 40)},
                topk={"kv.hot_keys": [[int(k), int(n)] for k, n in zip(
                    rng.integers(0, 1 << 20, 8),
                    rng.integers(1, 100, 8))]}),
            9: _snap(9, "worker", counters={"kv.pushes": push},
                     hists={"kv.push_latency_s": hist}),
        }
        feed.append((float(100 + 2 * w), snaps))
    return feed


def _history_run(api):
    env = api.Env({"PS_SLO": "shed_rate=1:20,req_p99=0.001:0.01",
                   "PS_METRICS_HISTORY": "8"})
    h = api.ts.ClusterHistory(env=env, interval_s=1.0)
    out = []
    for wall, snaps in _history_feed():
        h.ingest(snaps, wall=wall)
        out.append((h.rate(8, "kv.server_push_requests"),
                    h.rate(8, "qos.shed_requests", window_s=4.0),
                    h.counter_delta(9, "kv.pushes"),
                    h.window_quantile(9, "kv.push_latency_s", 0.5),
                    h.window_quantile(9, "kv.push_latency_s", 0.99),
                    h.trend(8, "resender.retransmits"),
                    h.gauges_window(8)))
    events = [e.as_dict() for e in h.watchdog.events(min_severity="info")]
    return out, events, h.stale_ages(now=200.0), len(h.series(8).samples)


def test_history_rates_quantiles_and_health_events_match():
    j, t = _both(_history_run)
    assert j == t
    assert j[1], "the watchdog should have graded the shed storm"


def test_slo_spec_parses_the_same():
    spec = "shed_rate=1:5, req_p99=0.002:0.02 ,repl_lag=10:100"

    def run(api):
        return {k: (r.name, r.warn, r.crit)
                for k, r in api.health.parse_slo(spec).items()}

    j, t = _both(run)
    assert j == t


def test_hot_key_hint_and_load_weighted_join_cut_the_same():
    rng = np.random.default_rng(9)
    zipf_keys = (rng.zipf(1.2, 4000) * 7919) % (1 << 40)
    counts = {}
    for k in zipf_keys:
        counts[int(k)] = counts.get(int(k), 0) + 1
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:10]
    replies = {8: {"metrics": {"topk": {"kv.hot_keys": [
        [k, n] for k, n in top[:6]]}}},
        10: {"metrics": {"topk": {"kv.hot_keys": [
            [k, n] for k, n in top[4:]] + [["bad"]]}}},
        1: {"error": "x"}}

    def run(api):
        env = api.Env({"DMLC_NUM_WORKER": "1", "DMLC_NUM_SERVER": "2",
                       "PS_VAN_TYPE": "loopback"})
        role = (api.pkg.Role.SCHEDULER if api is JAX else "scheduler")
        po = api.pkg.Postoffice(role, env=env)
        po._metrics_replies = dict(replies)
        hint = po.hot_key_hint()
        t0 = api.Table.initial(2)
        t1 = t0.with_join(2, hot=hint)
        t2 = t1.with_rebalance(0, 1, hot=hint)
        return hint, t1.to_json(), t2.to_json()

    j, t = _both(run)
    assert j == t
    assert j[0]


class _FakePo:
    """The actuator surface the autopilot drives, calls recorded (after
    ``tests/test_autopilot.py``'s FakePo)."""

    def __init__(self, api, env, num_servers=3, elastic=True):
        self.env = env
        self.flight = api.flight.FlightRecorder(env, "scheduler")
        self.group_size = 1
        self._table = (api.Table.initial(num_servers) if elastic else None)
        self.broadcasts = []
        self.retunes = []
        self.snapshot_calls = []
        self.snapshot_dir = None
        self.van = types.SimpleNamespace(broadcast_routing=self._bcast)

    def _bcast(self, table):
        self.broadcasts.append(table.to_json())
        self._table = table

    def routing_table(self):
        return self._table

    def migrations_in_flight(self):
        t = self._table
        return [] if t is None else [(t.epoch, e.begin)
                                     for e in t.migrations()]

    def hot_key_hint(self):
        return {}

    def snapshot(self, **kw):
        self.snapshot_calls.append(kw)
        return {"servers": 1}

    def retune_apply(self, task_bytes, **kw):
        self.retunes.append(task_bytes)
        return {"applied": 1}


AUTOPILOT_CASES = {
    "hot_skew": dict(mode="act", env={"PS_AUTOPILOT_SUSTAIN": 3,
                                      "PS_AUTOPILOT_SKEW_COOLDOWN_S": 0}),
    "plan_budget": dict(mode="plan", env={
        "PS_AUTOPILOT_SUSTAIN": 1, "PS_AUTOPILOT_SKEW_COOLDOWN_S": 0,
        "PS_AUTOPILOT_MAX_ACTIONS": 1, "PS_AUTOPILOT_WINDOW_S": 60}),
    "static": dict(mode="act", elastic=False, env={
        "PS_AUTOPILOT_SUSTAIN": 1, "PS_AUTOPILOT_SKEW_COOLDOWN_S": 0}),
    "apply_wait": dict(mode="act", env={
        "PS_AUTOPILOT_SUSTAIN": 1, "PS_AUTOPILOT_RETUNE_COOLDOWN_S": 0,
        "PS_APPLY_TASK_BYTES": 256 << 10}, traces=True),
}


@pytest.mark.parametrize("case", sorted(AUTOPILOT_CASES))
def test_autopilot_decisions_match(case):
    spec = AUTOPILOT_CASES[case]
    rng = np.random.default_rng(17)
    rates = [{8: float(r0), 10: float(r1), 12: float(r2)}
             for r0, r1, r2 in zip(rng.integers(60, 120, 8),
                                   rng.integers(1, 10, 8),
                                   rng.integers(1, 10, 8))]
    shares = [0.8, 0.7, 0.9, 0.02, 0.01, 0.3, 0.0, 0.0]

    def run(api):
        env = api.Env({k: str(v) for k, v in spec["env"].items()})
        po = _FakePo(api, env, elastic=spec.get("elastic", True))
        ap = api.ap.Autopilot(po, env=env, mode=spec["mode"])
        h = api.ts.ClusterHistory(env=None, interval_s=1.0)
        h.autopilot = ap
        share = {"v": 0.0}
        if spec.get("traces"):
            ap.trace_source = lambda: {
                "count": 20, "slow": {"apply_wait": {
                    "share": share["v"], "total_us": 1000.0}}}
        for w, r in enumerate(rates):
            share["v"] = shares[w]
            h.ingest({nid: _snap(nid, "server", counters={
                "kv.server_pull_requests": int(v * (w + 1) * 10)})
                for nid, v in r.items()}, wall=float(w))
        decisions = [(d.rule, d.action, d.outcome,
                      d.detail.get("veto", "")) for d in ap.decision_log]
        return decisions, po.broadcasts, po.retunes, [
            (e["kind"], e.get("outcome")) for e in po.flight.events()]

    j, t = _both(run)
    assert j == t
    assert j[0], f"case {case} made no decision"


def test_autopilot_mode_parsing_matches():
    for raw in (None, "", "0", "off", "1", "on", "act", "plan", "dry-run",
                "PLAN"):
        j = t = None
        try:
            j = j_ap.parse_mode(raw)
        except j_log.CheckError:
            j = "raise"
        try:
            t = t_ap.parse_mode(raw)
        except t_log.CheckError:
            t = "raise"
        assert j == t, raw


# -- wire stats, flight recorder, profiler --------------------------------------


def test_wire_stats_snapshots_match():
    def run(api):
        reg = api.metrics.Registry()
        env = api.Env({"PS_WIRE_MAX_LANES": "3",
                       "PS_WIRE_FLUSH_OPS": "7"})
        ws = api.wire.make_wire_stats(reg, env)
        rng = np.random.default_rng(2)
        for i in range(300):
            ws.tx_msg(int(rng.integers(1, 4)))
            ws.tx_frame(int(rng.integers(8, 16)), int(rng.integers(0, 1 << 20)),
                        int(rng.integers(40, 200)))
            ws.tx_syscalls(int(rng.integers(1, 3)))
            ws.rx_msg(int(rng.integers(1, 3)), int(rng.integers(0, 1 << 16)))
            ws.rx_syscalls(1)
            ws.lane_residency(float(rng.lognormal(-9, 1)))
            ws.batch_occupancy(int(rng.integers(1, 64)))
        ws.sync_native({"tx_syscalls": 10, "tx_msgs": 4, "rx_frames": 3})
        ws.sync_native({"tx_syscalls": 15, "tx_msgs": 9, "rx_frames": 3})
        ws.flush()
        off = api.wire.make_wire_stats(
            reg, api.Env({"PS_WIRE_TELEMETRY": "0"}))
        return _no_uptime(reg.snapshot()), off.enabled

    j, t = _both(run)
    assert j == t
    assert j[1] is False


def test_flight_recorder_ring_and_dump(tmp_path):
    def run(api):
        d = tmp_path / api.name
        d.mkdir()
        env = api.Env({"PS_FLIGHT_EVENTS": "5", "PS_TRACE_DIR": str(d)})
        fr = api.flight.FlightRecorder(env, "server")
        fr.node_id = 8
        for i in range(21):
            fr.record("node_down" if i % 2 else "epoch_change",
                      severity="crit" if i == 6 else "info", peer=i)
        evs = [{k: v for k, v in e.items() if k not in ("wall", "ts_us")}
               for e in fr.events()]
        path = fr.dump_if_abnormal()
        dumped = json.load(open(path))
        return evs, os.path.basename(path).split("_")[:3], \
            sorted(dumped) if isinstance(dumped, dict) else type(dumped)

    j, t = _both(run)
    assert j == t
    assert len(j[0]) == 16


def test_profiler_event_log_matches(tmp_path):
    def run(api):
        path = tmp_path / f"{api.name}.csv"
        env = api.Env({"ENABLE_PROFILING": "1", "PROFILE_PATH": str(path)})
        p = api.prof.Profiler(env, "worker")
        for i in range(600):
            p.record(i % 5, "send" if i % 2 else "recv", bool(i % 3))
        p.record_engine("grads", "push_pull", 81920000, 42)
        p.close()
        assert p.closed
        rows = [ln.split(",") for ln in path.read_text().splitlines()]
        return [r[:2] if len(r) == 3 else [r[0], r[1], r[3], r[4]]
                for r in rows]

    j, t = _both(run)
    assert j == t
    assert j[-1] == ["grads", "push_pull_engine", "81920000", "42"]


def test_device_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    import torch

    with t_prof.device_trace(str(tmp_path)) as tr:
        a = torch.randn(64, 64)
        (a @ a).sum().item()
    assert tr.path and os.path.exists(tr.path)
    doc = json.load(open(tr.path))
    assert doc.get("traceEvents")
    assert any("mm" in (e.get("name") or "") for e in doc["traceEvents"])


def test_clocked_matches():
    assert t_prof.clocked(lambda: None, measure=lambda f: 1.5) == 1.5
    assert t_prof.clocked(lambda: None) >= 0.0
    assert j_prof.clocked(lambda: None, measure=lambda f: 1.5) == 1.5


# -- the knobs, set in both packages ------------------------------------------


def _knob_tracer(api, env):
    return api.tracing.Tracer(env, "worker",
                              metrics=api.metrics.Registry())


KNOBS = {
    "PS_TELEMETRY": ("0", lambda api, env: api.metrics.Registry(
        enabled=env.find_bool("PS_TELEMETRY", True)).enabled),
    "PS_TRACE_SAMPLE": ("0.25", lambda api, env: (
        _knob_tracer(api, env).sample, _knob_tracer(api, env).active)),
    "PS_TRACE_TAIL": ("slow:p90,errors", lambda api, env: (
        getattr(_knob_tracer(api, env).tail, "slow_q", None),
        _knob_tracer(api, env).active)),
    "PS_TRACE_DIR": ("/nonexistent/pstrace", lambda api, env: os.path.dirname(
        _knob_tracer(api, env).default_path())),
    "PS_TRACE_RING": ("77", lambda api, env: _knob_tracer(api, env)
                      .MAX_EVENTS),
    "PS_TRACE_FLUSH_S": ("3.5", lambda api, env: _knob_tracer(api, env)
                         ._flush_s),
    "PS_METRICS_INTERVAL": ("2.5", lambda api, env: api.ts.ClusterHistory(
        env=env).interval_s),
    "PS_METRICS_HISTORY": ("9", lambda api, env: api.ts.ClusterHistory(
        env=env).depth),
    "PS_SLO": ("shed_rate=3:9", lambda api, env: (
        api.ts.ClusterHistory(env=env).watchdog.rules["shed_rate"].warn)),
    "PS_FLIGHT_EVENTS": ("20", lambda api, env: api.flight.FlightRecorder(
        env, "worker")._ring.maxlen),
    "ENABLE_PROFILING": ("1", None),
    "PROFILE_PATH": ("1", None),
    "PS_AUTOPILOT": ("plan", lambda api, env: api.ap.parse_mode(
        env.find("PS_AUTOPILOT"))),
    "PS_AUTOPILOT_SUSTAIN": ("4", lambda api, env: [
        r.sustain for r in _knob_autopilot(api, env).rules]),
    "PS_AUTOPILOT_MAX_ACTIONS": ("2", lambda api, env: _knob_autopilot(
        api, env).max_actions),
    "PS_AUTOPILOT_DISABLE": ("hot_skew,apply_wait", lambda api, env:
                             [r.name for r in _knob_autopilot(api, env)
                              .rules]),
}


def _knob_autopilot(api, env):
    return api.ap.Autopilot(_FakePo(api, env), env=env, mode="plan")


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_knob_is_honoured_in_both(knob, tmp_path):
    value, probe = KNOBS[knob]
    if probe is None:  # the event profiler: its log appears at the path
        def probe(api, env):
            path = tmp_path / f"{api.name}.csv"
            env = api.Env({"ENABLE_PROFILING": "1",
                           "PROFILE_PATH": str(path)})
            p = api.prof.Profiler(env, "server")
            p.record(3, "send", True)
            p.close()
            return path.read_text().split(",")[:2]
    j, t = _both(lambda api: probe(api, api.Env({knob: value})))
    off = _both(lambda api: probe(api, api.Env({})))
    assert j == t
    assert off[0] == off[1]
    if knob not in ("ENABLE_PROFILING", "PROFILE_PATH"):
        assert j != off[0], f"{knob} changed nothing"
