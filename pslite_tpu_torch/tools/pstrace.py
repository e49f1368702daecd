"""pstrace — live tail-trace explorer (docs/observability.md).

(The port's copy of ``tools/pstrace.py``: the same text from the port's
scheduler, the port's demo cluster.)

Where psmon answers "what are the rates", pstrace answers "where does
the tail LIVE": it drives the scheduler's ``TRACE_PULL`` broadcast
(``Postoffice.collect_cluster_traces``), which drains every node's
tail-trace span ring, assembles complete request trees by trace id
(``telemetry/trace_store.py``), and attributes each request's wall
time across the pipeline stages (``telemetry/critical_path.py``):

    worker queue → lane wait → wire → server intake queue → decode →
    apply-shard wait → apply → response gate → response wire →
    completion

Library use (any live cluster — attach to your scheduler po)::

    from pslite_tpu_torch.tools import pstrace
    coll = pstrace.collect(scheduler_po)     # TraceCollector
    print(pstrace.format_top(coll))          # per-stage share table
    print(pstrace.format_slowest(coll, 5))   # slowest traces + flight
    print(pstrace.format_path(coll, tid))    # one trace, stage by stage
    pstrace.export_chrome(coll, "out.json")  # Perfetto-ready JSON

CLI: ``python -m pslite_tpu_torch.tools.pstrace [--top|--slowest N|--path
TID|--export FILE]`` boots a live 2w+2s TCP demo cluster with tail
tracing ON and a chaos receive delay injected on ONE server, runs a mixed push/pull
storm, and renders the assembled tail — the end-to-end proof that the
critical-path attribution pins the injected stage on the slow server.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from ..telemetry.critical_path import STAGES


def collect(scheduler_po, timeout_s: float = 5.0):
    """One TRACE_PULL round: drains every node's span ring into the
    scheduler's TraceCollector and returns it (traces accumulate
    across calls; rootless partials retire on the TTL)."""
    return scheduler_po.collect_cluster_traces(timeout_s=timeout_s)


def _ms(us: float) -> str:
    return f"{us / 1000.0:.3f}"


def format_top(coll, slow_frac: float = 0.25) -> str:
    """The "where does the tail live" table: per-stage wall-time
    shares over every assembled trace, and over the SLOWEST
    ``slow_frac`` of them (the population a p99 panel shows)."""
    agg = coll.aggregate(slow_frac=slow_frac)
    if not agg["count"]:
        return ("pstrace: no assembled traces (is PS_TRACE_TAIL set, "
                "and has any request been kept since the last pull?)")
    lines = [
        f"pstrace --top  assembled={agg['count']} "
        f"wall_p50={_ms(agg['wall_p50_us'])}ms "
        f"wall_max={_ms(agg['wall_max_us'])}ms "
        f"(slow set = slowest {agg['slow_count']})",
        f"{'stage':>14} {'all ms':>10} {'all %':>7} "
        f"{'slow ms':>10} {'slow %':>7}",
        "-" * 53,
    ]
    for name in STAGES:
        a = agg["stages"].get(name, {"total_us": 0.0, "share": 0.0})
        s = agg["slow"].get(name, {"total_us": 0.0, "share": 0.0})
        lines.append(
            f"{name:>14} {_ms(a['total_us']):>10} "
            f"{a['share'] * 100:>6.1f}% {_ms(s['total_us']):>10} "
            f"{s['share'] * 100:>6.1f}%"
        )
    lines.append("")
    lines.append(f"tail lives in: {agg['top_stage']} "
                 f"({agg['slow'][agg['top_stage']]['share'] * 100:.1f}% "
                 f"of the slow set's wall)")
    lost = getattr(coll, "lost_spans", 0)
    if lost:
        lines.append(
            f"WARNING: node rings overwrote {lost} span(s) before they "
            f"could be pulled — pull more often or raise PS_TRACE_RING"
        )
    return "\n".join(lines)


def _flight_lines(flight: List[dict], indent: str = "      ") -> List[str]:
    out = []
    for ev in flight:
        extra = {k: v for k, v in ev.items()
                 if k not in ("ts_us", "kind", "severity", "trace")}
        out.append(
            f"{indent}flight [{ev.get('severity', '?').upper()}] "
            f"{ev.get('kind')}: "
            + ", ".join(f"{k}={v}" for k, v in sorted(extra.items()))
        )
    return out


def format_slowest(coll, n: int = 5) -> str:
    """The slowest assembled traces, each with its critical-path
    breakdown, keep reason, critical server, and any flight-recorder
    events correlated by trace id (sheds, failovers, give-ups)."""
    rows = sorted(coll.breakdowns(), key=lambda b: -b["wall_us"])[:n]
    if not rows:
        return "pstrace: no assembled traces"
    lines = [f"pstrace --slowest {n}"]
    for b in rows:
        top3 = sorted(b["stages"].items(), key=lambda kv: -kv[1])[:3]
        wall = max(b["wall_us"], 1e-9)
        stages = "  ".join(
            f"{name}={_ms(us)}ms({us / wall * 100:.0f}%)"
            for name, us in top3 if us > 0
        )
        lines.append(
            f"  {b['trace']}: wall={_ms(b['wall_us'])}ms "
            f"keep={b['keep']}"
            + (f" outcome={b['outcome']}" if b.get("outcome") else "")
            + f" server={b['server']}  {stages}"
        )
        lines.extend(_flight_lines(b.get("flight") or []))
    return "\n".join(lines)


def format_path(coll, tid: str) -> str:
    """One trace end to end: the per-stage serial breakdown (sums to
    the request's wall by construction) and every span on the shared
    timeline."""
    tr = coll.get(tid)
    if tr is None:
        return f"pstrace: unknown trace {tid!r}"
    b = tr.breakdown()
    if b is None:
        return (f"pstrace: trace {tid} has no worker root yet "
                f"(partial — {len(tr.spans)} span(s) collected)")
    wall = max(b["wall_us"], 1e-9)
    lines = [
        f"pstrace --path {tid}  wall={_ms(b['wall_us'])}ms "
        f"keep={b['keep']} worker={b['worker']} server={b['server']}",
        f"{'stage':>14} {'ms':>10} {'%':>6}",
        "-" * 33,
    ]
    for name in STAGES:
        us = b["stages"][name]
        lines.append(f"{name:>14} {_ms(us):>10} {us / wall * 100:>5.1f}%")
    lines.extend(_flight_lines(b.get("flight") or [], indent="  "))
    lines.append("")
    lines.append("spans (t_rel ms, dur ms, node, name):")
    t0 = b["t0_us"]
    for ev in sorted(tr.spans, key=lambda e: e.get("ts", 0.0)):
        lines.append(
            f"  {_ms(ev.get('ts', 0.0) - t0):>9} "
            f"{_ms(ev.get('dur', 0.0)):>9} "
            f"{ev.get('pid', '?'):>4} {ev.get('name')}"
        )
    return "\n".join(lines)


def export_chrome(coll, path: str, tid: Optional[str] = None) -> str:
    """Write assembled traces (or ONE trace with ``tid``) as Chrome
    trace-event JSON — drop the file into Perfetto; every node is its
    own process on the shared timeline."""
    if tid is not None:
        tr = coll.get(tid)
        if tr is None:
            raise KeyError(f"unknown trace {tid!r}")
        doc = tr.chrome()
    else:
        events: List[dict] = []
        roles = {}
        for tr in coll.assembled():
            roles.update(tr.roles)
            events.extend(tr.spans)
        doc = {"traceEvents": [
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": f"{roles[pid]} {pid}"}}
            for pid in sorted(roles)
        ] + sorted(events, key=lambda e: e.get("ts", 0.0)),
            "displayTimeUnit": "ms"}
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return path


# -- CLI demo ----------------------------------------------------------------


def _demo_cluster(slow_server_delay_ms=(5, 15)):
    """Boot a live 2w+2s cluster over REAL TCP sockets with tail
    tracing on and a chaos receive delay wrapped around server 1 —
    the injected tail the demo's attribution must pin."""
    import threading

    from ..environment import Environment
    from ..message import Role
    from ..postoffice import Postoffice
    from ..utils.network import get_available_port

    host, port = "127.0.0.1", get_available_port()
    base = {
        "DMLC_NUM_WORKER": "2",
        "DMLC_NUM_SERVER": "2",
        "DMLC_PS_ROOT_URI": host,
        "DMLC_PS_ROOT_PORT": str(port),
        "DMLC_NODE_HOST": host,
        "PS_VAN_TYPE": "tcp",
        "PS_TRACE_TAIL": "slow:p90,errors,floor:0.05",
    }
    lo, hi = slow_server_delay_ms
    slow = dict(base, PS_VAN_TYPE="chaos+tcp",
                PS_CHAOS=f"seed=11,delay={lo}:{hi}")
    nodes = [Postoffice(Role.SCHEDULER, env=Environment(dict(base)))]
    nodes.append(Postoffice(Role.SERVER, env=Environment(dict(base))))
    nodes.append(Postoffice(Role.SERVER, env=Environment(slow)))
    nodes += [Postoffice(Role.WORKER, env=Environment(dict(base)))
              for _ in range(2)]
    threads = [threading.Thread(target=po.start, args=(0,), daemon=True)
               for po in nodes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    return nodes


def _demo(args) -> int:
    import numpy as np

    from ..benchmark import _teardown_cluster
    from ..kv.kv_app import KVServer, KVServerDefaultHandle, KVWorker

    nodes = _demo_cluster()
    scheduler, server_pos, worker_pos = nodes[0], nodes[1:3], nodes[3:]
    servers, workers = [], []
    try:
        for po in server_pos:
            srv = KVServer(0, postoffice=po)
            srv.set_request_handle(KVServerDefaultHandle())
            servers.append(srv)
        workers = [KVWorker(0, 0, postoffice=po) for po in worker_pos]
        # Mixed storm spanning BOTH servers' key ranges: the chaos
        # delay on server 1 should surface as wire-stage tail there.
        keys = np.array([3, 2 ** 62, 2 ** 63 + 9, 2 ** 63 + 2 ** 62],
                        dtype=np.uint64)
        vals = np.ones(len(keys) * 256, dtype=np.float32)
        out = np.zeros_like(vals)
        for i in range(args.rounds):
            tss = [w.push(keys, vals) for w in workers]
            for w, ts in zip(workers, tss):
                w.wait(ts)
            if i % 4 == 3:
                workers[0].wait(workers[0].pull(keys, out))
        coll = collect(scheduler, timeout_s=10.0)
        if args.export:
            path = export_chrome(coll, args.export, tid=args.path)
            print(f"pstrace: wrote {path}")
        elif args.path:
            print(format_path(coll, args.path))
        elif args.slowest:
            print(format_slowest(coll, args.slowest))
        else:
            print(format_top(coll))
            print()
            print(format_slowest(coll, 3))
    finally:
        _teardown_cluster(nodes, workers, servers)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--top", action="store_true",
                    help="per-stage critical-path share table (default)")
    ap.add_argument("--slowest", type=int, metavar="N", default=0,
                    help="show the N slowest assembled traces with "
                         "correlated flight events")
    ap.add_argument("--path", type=str, metavar="TRACE", default=None,
                    help="full stage-by-stage breakdown of one trace id")
    ap.add_argument("--export", type=str, metavar="FILE", default=None,
                    help="write assembled traces (or --path's trace) "
                         "as Chrome/Perfetto trace JSON")
    ap.add_argument("--rounds", type=int, default=48,
                    help="demo storm rounds before collecting")
    args = ap.parse_args(argv)
    return _demo(args)


if __name__ == "__main__":
    sys.exit(main())
