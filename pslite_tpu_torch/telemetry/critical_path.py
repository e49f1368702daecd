# The port's copy of pslite_tpu/telemetry/critical_path.py (it imports nothing
# of JAX); names and numbers match the JAX package's.
"""Critical-path attribution of assembled traces.

An assembled trace (telemetry/trace_store.py) is a bag of spans from
every node one request touched, on one wall-aligned timeline.  This
module turns it into the answer an operator actually needs when the
watchdog fires "req_p99 breached": a serial breakdown of the request's
wall time across the pipeline stages —

    worker queue → lane/combine wait → wire → server intake queue →
    decode → apply-shard wait → apply → response gate →
    response wire → completion

computed as CONSECUTIVE segments between the checkpoints the spans
provide.  For a fan-out request the breakdown follows the CRITICAL
server — the one whose response landed last; by construction the
stages of one trace sum exactly to the request's measured wall time
(missing checkpoints fold their interval into the next present stage,
never drop it).
"""

from __future__ import annotations

from typing import Dict, List, Optional

# Stage names in pipeline order.  Every breakdown dict carries all of
# them (0.0 where the trace had no checkpoint to split on).
STAGES = (
    "worker_queue",    # issue -> send-lane/combiner enqueue
    "lane_wait",       # enqueue -> dispatch (lane_wait / combine_wait)
    "wire",            # dispatch -> server receive
    "server_queue",    # server receive -> request-thread intake
    "decode",          # codec decode (0 for raw payloads)
    "apply_wait",      # intake -> first apply-shard start
    "apply",           # first apply start -> last apply end
    "response_gate",   # apply end -> response emission (order gate)
    "response_wire",   # respond -> worker receives the response
    "completion",      # response receive -> request completion
)


def _end(ev: dict) -> float:
    return ev.get("ts", 0.0) + ev.get("dur", 0.0)


def _server_events(spans: List[dict], wpid: int,
                   t0: float, t1: float) -> Dict[int, dict]:
    """Per-server-node checkpoint spans within the request window."""
    out: Dict[int, dict] = {}
    for ev in spans:
        pid = ev.get("pid")
        if pid == wpid:
            continue
        ts = ev.get("ts", 0.0)
        if ts < t0 - 1.0 or ts > t1 + 1.0:
            continue  # an earlier retry's spans under a reused ring id
        ent = out.setdefault(pid, {})
        name = ev.get("name")
        if name == "server_queue" and "sq" not in ent:
            ent["sq"] = ev
        elif name == "codec_decode":
            ent["decode"] = ev
        elif name == "apply":
            ent.setdefault("applies", []).append(ev)
        elif name == "respond":
            # Batched frames respond once per sub-op; keep the first.
            if "respond" not in ent:
                ent["respond"] = ev
    return out


def breakdown(trace) -> Optional[dict]:
    """Per-stage attribution of one assembled trace; None without a
    worker root span."""
    root = trace.root
    if root is None:
        return None
    wpid = root.get("pid")
    t0 = root.get("ts", 0.0)
    wall = root.get("dur", 0.0)
    t1 = t0 + wall
    args = root.get("args") or {}
    # Worker-side send checkpoint: the earliest lane/combiner wait
    # inside the window (a fan-out's first slice — the critical chain
    # below is server-side; send-side skew is sub-stage noise).
    lane = None
    wrecv = None
    for ev in trace.spans:
        if ev.get("pid") != wpid:
            continue
        ts = ev.get("ts", 0.0)
        if ts < t0 - 1.0 or ts > t1 + 1.0:
            continue
        name = ev.get("name")
        if name in ("lane_wait", "combine_wait"):
            if lane is None or ts < lane["ts"]:
                lane = ev
        elif name == "recv" and not (ev.get("args") or {}).get("request",
                                                               True):
            # The LAST response frame's arrival bounds response_wire.
            if wrecv is None or ts > wrecv["ts"]:
                wrecv = ev
    servers = _server_events(trace.spans, wpid, t0, t1)
    critical = None
    for pid, ent in servers.items():
        marks = [
            _end(e) for e in (
                [ent.get("respond")]
                + (ent.get("applies") or [])
                + [ent.get("sq")]
            ) if e is not None
        ]
        if not marks:
            continue
        ent["last"] = max(marks)
        ent["pid"] = pid
        if critical is None or ent["last"] > critical["last"]:
            critical = ent
    # Checkpoints in pipeline order: (stage ending here, time).
    checkpoints: List[tuple] = []
    if lane is not None:
        checkpoints.append(("worker_queue", lane["ts"]))
        checkpoints.append(("lane_wait", _end(lane)))
    if critical is not None:
        sq = critical.get("sq")
        if sq is not None:
            checkpoints.append(("wire", sq["ts"]))
            checkpoints.append(("server_queue", _end(sq)))
        dec = critical.get("decode")
        if dec is not None:
            checkpoints.append(("decode", _end(dec)))
        applies = critical.get("applies") or []
        if applies:
            checkpoints.append(("apply_wait",
                                min(e["ts"] for e in applies)))
            checkpoints.append(("apply", max(_end(e) for e in applies)))
        resp = critical.get("respond")
        if resp is not None:
            checkpoints.append(("response_gate", resp["ts"]))
    if wrecv is not None:
        checkpoints.append(("response_wire", wrecv["ts"]))
    stages = {name: 0.0 for name in STAGES}
    prev = t0
    for name, c in checkpoints:
        c = min(max(c, prev), t1)  # clamp: monotone, inside the window
        stages[name] += c - prev
        prev = c
    stages["completion"] += t1 - prev  # remainder: sum == wall exactly
    return {
        "trace": trace.tid,
        "wall_us": wall,
        "t0_us": t0,
        "worker": wpid,
        "server": critical["pid"] if critical is not None else None,
        "keep": args.get("keep"),
        "outcome": args.get("outcome"),
        "pull": args.get("pull"),
        "stages": stages,
        "flight": list(getattr(trace, "flight", ())),
    }


def _stage_shares(rows: List[dict]) -> dict:
    totals = {name: 0.0 for name in STAGES}
    for b in rows:
        for name, v in b["stages"].items():
            totals[name] += v
    wall = sum(totals.values())
    return {
        name: {"total_us": round(totals[name], 1),
               "share": round(totals[name] / wall, 4) if wall > 0 else 0.0}
        for name in STAGES
    }


def aggregate(breakdowns: List[dict], slow_frac: float = 0.25) -> dict:
    """"Where does the tail live": per-stage totals and shares across
    all assembled traces, plus the same table restricted to the
    SLOWEST ``slow_frac`` of them (the population a p99 panel shows).
    ``top_stage`` names the slow set's dominant stage — the pstrace
    headline."""
    if not breakdowns:
        return {"count": 0, "stages": {}, "slow": {}, "top_stage": None,
                "wall_p50_us": 0.0, "wall_max_us": 0.0}
    by_wall = sorted(breakdowns, key=lambda b: b["wall_us"])
    n = len(by_wall)
    slow = by_wall[max(0, n - max(1, round(n * slow_frac))):]
    stages = _stage_shares(breakdowns)
    slow_stages = _stage_shares(slow)
    top = max(slow_stages, key=lambda s: slow_stages[s]["total_us"])
    return {
        "count": n,
        "wall_p50_us": round(by_wall[n // 2]["wall_us"], 1),
        "wall_max_us": round(by_wall[-1]["wall_us"], 1),
        "stages": stages,
        "slow": slow_stages,
        "slow_count": len(slow),
        "top_stage": top,
    }
