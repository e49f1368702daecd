"""The port's operator tools (``pslite_tpu_torch/tools/psmon.py`` and
``pstrace.py``) against the repo's JAX-side ``tools/psmon.py`` and
``tools/pstrace.py``: one snapshot (and one trace collector) of a live
port cluster rendered by both gives the same text.  The CLI demos run on
the port's own loopback and tcp clusters and exit 0."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from pslite_tpu_torch.benchmark import _loopback_cluster, _teardown_cluster
from pslite_tpu_torch.kv.kv_app import (KVServer, KVServerDefaultHandle,
                                        KVWorker)
from pslite_tpu_torch.tools import psmon, pstrace

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "tools"))

import psmon as jpsmon  # noqa: E402
import pstrace as jpstrace  # noqa: E402


@pytest.fixture(scope="module")
def cluster():
    """A port 2w + 2s loopback cluster under tail tracing, after a
    push/pull storm: ``(scheduler, snapshot, history, collector)``."""
    nodes = _loopback_cluster(
        2, 2, "tools-parity",
        env_extra={"PS_TRACE_TAIL": "slow:p50,errors,floor:1.0"})
    sched = nodes[0]
    servers, workers = [], []
    try:
        for po in nodes[1:3]:
            srv = KVServer(0, postoffice=po)
            srv.set_request_handle(KVServerDefaultHandle())
            servers.append(srv)
        workers = [KVWorker(0, 0, postoffice=po) for po in nodes[3:]]
        history = sched.start_history(interval_s=0.05)
        keys = np.array([3, 2 ** 62, 2 ** 63 + 9], dtype=np.uint64)
        vals = np.ones(3 * 64, dtype=np.float32)
        out = np.zeros_like(vals)
        for i in range(16):
            for w in workers:
                w.wait(w.push(keys, vals))
            if i % 4 == 3:
                workers[0].wait(workers[0].pull(keys, out))
        snap = psmon.collect(sched, timeout_s=10)
        coll = pstrace.collect(sched, timeout_s=10)
        yield sched, snap, history, coll
    finally:
        _teardown_cluster(nodes, workers, servers)


def test_psmon_renders_jax_text(cluster):
    sched, snap, _, _ = cluster
    assert len(snap) == 5
    stale = {99: 12.5}
    assert psmon.format_table(snap) == jpsmon.format_table(snap)
    assert psmon.format_table(snap, stale=stale) == \
        jpsmon.format_table(snap, stale=stale)
    assert psmon.to_json(snap) == jpsmon.to_json(snap)
    assert psmon.to_prometheus(snap) == jpsmon.to_prometheus(snap)
    assert psmon.format_wire(snap) == jpsmon.format_wire(snap)
    assert psmon.stale_ages(sched, snap) == {}
    for m in snap.values():
        assert psmon._req_quantiles(m) == jpsmon._req_quantiles(m)
    assert json.loads(psmon.to_json(snap))


def test_psmon_watch_frame_renders_jax_text(cluster):
    _, _, history, coll = cluster
    assert psmon.format_watch(history) == jpsmon.format_watch(history)
    assert psmon.format_watch(history, traces=coll) == \
        jpsmon.format_watch(history, traces=coll)


def test_pstrace_renders_jax_text(cluster, tmp_path):
    _, _, _, coll = cluster
    assert coll.breakdowns(), "no tail traces assembled"
    assert pstrace.STAGES == jpstrace.STAGES
    assert pstrace.format_top(coll) == jpstrace.format_top(coll)
    assert pstrace.format_slowest(coll, 3) == jpstrace.format_slowest(coll,
                                                                      3)
    tid = coll.breakdowns()[0]["trace"]
    assert pstrace.format_path(coll, tid) == jpstrace.format_path(coll, tid)
    ours = pstrace.export_chrome(coll, str(tmp_path / "port.json"))
    theirs = jpstrace.export_chrome(coll, str(tmp_path / "jax.json"))
    with open(ours) as a, open(theirs) as b:
        assert json.load(a) == json.load(b)


@pytest.mark.parametrize("tool, args", [
    ("psmon", ["--json"]), ("psmon", []), ("psmon", ["--wire"]),
    ("pstrace", ["--rounds", "12"])])
def test_cli_demo_exits_zero(tool, args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-m", f"pslite_tpu_torch.tools.{tool}", *args],
        cwd=_REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-1500:]
    if args == ["--json"]:
        assert len(json.loads(res.stdout)) == 5
    elif tool == "pstrace":
        assert "tail lives in:" in res.stdout
    else:
        assert res.stdout.strip()
