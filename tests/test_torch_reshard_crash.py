"""KVWorker.reshard and the crash atomicity of a recut, on the port.

The in-process cases of tests/test_reshard_crash.py, with the staging
fault injected through the port's placement function
(``pslite_tpu_torch.parallel.placement.place``, looked up at call time,
as the JAX tests patch ``placement.place_host_array``) and barrier deaths
through a patched ``Postoffice.barrier``; then two port worker processes
over ``tcp`` (``ici_tcp``, each with its own engine on a CPU group, child
``tests/torch_reshard_child.py``): a peer that dies before the entry
barrier, and a peer whose staging fails.  Each process case sets a small
``PS_RESHARD_TMO_S`` and its own deadline.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from pslite_tpu.parallel.engine import CollectiveEngine as JaxEngine
from pslite_tpu.parallel.sparse import SparseEngine as JaxSparse
from pslite_tpu_torch import (CollectiveEngine, DeviceGroup, KVServer,
                              KVServerDefaultHandle, KVWorker, SparseEngine)
from pslite_tpu_torch.parallel import placement
from pslite_tpu_torch.utils.logging import CheckError
from pslite_tpu_torch.utils.network import get_available_port

from test_torch_msg_plane import PortCluster
from test_torch_msg_plane import _port_loopback_isolation  # noqa: F401

_HERE = os.path.dirname(os.path.abspath(__file__))
CHILD = os.path.join(_HERE, "torch_reshard_child.py")


def _group(n):
    return DeviceGroup(n, device="cpu")


def _failing_placement(monkeypatch, fail_on_call: int):
    """Make placement.place raise on its N-th call."""
    real = placement.place
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == fail_on_call:
            raise RuntimeError("injected recut failure (dead peer)")
        return real(*a, **kw)

    monkeypatch.setattr(placement, "place", flaky)
    return calls


def test_engine_recut_failure_is_atomic(monkeypatch):
    """A failure midway through the recut (bucket a's v, the third
    placement) leaves every bucket on the old group; a clean retry then
    succeeds."""
    g8 = _group(8)
    eng = CollectiveEngine(g8, server_handle="adam:0.01")
    keys = np.arange(2, dtype=np.uint64)
    for name in ("a", "b"):
        eng.register_dense(name, keys, 64)
        eng.push_pull(name, np.ones((8, 128), np.float32))
    before = {n: eng.pull(n) for n in ("a", "b")}
    state = {n: eng.opt_state(n)[1] for n in ("a", "b")}
    calls = _failing_placement(monkeypatch, fail_on_call=3)
    with pytest.raises(RuntimeError, match="injected"):
        eng.reshard(_group(4))
    assert calls["n"] == 3
    assert eng.group is g8 and eng.num_shards == 8
    for n in ("a", "b"):
        assert eng.bucket(n).padded_len == 128
        assert torch.equal(eng.pull(n), before[n])
        for x, y in zip(eng.opt_state(n)[1], state[n]):
            assert torch.equal(x, y)
        eng.push_pull(n, np.ones((8, 128), np.float32))  # state still live
    monkeypatch.undo()
    eng.reshard(_group(4))
    assert eng.num_shards == 4


def test_sparse_recut_failure_is_atomic(monkeypatch):
    se = SparseEngine(_group(8))
    se.register_sparse("t1", 64, 4)
    se.register_sparse("t2", 32, 4)
    idx = np.tile(np.arange(8, dtype=np.int32)[:, None], (1, 2))
    g = np.ones((8, 2, 4), np.float32)
    se.push("t1", idx, g, handle="row_adagrad:0.1,1e-8")
    se.push("t2", idx, g)
    before1, acc1 = se.pull("t1", idx), se.acc_array("t1")
    calls = _failing_placement(monkeypatch, fail_on_call=2)
    with pytest.raises(RuntimeError, match="injected"):
        se.reshard(_group(4))
    assert calls["n"] == 2
    assert se.num_shards == 8
    assert torch.equal(se.pull("t1", idx), before1)
    assert torch.equal(se.acc_array("t1"), acc1)
    monkeypatch.undo()
    se.reshard(_group(4))
    assert se.num_shards == 4
    assert torch.equal(se.pull("t1", idx[:4]), before1[:4])


def _ici_cluster():
    c = PortCluster(num_workers=1, num_servers=1, van_type="ici")
    c.start()
    srv = KVServer(0, postoffice=c.servers[0])
    srv.set_request_handle(KVServerDefaultHandle())
    worker = KVWorker(0, 0, postoffice=c.workers[0])
    return c, [srv, worker], worker


def _stop(c, apps):
    for a in apps:
        a.stop()
    c.finalize()


def _barrier_death(dying_call: int, expect_match: str,
                   expect_new_group: bool):
    """KVWorker.reshard with the N-th barrier raising a timeout (1 =
    entry, 2 = commit, 3 = resume)."""
    c, apps, worker = _ici_cluster()
    try:
        eng = worker.engine
        keys = np.arange(2, dtype=np.uint64)
        worker.register_dense("g", keys, 16)
        outs = np.zeros(32, np.float32)
        worker.wait(worker.push_pull(keys, np.ones(32, np.float32), outs))
        po = c.workers[0]
        real_barrier = po.barrier
        state = {"n": 0}

        def dying_barrier(*a, **kw):
            state["n"] += 1
            if state["n"] == dying_call:
                raise CheckError("barrier timed out (injected death)")
            return real_barrier(*a, **kw)

        po.barrier = dying_barrier
        with pytest.raises(CheckError, match=expect_match):
            worker.reshard(_group(4))
        po.barrier = real_barrier
        assert eng.num_shards == (4 if expect_new_group else 8)
        assert worker.sparse_engine.num_shards == eng.num_shards
        out2 = np.zeros(32, np.float32)
        worker.wait(worker.pull(keys, out2))
        np.testing.assert_array_equal(out2, outs)
    finally:
        _stop(c, apps)


def test_entry_barrier_death_leaves_engines_untouched():
    _barrier_death(1, "injected death", expect_new_group=False)


def test_commit_barrier_death_aborts_together_on_old_group():
    """A peer that failed staging never joins the commit barrier: this
    worker's commit-barrier timeout drops its staged state."""
    _barrier_death(2, "aborted together", expect_new_group=False)


def test_resume_barrier_death_reports_degraded_committed_state():
    """A peer dying between the commit and the resume barrier: the recut
    here has committed, and the op reports the cluster degraded."""
    _barrier_death(3, "degraded", expect_new_group=True)


def test_pair_atomicity_dense_and_sparse(monkeypatch):
    """A failure in the sparse staging of a coordinated recut leaves the
    dense engine untouched too: both stage before either commits."""
    c, apps, worker = _ici_cluster()
    try:
        eng, se = worker.engine, worker.sparse_engine
        keys = np.arange(2, dtype=np.uint64)
        worker.register_dense("g", keys, 16)
        outs = np.zeros(32, np.float32)
        worker.wait(worker.push_pull(keys, np.ones(32, np.float32), outs))
        se.register_sparse("emb", 16, 4)
        # Dense staging places one store; the next placement is the
        # table's.
        calls = _failing_placement(monkeypatch, fail_on_call=2)
        with pytest.raises(RuntimeError, match="injected"):
            worker.reshard(_group(4))
        assert calls["n"] == 2
        assert eng.num_shards == 8, "dense engine committed alone"
        assert se.num_shards == 8, "sparse engine committed alone"
        out2 = np.zeros(32, np.float32)
        worker.wait(worker.pull(keys, out2))
        np.testing.assert_array_equal(out2, outs)
        monkeypatch.undo()
        worker.reshard(_group(4))
        assert eng.num_shards == 4 and se.num_shards == 4
    finally:
        _stop(c, apps)


def test_kvworker_reshard_matches_jax_engines():
    """KVWorker.reshard on an ici cluster: registered names stay valid,
    the dense bucket and the table equal JAX engines doing the same
    recut, and grads take the new worker count."""
    c, apps, worker = _ici_cluster()
    try:
        rng = np.random.default_rng(31)
        jeng = JaxEngine(Mesh(np.array(jax.devices()[:8]), ("kv",)))
        jse = JaxSparse(jeng.mesh)
        keys = np.arange(3, dtype=np.uint64)
        worker.register_dense("d", keys, 33)
        jeng.register_dense("d", keys, 33)
        for se in (worker.sparse_engine, jse):
            se.register_sparse("emb", 21, 8)
        g8 = rng.normal(size=(8, 99)).astype(np.float32)
        idx = rng.integers(0, 21, size=(8, 5)).astype(np.int32)
        rows = rng.normal(size=(8, 5, 8)).astype(np.float32)
        outs = np.zeros(99, np.float32)
        worker.wait(worker.push_pull(keys, g8, outs))
        worker.wait(worker.push_sparse("emb", idx, rows))
        jeng.push_pull("d", g8)
        jse.push("emb", idx, rows)
        worker.reshard(_group(4))
        jmesh4 = Mesh(np.array(jax.devices()[:4]), ("kv",))
        jeng.reshard(jmesh4)
        jse.reshard(jmesh4)
        assert worker.engine.num_workers == 4
        g4 = g8[:4] * 0.5
        worker.wait(worker.push_pull(keys, g4, outs))
        np.testing.assert_array_equal(outs, np.asarray(jeng.push_pull("d",
                                                                      g4)))
        pulled = np.zeros((4, 5, 8), np.float32)
        worker.wait(worker.pull_sparse("emb", idx[:4], out=pulled))
        np.testing.assert_array_equal(pulled,
                                      np.asarray(jse.pull("emb", idx[:4])))
        with pytest.raises(CheckError, match="not in the device group"):
            worker.reshard(DeviceGroup(4, device="cpu", axis_name="x"))
    finally:
        _stop(c, apps)


# -- two worker processes over tcp ----------------------------------------------

def _live_cluster(tmp_path, mode: str, deadline: float = 60.0):
    """Scheduler + server in one process, two workers in two more
    (``ici_tcp``): worker 0 survives, worker 1 runs ``mode``.  Returns
    (worker 0's output, worker 1's output, worker 1's exit code)."""
    base = dict(os.environ, DMLC_NUM_WORKER="2", DMLC_NUM_SERVER="1",
                DMLC_PS_ROOT_URI="127.0.0.1",
                DMLC_PS_ROOT_PORT=str(get_available_port()),
                DMLC_NODE_HOST="127.0.0.1", PS_VAN_TYPE="ici_tcp",
                PS_RESHARD_TMO_S="3", PSTEST_DEADLINE=str(deadline))
    roles = [("scheduler,server", "survive"), ("worker", "survive"),
             ("worker", mode)]
    procs, logs = [], []
    try:
        for i, (r, m) in enumerate(roles):
            log = open(tmp_path / f"child{i}.log", "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, CHILD], stdout=log, stderr=subprocess.STDOUT,
                env=dict(base, PSTEST_ROLES=r, PSTEST_CRASH=m)))
        end = time.monotonic() + deadline
        for p in procs[1:]:
            try:
                p.wait(timeout=max(0.1, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    return outs[1], outs[2], procs[2].returncode


def test_peer_death_before_entry_barrier(tmp_path):
    """Worker 1 exits before calling reshard; worker 0 times out at the
    entry barrier and aborts with its engine untouched."""
    out0, out1, rc1 = _live_cluster(tmp_path, "exit_before")
    assert rc1 == 42, out1[-1500:]
    assert "CRASH_OK untouched=True CheckError" in out0, out0[-1500:]
    assert "timed out" in out0, out0[-1500:]


def test_peer_staging_failure_aborts_cluster_together(tmp_path):
    """Worker 1's staging fails and it goes silent; worker 0 times out
    at the commit barrier and aborts: both end on the old group."""
    out0, out1, rc1 = _live_cluster(tmp_path, "stage_fail")
    assert rc1 == 0, out1[-1500:]
    assert "CRASH_OK untouched=True RuntimeError" in out1, out1[-1500:]
    assert "CRASH_OK untouched=True CheckError" in out0, out0[-1500:]
    assert "aborted together" in out0, out0[-1500:]
    assert "CRASH_FAIL" not in out0 + out1
