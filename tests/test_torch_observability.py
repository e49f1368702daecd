"""The port's observability on running clusters, against the JAX package.

The same seeded numpy pushes and pulls run on clusters of either
package (loopback, in this process) and on mixed tcp clusters whose
nodes come from both packages.  Compared, with no tolerance (but for
one line: a live trace's stages sum to its wall within 1 us, the
resolution of a float64 wall-clock microsecond stamp):

- the scheduler's ``collect_cluster_metrics`` returns every node, with
  the same metric names per role as an all-JAX cluster and equal counts
  of work (``kv.server_push_requests``, ``kv.pushes``, ``kv.pulls``,
  ``wire.tx.ops``, ``wire.rx.frames``);
- ``collect_cluster_traces`` assembles one trace across a mixed
  cluster, and traced frames are byte-equal to JAX's (after
  ``tests/test_tracing.py``'s frame parity and batch-table cases);
- ``ENABLE_PROFILING`` writes the same ``key,event`` sequence per role
  (timestamps differ), and the engines' ``record_engine`` events carry
  the same bucket, op and bytes on a CPU group of 8 ranks;
- the scheduler's history, health, ``retune`` and the autopilot (plan
  mode) run on a port cluster, and an elastic join cuts at the key
  ``with_join`` computes from the scheduler's load hint.

Every cluster start, wait and poll has a deadline.
"""

import time

import numpy as np
import pytest

import pslite_tpu as jps
import pslite_tpu_torch as tps
from pslite_tpu import wire as jwire
from pslite_tpu.message import BatchInfo as JBatchInfo
from pslite_tpu.message import BatchOp as JBatchOp
from pslite_tpu.message import Meta as JMeta
from pslite_tpu_torch import wire as twire
from pslite_tpu_torch.message import BatchInfo as TBatchInfo
from pslite_tpu_torch.message import BatchOp as TBatchOp
from pslite_tpu_torch.message import Meta as TMeta

from test_torch_elastic_membership import (
    ELASTIC_ENV,
    Elastic,
    MixedTcp,
    _spread_keys,
    _wait_epoch,
    _wait_for,
)
from test_torch_msg_plane import (  # noqa: F401 - the fixture runs by name
    JAX,
    PORT,
    _port_loopback_isolation,
)

DEADLINE = 30.0
VAL_LEN = 8
WORK_COUNTERS = ("kv.server_push_requests", "kv.server_pull_requests",
                 "kv.pushes", "kv.pulls", "wire.tx.ops", "wire.rx.frames")


def _api_of(po):
    return JAX if isinstance(po, jps.Postoffice) else PORT


def _serve(po):
    api = _api_of(po)
    srv = api.KVServer(0, postoffice=po)
    srv.set_request_handle(api.DefaultHandle())
    return srv


def _storm(workers, rounds=6, seed=3):
    """Seeded pushes and pulls of a few keys per server range."""
    rng = np.random.default_rng(seed)
    keys = _spread_keys(8)
    for r in range(rounds):
        for w in workers:
            vals = rng.standard_normal(len(keys) * VAL_LEN).astype(
                np.float32)
            w.wait(w.push(keys, vals))
            out = np.zeros(len(keys) * VAL_LEN, np.float32)
            w.wait(w.pull(keys, out))


def _summary(snaps):
    """Per role: the metric names of each kind; and the summed work
    counters."""
    names, work = {}, {}
    for nid, snap in snaps.items():
        assert "error" not in snap, snap
        role = snap["role"]
        m = snap["metrics"]
        ent = names.setdefault(role, {k: set() for k in
                                      ("counters", "gauges", "histograms",
                                       "topk")})
        for kind in ent:
            ent[kind] |= set(m.get(kind, {}))
        for c in WORK_COUNTERS:
            if c in m["counters"]:
                key = (role, c)
                work[key] = work.get(key, 0) + m["counters"][c]
    return names, work


def _pull_scenario(api, cluster):
    servers = [_serve(po) for po in cluster.servers]
    workers = [api.KVWorker(0, 0, postoffice=po) for po in cluster.workers]
    try:
        _storm(workers)
        snaps = cluster.scheduler.collect_cluster_metrics(timeout_s=DEADLINE)
        assert len(snaps) == len(cluster.all_nodes())
        return _summary(snaps)
    finally:
        for a in workers + servers:
            a.stop()


def test_metrics_pull_names_and_work_match_jax():
    from test_torch_msg_plane import run_both

    (jn, jw), (tn, tw) = run_both(_pull_scenario, num_workers=2,
                                  num_servers=2)
    assert tn == jn
    assert tw == jw
    assert jw[("server", "kv.server_push_requests")] == 2 * 6 * 2


# -- mixed tcp clusters --------------------------------------------------------


MIXES = {
    "jax-scheduler": ("jax", ["port", "jax"], ["port", "jax"]),
    "port-scheduler": ("port", ["jax", "port"], ["jax", "port"]),
}
TCP_ENV = {"PS_NATIVE": "0"}  # one plane: the wire.* names must agree


def _mixed_run(scheduler, servers, workers, env=None):
    cluster = MixedTcp(scheduler, servers, workers,
                       env_extra=dict(TCP_ENV, **(env or {})))
    cluster.start()
    apps = []
    try:
        apps = [_serve(po) for po in cluster.servers]
        ws = [_api_of(po).KVWorker(0, 0, postoffice=po)
              for po in cluster.workers]
        apps += ws
        _storm(ws)
        snaps = cluster.scheduler.collect_cluster_metrics(
            timeout_s=DEADLINE)
        assert sorted(snaps) == sorted(po.van.my_node.id
                                       for po in cluster.all_nodes())
        return _summary(snaps)
    finally:
        for a in apps:
            a.stop()
        for po in cluster.all_nodes():
            po.van.stop()


@pytest.fixture(scope="module")
def alljax_pull():
    return _mixed_run("jax", ["jax", "jax"], ["jax", "jax"])


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_mixed_cluster_metrics_pull_reaches_every_node(mix, alljax_pull):
    names, work = _mixed_run(*MIXES[mix])
    want_names, want_work = alljax_pull
    assert names == want_names
    assert work == want_work


TRACE_MIXES = {
    "port-worker-jax-server": ("port", ["jax"], ["port"]),
    "jax-worker-port-server": ("jax", ["port"], ["jax"]),
}


@pytest.mark.parametrize("mix", sorted(TRACE_MIXES))
def test_trace_pull_assembles_one_trace_across_packages(mix):
    scheduler, servers, workers = TRACE_MIXES[mix]
    cluster = MixedTcp(scheduler, servers, workers,
                       env_extra=dict(TCP_ENV, PS_TRACE_TAIL="floor:1.0"))
    cluster.start()
    apps = []
    try:
        apps = [_serve(po) for po in cluster.servers]
        w = _api_of(cluster.workers[0]).KVWorker(
            0, 0, postoffice=cluster.workers[0])
        apps.append(w)
        keys = np.array([5, 9], dtype=np.uint64)
        w.wait(w.push(keys, np.ones(2 * VAL_LEN, np.float32)))
        coll = cluster.scheduler.collect_cluster_traces(timeout_s=DEADLINE)
        asm = coll.assembled()
        assert len(asm) == 1
        tr = asm[0]
        sid = cluster.servers[0].van.my_node.id
        wid = cluster.workers[0].van.my_node.id
        assert {wid, sid} <= set(tr.roles)
        names = {e["name"] for e in tr.spans if e["pid"] == sid}
        assert {"server_queue", "apply"} <= names
        b = tr.breakdown()
        assert b["server"] == sid and b["keep"] == "floor"
        # Stamps are wall-clock microseconds near 1.8e15, where a float64
        # resolves 0.25 us: the telescoped sum holds within 1 us.
        assert sum(b["stages"].values()) == pytest.approx(b["wall_us"],
                                                          abs=1.0)
    finally:
        for a in apps:
            a.stop()
        for po in cluster.all_nodes():
            po.van.stop()


# -- traced frames -------------------------------------------------------------


def _frames_for(pkg, traces):
    """One combiner pickup of ten pushes (``tests/test_tracing.py``'s
    frame parity case), through ``pkg``'s OpCombiner."""
    import time as _t

    if pkg == "jax":
        from pslite_tpu.kv.batching import OpCombiner
        from pslite_tpu.message import Message
        from pslite_tpu.sarray import SArray
    else:
        from pslite_tpu_torch.kv.batching import OpCombiner
        from pslite_tpu_torch.message import Message
        from pslite_tpu_torch.sarray import SArray

    def mk(ts, trace):
        m = Message()
        mm = m.meta
        mm.app_id = 1
        mm.request = True
        mm.push = True
        mm.head = 0
        mm.timestamp = ts
        mm.recver = 8
        mm.trace = trace
        m.add_data(SArray(np.array([ts], np.uint64)))
        m.add_data(SArray(np.ones(4, np.float32)))
        return m

    sent = []
    c = OpCombiner(sent.append, lambda msgs, exc: None, max_bytes=1 << 20)
    key = None
    with c._cv:
        for i in range(10):
            key, _grp, _ = c._enqueue_locked(mk(i, traces[i]),
                                             _t.monotonic())
        taken = c._take_locked(key)
    c._stop = True
    c._flush(taken)
    return sent


@pytest.mark.parametrize("traced", [False, True])
def test_combined_frames_byte_equal_to_jax(traced):
    traces = [0x100 + i if traced else 0 for i in range(10)]
    jf = _frames_for("jax", traces)
    tf = _frames_for("port", traces)
    assert len(jf) == len(tf) == 1
    assert [op.trace for op in tf[0].meta.batch.ops] == traces
    assert twire.pack_meta(tf[0].meta) == jwire.pack_meta(jf[0].meta)


def test_traced_meta_and_batch_table_byte_equal_to_jax():
    """A traced request meta, and a batch table with one traced op, pack
    to JAX's bytes; ``trace=0`` adds nothing."""
    def metas(Meta, BatchInfo, BatchOp):
        one = Meta(app_id=1, request=True, push=True, timestamp=3,
                   sender=9, recver=8, key=77, trace=0xABCDEF0123)
        tab = Meta(app_id=1, request=True, push=True, timestamp=3,
                   sender=9, recver=8)
        tab.batch = BatchInfo(ops=(
            BatchOp(push=True, timestamp=1, key=10, val_len=16, nseg=2,
                    trace=0xABCDEF0123),
            BatchOp(pull=True, timestamp=2, key=20, val_len=16, nseg=2)))
        plain = Meta(app_id=1, request=True, push=True, timestamp=3,
                     sender=9, recver=8, key=77)
        return one, tab, plain

    j = [jwire.pack_meta(m) for m in metas(JMeta, JBatchInfo, JBatchOp)]
    t = [twire.pack_meta(m) for m in metas(TMeta, TBatchInfo, TBatchOp)]
    assert t == j
    assert t[0] != t[2]
    assert twire.unpack_meta(t[0]).trace == 0xABCDEF0123
    back = twire.unpack_meta(j[1])
    assert back.batch.ops[0].trace == 0xABCDEF0123


# -- the event profiler ----------------------------------------------------------


def _profile_scenario(tmp_path):
    def scenario(api, cluster):
        servers = [_serve(po) for po in cluster.servers]
        w = api.KVWorker(0, 0, postoffice=cluster.workers[0])
        try:
            keys = np.array([3, 11], dtype=np.uint64)
            for i in range(3):
                w.wait(w.push(keys, np.full(2 * VAL_LEN, i, np.float32)))
                out = np.zeros(2 * VAL_LEN, np.float32)
                w.wait(w.pull(keys, out))
            w.wait(w.push_pull(keys, np.ones(2 * VAL_LEN, np.float32),
                               np.zeros(2 * VAL_LEN, np.float32)))
        finally:
            w.stop()
            for s in servers:
                s.stop()
        return None
    return scenario


def test_profiler_writes_the_same_event_sequence_per_role(tmp_path):
    logs = {}
    for api in (JAX, PORT):
        per_node = {
            role: {"ENABLE_PROFILING": "1",
                   "PROFILE_PATH": str(tmp_path / f"{api.name}_{role}")}
            for role in ("scheduler", "server0", "worker0")}
        cluster = api.cluster(num_workers=1, num_servers=1,
                              per_node_env=per_node)
        cluster.start()
        try:
            _profile_scenario(tmp_path)(api, cluster)
        finally:
            cluster.finalize()
        for role in ("server0", "worker0"):
            rows = (tmp_path / f"{api.name}_{role}").read_text().split()
            logs[(api.name, role)] = [",".join(r.split(",")[:2])
                                      for r in rows]
    for role in ("server0", "worker0"):
        assert logs[("port", role)] == logs[("jax", role)], role
    assert logs[("port", "worker0")][:2] == ["3,send_push", "3,recv_push"]
    assert "3,recv_pull" in logs[("port", "worker0")]


def test_engine_events_match_on_a_cpu_group_of_8(tmp_path):
    from pslite_tpu.environment import Environment as JEnv
    from pslite_tpu.parallel.engine import CollectiveEngine as JaxEngine
    from pslite_tpu.parallel.mesh import default_mesh
    from pslite_tpu.utils.profiling import Profiler as JProfiler
    from pslite_tpu_torch.environment import Environment as TEnv
    from pslite_tpu_torch.parallel.sparse import SparseEngine
    from pslite_tpu_torch.utils.profiling import Profiler as TProfiler

    def run(name, make_engine, env_cls, prof_cls, sparse=None):
        path = tmp_path / name
        prof = prof_cls(env_cls({"ENABLE_PROFILING": "1",
                                 "PROFILE_PATH": str(path)}), "worker")
        eng = make_engine(prof)
        keys = np.arange(6, dtype=np.uint64)
        eng.register_dense("grads", keys, 16)
        eng.register_dense("emb", np.arange(6, 9, dtype=np.uint64), 4)
        g = np.random.default_rng(1).standard_normal(
            (8, 96)).astype(np.float32)
        for _ in range(3):
            eng.push_pull("grads", g)
        eng.push("grads", g)
        eng.pull("grads")
        eng.push_pull_group(["grads", "emb"],
                            [g, np.ones((8, 12), np.float32)])
        eng.replay("grads", np.stack([g, g]), keep="last")
        if sparse is not None:
            sp = sparse(eng, prof)
            sp.register_sparse("rows", 64, 4)
            idx = np.tile(np.arange(5), (8, 1))
            sp.push("rows", idx, np.ones((8, 5, 4), np.float32))
            sp.pull("rows", idx)
        prof.close()
        return [ln.split(",") for ln in path.read_text().split()]

    j = run("jax", lambda p: JaxEngine(default_mesh(), impl="xla",
                                       profiler=p), JEnv, JProfiler)
    t = run("port", lambda p: tps.CollectiveEngine(
        tps.DeviceGroup(8, device="cpu"), impl="xla", profiler=p),
        TEnv, TProfiler,
        sparse=lambda eng, p: SparseEngine(eng.group, eng.axis,
                                           profiler=p))
    assert [(r[0], r[1], r[3]) for r in t[:len(j)]] == \
        [(r[0], r[1], r[3]) for r in j]
    assert [(r[0], r[1], r[3]) for r in t[len(j):]] == [
        ("rows", "sparse_push_engine", str(8 * 5 * 4 * 4)),
        ("rows", "sparse_pull_engine", str(8 * 5 * 4 * 4))]
    for r in t:
        assert int(r[2]) > 0 and int(r[4]) >= 0


# -- history, health, retune, the autopilot, the join's load hint ---------------


def test_port_history_health_retune_and_autopilot():
    cluster = PORT.cluster(num_workers=1, num_servers=2, env_extra={
        "PS_METRICS_INTERVAL": "0.1", "PS_AUTOPILOT": "plan",
        "PS_REPLICA_READ_POLICY": "load"})
    cluster.start()
    servers = [_serve(po) for po in cluster.servers]
    w = tps.KVWorker(0, 0, postoffice=cluster.workers[0])
    sched = cluster.scheduler
    try:
        hist = sched.history
        assert hist is not None and hist.running
        assert hist.autopilot is not None and hist.autopilot.mode == "plan"
        w.attach_history(hist)
        _storm([w], rounds=4)
        _wait_for(lambda: hist.samples >= 3, "three history samples")
        sid = cluster.servers[0].van.my_node.id
        _wait_for(lambda: hist.rate(sid, "kv.server_push_requests")
                  is not None, "a windowed server rate")
        assert isinstance(sched.health(min_severity="info"), list)
        rep = sched.retune_apply(64 << 10, timeout_s=DEADLINE)
        assert rep == {"task_bytes": 64 << 10, "servers": 2,
                       "applied": sum(s._apply_pool is not None
                                      for s in servers)}
        assert all(s._apply_pool._task_bytes == 64 << 10
                   for s in servers if s._apply_pool is not None)
        assert sched.flight.events("apply_retune")
        assert sched.metrics_last_seen()
    finally:
        w.stop()
        for s in servers:
            s.stop()
        cluster.finalize()
    assert not sched.history.running


def test_elastic_join_cuts_at_the_hint():
    el = Elastic(PORT, num_workers=1, num_servers=2, env_extra=ELASTIC_ENV)
    try:
        w = el.workers[0]
        rng = np.random.default_rng(4)
        span = 1 << 62
        hot = (rng.zipf(1.4, 400) * 104729) % span  # all in rank 0's range
        for chunk in np.array_split(np.unique(hot).astype(np.uint64), 8):
            w.wait(w.push(chunk, np.ones(len(chunk) * VAL_LEN, np.float32)))
        for _ in range(3):
            keys = np.unique(hot[:64]).astype(np.uint64)
            w.wait(w.push(keys, np.ones(len(keys) * VAL_LEN, np.float32)))
        sched = el.cluster.scheduler
        snaps = sched.collect_cluster_metrics(timeout_s=DEADLINE)
        assert len(snaps) == 4
        hint = sched.hot_key_hint()
        assert hint
        want = sched.routing_table().with_join(2, hot=hint)
        el.join()
        got = _wait_epoch(sched, want.epoch)
        assert got.to_json() == want.to_json()
        new = [e for e in got.entries if e.owner == 2]
        assert new and new[0].begin in hint
    finally:
        el.close()
