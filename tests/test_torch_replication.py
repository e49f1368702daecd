"""pslite_tpu_torch's chain replication against ``tests/test_replication.py``.

Mirrored on the port's in-process cluster (``PortCluster`` of
test_torch_msg_plane.py, loopback van): forwarding bit-exactness, the
worker's failover routing with deadlines, a recovered server restoring
its range from the replica, and the kill-a-server-mid-push-storm
acceptance (chaos crash hook + deadlines + replication) against a
fault-free run.  Beyond JAX's cases:

- the same forward schedule through JAX's and the port's clusters gives
  bit-equal stores on every server (``run_both``);
- small-op batching under replication forwards and dedups each sub-op;
- the origin dedup applies a failover retry once whether it lands before
  or after the primary's forward, and forgets a recovered worker's
  origins;
- whole clusters that mix the packages over tcp in one process
  (``tests/torch_durability_child.py``): a JAX primary with port
  replicas and the reverse, at ``PS_KV_REPLICATION=2`` and ``3``,
  through a server's death, failover and a recovered server (of the
  other package) restoring from its chain, bit-equal to the all-JAX run
  (tolerance: none; the pushes are small integers, so every order of
  addition gives the same bits);
- all-port clusters over ``shm``, ``multi`` and tcp's Python plane
  with the server mesh.

Every wait is bounded (deadlines, joins, polls with timeouts).
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import pslite_tpu_torch as tps
from pslite_tpu_torch.base import server_rank_to_id
from pslite_tpu_torch.environment import Environment
from pslite_tpu_torch.kv.kv_app import KVMeta
from pslite_tpu_torch.message import OPT_REPLICA
from pslite_tpu_torch.utils.network import get_available_port

from test_torch_msg_plane import (  # noqa: F401 - the fixture runs by name
    PortCluster,
    _port_loopback_isolation,
    assert_same,
    run_both,
    servers_with,
    stores,
)

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_HERE)
CHILD = os.path.join(_HERE, "torch_durability_child.py")

# Keys in server rank 0's range and rank 1's (the uniform split of the
# uint64 key space over 2 servers).
K0 = np.array([7, 42], dtype=np.uint64)
K1 = np.array([2**63 + 5, 2**63 + 77], dtype=np.uint64)

FT_ENV = {
    "PS_KV_REPLICATION": "2",
    "PS_HEARTBEAT_INTERVAL": "0.3",
    "PS_HEARTBEAT_TIMEOUT": "1.0",
    "PS_REQUEST_TIMEOUT": "0.5",
    "PS_REQUEST_RETRIES": "5",
}


def _spin_up(cluster):
    servers = servers_with(tps, cluster, tps.KVServerDefaultHandle)
    workers = [tps.KVWorker(0, 0, postoffice=po) for po in cluster.workers]
    return servers, workers


def _by_rank(servers, rank):
    return next(s for s in servers
                if s.po.van.my_node.id == server_rank_to_id(rank))


def _crash_teardown(cluster, servers, workers, dead_pos=()):
    for w in workers:
        w.stop()
    for s in servers:
        if s.po not in dead_pos:
            s.stop()
    # Every van, dead ones too (stop is idempotent): a crashed victim's
    # threads must not outlive the test.
    for po in cluster.all_nodes():
        po.van.stop()


def _teardown(cluster, servers, workers):
    for w in workers:
        w.stop()
    for s in servers:
        s.stop()
    cluster.finalize()


def _wait_for(pred, what, timeout=15.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"{what} not within {timeout}s")


def _converged(primary, replica, keys_by_holder):
    for ks, holder, copy in keys_by_holder:
        for k in ks:
            a = holder._handle.store.get(int(k))
            b = copy._handle.store.get(int(k))
            if a is None or b is None or not np.array_equal(a, b):
                return False
    return True


# -- mirrors of tests/test_replication.py -------------------------------------

def test_chain_forward_bit_exact():
    """Each accepted push chain-forwards to the next rank (the chain
    wraps); the forward stream keeps the primary's arrival order, so the
    replica's arrays are bit-exact with the primary's."""
    cluster = PortCluster(num_workers=1, num_servers=2,
                          env_extra={"PS_KV_REPLICATION": "2"})
    cluster.start()
    servers, workers = _spin_up(cluster)
    worker = workers[0]
    try:
        rng = np.random.default_rng(5)
        for _ in range(6):
            worker.wait(worker.push(
                K0, rng.standard_normal(2 * 16).astype(np.float32)))
            worker.wait(worker.push(
                K1, rng.standard_normal(2 * 16).astype(np.float32)))
        primary, replica = _by_rank(servers, 0), _by_rank(servers, 1)
        plan = ((K0, primary, replica), (K1, replica, primary))
        _wait_for(lambda: _converged(primary, replica, plan),
                  "replicas converged")
        for ks, holder, copy in plan:
            for k in ks:
                np.testing.assert_array_equal(copy._handle.store[int(k)],
                                              holder._handle.store[int(k)])
        assert primary._replicator.forwarded == 6
        assert replica._replicator.forwarded == 6
        # The lags JAX's gauges sample: nothing left in the forward
        # lanes, no stamp (stamping is off here) claimed and unapplied.
        assert primary._replicator.pending_forwards() == 0
        assert replica._replicator.stamp_lag() == 0
    finally:
        _teardown(cluster, servers, workers)


def test_failover_pull_and_push_after_kill():
    """After the detector declares rank 0 dead, the worker's deadline
    sweeper routes rank 0's range to its replica: pulls return the
    replicated values, pushes keep applying, nothing hangs."""
    cluster = PortCluster(num_workers=1, num_servers=2, env_extra=FT_ENV)
    cluster.start()
    servers, workers = _spin_up(cluster)
    worker = workers[0]
    victim_po = _by_rank(servers, 0).po
    vals = np.ones(2 * 16, dtype=np.float32)
    try:
        for _ in range(3):
            worker.wait(worker.push(K0, vals))
        replica = _by_rank(servers, 1)
        _wait_for(lambda: np.array_equal(
            replica._handle.store.get(42, np.zeros(16)), 3 * vals[16:]),
            "forwards drained")
        victim_po.van.stop()  # the crash
        _wait_for(lambda: server_rank_to_id(0) in worker._down_servers,
                  "death detected")
        out = np.zeros_like(vals)
        t0 = time.monotonic()
        worker.wait(worker.pull(K0, out))
        assert time.monotonic() - t0 < 5.0
        np.testing.assert_array_equal(out, 3 * vals)
        worker.wait(worker.push(K0, vals))
        out2 = np.zeros_like(vals)
        worker.wait(worker.pull(K0, out2))
        np.testing.assert_array_equal(out2, 4 * vals)
        assert worker.stats["failovers"] > 0
    finally:
        _crash_teardown(cluster, servers, workers, dead_pos=(victim_po,))


def test_recovered_server_restores_range_from_replica():
    """A recovered server fetches its range from its replica
    (``REPLICA_FETCH_CMD``) in ``set_request_handle``, before serving,
    and workers route back to it on recovery."""
    cluster = PortCluster(num_workers=1, num_servers=2, env_extra=FT_ENV)
    cluster.start()
    servers, workers = _spin_up(cluster)
    worker = workers[0]
    victim_po = _by_rank(servers, 0).po
    vals = np.arange(2 * 16, dtype=np.float32)
    repl_srv = None
    try:
        worker.wait(worker.push(K0, vals))
        replica = _by_rank(servers, 1)
        _wait_for(lambda: 42 in replica._handle.store, "forward landed")
        victim_po.van.stop()
        _wait_for(lambda: server_rank_to_id(0) in worker._down_servers,
                  "death detected")
        repl_po = tps.Postoffice("server", env=Environment(
            dict(cluster.base_env, **FT_ENV)))
        cluster.servers.append(repl_po)  # torn down with the rest
        repl_po.start(0)
        assert repl_po.is_recovery
        assert repl_po.van.my_node.id == server_rank_to_id(0)
        handle = tps.KVServerDefaultHandle()
        repl_srv = tps.KVServer(0, postoffice=repl_po)
        repl_srv.set_request_handle(handle)  # the restore runs here
        np.testing.assert_array_equal(handle.store[7], vals[:16])
        np.testing.assert_array_equal(handle.store[42], vals[16:])
        _wait_for(lambda: server_rank_to_id(0) not in worker._down_servers,
                  "recovery heard")
        out = np.zeros_like(vals)
        worker.wait(worker.pull(K0, out))
        np.testing.assert_array_equal(out, vals)
    finally:
        if repl_srv is not None:
            repl_srv.stop()
        _crash_teardown(cluster, servers, workers, dead_pos=(victim_po,))


def test_restored_server_dedups_what_the_replica_applied():
    """Dedup across a restart: a push the replica applied while the
    primary was dead (a failover) is in the restored primary's import,
    and the fetch carried its origin, so a retry of it (or a forward of
    it parked during the restore) applies once, not twice."""
    cluster = PortCluster(num_workers=1, num_servers=2, env_extra=FT_ENV)
    cluster.start()
    servers, workers = _spin_up(cluster)
    worker = workers[0]
    victim_po = _by_rank(servers, 0).po
    vals = np.ones(2 * 16, dtype=np.float32)
    repl_srv = None
    try:
        worker.wait(worker.push(K0, vals))
        victim_po.van.stop()
        _wait_for(lambda: server_rank_to_id(0) in worker._down_servers,
                  "death detected")
        ts = worker.push(K0, vals)  # applied by the replica (failover)
        worker.wait(ts)
        repl_po = tps.Postoffice("server", env=Environment(
            dict(cluster.base_env, **FT_ENV)))
        cluster.servers.append(repl_po)
        repl_po.start(0)
        handle = tps.KVServerDefaultHandle()
        repl_srv = tps.KVServer(0, postoffice=repl_po)
        repl_srv.set_request_handle(handle)
        np.testing.assert_array_equal(handle.store[7], 2 * vals[:16])
        retry = KVMeta(push=True, sender=cluster.workers[0].van.my_node.id,
                       customer_id=0, timestamp=ts, key=7)
        assert not repl_srv._replicator.should_apply(retry)
    finally:
        if repl_srv is not None:
            repl_srv.stop()
        _crash_teardown(cluster, servers, workers, dead_pos=(victim_po,))


def test_kill_server_mid_push_storm_acceptance():
    """A server crashes (chaos crash hook) mid push storm with
    ``PS_KV_REPLICATION=2`` and deadlines: every worker completes, no
    wait blocks past its retry budget, and the dead rank's range served
    by the replica is bit-exact with a fault-free run."""
    rounds, crash_after = 12, 8
    vals = np.ones(2 * 16, dtype=np.float32)  # exact float additions

    def run_storm(chaos: bool):
        per_node = ({"server0": {"PS_CHAOS": f"crash=recv:{crash_after}"}}
                    if chaos else {})
        cluster = PortCluster(
            num_workers=2, num_servers=2,
            van_type="chaos+loopback" if chaos else "loopback",
            env_extra=dict(FT_ENV, PS_RESEND="1", PS_RESEND_TIMEOUT="200"),
            per_node_env=per_node)
        cluster.start()
        servers, workers = _spin_up(cluster)
        victim_po = _by_rank(servers, 0).po
        max_wait = [0.0]
        errors = []

        def storm(w):
            try:
                for _ in range(rounds):
                    for keys in (K0, K1):
                        t0 = time.monotonic()
                        w.wait(w.push(keys, vals))
                        max_wait[0] = max(max_wait[0],
                                          time.monotonic() - t0)
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        threads = [threading.Thread(target=storm, args=(w,), daemon=True)
                   for w in workers]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        try:
            assert not any(t.is_alive() for t in threads), "storm hung"
            assert not errors, f"storm waits failed: {errors!r}"
            replica = _by_rank(servers, 1)
            _wait_for(lambda: np.array_equal(
                replica._handle.store.get(42, np.zeros(16)),
                2 * rounds * vals[16:]), "the replica holds every push")
            out = np.zeros_like(vals)
            workers[0].wait(workers[0].pull(K0, out))
            if chaos:
                assert victim_po.van.chaos_crashed.is_set(), \
                    "victim never crashed: scenario inert"
        finally:
            _crash_teardown(cluster, servers, workers,
                            dead_pos=(victim_po,) if chaos else ())
        return out, max_wait[0]

    faulty, faulty_max_wait = run_storm(chaos=True)
    clean, _ = run_storm(chaos=False)
    np.testing.assert_array_equal(faulty, clean)
    np.testing.assert_array_equal(clean, 2 * rounds * vals)
    assert faulty_max_wait < 60.0, f"wait took {faulty_max_wait:.1f}s"


# -- beyond JAX's cases -------------------------------------------------------

def test_send_failures_before_detection_keep_their_retries():
    """Pushes to a server that just died fail to send at once, before
    the detector declares it (a broken connection).  Under replication
    such a slice waits for its deadline instead of a retry at once, so
    its retries are not spent before the failover: with 2 retries the
    push still lands on the replica."""
    env = dict(FT_ENV, PS_REQUEST_RETRIES="2", DMLC_PS_ROOT_URI="127.0.0.1",
               DMLC_NODE_HOST="127.0.0.1",
               DMLC_PS_ROOT_PORT=str(get_available_port()))
    # Over tcp: the native lanes report the broken connection at once.
    cluster = PortCluster(num_workers=1, num_servers=2, van_type="tcp",
                          env_extra=env)
    cluster.start()
    servers, workers = _spin_up(cluster)
    worker = workers[0]
    victim_po = _by_rank(servers, 0).po
    vals = np.ones(2 * 16, dtype=np.float32)
    try:
        worker.wait(worker.push(K0, vals))
        victim_po.van.stop()
        t0 = time.monotonic()
        worker.wait(worker.push(K0, vals))  # sent before the detection
        assert time.monotonic() - t0 < 10.0
        out = np.zeros_like(vals)
        worker.wait(worker.pull(K0, out))
        np.testing.assert_array_equal(out, 2 * vals)
    finally:
        _crash_teardown(cluster, servers, workers, dead_pos=(victim_po,))


def test_push_is_acknowledged_after_its_forwards_are_written():
    """A replicated push's response leaves only once every forward's
    sent event is set (the van sets it when the bytes are written), so
    an acknowledged push never dies with its primary."""
    cluster = PortCluster(num_workers=1, num_servers=2,
                          env_extra={"PS_KV_REPLICATION": "2"})
    cluster.start()
    servers, workers = _spin_up(cluster)
    try:
        srv = _by_rank(servers, 0)
        sent = []
        srv._send_response = sent.append
        written = threading.Event()
        meta = KVMeta(push=True, sender=cluster.workers[0].van.my_node.id,
                      timestamp=99, key=7, forwards=[written])
        t = threading.Thread(target=srv.response, args=(meta,))
        t.start()
        time.sleep(0.2)
        assert not sent  # held while the forward is unwritten
        written.set()
        t.join(timeout=5)
        assert len(sent) == 1 and sent[0].meta.timestamp == 99
        # A real forward's event is set by the van once written.
        fwd = srv._replicator.forward(
            KVMeta(push=True, sender=meta.sender, timestamp=100, key=7),
            tps.KVPairs(keys=K0, vals=np.ones(32, np.float32)))
        assert len(fwd) == 1 and fwd[0].wait(5)
    finally:
        _teardown(cluster, servers, workers)


def test_forward_schedule_bit_equal_to_jax():
    """The same pushes (and a codec push, forwarded as its wire bytes)
    through a JAX and a port cluster under ``PS_KV_REPLICATION=2``:
    every server's store, replicas included, is bit-equal."""
    rng = np.random.default_rng(9)
    pushes = [rng.standard_normal(4 * 16).astype(np.float32)
              for _ in range(5)]
    keys = np.concatenate([K0, K1])

    def scenario(api, cluster):
        servers = servers_with(api, cluster, api.DefaultHandle)
        try:
            w = api.KVWorker(0, 0, postoffice=cluster.workers[0])
            for i, v in enumerate(pushes):
                w.wait(w.push(keys, v, codec="int8" if i == 2 else None))
            end = time.monotonic() + 15
            while time.monotonic() < end and not all(
                    len(s._handle.store) == 4 for s in servers):
                time.sleep(0.05)
            time.sleep(0.2)  # the last forwards apply
            out = np.zeros(4 * 16, np.float32)
            w.wait(w.pull(keys, out))
            w.stop()
            return out, sorted(stores(servers), key=lambda d: sorted(d))
        finally:
            for s in servers:
                s.stop()

    want, got = run_both(scenario, num_workers=1, num_servers=2,
                         env_extra={"PS_KV_REPLICATION": "2"})
    assert_same(got, want)
    a, b = got[1]
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_batching_under_replication_forwards_each_sub_op():
    """``PS_BATCH_BYTES`` under replication (refused before the port had
    replication): a concurrent small-op storm rides EXT_BATCH frames,
    each sub-op is forwarded on its own (the replica applies it once,
    in the primary's order) and acked in the batched response."""
    cluster = PortCluster(num_workers=1, num_servers=2, env_extra={
        "PS_KV_REPLICATION": "2", "PS_BATCH_BYTES": "65536",
        "PS_BATCH_NEGOTIATE": "0"})
    cluster.start()
    servers, workers = _spin_up(cluster)
    w = workers[0]
    try:
        rng = np.random.default_rng(3)
        n_ops = 64
        keys = [np.array([k], np.uint64)
                for k in rng.integers(0, 2**62, n_ops)]
        vals = [rng.integers(-4, 4, 8).astype(np.float32)
                for _ in range(n_ops)]
        tss = [w.push(k, v) for k, v in zip(keys, vals)]
        for ts in tss:
            w.wait(ts)
        comb = w.combiner
        assert comb.flushed_frames > 0 and comb.flushed_ops > 1  # batched
        primary, replica = _by_rank(servers, 0), _by_rank(servers, 1)
        want = {}
        for k, v in zip(keys, vals):
            want[int(k[0])] = want.get(int(k[0]), 0) + v
        _wait_for(lambda: all(
            np.array_equal(replica._handle.store.get(k, np.zeros(8)), v)
            for k, v in want.items()), "every sub-op forwarded")
        for k, v in want.items():
            np.testing.assert_array_equal(primary._handle.store[k], v)
        assert primary._replicator.forwarded == n_ops
    finally:
        _teardown(cluster, servers, workers)


def test_origin_dedup_applies_a_retry_once_in_either_order():
    """A worker's failover retry and the primary's forward of the same
    push share an origin (sender, customer, ts, key): whichever lands
    first applies, the other is a dedup hit.  A recovered worker's old
    origins are purged (its timestamps restart at 0)."""
    cluster = PortCluster(num_workers=1, num_servers=2,
                          env_extra={"PS_KV_REPLICATION": "2"})
    cluster.start()
    servers, workers = _spin_up(cluster)
    try:
        rep = _by_rank(servers, 1)._replicator
        primary = server_rank_to_id(0)
        worker_id = cluster.workers[0].van.my_node.id
        direct = KVMeta(push=True, sender=worker_id, timestamp=5, key=7)
        forward = KVMeta(push=True, sender=primary, addr=worker_id,
                         timestamp=5, key=7, option=OPT_REPLICA)
        for first, second in ((forward, direct), (direct, forward)):
            base = rep.deduped
            assert rep.should_apply(first)
            assert not rep.should_apply(second)
            assert rep.deduped == base + 1
            rep._on_node_event(worker_id, False)  # the worker recovered
            assert rep.should_apply(second)  # its new life's ts 5
            rep._on_node_event(worker_id, False)
    finally:
        _teardown(cluster, servers, workers)


def _run_child(tmp_path, pkgs, k, scenario, recover="port", van="tcp",
               with_report=False, **extra):
    env = dict(os.environ, **dict(FT_ENV, **extra))
    env.update(DMLC_NUM_WORKER="1", DMLC_NUM_SERVER=str(k),
               DMLC_PS_ROOT_URI="127.0.0.1",
               DMLC_PS_ROOT_PORT=str(get_available_port()),
               DMLC_NODE_HOST="127.0.0.1", PS_VAN_TYPE=van,
               PS_KV_REPLICATION=str(k), PSTEST_PKGS=",".join(pkgs),
               PSTEST_RECOVER_PKG=recover, PSTEST_SCENARIO=scenario,
               PSTEST_OUT=str(tmp_path))
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-X", "faulthandler", CHILD],
                          capture_output=True, timeout=150, env=env,
                          cwd=_REPO)
    out = proc.stdout.decode() + proc.stderr.decode()
    assert proc.returncode == 0, out[-6000:]
    report = json.loads(proc.stdout.decode().strip().splitlines()[-1])
    with np.load(os.path.join(tmp_path, "result.npz")) as z:
        results = {name: z[name] for name in z.files}
    return (results, report) if with_report else results


def assert_results_equal(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert got[name].tobytes() == want[name].tobytes(), name


@pytest.fixture(scope="module")
def alljax_failover(tmp_path_factory):
    """The failover schedule on all-JAX clusters, k = 2 and 3."""
    return {k: _run_child(tmp_path_factory.mktemp(f"alljax{k}"),
                          ["jax"] * (k + 2), k, "failover", recover="jax")
            for k in (2, 3)}


@pytest.mark.parametrize("k,pkgs,recover", [
    (2, ["jax", "jax", "port", "port"], "port"),
    (2, ["port", "port", "jax", "jax"], "jax"),
    (3, ["port", "jax", "port", "jax", "port"], "port"),
], ids=["k2-jax_primary-port_replica", "k2-port_primary-jax_replica",
        "k3-mixed_chain"])
def test_mixed_failover_and_restore_bit_equal_to_jax(tmp_path,
                                                     alljax_failover, k,
                                                     pkgs, recover):
    """Pushes over every range, forwards drained (each store read back),
    server rank 0 killed, its range pulled and pushed through the
    replica, then a server of the other package takes rank 0 back and
    restores from its chain: every read-back, pull and restored store is
    bit-equal to the all-JAX run's."""
    got = _run_child(tmp_path, pkgs, k, "failover", recover=recover)
    assert_results_equal(got, alljax_failover[k])
    assert any(name.startswith("restored_") for name in got)


@pytest.mark.parametrize("van,extra", [
    ("shm", {}),
    ("multi", {"DMLC_NUM_PORTS": "2"}),
    ("tcp", {"PS_NATIVE": "0"}),
], ids=["shm", "multi-2rails", "tcp-python"])
def test_port_cluster_server_mesh_on_every_van(tmp_path, alljax_failover,
                                               van, extra):
    """The same schedule on an all-port cluster over ``shm`` (segment
    names per port pair), ``multi`` (2 tcp rails) and tcp's Python
    plane: the servers' mesh carries the forwards and the restore
    fetch."""
    if van == "shm":
        extra = dict(extra, PS_SHM_NS=f"torchrepl{os.getpid()}")
    got = _run_child(tmp_path, ["port"] * 4, 2, "failover", van=van,
                     **extra)
    assert_results_equal(got, alljax_failover[2])


@pytest.fixture(scope="module")
def alljax_batch(tmp_path_factory):
    return _run_child(tmp_path_factory.mktemp("alljax_batch"), ["jax"] * 4,
                      2, "batch", **BATCH_ENV)


BATCH_ENV = {"PS_BATCH_BYTES": "65536", "PS_BATCH_NEGOTIATE": "0"}


@pytest.mark.parametrize("pkgs", [
    ["jax", "jax", "port", "jax"],
    ["port", "port", "jax", "port"],
], ids=["jax_primary-port_replica-jax_worker",
        "port_primary-jax_replica-port_worker"])
def test_mixed_batching_under_replication_bit_equal_to_jax(
        tmp_path, alljax_batch, pkgs):
    """64 one-key pushes at once under ``PS_BATCH_BYTES`` and
    ``PS_KV_REPLICATION=2``, over a chain of both packages: the batched
    sub-ops are forwarded one by one, and every server's store (each
    holds both ranges) is bit-equal to the all-JAX run's."""
    got, report = _run_child(tmp_path, pkgs, 2, "batch", with_report=True,
                             **BATCH_ENV)
    assert report["batch_frames"] > 0
    assert_results_equal(got, alljax_batch)
