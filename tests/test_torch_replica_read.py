"""pslite_tpu_torch's replica reads and model namespaces against
``tests/test_replica_read.py``.

Mirrored on the port's in-process cluster (``PortCluster``, loopback
van, 3 servers at ``PS_KV_REPLICATION=3``, ``rr`` read policy so one
worker reaches every chain member): the spread with bit-exact answers,
read-your-writes under a racing push storm, a stale replica answer
pulled again from the primary, a replica crashing mid read storm, a
model namespace flipped in and rolled back under a pull storm, and a
hot-cache fill from a replica filed under the primary's identity, and
JAX's ``test_elastic_join_backfills_replicated_ranges``: a server that
joins an elastic cluster backfills the ranges whose chains it enters,
bit-equal in both packages.

Beyond JAX's cases: the same read schedule through JAX's and the port's
clusters answers bit-equal (``run_both``); clusters that mix the
packages over tcp (``tests/torch_durability_child.py``), the spread
pulls and read-your-writes probes bit-equal to the all-JAX run's (a
replica of one package answers in the stamp currency of a primary of
the other); and ``PS_REQUEST_TIMEOUT``'s default of 10 s under replica
reads.  Tolerance: none (the table rows and the probe's pushes are
small integers).
"""

import os
import shutil
import tempfile
import threading
import time

import numpy as np
import pytest

import pslite_tpu_torch as tps
from pslite_tpu_torch.base import server_rank_to_id

from test_torch_msg_plane import (  # noqa: F401 - the fixture runs by name
    PortCluster,
    _port_loopback_isolation,
    assert_same,
    run_both,
    servers_with,
)
from test_torch_replication import _run_child, assert_results_equal

ROWS = 96
DIM = 8
KEYS = np.arange(ROWS, dtype=np.uint64)

RR_ENV = {
    "PS_KV_REPLICATION": "3",
    "PS_REPLICA_READS": "1",
    "PS_REPLICA_READ_POLICY": "rr",
    "PS_REQUEST_TIMEOUT": "2.0",
    "PS_REQUEST_RETRIES": "8",
    "PS_HOT_CACHE": "0",
}


def _spin_up(cluster):
    servers = servers_with(tps, cluster, tps.KVServerDefaultHandle)
    workers = [tps.KVWorker(0, 0, postoffice=po) for po in cluster.workers]
    return servers, workers


def _teardown(cluster, servers, workers, dead_pos=()):
    for w in workers:
        w.stop()
    for s in servers:
        if s.po not in dead_pos:
            s.stop()
    for po in cluster.all_nodes():
        po.van.stop()


def _table(scale=1.0):
    return np.stack([np.full(DIM, scale * (1.0 + r), np.float32)
                     for r in range(ROWS)])


def _push_table(worker, table):
    worker.wait(worker.push(KEYS, np.ascontiguousarray(table).reshape(-1)))


def _settle(worker, expected, timeout=15.0):
    """Poll until every chain member serves the expected table."""
    out = np.zeros(ROWS * DIM, np.float32)
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        ok = True
        for _ in range(3):  # rr: one pull per chain member
            out[:] = 0
            worker.wait(worker.pull(KEYS, out))
            ok = ok and np.array_equal(out.reshape(ROWS, DIM), expected)
        if ok:
            return
        time.sleep(0.05)
    raise TimeoutError("replicas never converged on the pushed table")


def test_spread_and_bit_exact():
    """rr reads reach every live chain member, and every answer is
    bit-exact with the pushed table."""
    cluster = PortCluster(num_workers=1, num_servers=3, env_extra=RR_ENV)
    cluster.start()
    servers, workers = _spin_up(cluster)
    w = workers[0]
    try:
        table = _table()
        _push_table(w, table)
        _settle(w, table)
        out = np.zeros(16 * DIM, np.float32)
        for i in range(30):
            start = (i * 3) % (ROWS - 16)
            out[:] = 0
            w.wait(w.pull(KEYS[start:start + 16], out))
            np.testing.assert_array_equal(out.reshape(16, DIM),
                                          table[start:start + 16])
        assert w.stats["replica_read.spread"] > 0
        assert len(w._read_share) == 3, w._read_share
        # The replicas claimed the primary's forward stamp and applied
        # it: the applied-stamp lag is 0 once settled.
        primary = server_rank_to_id(0)
        for s in servers:
            rep = s._replicator
            if s.po.van.my_node.id != primary:
                assert rep.claimed_stamp(primary) > 0
                assert rep.stamp_lag() == 0
        assert all(n > 0 for n in w._read_share.values()), w._read_share
    finally:
        _teardown(cluster, servers, workers)


def test_read_your_writes_under_racing_push_storm():
    """Push then pull never returns a value missing the worker's own
    push, while a storm keeps the forwards busy and 2/3 of the pulls land
    on replicas."""
    cluster = PortCluster(num_workers=1, num_servers=3, env_extra=RR_ENV)
    cluster.start()
    servers, workers = _spin_up(cluster)
    w = workers[0]
    try:
        table = _table()
        _push_table(w, table)
        _settle(w, table)
        stop = threading.Event()
        storm_keys = KEYS[:32]
        storm_delta = np.ones(32 * DIM, np.float32)
        storm_pushes = [0]

        def storm():
            while not stop.is_set():
                w.wait(w.push(storm_keys, storm_delta))
                storm_pushes[0] += 1

        t = threading.Thread(target=storm, daemon=True)
        t.start()
        try:
            probe_keys = KEYS[ROWS - 8:]
            expected = np.ascontiguousarray(table[ROWS - 8:])
            delta = np.ones(8 * DIM, np.float32)
            out = np.zeros(8 * DIM, np.float32)
            for _ in range(40):
                expected += 1.0
                w.wait(w.push(probe_keys, delta))
                out[:] = 0
                w.wait(w.pull(probe_keys, out))
                np.testing.assert_array_equal(out.reshape(8, DIM),
                                              expected)
        finally:
            stop.set()
            t.join(timeout=10)
        assert storm_pushes[0] > 0
    finally:
        _teardown(cluster, servers, workers)


def test_stale_replica_answer_repulls_from_primary():
    """A replica answer whose stamp trails the worker's push frontier is
    discarded and pulled again from the primary: with the frontier
    forced far ahead every replica answer is stale, yet every pull
    returns the table and the fallbacks are counted."""
    cluster = PortCluster(num_workers=1, num_servers=3, env_extra=RR_ENV)
    cluster.start()
    servers, workers = _spin_up(cluster)
    w = workers[0]
    try:
        table = _table()
        _push_table(w, table)
        _settle(w, table)
        with w._mu:
            w._seen_stamps[server_rank_to_id(0)] = 1 << 40
        out = np.zeros(8 * DIM, np.float32)
        for _ in range(9):
            out[:] = 0
            w.wait(w.pull(KEYS[:8], out))
            np.testing.assert_array_equal(out.reshape(8, DIM), table[:8])
        assert w.stats["replica_read.fallbacks"] > 0
    finally:
        _teardown(cluster, servers, workers)


def test_chaos_kill_replica_mid_read_storm():
    """A replica crashing mid read storm never fails a wait: the dead
    member leaves the spread set and its in-flight pulls retry onto live
    members."""
    env = dict(RR_ENV, PS_HEARTBEAT_INTERVAL="0.3",
               PS_HEARTBEAT_TIMEOUT="1.0", PS_REQUEST_TIMEOUT="0.5")
    cluster = PortCluster(
        num_workers=1, num_servers=3, env_extra=env,
        van_type="chaos+loopback",
        per_node_env={"server1": {"PS_CHAOS": "crash=recv:40"}})
    cluster.start()
    servers, workers = _spin_up(cluster)
    w = workers[0]
    dead_po = cluster.servers[1]
    try:
        table = _table()
        _push_table(w, table)
        _settle(w, table)
        out = np.zeros(16 * DIM, np.float32)
        for i in range(150):
            start = (i * 5) % (ROWS - 16)
            out[:] = 0
            w.wait(w.pull(KEYS[start:start + 16], out))
            np.testing.assert_array_equal(out.reshape(16, DIM),
                                          table[start:start + 16])
        assert dead_po.van.chaos_crashed.is_set(), \
            "victim never crashed: scenario inert"
    finally:
        _teardown(cluster, servers, workers, dead_pos=(dead_po,))


def test_namespace_flip_and_rollback_under_pull_storm():
    """A published model version flips in under a live pull storm: no
    failed request, every answer bit-exact against exactly one version,
    and rollback restores the displaced store."""
    snapdir = tempfile.mkdtemp(prefix="torch_nsflip_")
    cluster = PortCluster(num_workers=1, num_servers=3,
                          env_extra=dict(RR_ENV, PS_SNAPSHOT_DIR=snapdir))
    cluster.start()
    servers, workers = _spin_up(cluster)
    w = workers[0]
    try:
        v1 = _table()
        _push_table(w, v1)
        _settle(w, v1)
        cluster.scheduler.snapshot()
        _push_table(w, v1)  # the live (additive) store is now 2 * v1
        v2 = 2 * v1
        _settle(w, v2)
        stop = threading.Event()
        errors = []
        pulls = [0]

        def storm():
            out = np.zeros(16 * DIM, np.float32)
            i = 0
            while not stop.is_set():
                start = (i * 7) % (ROWS - 16)
                i += 1
                out[:] = 0
                try:
                    w.wait(w.pull(KEYS[start:start + 16], out))
                except Exception as exc:  # noqa: BLE001
                    errors.append(repr(exc))
                    continue
                got = out.reshape(16, DIM)
                if not (np.array_equal(got, v1[start:start + 16])
                        or np.array_equal(got, v2[start:start + 16])):
                    errors.append(f"mixed-version read at row {start}")
                pulls[0] += 1

        t = threading.Thread(target=storm, daemon=True)
        t.start()
        try:
            time.sleep(0.2)
            pub = cluster.scheduler.publish_model(namespace="m",
                                                  version="v1")
            assert pub["servers"] == 3, pub
            time.sleep(0.2)
            rb = cluster.scheduler.rollback_model()
            assert rb["servers"] == 3, rb
            time.sleep(0.2)
        finally:
            stop.set()
            t.join(timeout=10)
        assert not errors, errors[:5]
        assert pulls[0] > 0
        out = np.zeros(ROWS * DIM, np.float32)
        w.wait(w.pull(KEYS, out))
        np.testing.assert_array_equal(out.reshape(ROWS, DIM), v2)
        for s in servers:
            assert s.po.model_namespace == {"name": "live", "version": ""}
            assert s._ns_prev[:2] == ("m", "v1")
    finally:
        _teardown(cluster, servers, workers)
        shutil.rmtree(snapdir, ignore_errors=True)


def test_hot_cache_fill_from_replica_carries_primary_identity():
    """A fill from a replica-served pull is filed under the primary's
    node id with the replica's stamp (the same counter domain): the
    primary's next push-ack stamp invalidates it, so a pull after a push
    never serves the displaced value."""
    cluster = PortCluster(num_workers=1, num_servers=3,
                          env_extra=dict(RR_ENV, PS_HOT_CACHE="1"))
    cluster.start()
    servers, workers = _spin_up(cluster)
    w = workers[0]
    try:
        table = _table()
        _push_table(w, table)
        _settle(w, table)
        primary_id = server_rank_to_id(0)
        time.sleep(0.3)  # forwards drain: replicas answer fresh
        w._hot_cache.invalidate_range(0, (1 << 64) - 1)
        out = np.zeros(8 * DIM, np.float32)
        for b in range(3):
            out[:] = 0
            w.wait(w.pull(KEYS[b * 8:(b + 1) * 8], out))
        assert w.stats["replica_read.spread"] > 0
        with w._hot_cache._mu:
            idents = {w._hot_cache._entries[int(k)][1] for k in KEYS[:24]
                      if int(k) in w._hot_cache._entries}
        assert idents == {primary_id}, idents
        w.wait(w.push(KEYS[:8], np.ones(8 * DIM, np.float32)))
        out[:] = 0
        w.wait(w.pull(KEYS[:8], out))
        np.testing.assert_array_equal(out.reshape(8, DIM), table[:8] + 1.0)
    finally:
        _teardown(cluster, servers, workers)


# -- beyond JAX's cases -------------------------------------------------------

def test_namespace_decline_matrix(tmp_path):
    """Namespace ops refuse loudly, as in JAX: a flip with nothing
    staged, a rollback with nothing displaced, a publish of a directory
    with no manifest, and a tiered store (its state is outside a plain
    dict).  The autopilot's ``retune`` op on the same channel is served:
    each server answers what it applied."""
    from pslite_tpu_torch.utils import logging as log

    cluster = PortCluster(num_workers=1, num_servers=1, env_extra={
        "PS_SNAPSHOT_DIR": str(tmp_path / "none")})
    cluster.start()
    servers, workers = _spin_up(cluster)
    sched = cluster.scheduler
    try:
        for body, match in (
                ({"op": "flip"}, "without a staged namespace"),
                ({"op": "rollback"}, "without a previous namespace")):
            with pytest.raises(log.CheckError, match=match):
                sched._model_ctl(body, timeout_s=20.0)
        pool = servers[0]._apply_pool
        rep = sched.retune_apply(1, timeout_s=20.0)
        assert rep["servers"] == 1
        assert rep["applied"] == (1 if pool is not None else 0)
        with pytest.raises(log.CheckError, match="no committed manifest"):
            sched.publish_model(version="v1", timeout_s=20.0)
    finally:
        _teardown(cluster, servers, workers)

    cluster = PortCluster(num_workers=1, num_servers=1, env_extra={
        "PS_SNAPSHOT_DIR": str(tmp_path / "snap"), "PS_STORE_RAM_MB": "1"})
    cluster.start()
    servers, workers = _spin_up(cluster)
    try:
        w = workers[0]
        w.wait(w.push(KEYS[:4], np.ones(4 * DIM, np.float32)))
        cluster.scheduler.snapshot()
        with pytest.raises(log.CheckError, match="plain dict store"):
            cluster.scheduler.publish_model(timeout_s=20.0)
    finally:
        _teardown(cluster, servers, workers)


def test_read_schedule_bit_equal_to_jax():
    """The same pushes and spread pulls through a JAX and a port
    cluster answer bit-equal, every chain member reached on both."""
    table = _table()

    def scenario(api, cluster):
        servers = servers_with(api, cluster, api.DefaultHandle)
        w = api.KVWorker(0, 0, postoffice=cluster.workers[0])
        try:
            _push_table(w, table)
            _settle(w, table)
            outs = []
            out = np.zeros(16 * DIM, np.float32)
            for i in range(12):
                start = (i * 7) % (ROWS - 16)
                out[:] = 0
                w.wait(w.pull(KEYS[start:start + 16], out))
                outs.append(out.copy())
            return outs, len(w._read_share)
        finally:
            w.stop()
            for s in servers:
                s.stop()

    want, got = run_both(scenario, num_workers=1, num_servers=3,
                         env_extra=RR_ENV)
    assert_same(got, want)
    assert got[1] == 3


def test_request_timeout_defaults_to_10s_under_replica_reads():
    """Replica reads need the sweeper (a stale answer's re-pull is a
    retry): ``PS_REQUEST_TIMEOUT`` defaults to 10 s under them, as in
    JAX, and stays 0 (off) otherwise."""
    env = {k: v for k, v in RR_ENV.items() if k != "PS_REQUEST_TIMEOUT"}
    cluster = PortCluster(num_workers=1, num_servers=3, env_extra=env)
    cluster.start()
    try:
        w = tps.KVWorker(0, 0, postoffice=cluster.workers[0])
        assert w._req_timeout == 10.0 and w._replica_reads
        w.stop()
    finally:
        cluster.finalize()
    cluster = PortCluster(num_workers=1, num_servers=3,
                          env_extra={"PS_KV_REPLICATION": "3"})
    cluster.start()
    try:
        w = tps.KVWorker(0, 0, postoffice=cluster.workers[0])
        assert w._req_timeout == 0.0 and not w._replica_reads
        w.stop()
    finally:
        cluster.finalize()


READ_ENV = {"PS_REPLICA_READS": "1", "PS_REPLICA_READ_POLICY": "rr",
            "PS_REQUEST_TIMEOUT": "2"}


@pytest.fixture(scope="module")
def alljax_reads(tmp_path_factory):
    return _run_child(tmp_path_factory.mktemp("alljax_reads"),
                      ["jax"] * 5, 3, "reads", **READ_ENV)


@pytest.mark.parametrize("pkgs", [
    ["jax", "port", "jax", "port", "port"],
    ["port", "jax", "port", "jax", "jax"],
    ["port"] * 5,
], ids=["jax_primary", "port_primary", "all_port"])
def test_mixed_replica_reads_bit_equal_to_jax(tmp_path, alljax_reads, pkgs):
    """Spread pulls of a pushed table and push-then-pull probes over a
    chain of both packages (server rank 0 is the primary of the table):
    every answer bit-equal to the all-JAX run's."""
    got = _run_child(tmp_path, pkgs, 3, "reads", **READ_ENV)
    assert_results_equal(got, alljax_reads)


def test_elastic_join_backfills_replicated_ranges():
    """JAX's test in both packages: a server joining an elastic cluster
    at ``PS_KV_REPLICATION=2`` owes replica state for the ranges whose
    chains it enters; the chain recomputation backfills them from their
    primaries, so the joiner holds exact copies of keys it does not own.
    The joiner's replicated copies are bit-equal across the packages."""
    from test_torch_elastic_membership import run_both_elastic

    from pslite_tpu_torch.kv.replication import chain_ranks

    env = {"PS_ELASTIC": "1", "PS_KV_REPLICATION": "2",
           "PS_REPLICA_READS": "1", "PS_REQUEST_TIMEOUT": "2.0",
           "PS_REQUEST_RETRIES": "8"}
    span = (1 << 64) // 8
    keys = np.arange(8, dtype=np.uint64) * np.uint64(span) + np.uint64(3)
    vals = np.arange(8 * DIM, dtype=np.float32) + 1.0

    def scenario(el):
        w = el.workers[0]
        w.wait(w.push(keys, vals))
        time.sleep(0.3)
        po, joiner = el.join()
        deadline = time.monotonic() + 20
        got = {}
        while time.monotonic() < deadline and not got:
            rt = po.current_routing()
            if rt is not None:
                my = po.my_group_rank()
                for e in rt.entries:
                    if e.owner == my or my not in chain_ranks(
                            e.owner, 2, po.num_servers,
                            active=sorted(rt.active)):
                        continue
                    got = {int(k): joiner._handle.store[int(k)].copy()
                           for k in keys if e.begin <= int(k) < e.end
                           and int(k) in joiner._handle.store}
                    if got:
                        break
            time.sleep(0.1)
        assert got, "joiner never backfilled a replicated range"
        return got

    want, got = run_both_elastic(scenario, num_workers=1, num_servers=2,
                                 env_extra=env)
    assert_same(got, want)
    for k, v in got.items():
        i = int(np.searchsorted(keys, k))
        np.testing.assert_array_equal(v, vals[i * DIM:(i + 1) * DIM])
