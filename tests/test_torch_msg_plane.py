"""pslite_tpu_torch's message control plane against the JAX package's.

Whole clusters run in one process over the loopback van: the JAX package
through ``tests/helpers.py``'s ``LoopbackCluster``, the port through
:class:`PortCluster` below (the port's in-process cluster, which the
other port test files import).  The same seeded numpy pushes go
through both, in the same order.  Tolerance: none.  Server stores and
pulls are bit-equal, because both sides add and update the same float32
numpy arrays in the same order (the optimizer handle is numpy on both
sides too).

Mirrored here: ``test_kv_loopback.py`` (10 of its 14 cases; the shm
van's transport delivery and the three compressed cases wait for ROADMAP
Queue 1 items 3 and 6), ``test_rank_assignment.py``,
``test_barrier_mixed.py`` and ``test_ici_van.py::
test_unregistered_keys_fall_back_to_messages``; then the lifecycle
(``start_ps`` with the joint role and instance groups, no thread left
after ``finalize``), the vans that raise, heartbeats, the resender, and
``convert.load_server_store``.

Every cluster start, barrier and finalize runs under a deadline of its
own (:data:`DEADLINE` seconds) that fails the test.
"""

import itertools
import os
import threading
import time
import types
import uuid

import numpy as np
import pytest
import torch

import pslite_tpu as jps
import pslite_tpu_torch as tps
from pslite_tpu_torch import convert
from pslite_tpu_torch import ps as tps_ps
from pslite_tpu_torch.base import (
    ALL_GROUP,
    SCHEDULER_ID,
    SERVER_WORKER_GROUP,
    server_rank_to_id,
    worker_rank_to_id,
)
from pslite_tpu_torch.environment import Environment
from pslite_tpu_torch.utils.logging import CheckError
from pslite_tpu_torch.vans import loopback_van as port_loopback

from helpers import LoopbackCluster

DEADLINE = 30.0
_ports = itertools.count(46000)


@pytest.fixture(autouse=True)
def _port_loopback_isolation(monkeypatch):
    """A loopback namespace of the port's own per test, and a clean
    registry after it."""
    monkeypatch.setenv("PS_LOOPBACK_NS", f"torch-{uuid.uuid4().hex}")
    yield
    port_loopback.reset_registry()


def join_all(threads, what: str) -> None:
    """Join ``threads`` within DEADLINE seconds in all, or fail."""
    end = time.monotonic() + DEADLINE
    for t in threads:
        t.join(max(0.0, end - time.monotonic()))
    alive = [t.name for t in threads if t.is_alive()]
    assert not alive, f"{what} did not finish within {DEADLINE}s: {alive}"


def run_all(fns, what: str) -> None:
    """Run each zero-argument callable on its own thread, join them
    under the deadline, and re-raise the first error."""
    errors = []

    def wrap(fn):
        def run():
            try:
                fn()
            except Exception as exc:  # noqa: BLE001 - re-raised below
                errors.append(exc)
        return run

    threads = [threading.Thread(target=wrap(fn), daemon=True,
                                name=f"{what}-{i}")
               for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    join_all(threads, what)
    if errors:
        raise errors[0]


class PortCluster:
    """A whole port cluster in one process: one scheduler, ``num_servers``
    servers and ``num_workers`` workers (``group_size`` instances each),
    each node with its own Environment.  With ``van_type="ici"`` every
    worker gets a CPU ``DeviceGroup(8)`` before start.  ``per_node_env``
    overlays env vars onto one node, keyed ``"scheduler"``,
    ``"server<N>"`` or ``"worker<N>"`` (N in creation order)."""

    def __init__(self, num_workers=1, num_servers=1, group_size=1,
                 van_type="loopback", env_extra=None, per_node_env=None):
        self._per_node_env = per_node_env or {}
        self.base_env = {
            "DMLC_NUM_WORKER": str(num_workers),
            "DMLC_NUM_SERVER": str(num_servers),
            "DMLC_GROUP_SIZE": str(group_size),
            "DMLC_PS_ROOT_URI": "lo",
            "DMLC_PS_ROOT_PORT": str(next(_ports)),
            "DMLC_NODE_HOST": "lo",
            "PS_VAN_TYPE": van_type,
            "PS_LOOPBACK_NS": os.environ["PS_LOOPBACK_NS"],
        }
        self.base_env.update(env_extra or {})
        self.scheduler = self._make("scheduler", 0, "scheduler")
        self.servers = [self._make("server", idx, f"server{n}")
                        for n in range(num_servers)
                        for idx in range(group_size)]
        self.workers = [self._make("worker", idx, f"worker{n}")
                        for n in range(num_workers)
                        for idx in range(group_size)]
        if van_type == "ici":
            for po in self.workers:
                po.van.set_mesh(tps.DeviceGroup(8, device="cpu"))

    def _make(self, role, idx, key):
        env = dict(self.base_env, **self._per_node_env.get(key, {}))
        return tps.Postoffice(role, instance_idx=idx, env=Environment(env))

    def all_nodes(self):
        return [self.scheduler] + self.servers + self.workers

    def join_server(self, env_extra=None):
        """Boot one more server against the running cluster (an elastic
        join): the base env, started at once with no barrier (the
        scheduler admits it through its late ADD_NODE path)."""
        env = dict(self.base_env, **(env_extra or {}))
        po = tps.Postoffice("server", env=Environment(env))
        po.start(0)
        self.servers.append(po)
        return po

    def start(self):
        run_all([po.start for po in self.all_nodes()], "cluster start")

    def finalize(self):
        run_all([po.finalize for po in self.all_nodes()], "cluster finalize")

    def barrier(self, nodes, group, instance=False):
        run_all([lambda po=po: po.barrier(0, group, instance=instance)
                 for po in nodes], f"barrier(group={group})")


def by_address(pos):
    """Postoffices in the order of their bound ``host:port``: the order
    the scheduler assigns ranks in (without preferred ranks).  Ports are
    drawn at bind time, on each node's own start thread, so creation
    order says nothing about it."""
    return sorted(pos, key=lambda po: po.van.my_node.addr_key())


JAX = types.SimpleNamespace(
    name="jax", cluster=LoopbackCluster, KVWorker=jps.KVWorker,
    KVServer=jps.KVServer, KVPairs=jps.KVPairs,
    DefaultHandle=jps.KVServerDefaultHandle,
    OptimizerHandle=jps.KVServerOptimizerHandle, SimpleApp=jps.SimpleApp)
PORT = types.SimpleNamespace(
    name="port", cluster=PortCluster, KVWorker=tps.KVWorker,
    KVServer=tps.KVServer, KVPairs=tps.KVPairs,
    DefaultHandle=tps.KVServerDefaultHandle,
    OptimizerHandle=tps.KVServerOptimizerHandle, SimpleApp=tps.SimpleApp)


def run_both(scenario, **cluster_kw):
    """``scenario(api, cluster)`` on a started JAX cluster and on a
    started port cluster; returns both results."""
    out = []
    for api in (JAX, PORT):
        cluster = api.cluster(**cluster_kw)
        cluster.start()
        try:
            out.append(scenario(api, cluster))
        finally:
            cluster.finalize()
    return out


def servers_with(api, cluster, handle_fn):
    servers = []
    for po in cluster.servers:
        srv = api.KVServer(0, postoffice=po)
        srv.set_request_handle(handle_fn())
        servers.append(srv)
    return servers


def stores(servers):
    return [{k: v.copy() for k, v in s._handle.store.items()}
            for s in servers]


def assert_same(a, b):
    """Bit-equal nested results (arrays, dicts, lists, scalars)."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


# -- mirrors of tests/test_kv_loopback.py --------------------------------------

def test_bootstrap_assigns_ranks():
    def scenario(api, cluster):
        ranges = cluster.workers[0].get_server_key_ranges()
        return (sorted(po.van.my_node.id for po in cluster.workers),
                sorted(po.van.my_node.id for po in cluster.servers),
                cluster.scheduler.van.my_node.id,
                [(r.begin, r.end) for r in ranges])

    want, got = run_both(scenario, num_workers=2, num_servers=2)
    assert_same(got, want)
    assert got[0] == [worker_rank_to_id(0), worker_rank_to_id(1)]
    assert got[1] == [server_rank_to_id(0), server_rank_to_id(1)]
    assert got[2] == SCHEDULER_ID
    assert got[3][0][1] == got[3][1][0]


def _spread_keys(po, num_keys):
    ranges = po.get_server_key_ranges()
    return np.sort(np.array([ranges[i % 2].begin + i
                             for i in range(num_keys)], dtype=np.uint64))


def test_push_pull_single_worker():
    keys_n, k = 8, 16
    vals = np.random.default_rng(0).normal(size=keys_n * k).astype(
        np.float32)

    def scenario(api, cluster):
        servers = servers_with(api, cluster, api.DefaultHandle)
        try:
            w = api.KVWorker(0, 0, postoffice=cluster.workers[0])
            keys = _spread_keys(cluster.workers[0], keys_n)
            outs = []
            for _ in range(2):
                w.wait(w.push(keys, vals))
                out = np.zeros_like(vals)
                w.wait(w.pull(keys, out))
                outs.append(out)
            return outs, stores(servers)
        finally:
            for s in servers:
                s.stop()

    want, got = run_both(scenario, num_workers=1, num_servers=2)
    assert_same(got, want)
    np.testing.assert_array_equal(got[0][0], vals)
    np.testing.assert_array_equal(got[0][1], vals + vals)
    assert all(len(s) == keys_n // 2 for s in got[1])


def test_multi_worker_aggregation():
    keys = np.array([10, 20, 30], dtype=np.uint64)
    rng = np.random.default_rng(1)
    v0, v1 = (rng.normal(size=12).astype(np.float32) for _ in range(2))

    def scenario(api, cluster):
        servers = servers_with(api, cluster, api.DefaultHandle)
        try:
            w0, w1 = (api.KVWorker(0, 0, postoffice=po)
                      for po in cluster.workers)
            w0.wait(w0.push(keys, v0))
            w1.wait(w1.push(keys, v1))
            out = np.zeros_like(v0)
            w0.wait(w0.pull(keys, out))
            return out, stores(servers)
        finally:
            for s in servers:
                s.stop()

    want, got = run_both(scenario, num_workers=2, num_servers=1)
    assert_same(got, want)
    np.testing.assert_array_equal(got[0], v0 + v1)


def test_push_pull_fused():
    vals = np.random.default_rng(2).normal(size=8).astype(np.float32)

    def scenario(api, cluster):
        servers = servers_with(api, cluster, api.DefaultHandle)
        try:
            w = api.KVWorker(0, 0, postoffice=cluster.workers[0])
            ranges = cluster.workers[0].get_server_key_ranges()
            keys = np.array([ranges[0].begin, ranges[1].begin + 5],
                            dtype=np.uint64)
            outs = []
            for _ in range(2):
                out = np.zeros_like(vals)
                w.wait(w.push_pull(keys, vals, out))
                outs.append(out)
            return outs, stores(servers)
        finally:
            for s in servers:
                s.stop()

    want, got = run_both(scenario, num_workers=1, num_servers=2)
    assert_same(got, want)
    np.testing.assert_array_equal(got[0][0], vals)
    np.testing.assert_array_equal(got[0][1], vals + vals)


def test_variable_length_values():
    def scenario(api, cluster):
        class VarHandle:
            def __init__(self):
                self.store = {}

            def __call__(self, meta, data, server):
                if meta.push:
                    off = 0
                    for key, ln in zip(data.keys, data.lens):
                        self.store[int(key)] = data.vals[off:off + ln].copy()
                        off += int(ln)
                    server.response(meta)
                else:
                    vals = [self.store[int(k)] for k in data.keys]
                    server.response(meta, api.KVPairs(
                        keys=data.keys, vals=np.concatenate(vals),
                        lens=np.array([len(v) for v in vals], np.int32)))

        servers = servers_with(api, cluster, VarHandle)
        try:
            w = api.KVWorker(0, 0, postoffice=cluster.workers[0])
            ranges = cluster.workers[0].get_server_key_ranges()
            keys = np.array([ranges[0].begin, ranges[1].begin + 1],
                            dtype=np.uint64)
            lens = np.array([3, 5], dtype=np.int32)
            vals = np.arange(8, dtype=np.float32)
            w.wait(w.push(keys, vals, lens=lens))
            out = np.zeros_like(vals)
            out_lens = np.zeros(2, dtype=np.int32)
            w.wait(w.pull(keys, out, lens=out_lens))
            return out, out_lens, stores(servers)
        finally:
            for s in servers:
                s.stop()

    want, got = run_both(scenario, num_workers=1, num_servers=2)
    assert_same(got, want)
    np.testing.assert_array_equal(got[0], np.arange(8, dtype=np.float32))
    np.testing.assert_array_equal(got[1], [3, 5])


def test_early_push_buffered_until_server_app_ready():
    """A push that lands before the server app registers is parked (the
    receive loop keeps running: a barrier still passes) and applied on
    registration."""
    vals = np.random.default_rng(3).normal(size=16).astype(np.float32)

    def scenario(api, cluster):
        servers = []
        try:
            w = api.KVWorker(0, 0, postoffice=cluster.workers[0])
            keys = np.array([3], dtype=np.uint64)
            ts = w.push(keys, vals)  # the server app does not exist yet
            time.sleep(0.2)
            if api is PORT:
                cluster.barrier(cluster.all_nodes(), ALL_GROUP, instance=True)
            else:
                cluster.barrier_all()
            servers = servers_with(api, cluster, api.DefaultHandle)
            w.wait(ts)
            out = np.zeros_like(vals)
            w.wait(w.pull(keys, out))
            return out, stores(servers)
        finally:
            for s in servers:
                s.stop()

    want, got = run_both(scenario, num_workers=1, num_servers=1)
    assert_same(got, want)
    np.testing.assert_array_equal(got[0], vals)


def test_simple_app():
    def scenario(api, cluster):
        received, replies = [], []

        def handle(req, app):
            received.append((req.head, bytes(req.body)))
            app.response(req, b"pong")

        server_app = api.SimpleApp(5, postoffice=cluster.servers[0])
        server_app.set_request_handle(handle)
        worker_app = api.SimpleApp(5, postoffice=cluster.workers[0])
        worker_app.set_response_handle(
            lambda res, app: replies.append(bytes(res.body)))
        try:
            worker_app.wait(worker_app.request(42, b"ping",
                                               server_rank_to_id(0)))
            return received, replies
        finally:
            worker_app.stop()
            server_app.stop()

    want, got = run_both(scenario, num_workers=1, num_servers=1)
    assert_same(got, want)
    assert got == ([(42, b"ping")], [b"pong"])


def test_registered_recv_buffer_identity():
    """Pushes for a registered (worker, key) land in exactly the
    registered buffer (test_benchmark.cc:169-181)."""
    vals = np.random.default_rng(4).normal(size=64).astype(np.float32)

    def scenario(api, cluster):
        seen = {}

        def handle(meta, data, server):
            if meta.push:
                seen["vals"] = data.vals
            server.response(meta)

        srv = api.KVServer(0, postoffice=cluster.servers[0])
        srv.set_request_handle(handle)
        try:
            w = api.KVWorker(0, 0, postoffice=cluster.workers[0])
            registered = np.zeros(64, dtype=np.float32)
            srv.register_recv_buffer(cluster.workers[0].van.my_node.id, 7,
                                     registered)
            w.wait(w.push(np.array([7], np.uint64), vals))
            return np.shares_memory(seen["vals"], registered), registered
        finally:
            srv.stop()

    want, got = run_both(scenario, num_workers=1, num_servers=1)
    assert_same(got, want)
    assert got[0]
    np.testing.assert_array_equal(got[1], vals)


def test_server_optimizer_handle_async_sgd():
    """Two workers push gradients with no inter-worker barrier; the
    server's optimizer applies each on arrival.  Each push is waited
    before the next, so both packages apply them in one order."""
    keys = np.array([3, 9], np.uint64)
    rng = np.random.default_rng(5)
    grads = [rng.normal(size=8).astype(np.float32) for _ in range(6)]

    def scenario(api, cluster):
        servers = servers_with(
            api, cluster, lambda: api.OptimizerHandle(kind="sgd", lr=0.1))
        try:
            workers = [api.KVWorker(0, 0, postoffice=po)
                       for po in cluster.workers]
            for i, g in enumerate(grads):
                w = workers[i % 2]
                w.wait(w.push(keys, g))
            out = np.zeros(8, np.float32)
            workers[0].wait(workers[0].pull(keys, out))
            return out, stores(servers)
        finally:
            for s in servers:
                s.stop()

    want, got = run_both(scenario, num_workers=2, num_servers=1)
    assert_same(got, want)
    np.testing.assert_allclose(got[0], -0.1 * np.sum(grads, axis=0),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["sgd_momentum", "adam"])
def test_server_optimizer_handle_momentum_adam(kind):
    rng = np.random.default_rng(7)
    grads = [rng.normal(size=4).astype(np.float32) for _ in range(5)]
    key = np.array([1], np.uint64)

    def scenario(api, cluster):
        handle = api.OptimizerHandle(kind=kind, lr=0.05)
        handle.init(1, np.ones(4, np.float32))
        srv = api.KVServer(0, postoffice=cluster.servers[0])
        srv.set_request_handle(handle)
        try:
            w = api.KVWorker(0, 0, postoffice=cluster.workers[0])
            for g in grads:
                w.wait(w.push(key, g))
            out = np.zeros(4, np.float32)
            w.wait(w.pull(key, out))
            return out, handle.store, handle._m, handle._v, handle._t
        finally:
            srv.stop()

    want, got = run_both(scenario, num_workers=1, num_servers=1)
    assert_same(got, want)
    # The float64 host loop of the JAX test.
    p = np.ones(4)
    m, v = np.zeros(4), np.zeros(4)
    for t, g in enumerate(grads, 1):
        if kind == "sgd_momentum":
            m = 0.9 * m + g
            p = p - 0.05 * m
        else:
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            p = p - 0.05 * (m / (1 - 0.9 ** t)) / (
                np.sqrt(v / (1 - 0.999 ** t)) + 1e-8)
    np.testing.assert_allclose(got[0], p, rtol=1e-5, atol=1e-6)


# -- mirrors of test_rank_assignment.py ----------------------------------------

_PREFS = {"server0": {"DMLC_RANK": "1"}, "server1": {"DMLC_RANK": "0"},
          "worker0": {"DMLC_RANK": "1"}, "worker1": {"DMLC_RANK": "0"}}


@pytest.mark.parametrize("policy,shape,per_node,extra,want", [
    # Every node names DMLC_RANK: ids follow the preferences.
    ("preferred", (2, 2), _PREFS, {},
     {"servers": [server_rank_to_id(1), server_rank_to_id(0)],
      "workers": [worker_rank_to_id(1), worker_rank_to_id(0)]}),
    # Mixed mode: the server NOT on a worker's host takes rank 0.
    ("mixed", (1, 2), {"server0": {"DMLC_NODE_HOST": "hostB"},
                       "server1": {"DMLC_NODE_HOST": "hostA"},
                       "worker0": {"DMLC_NODE_HOST": "hostB"}},
     {"BYTEPS_ENABLE_MIXED_MODE": "1"},
     {"servers": [server_rank_to_id(1), server_rank_to_id(0)]}),
    # BYTEPS_ORDERED_HOSTS pins the rank order to the host list.
    ("ordered_hosts", (2, 1), {"worker0": {"DMLC_NODE_HOST": "h2"},
                               "worker1": {"DMLC_NODE_HOST": "h1"},
                               "server0": {"DMLC_NODE_HOST": "h1"}},
     {"BYTEPS_ORDERED_HOSTS": "h1,h2"},
     {"workers": [worker_rank_to_id(1), worker_rank_to_id(0)]}),
])
def test_rank_assignment_policies(policy, shape, per_node, extra, want):
    def scenario(api, cluster):
        return {"servers": [po.van.my_node.id for po in cluster.servers],
                "workers": [po.van.my_node.id for po in cluster.workers]}

    jax_ids, port_ids = run_both(scenario, num_workers=shape[0],
                                 num_servers=shape[1], env_extra=extra,
                                 per_node_env=per_node)
    assert port_ids == jax_ids
    for role, ids in want.items():
        assert port_ids[role] == ids, policy


# -- mirrors of test_barrier_mixed.py ------------------------------------------

@pytest.mark.parametrize("workers,servers,group,nodes,rounds", [
    (1, 1, SERVER_WORKER_GROUP, "servers+workers", 1),
    (2, 1, ALL_GROUP, "all", 1),
    (2, 2, SERVER_WORKER_GROUP, "servers+workers", 3),
])
def test_mixed_group_barrier(workers, servers, group, nodes, rounds):
    """Group (non-instance) barriers over mixed roles: server id 8 and
    worker id 9 share group rank 0, so the scheduler must count by role
    too, and reset between rounds."""
    cluster = PortCluster(num_workers=workers, num_servers=servers)
    cluster.start()
    try:
        members = (cluster.all_nodes() if nodes == "all"
                   else cluster.servers + cluster.workers)
        for _ in range(rounds):
            cluster.barrier(members, group)
    finally:
        cluster.finalize()


# -- the ICI van's fallback for unregistered keys -------------------------------

def test_unregistered_keys_fall_back_to_messages():
    """One KVWorker on an ``ici`` cluster: the registered bucket rides the
    engine, every other key goes over messages to the server, whose store
    then holds exactly those keys.  Equal to the JAX IciVan on the same
    inputs (the engine's sum is bit-exact, see test_torch_engine.py)."""
    rng = np.random.default_rng(8)
    bucket = np.arange(4, dtype=np.uint64) + 100
    grads = [rng.normal(size=(8, 4 * 16)).astype(np.float32)
             for _ in range(2)]
    loose = np.array([7777, 9999], dtype=np.uint64)
    loose_vals = [rng.normal(size=2 * 32).astype(np.float32)
                  for _ in range(2)]

    def scenario(api, cluster):
        srv = api.KVServer(0, postoffice=cluster.servers[0])
        srv.set_request_handle(api.DefaultHandle())
        try:
            w = api.KVWorker(0, 0, postoffice=cluster.workers[0])
            w.register_dense("grads", bucket, 16)
            outs = []
            for g, v in zip(grads, loose_vals):
                out = np.zeros(4 * 16, np.float32)
                w.wait(w.push_pull(bucket, g, out))
                w.wait(w.push(loose, v))
                pulled = np.zeros_like(v)
                w.wait(w.pull(loose, pulled))
                outs += [out, pulled]
            return outs, srv._handle.store
        finally:
            srv.stop()

    want, got = run_both(scenario, num_workers=1, num_servers=1,
                         van_type="ici")
    assert_same(got, want)
    assert sorted(got[1]) == [7777, 9999]
    np.testing.assert_array_equal(got[0][3], loose_vals[0] + loose_vals[1])


# -- lifecycle -----------------------------------------------------------------

def test_joint_role_and_instance_groups_start_and_finalize():
    """``start_ps`` for the scheduler and for a joint node with two
    instances per group, in one process: each worker instance talks to
    its server instance, and no thread of the port outlives
    ``finalize``."""
    before = set(threading.enumerate())
    base = {"DMLC_NUM_WORKER": "1", "DMLC_NUM_SERVER": "1",
            "DMLC_GROUP_SIZE": "2", "DMLC_PS_ROOT_URI": "lo",
            "DMLC_PS_ROOT_PORT": str(next(_ports)), "DMLC_NODE_HOST": "lo",
            "PS_VAN_TYPE": "loopback",
            "PS_LOOPBACK_NS": os.environ["PS_LOOPBACK_NS"],
            "PS_HEARTBEAT_INTERVAL": "0.05"}
    run_all([lambda: tps_ps.start_ps(role="scheduler",
                                     env=Environment(base)),
             lambda: tps_ps.start_ps(role="joint", env=Environment(base))],
            "start_ps")
    apps = []
    try:
        servers = [tps.postoffice("server", idx) for idx in (0, 1)]
        workers = [tps.postoffice("worker", idx) for idx in (0, 1)]
        # Ranks follow the sorted addresses, whichever instance bound
        # first.
        assert [po.van.my_node.id for po in by_address(servers)] == [
            server_rank_to_id(0), server_rank_to_id(1)]
        assert [po.van.my_node.id for po in by_address(workers)] == [
            worker_rank_to_id(0), worker_rank_to_id(1)]
        for po in servers:
            srv = tps.KVServer(0, postoffice=po)
            srv.set_request_handle(tps.KVServerDefaultHandle())
            apps.append(srv)
        for idx, po in enumerate(workers):
            w = tps.KVWorker(0, 0, postoffice=po)
            apps.append(w)
            w.wait(w.push(np.array([5], np.uint64),
                          np.full(4, idx + 1.0, np.float32)))
        # Worker instance i reached the server instance of rank i only.
        assert {po.my_rank(): float(a._handle.store[5][0])
                for po, a in zip(servers, apps)} == {0: 1.0, 1: 2.0}
        assert tps.postoffice().is_worker
        assert tps.postoffice("scheduler").is_scheduler
    finally:
        for a in apps:
            a.stop()
        run_all([tps.finalize], "finalize")
    with pytest.raises(KeyError):
        tps.postoffice()
    end = time.monotonic() + 5
    while time.monotonic() < end:
        left = [t.name for t in set(threading.enumerate()) - before
                if t.is_alive()]
        if not left:
            break
        time.sleep(0.05)
    assert not left, f"threads outlived finalize: {left}"


def _mp_group(shape=4, names="kv"):
    """This process's view of a group of two processes (no process group
    needed: the engines refuse it before any collective)."""
    n = int(np.prod(shape))
    return tps.DeviceGroup(shape, device="cpu", axis_name=names,
                           owners=[0] * (n // 2) + [1] * (n - n // 2))


@pytest.mark.parametrize("van,case", [
    ("ici_tcp", "2-D"), ("ici_shm", "int8"),
    ("ici_tcp", "no DMLC_RANK"), ("ici_shm", "no DMLC_RANK"),
])
def test_socket_vans_raise_naming_their_roadmap_item(van, case,
                                                     monkeypatch):
    """The socket vans and one group across their worker processes
    (``PS_ICI_MULTIHOST=1``, tests/test_torch_ici_multiprocess.py and
    tests/test_torch_mp_shapes.py) are ported, 2-D ``worker_axis`` groups
    and int8 wire compression included; what that group leaves out (ranks
    on several cards) raises, naming its ROADMAP item, and a multihost
    worker without ``DMLC_RANK`` fails JAX's check with JAX's message."""
    from pslite_tpu_torch.parallel import distributed

    if case in ("2-D", "int8"):
        if case == "2-D":
            eng = tps.CollectiveEngine(_mp_group((2, 2), ("dp", "kv")),
                                       worker_axis="dp")
            assert (eng.num_shards, eng.num_workers) == (2, 2)
        else:
            eng = tps.CollectiveEngine(_mp_group(), wire_compress="int8")
            assert eng.wire_compress == "int8" and eng.num_shards == 4
        monkeypatch.setattr(distributed, "is_initialized", lambda: True)
        monkeypatch.setattr(distributed, "allgather_object",
                            lambda obj: [(2, "cuda:0"), (2, "cuda:1")])
        with pytest.raises(NotImplementedError,
                           match="ranks on several cards.*Queue 1 item 9"):
            distributed.global_group(local_ranks=2, device="cpu")
        return
    po = tps.Postoffice("worker", env=Environment({
        "PS_VAN_TYPE": van, "PS_ICI_MULTIHOST": "1",
        "DMLC_NUM_WORKER": "2", "DMLC_PS_ROOT_URI": "127.0.0.1",
        "DMLC_PS_ROOT_PORT": "9"}))
    with pytest.raises(CheckError, match="^DMLC_RANK must be set per host "
                                         "for multi-host meshes$"):
        po.van._make_group()


def test_unknown_van_and_role_raise_value_error():
    with pytest.raises(ValueError, match="unknown van type"):
        tps.Postoffice("server", env=Environment({"PS_VAN_TYPE": "bogus"}))
    with pytest.raises(ValueError, match="unknown role"):
        tps.Postoffice("bogus", env=Environment({}))


def test_codecs_raise_naming_their_roadmap_item():
    """The codecs are ported (tests/test_torch_codecs.py): an unknown
    codec fails the call, and a codec on non-float32 values too."""
    cluster = PortCluster()
    cluster.start()
    try:
        w = tps.KVWorker(0, 0, postoffice=cluster.workers[0])
        keys = np.array([1], np.uint64)
        with pytest.raises(AssertionError, match="unknown codec 'fp4'"):
            w.push(keys, np.ones(4, np.float32), compress="fp4")
        with pytest.raises(AssertionError, match="requires float32"):
            w.pull(keys, np.ones(4, np.float64), codec="bf16")
        w.stop()
    finally:
        cluster.finalize()


def test_handler_error_fails_the_wait_and_custom_cmd_reaches_it():
    """``cmd`` reaches the handler as ``meta.cmd``; a handler that
    raises answers error-marked, so the worker's wait raises instead of
    hanging."""
    cluster = PortCluster(num_servers=2)
    cluster.start()
    seen = []

    def handle(meta, data, server):
        seen.append(meta.cmd)
        if meta.cmd == 13:
            raise ValueError("boom")
        server.response(meta)

    servers = []
    try:
        for po in cluster.servers:
            srv = tps.KVServer(0, postoffice=po)
            srv.set_request_handle(handle)
            servers.append(srv)
        w = tps.KVWorker(0, 0, postoffice=cluster.workers[0])
        keys = _spread_keys(cluster.workers[0], 4)
        w.wait(w.push(keys, np.ones(8, np.float32), cmd=7))
        with pytest.raises(RuntimeError, match="failed server-side"):
            w.wait(w.push(keys, np.ones(8, np.float32), cmd=13))
        assert seen == [7, 7, 13, 13]
        w.stop()
    finally:
        for s in servers:
            s.stop()
        cluster.finalize()


def test_heartbeats_and_resender_keep_a_lossy_cluster_working():
    """Heartbeats every 50 ms reach the scheduler; with 20 % of messages
    dropped, the resender still delivers every push and pull."""
    cluster = PortCluster(num_servers=2, env_extra={
        "PS_HEARTBEAT_INTERVAL": "0.05", "PS_RESEND": "1",
        "PS_RESEND_TIMEOUT": "100", "PS_DROP_MSG": "20"})
    cluster.start()
    servers = []
    try:
        servers = servers_with(PORT, cluster, PORT.DefaultHandle)
        w = tps.KVWorker(0, 0, postoffice=cluster.workers[0])
        keys = _spread_keys(cluster.workers[0], 6)
        vals = np.arange(18, dtype=np.float32)
        for _ in range(3):
            w.wait(w.push(keys, vals))
        out = np.zeros_like(vals)
        w.wait(w.pull(keys, out))
        np.testing.assert_array_equal(out, 3 * vals)
        time.sleep(0.2)
        sched = cluster.scheduler
        assert sched.get_dead_nodes(5.0) == []
        assert all(n in sched._heartbeats
                   for n in (worker_rank_to_id(0), server_rank_to_id(1)))
        w.stop()
    finally:
        for s in servers:
            s.stop()
        cluster.finalize()


def test_load_server_store_carries_a_jax_handle():
    """A port optimizer handle seeded from a JAX handle's store and
    slots continues bit-equal to it under the same pushes."""
    rng = np.random.default_rng(9)
    jh = jps.KVServerOptimizerHandle(kind="adam", lr=0.01)
    th = tps.KVServerOptimizerHandle(kind="adam", lr=0.01)
    meta_j = jps.KVMeta(push=True)
    meta_t = tps.KVMeta(push=True)
    keys = np.array([2, 4], np.uint64)
    for _ in range(3):
        g = rng.normal(size=6).astype(np.float32)
        jh.apply_shard(meta_j, keys, [g[:3], g[3:]])
    convert.load_server_store(th, jh.store, jh)
    for _ in range(2):
        g = rng.normal(size=6).astype(np.float32)
        jh.apply_shard(meta_j, keys, [g[:3], g[3:]])
        th.apply_shard(meta_t, keys, [g[:3], g[3:]])
    assert_same((th.store, th._m, th._v, th._t),
                (jh.store, jh._m, jh._v, jh._t))
    dh = tps.KVServerDefaultHandle()
    convert.load_server_store(dh, {3: np.ones(2, np.float32)})
    assert_same(dh.store, {3: np.ones(2, np.float32)})
    with pytest.raises(AssertionError, match="optimizer slots"):
        convert.load_server_store(dh, {}, slots=jh)


def test_port_tensor_values_on_the_message_path():
    """A CPU tensor pushes like its numpy array; the result is host
    numpy, as in JAX."""
    cluster = PortCluster()
    cluster.start()
    srv = None
    try:
        srv = tps.KVServer(0, postoffice=cluster.servers[0])
        srv.set_request_handle(tps.KVServerDefaultHandle())
        w = tps.KVWorker(0, 0, postoffice=cluster.workers[0])
        keys = np.array([1, 2], np.uint64)
        w.wait(w.push(keys, torch.arange(6, dtype=torch.float32)))
        out = np.zeros(6, np.float32)
        w.wait(w.pull(keys, out))
        np.testing.assert_array_equal(out, np.arange(6, dtype=np.float32))
        w.stop()
    finally:
        if srv is not None:
            srv.stop()
        cluster.finalize()


def test_failure_detector_declares_a_silent_worker_dead():
    """Heartbeats every 50 ms, timeout 0.3 s: a worker whose van stops
    (its heartbeats with it) is declared dead by the scheduler; every
    server learns it through NODE_FAILURE (hook and down mark), and a
    data send to it then fails fast with PeerDeadError."""
    from pslite_tpu_torch.message import Message
    from pslite_tpu_torch.vans.van import PeerDeadError

    cluster = PortCluster(num_workers=2, num_servers=1, env_extra={
        "PS_HEARTBEAT_INTERVAL": "0.05", "PS_HEARTBEAT_TIMEOUT": "0.3"})
    cluster.start()
    server = cluster.servers[0]
    events = []
    server.register_node_failure_hook(lambda n, down: events.append((n,
                                                                     down)))
    dead = cluster.workers[1]
    dead_id = dead.van.my_node.id
    try:
        dead.van.stop()
        end = time.monotonic() + DEADLINE
        while not server.van.is_peer_down(dead_id):
            assert time.monotonic() < end, "the silent worker was never " \
                                           "declared dead"
            time.sleep(0.05)
        assert (dead_id, True) in events
        assert dead_id in cluster.scheduler.get_dead_nodes(0.3)
        msg = Message()
        msg.meta.recver = dead_id
        with pytest.raises(PeerDeadError):
            server.van.send(msg)
    finally:
        run_all([lambda po=po: po.finalize(do_barrier=False)
                 for po in cluster.all_nodes() if po is not dead],
                "cluster finalize")


def test_custom_slicer_and_customer_executor():
    """``set_slicer`` decides which server gets which keys (here all to
    server 0), and a server customer with ``PS_CUSTOMER_EXECUTOR=1``
    (handlers on their own thread) answers the same."""
    cluster = PortCluster(num_servers=2,
                          env_extra={"PS_CUSTOMER_EXECUTOR": "1"})
    cluster.start()
    servers = []
    try:
        servers = servers_with(PORT, cluster, PORT.DefaultHandle)
        w = tps.KVWorker(0, 0, postoffice=cluster.workers[0])
        w.set_slicer(lambda kvs, ranges: [kvs] + [None] * (len(ranges) - 1))
        keys = _spread_keys(cluster.workers[0], 4)
        vals = np.arange(8, dtype=np.float32)
        w.wait(w.push(keys, vals))
        out = np.zeros_like(vals)
        w.wait(w.pull(keys, out))
        np.testing.assert_array_equal(out, vals)
        assert [len(s._handle.store) for s in servers] == [4, 0]
        w.stop()
    finally:
        for s in servers:
            s.stop()
        cluster.finalize()
