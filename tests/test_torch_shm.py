"""pslite_tpu_torch's shared-memory van against the JAX package's, across
real OS processes on one host.

Clusters of ``tests/torch_mixed_child.py`` processes over ``shm`` (meta
over the socket, payloads through /dev/shm segments whose names both
packages derive alike): a JAX worker against port servers and the
reverse, each pulling into ``alloc_pull_buffer`` (the servers write the
pull response straight into the worker's segment); ``multi`` with 2 shm
rails; a port ``ici_shm`` worker process on a CPU device group.  Stores
and pulls are bit-equal to an all-JAX tcp cluster's (tolerance: none),
and no segment of the run is left in /dev/shm afterwards.  Every child
has its own deadline and is killed after it.
"""

import os
import threading

import numpy as np
import pytest

import pslite_tpu_torch as tps
from pslite_tpu_torch.environment import Environment
from pslite_tpu_torch.utils.network import get_available_port
from pslite_tpu_torch.vans.shm_van import SHM_DIR

from test_torch_tcp import (  # noqa: F401 - jax_reference is a fixture
    MIXES,
    PLANES,
    assert_bit_equal,
    assert_chunked,
    assert_plane,
    cluster_env,
    jax_reference,
    results,
    run_cluster,
)


def shm_env(van="shm", **extra):
    env = cluster_env(van, **extra)
    env["PS_SHM_NS"] = f"torchtest{env['DMLC_PS_ROOT_PORT']}"
    return env


def leftover_segments(env):
    return [f for f in os.listdir(SHM_DIR) if env["PS_SHM_NS"] in f]


@pytest.mark.parametrize("plane", sorted(PLANES))
@pytest.mark.parametrize("mix", ["jax_worker_port_servers",
                                 "port_worker_jax_servers"])
def test_mixed_shm_cluster_with_zero_copy_pulls(tmp_path, jax_reference,
                                                mix, plane):
    """On both of the port's planes: the native core's sockets (and its
    copy pool for the segments) or Python's."""
    env = shm_env(**PLANES[plane])
    procs = [(pkg, roles, {"PSTEST_ZPULL": "1"})
             for pkg, roles, _ in MIXES[mix]]
    reports = run_cluster(tmp_path, env, procs)
    assert_bit_equal(results(tmp_path), jax_reference)
    assert_chunked(reports)
    worker = [r for r in reports if "worker" in r["roles"]][0]
    assert worker["zpull_hits"] == 1  # the pull skipped reassembly
    assert_plane(reports, plane)
    assert not leftover_segments(env)


def test_multi_shm_rails_and_ici_shm_worker(tmp_path, jax_reference):
    """``multi`` over 2 shm rails (a JAX worker against port servers),
    then a port ``ici_shm`` worker process (engine on a CPU group of 8
    ranks) against a JAX scheduler and servers."""
    env = shm_env("multi", DMLC_NUM_PORTS="2", PS_MULTI_RAIL_VAN="shm")
    (tmp_path / "multi").mkdir()
    reports = run_cluster(tmp_path / "multi", env,
                          MIXES["jax_worker_port_servers"])
    assert_bit_equal(results(tmp_path / "multi"), jax_reference)
    assert_chunked(reports)
    assert not leftover_segments(env)
    env = shm_env("ici_shm")
    (tmp_path / "ici").mkdir()
    reports = run_cluster(tmp_path / "ici", env, [
        ("jax", ["scheduler", "server", "server"], {}),
        ("port", ["worker"], {"PSTEST_CPU_GROUP": "8"})])
    assert_bit_equal(results(tmp_path / "ici"), jax_reference)
    assert [r["bucket_steps"] for r in reports if r["pkg"] == "port"] == [3]
    assert not leftover_segments(env)


def _port_cluster(van_env, ns=None, handle=None):
    env = {"DMLC_NUM_WORKER": "1", "DMLC_NUM_SERVER": "1",
           "DMLC_PS_ROOT_URI": "127.0.0.1",
           "DMLC_PS_ROOT_PORT": str(get_available_port()),
           "DMLC_NODE_HOST": "127.0.0.1", "PS_VAN_TYPE": "shm", **van_env}
    env["PS_SHM_NS"] = ns or f"torchtest{env['DMLC_PS_ROOT_PORT']}"
    nodes = [tps.Postoffice(r, env=Environment(env))
             for r in ("scheduler", "server", "worker")]
    threads = [threading.Thread(target=po.start) for po in nodes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert all(po.van.ready.is_set() for po in nodes)
    srv = tps.KVServer(0, postoffice=nodes[1])
    srv.set_request_handle(handle or tps.KVServerDefaultHandle())
    return env, nodes, srv, tps.KVWorker(0, 0, postoffice=nodes[2])


def _finalize(nodes, apps):
    for a in apps:
        a.stop()
    threads = [threading.Thread(target=po.finalize) for po in nodes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)


@pytest.mark.parametrize("min_bytes,segments", [("4096", 2), ("1073741824",
                                                                0)])
def test_payloads_below_the_threshold_ride_the_socket(min_bytes, segments):
    """A push and a pull of 64 KiB: through one segment each way, or,
    below ``PS_SHM_MIN_BYTES``, over the socket (no segment at all)."""
    env, nodes, srv, w = _port_cluster({"PS_SHM_MIN_BYTES": min_bytes})
    try:
        keys = np.array([3], np.uint64)
        vals = np.arange(16384, dtype=np.float32)
        w.wait(w.push(keys, vals))
        out = np.zeros_like(vals)
        w.wait(w.pull(keys, out))
        np.testing.assert_array_equal(out, vals)
        assert len(leftover_segments(env)) == segments
    finally:
        _finalize(nodes, [w, srv])
    assert not leftover_segments(env)


def test_free_pull_buffer_unlinks_its_segment():
    env, nodes, srv, w = _port_cluster({})
    try:
        keys = np.array([5, 6], np.uint64)
        w.wait(w.push(keys, np.ones(8, np.float32)))
        buf = w.alloc_pull_buffer(keys, 4)
        w.wait(w.pull(keys, buf))
        np.testing.assert_array_equal(buf, np.ones(8, np.float32))
        assert w.zpull_hits == 1
        assert [f for f in leftover_segments(env) if "pslpull" in f]
        del buf
        w.free_pull_buffer(keys)
        assert not [f for f in leftover_segments(env) if "pslpull" in f]
    finally:
        _finalize(nodes, [w, srv])
    assert not leftover_segments(env)


class _HeldPushHandle(tps.KVServerDefaultHandle):
    """The default handle, but a push's values are read only once
    ``gate`` is set (``arrived`` tells that one is waiting): the pushed
    payload stays a view of the sender's segment meanwhile."""

    def __init__(self):
        super().__init__()
        self.arrived, self.gate = threading.Event(), threading.Event()

    def apply_shard(self, meta, keys, segs):
        if meta.push:
            self.arrived.set()
            assert self.gate.wait(30)
        return super().apply_shard(meta, keys, segs)


def _overlapped_pushes(ns_a, ns_b):
    """Two shm clusters up at once, each 1 scheduler + 1 server + 1
    worker: cluster A's push of 2 keys x 16 KiB is held at its server
    while cluster B pushes other values to the same keys; then A's push
    is applied, and each worker pulls into a registered (zero-copy) pull
    buffer.  Returns both clusters' (pushed, pulled) values and their
    environments; every node is finalized."""
    held = _HeldPushHandle()
    a = _port_cluster({}, ns=ns_a, handle=held)
    b = None
    try:
        b = _port_cluster({}, ns=ns_b)
        keys = np.array([3, 4], np.uint64)
        va = np.arange(8192, dtype=np.float32)
        vb = va + 1000
        ts = a[3].push(keys, va)
        assert held.arrived.wait(30)
        b[3].wait(b[3].push(keys, vb))
        held.gate.set()
        a[3].wait(ts)
        out = []
        for (_env, _nodes, _srv, w), pushed in ((a, va), (b, vb)):
            buf = w.alloc_pull_buffer(keys, 4096)
            w.wait(w.pull(keys, buf))
            out.append((pushed, np.array(buf)))
            del buf
            w.free_pull_buffer(keys)
        return out, a[0], b[0]
    finally:
        held.gate.set()
        for c in (b, a):
            if c is not None:
                _finalize(c[1], [c[3], c[2]])


def test_two_clusters_sharing_one_namespace_share_their_segments():
    """Queue 3's shm fault, on the CPU: a push segment is named by the
    namespace, the sender and receiver ids and the key, so two clusters
    up at once under one ``PS_SHM_NS`` (chip_smoke's plane legs gave
    their two clusters one) write one segment.  Cluster A's server reads
    cluster B's values in place of its own worker's."""
    ns = f"torchshared{get_available_port()}"
    ((pa, got_a), (pb, got_b)), env_a, _ = _overlapped_pushes(ns, ns)
    np.testing.assert_array_equal(got_b, pb)
    np.testing.assert_array_equal(got_a, pb)  # B's values, not A's
    assert not np.array_equal(got_a, pa)
    assert not leftover_segments(env_a)


def test_two_clusters_with_their_own_namespaces_are_exact():
    """The fix: each cluster under its own namespace.  The same
    overlapped pushes, and each worker pulls exactly its own values
    through its registered buffer; neither namespace leaves a segment."""
    port = get_available_port()
    ((pa, got_a), (pb, got_b)), env_a, env_b = _overlapped_pushes(
        f"torchns{port}a", f"torchns{port}b")
    np.testing.assert_array_equal(got_a, pa)
    np.testing.assert_array_equal(got_b, pb)
    assert not leftover_segments(env_a) and not leftover_segments(env_b)


def test_chip_smoke_plane_legs_take_their_own_namespaces():
    """``chip_smoke.py``'s plane legs (two clusters up at once) each
    take a namespace of their own from one ``PS_SHM_NS``; a leg without
    one gets none."""
    import chip_smoke

    planes = (("native", {"PS_SHM_RING": "1"}), ("python", {"PS_NATIVE": "0"}))
    envs = [chip_smoke.leg_env({"PS_SHM_NS": "c3", "ENABLE_RECV_BUFFER": "1"},
                               plane, env) for plane, env in planes]
    assert [e["PS_SHM_NS"] for e in envs] == ["c3native", "c3python"]
    assert all(e["ENABLE_RECV_BUFFER"] == "1" for e in envs)
    assert envs[0]["PS_SHM_RING"] == "1" and envs[1]["PS_NATIVE"] == "0"
    assert chip_smoke.leg_env(None, "native", {}) == {}
