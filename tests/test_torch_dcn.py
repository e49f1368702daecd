"""The port's cross-slice (DCN) tier beside the JAX package's, on the
same inputs: ``tests/test_dcn.py``'s two cases, each through both.

Two slices of 4 ranks (a CPU ``DeviceGroup(4)`` per slice leader; JAX
slices of 4 devices of the 8-device CPU mesh) exchange their slice sums
through 2 servers over the tcp van.  A round that starts from zero stores
is bit-exact between the two packages: each slice sum is the rank-order
sum, and the servers add the two slices, which commute.  Later rounds add
in arrival order, so they are held, as in JAX's test, against one flat
8-rank engine within 1e-5; int8 within JAX's bound, with the wire bytes
cut.
"""

import threading

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from pslite_tpu import KVServer as JaxServer
from pslite_tpu import KVServerDefaultHandle as JaxHandle
from pslite_tpu import KVWorker as JaxWorker
from pslite_tpu.parallel import CollectiveEngine as JaxEngine
from pslite_tpu.parallel.dcn import DcnKVWorker as JaxDcn

import pslite_tpu_torch as tps
from pslite_tpu_torch.environment import Environment
from pslite_tpu_torch.parallel.dcn import DcnKVWorker
from pslite_tpu_torch.utils.network import get_available_port

from helpers import LoopbackCluster


def _jax_slices():
    devs = jax.devices()
    return [Mesh(np.asarray(devs[:4]), ("kv",)),
            Mesh(np.asarray(devs[4:8]), ("kv",))]


def _port_cluster():
    env = {"DMLC_NUM_WORKER": "2", "DMLC_NUM_SERVER": "2",
           "DMLC_PS_ROOT_URI": "127.0.0.1",
           "DMLC_PS_ROOT_PORT": str(get_available_port()),
           "DMLC_NODE_HOST": "127.0.0.1", "PS_VAN_TYPE": "tcp"}
    nodes = [tps.Postoffice(r, env=Environment(env)) for r in
             ("scheduler", "server", "server", "worker", "worker")]
    _run([po.start for po in nodes])
    return nodes


def _run(fns, timeout=60):
    errors = []

    def wrap(fn):
        try:
            fn()
        except Exception as exc:  # noqa: BLE001 - raised below
            errors.append(exc)

    threads = [threading.Thread(target=wrap, args=(f,), daemon=True)
               for f in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "a node hung"
    assert not errors, errors


def _slices(port: bool, body, compress=None):
    """``body(slice_id, leader) -> result`` on both slice leaders of a
    fresh cluster of the port (``port``) or of JAX; their results and the
    workers' wire bytes."""
    if port:
        nodes = _port_cluster()
        servers, workers = nodes[1:3], nodes[3:]
        srvs = [tps.KVServer(0, postoffice=po) for po in servers]
        for s in srvs:
            s.set_request_handle(tps.KVServerDefaultHandle())

        def leader(i):
            eng = tps.CollectiveEngine(tps.DeviceGroup(4, device="cpu"))
            return DcnKVWorker(tps.KVWorker(0, 0, postoffice=workers[i]),
                               eng, compress=compress)
    else:
        cluster = LoopbackCluster(num_workers=2, num_servers=2,
                                  van_type="tcp")
        cluster.start()
        nodes, workers = None, cluster.workers
        srvs = [JaxServer(0, postoffice=po) for po in cluster.servers]
        for s in srvs:
            s.set_request_handle(JaxHandle())
        meshes = _jax_slices()

        def leader(i):
            return JaxDcn(JaxWorker(0, 0, postoffice=workers[i]),
                          JaxEngine(mesh=meshes[i]), compress=compress)
    results = {}
    try:
        _run([lambda i=i: results.__setitem__(i, body(i, leader(i)))
              for i in (0, 1)], timeout=120)
        wire = sum(po.van.send_bytes for po in workers)
    finally:
        for s in srvs:
            s.stop()
        if port:
            _run([po.finalize for po in nodes])
        else:
            cluster.finalize()
    return results, wire


def _flat(buckets, grads, rounds=1):
    flat = JaxEngine(mesh=Mesh(np.asarray(jax.devices()[:8]), ("kv",)))
    out = {}
    for n, (k, v) in buckets.items():
        flat.register_dense(n, k, v)
        for _ in range(rounds):
            out[n] = np.asarray(flat.push_pull(n, grads[n]))
    return out


def test_two_slices_match_jax_and_the_flat_group():
    keys = np.arange(4, dtype=np.uint64) + 10
    val_len = 50
    grads = np.random.default_rng(5).normal(size=(8, 4 * val_len)).astype(
        np.float32)

    def body(i, leader):
        leader.register_dense("g", keys, val_len)
        rows = grads[4 * i:4 * i + 4]
        outs = [leader.push_pull("g", rows) for _ in range(3)]
        dev = leader.to_device("g", outs[-1])
        return outs, np.asarray(dev.cpu() if hasattr(dev, "cpu") else dev)

    port, _ = _slices(True, body)
    jx, _ = _slices(False, body)
    expected = _flat({"g": (keys, val_len)}, {"g": grads}, rounds=3)["g"]
    for i in (0, 1):
        outs, dev = port[i]
        np.testing.assert_array_equal(outs[0], jx[i][0][0])
        for out in (outs[-1], dev):
            np.testing.assert_allclose(out, expected, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("compress", [None, "int8"])
def test_group_overlap_and_int8_compression(compress):
    """Overlapped multi-bucket rounds: the plain run bit-exact with
    JAX's; int8 within JAX's bound of the flat group, with a quarter of
    the payload bytes on the wire."""
    buckets = {"a": (np.arange(3, dtype=np.uint64), 4096),
               "b": (np.arange(3, dtype=np.uint64) + 100, 2048),
               "c": (np.arange(2, dtype=np.uint64) + 200, 1024)}
    rng = np.random.default_rng(11)
    grads = {n: rng.normal(size=(8, len(k) * v)).astype(np.float32)
             for n, (k, v) in buckets.items()}

    def body(i, leader):
        for n, (k, v) in buckets.items():
            leader.register_dense(n, k, v)
        names = list(buckets)
        outs = leader.push_pull_group(
            names, [grads[n][4 * i:4 * i + 4] for n in names])
        return dict(zip(names, outs))

    port, wire = _slices(True, body, compress)
    expected = _flat(buckets, grads)
    if compress is None:
        jx, _ = _slices(False, body)
        for i in (0, 1):
            for n in buckets:
                np.testing.assert_array_equal(port[i][n], jx[i][n])
        return
    _, wire_raw = _slices(True, body)
    for i in (0, 1):
        for n in buckets:
            err = np.abs(port[i][n] - expected[n]).max()
            scale = np.abs(expected[n]).max()
            # Three quantizations (2 pushes and 1 pull response), each
            # within about max|block| / 127.
            assert err < 0.05 * max(scale, 1.0), (n, err, scale)
    assert wire < 0.5 * wire_raw, (wire, wire_raw)
