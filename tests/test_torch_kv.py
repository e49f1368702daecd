"""pslite_tpu_torch's KVWorker and lifecycle against the JAX package.

The README's ICI snippet runs through both packages: the JAX KVWorker
over an in-process cluster with the ici van (8 virtual CPU devices), the
port's KVWorker over a worker Postoffice with ``DeviceGroup(8,
device="cpu")`` (alone, without a cluster) or over an ``ici`` cluster
(``PortCluster`` of test_torch_msg_plane.py).  Sums are bit-exact: both
add the worker rows in rank order.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from pslite_tpu import KVWorker as JaxKVWorker
from pslite_tpu_torch import DeviceGroup, KVWorker, Postoffice
from pslite_tpu_torch import ps as tps
from pslite_tpu_torch.environment import Environment
from pslite_tpu_torch.kv import kv_app as tps_kv

from helpers import LoopbackCluster
from test_torch_msg_plane import PortCluster, by_address
from test_torch_msg_plane import _port_loopback_isolation  # noqa: F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_worker(handle="sum", impl="xla"):
    po = Postoffice("worker", env=Environment({
        "PS_ICI_SERVER_HANDLE": handle, "PS_ICI_IMPL": impl,
        "PS_VAN_TYPE": "ici"}))
    po.van.set_mesh(DeviceGroup(8, device="cpu"))
    po.start()
    return po, KVWorker(0, 0, postoffice=po)


@pytest.fixture()
def port_worker():
    po, worker = _port_worker()
    yield worker
    worker.stop()
    po.finalize()


def test_readme_snippet_matches_jax(port_worker):
    keys = np.arange(8, dtype=np.uint64)
    rng = np.random.RandomState(0)
    steps = [np.ones(8 * 50, np.float32),  # the README's broadcast grads
             rng.randn(8, 8 * 50).astype(np.float32)]
    c = LoopbackCluster(num_workers=1, num_servers=1, van_type="ici")
    c.start()
    try:
        jw = JaxKVWorker(0, 0, postoffice=c.workers[0])
        jw.register_dense("grads", keys, val_len=50)
        want = []
        for g in steps:
            outs = np.zeros(8 * 50, np.float32)
            jw.wait(jw.push_pull(keys, g, outs))
            want.append(outs)
    finally:
        c.finalize()
    port_worker.register_dense("grads", keys, val_len=50)
    for g, w in zip(steps, want):
        outs = np.zeros(8 * 50, np.float32)
        ts = port_worker.push_pull(keys, g, outs)
        port_worker.wait(ts)
        np.testing.assert_array_equal(outs, w)
        dev = port_worker.get_pulled(ts)
        assert isinstance(dev, torch.Tensor) and dev.shape == (8 * 50,)
    np.testing.assert_array_equal(want[0], np.full(8 * 50, 8.0, np.float32))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_push_then_pull_through_the_worker(impl):
    po, worker = _port_worker("sum", impl)
    try:
        keys = np.arange(4, dtype=np.uint64) + 100
        worker.register_dense("acc", keys, 16)
        ones = np.ones(4 * 16, np.float32)
        ts = [worker.push(keys, ones) for _ in range(3)]
        for t in ts:
            worker.wait(t)
        out = np.zeros_like(ones)
        worker.wait(worker.pull(keys, out))
        np.testing.assert_array_equal(out, 3 * 8 * ones)
        dst = torch.zeros(4 * 16)
        worker.wait(worker.pull(keys, dst))
        assert torch.equal(dst, torch.from_numpy(out))
    finally:
        worker.stop()
        po.finalize()


def test_callback_fires_without_wait(port_worker):
    keys = np.arange(2, dtype=np.uint64) + 500
    port_worker.register_dense("cb", keys, 8)
    done = threading.Event()
    port_worker.push(keys, np.ones(16, np.float32), callback=done.set)
    assert done.wait(timeout=30), "engine-path callback never fired"


def test_unregistered_keys_raise(port_worker):
    """A worker without a cluster (no DMLC_PS_ROOT_URI) runs the data
    plane alone: a key set outside a registered bucket, ``lens`` or a
    custom ``cmd`` has no server to go to, and raises.  In a cluster the
    same calls fall back to messages (see
    test_torch_msg_plane.py::test_unregistered_keys_fall_back_to_messages
    for the comparison with the JAX IciVan)."""
    keys = np.arange(3, dtype=np.uint64)
    port_worker.register_dense("r", keys, 4)
    with pytest.raises(RuntimeError, match="message path needs a cluster"):
        port_worker.push(np.array([7777], np.uint64), np.ones(4, np.float32))
    with pytest.raises(RuntimeError, match="message path needs a cluster"):
        port_worker.pull(keys[:2], np.zeros(8, np.float32))
    with pytest.raises(RuntimeError, match="message path needs a cluster"):
        port_worker.push_pull(keys, np.ones(12, np.float32),
                              np.zeros(12, np.float32), cmd=3)

    cluster = PortCluster(van_type="ici")
    cluster.start()
    srv = tps_kv.KVServer(0, postoffice=cluster.servers[0])
    srv.set_request_handle(tps_kv.KVServerDefaultHandle())
    try:
        w = KVWorker(0, 0, postoffice=cluster.workers[0])
        w.register_dense("r", keys, 4)
        w.wait(w.push(np.array([7777], np.uint64), np.ones(4, np.float32)))
        w.wait(w.push(keys, np.ones(12, np.float32), cmd=3))
        out = np.zeros(8, np.float32)
        w.wait(w.pull(keys[:2], out))
        np.testing.assert_array_equal(out, np.ones(8, np.float32))
        assert sorted(srv._handle.store) == [0, 1, 2, 7777]
        w.stop()
    finally:
        srv.stop()
        cluster.finalize()


def test_other_roles_and_vans_not_ported():
    """``chaos`` and ``chaos+tcp`` build the chaos wrapper around the
    tcp van (``chaos+loopback`` around the loopback one); server and
    scheduler Postoffices start (over the ici van's loopback control
    plane) and finalize.  The servers' ids are 8 and 10 in the order of
    their addresses (bound on each node's own start thread, so not in
    creation order)."""
    from pslite_tpu_torch.vans.loopback_van import LoopbackVan
    from pslite_tpu_torch.vans.tcp_van import TcpVan

    for van, inner in (("chaos", TcpVan), ("chaos+tcp", TcpVan),
                       ("chaos+loopback", LoopbackVan)):
        po = Postoffice("worker", env=Environment({"PS_VAN_TYPE": van,
                                                   "PS_NATIVE": "0"}))
        assert type(po.van).__name__ == f"Chaos{inner.__name__}"
        assert type(po.van).__mro__[1] is inner
        assert not po.van.chaos_crashed.is_set()
    cluster = PortCluster(num_workers=1, num_servers=2, van_type="ici")
    cluster.start()
    try:
        assert cluster.scheduler.is_scheduler
        assert [po.van.my_node.id
                for po in by_address(cluster.servers)] == [8, 10]
        assert all(po.van.engine is None
                   for po in cluster.servers + [cluster.scheduler])
        assert cluster.workers[0].van.engine is not None
    finally:
        cluster.finalize()


def test_cuda_less_default_device_raises():
    """Without a card and without a CPU group, start_ps raises: nothing
    drops to the CPU silently."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tps.start_ps(env=Environment({"DMLC_ROLE": "worker",
                                          "PS_VAN_TYPE": "ici"}))
    with pytest.raises(KeyError):
        tps.postoffice()
    tps.finalize()


def test_start_ps_with_a_started_worker(monkeypatch):
    """start_ps/postoffice/finalize keep one worker Postoffice."""
    monkeypatch.setattr(
        "pslite_tpu_torch.vans.ici_van.IciVan.start",
        lambda self, customer_id=0: None)
    tps.start_ps(role="worker", env=Environment({"PS_VAN_TYPE": "ici"}))
    try:
        po = tps.postoffice()
        assert po.is_worker and tps.postoffice("WORKER") is po
        tps.start_ps(role="worker", env=Environment({"PS_VAN_TYPE": "ici"}))
        assert tps.postoffice() is po
    finally:
        tps.finalize()
    with pytest.raises(KeyError):
        tps.postoffice()


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pslite_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke, chip_trace_cells\n"
        "import glob, importlib.util, os\n"
        "for f in sorted(glob.glob('examples/torch/*.py')\n"
        "                + glob.glob('tools/*_phase.py')):\n"
        "    name = 'ex_' + os.path.basename(f)[:-3]\n"
        "    spec = importlib.util.spec_from_file_location(name, f)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "import ast\n"
        "srcs = (glob.glob('pslite_tpu_torch/**/*.py', recursive=True)\n"
        "        + glob.glob('examples/torch/*.py')\n"
        "        + glob.glob('tools/*_phase.py') + ['chip_smoke.py'])\n"
        "for f in srcs:  # imports inside functions too\n"
        "    for n in ast.walk(ast.parse(open(f).read())):\n"
        "        names = ([a.name for a in n.names]\n"
        "                 if isinstance(n, ast.Import) else\n"
        "                 [n.module or ''] if isinstance(n, ast.ImportFrom)\n"
        "                 and not n.level else [])\n"
        "        for m in names:\n"
        "            assert m.split('.')[0] not in ('jax', 'jaxlib',\n"
        "                                           'pslite_tpu'), (f, m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'pslite_tpu'))\n"
        "assert not bad, bad\n"
        "for m in ('ops.sparse_rows', 'parallel.sparse',\n"
        "          'models.embedding', 'base', 'range', 'sarray',\n"
        "          'message', 'wire', 'customer', 'postoffice', 'ps',\n"
        "          'telemetry', 'utils.queues', 'utils.bounded',\n"
        "          'utils.network', 'vans.van', 'vans.resender',\n"
        "          'vans.chunking', 'vans.loopback_van', 'vans.ici_van',\n"
        "          'vans.tcp_van', 'vans.shm_van', 'vans.multi_van',\n"
        "          'vans.chaos_van', 'kv.replication', 'kv.snapshot',\n"
        "          'kv.tiered', 'parallel.mesh', 'parallel.ring_attention',\n"
        "          'parallel.ulysses', 'parallel.moe', 'parallel.pipeline',\n"
        "          'models.transformer', 'models.ps_step', 'models.train',\n"
        "          'models.cnn', 'models.dlrm',\n"
        "          'tracker.local', 'kv.kv_app', 'kv.simple_app',\n"
        "          'parallel.distributed', 'parallel.peers', 'parallel.dcn',\n"
        "          'tracker.ssh', 'tracker.mpi', 'stress', 'benchmark',\n"
        "          'utils.xplane', 'tools.psmon', 'tools.pstrace'):\n"
        "    assert 'pslite_tpu_torch.' + m in sys.modules, m\n"
        "print('CLEAN', len([m for m in sys.modules\n"
        "                    if m.startswith('pslite_tpu_torch')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("CLEAN")
    # the message plane's and durability's modules included
    assert int(res.stdout.split()[1]) >= 49
