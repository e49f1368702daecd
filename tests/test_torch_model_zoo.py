"""pslite_tpu_torch's CNN and DLRM against the JAX package's
``models/cnn.py`` and ``models/dlrm.py``.

The JAX CNN step runs ``shard_map`` over a ``dp`` mesh of the 8 virtual
CPU devices of ``tests/conftest.py``, JAX's DLRM step a CPU
``CollectiveEngine`` and ``SparseEngine`` on them; the port runs on
``DeviceGroup(8, device="cpu")`` (the plain versions of K4's ring and of
the sparse row kernels S1-S3).  Params are JAX's, carried across as the
flat store (``convert.flat_from_jax``) or the MLP bucket.

Tolerances:
- the CNN forward in float64 within rtol/atol 1e-9, in float32 with
  bfloat16 convs at JAX's bars for bfloat16 (rtol 5e-2 / atol 2e-2);
  one PS step's loss within rtol 1e-3 and its store within ``2**-4`` of
  the largest update: each conv rounds its outputs, and in the backward
  pass its cotangents, to bfloat16, and XLA's convs and the port's
  grouped ``F.conv2d`` accumulate in other orders, so a value can land a
  bfloat16 ulp (``2**-8`` relative) apart at each of the six bfloat16
  products along the backward chain (head, four convs, the stem), and
  a ReLU gate can flip (measured: 0.019-0.031 of the largest update);
  the same step in float64 agrees within ``2**-22`` of it (the logits
  are float32 in both packages), which pins the gradients themselves;
- DLRM runs in float32 with no bfloat16: the loss within rtol 1e-6
  after each of 3 steps, and the MLP, the table and the row-wise Adagrad
  accumulator after them within rtol 1e-5 / atol 1e-6 (the dense
  optimizers' bar: products feeding adds may fuse into FMAs, and
  duplicate rows add in another order);
- the serving helpers are exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pslite_tpu.models import cnn as jc
from pslite_tpu.models import dlrm as jd
from pslite_tpu.parallel import CollectiveEngine as JEngine
from pslite_tpu.parallel import default_mesh
from pslite_tpu.parallel.sparse import SparseEngine as JSparse
from pslite_tpu_torch import (CollectiveEngine, DeviceGroup, KVServer,
                              KVServerDefaultHandle, KVWorker, SparseEngine)
from pslite_tpu_torch.convert import flat_from_jax, params_from_jax
from pslite_tpu_torch.models import cnn as tc
from pslite_tpu_torch.models import dlrm as td
from pslite_tpu_torch.models.ps_step import tree_leaves
from pslite_tpu_torch.ops import sparse_rows

from test_torch_msg_plane import (  # noqa: F401 - the fixture runs by name
    PortCluster,
    _port_loopback_isolation,
)
from torch_model_fixtures import (  # noqa: F401 - fixtures run by name
    _one_torch_thread, x64,
)

W = 8


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("dtype,size", [("float64", 8), ("float64", 9),
                                        ("float32", 16)])
def test_cnn_forward_and_init_match_jax(request, dtype, size):
    """The forward (stride-2 blocks with ``padding="SAME"``: (0, 1) on an
    even size, (1, 1) on an odd one) and ``init_params``' layout."""
    if dtype == "float64":
        request.getfixturevalue("x64")
    bar = (dict(rtol=1e-9, atol=1e-9) if dtype == "float64"
           else dict(rtol=5e-2, atol=2e-2))
    kw = dict(num_classes=4, channels=(8, 16), image_size=size, dtype=dtype)
    jcfg, tcfg = jc.CNNConfig(**kw), tc.CNNConfig(**kw)
    params = jc.init_params(jax.random.PRNGKey(0), jcfg)
    images, _ = jc.toy_batch(jcfg, batch=4, seed=0)
    images = images.astype(dtype)
    want = np.asarray(jax.jit(lambda p, x: jc.forward(p, x, jcfg))(
        params, jnp.asarray(images)))
    got = tc.forward(params_from_jax(_np_tree(params)),
                     torch.tensor(images), tcfg)
    np.testing.assert_allclose(got.numpy(), want, **bar)
    tp = tc.init_params(torch.Generator().manual_seed(0), tcfg)
    assert ([tuple(x.shape) for x in tree_leaves(tp)]
            == [x.shape for x in jax.tree.leaves(params)])


def _cnn_step(dtype, steps):
    """One step of JAX's CNN PS cycle over dp 8 from its params, and
    ``steps`` of the port's from the same params: (JAX loss, port
    losses, JAX store, port store after one step, initial flat)."""
    kw = dict(num_classes=4, channels=(8, 16), image_size=8, dtype=dtype)
    jcfg, tcfg = jc.CNNConfig(**kw), tc.CNNConfig(**kw)
    step, store, bs = jc.make_ps_train_step(
        jcfg, default_mesh(axis_name="dp"), lr=0.05)
    group = DeviceGroup(W, device="cpu", axis_name="dp")
    tstep, tstore = tc.make_ps_train_step(tcfg, group, lr=0.05)
    flat0 = flat_from_jax(_np_tree(jc.init_params(jax.random.PRNGKey(0),
                                                  jcfg)))
    tstore.engine.set_store_array(tstore.name, flat0)
    images, labels = jc.toy_batch(jcfg, batch=32, seed=0)
    images = images.astype(dtype)
    store, loss = step(store, jax.device_put(images, bs),
                       jax.device_put(labels, bs))
    losses = [float(tstep(images, labels))]
    ts = tstore.array().numpy()
    losses += [float(tstep(images, labels)) for _ in range(steps - 1)]
    return float(loss), losses, np.asarray(store), ts, flat0


def test_cnn_ps_step_matches_jax_and_loss_decreases():
    """One step of the CNN's PS cycle in float32 against JAX's, then
    JAX's ``test_cnn_ps_training_loss_decreases`` (12 steps at lr 0.05)
    on the port."""
    jl, losses, js, ts, flat0 = _cnn_step("float32", 12)
    upd = np.abs(js[:flat0.size] - flat0).max()
    assert upd > 1e-3
    np.testing.assert_allclose(losses[0], jl, rtol=1e-3)
    np.testing.assert_allclose(ts, js, rtol=0, atol=2.0 ** -4 * upd)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9, losses


def test_cnn_ps_step_float64_matches_jax(x64):
    """The same step in float64 (convs in float64): the gradients of the
    two packages agree to the float32 logits' rounding."""
    jl, losses, js, ts, flat0 = _cnn_step("float64", 1)
    upd = np.abs(js[:flat0.size] - flat0).max()
    assert upd > 1e-3
    np.testing.assert_allclose(losses[0], jl, rtol=1e-12)
    np.testing.assert_allclose(ts, js, rtol=0, atol=2.0 ** -22 * upd)


def _dlrm_cfgs():
    kw = dict(num_rows=256, emb_dim=8, num_cat=3, num_dense=4, hidden=32)
    return jd.DLRMConfig(**kw), td.DLRMConfig(**kw)


@pytest.mark.parametrize("opt", [None, "row_adagrad"],
                         ids=["sgd", "row_adagrad"])
def test_dlrm_steps_match_jax(opt):
    """Three hybrid steps (the MLP through K4's ``sum`` push, the rows
    through S3 and S1 or S2) from JAX's MLP: each loss, then the MLP,
    the table and the accumulator against JAX's."""
    jcfg, tcfg = _dlrm_cfgs()
    mesh = default_mesh()
    jeng = JEngine(mesh=mesh)
    jsp = JSparse(mesh, jeng.axis)
    jstep = jd.make_train_step(jcfg, jeng, jsp, lr=0.2, emb_optimizer=opt)
    group = DeviceGroup(W, device="cpu")
    teng = CollectiveEngine(group, impl="ring")
    tsp = SparseEngine(group)
    tstep = td.make_train_step(tcfg, teng, tsp, lr=0.2, emb_optimizer=opt)
    teng.set_store_array("dlrm_mlp", np.array(jeng.pull("dlrm_mlp")))
    idx, dense, labels = jd.toy_batch(jcfg, workers=W, batch=16, seed=1)
    sparse_rows.reset_launches()
    for _ in range(3):
        want = float(jstep(idx, dense, labels))
        np.testing.assert_allclose(float(tstep(idx, dense, labels)), want,
                                   rtol=1e-6)
    assert sum(sparse_rows.launches.values()) == 0  # CPU: plain versions
    bar = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(teng.pull("dlrm_mlp").numpy(),
                               np.asarray(jeng.pull("dlrm_mlp")), **bar)
    np.testing.assert_allclose(tsp.store_array("dlrm_emb").numpy(),
                               np.asarray(jsp.store_array("dlrm_emb")), **bar)
    if opt:
        np.testing.assert_allclose(tsp.acc_array("dlrm_emb").numpy(),
                                   np.asarray(jsp.acc_array("dlrm_emb")),
                                   **bar)


@pytest.mark.parametrize("opt", [None, "row_adagrad"],
                         ids=["sgd", "row_adagrad"])
def test_dlrm_loss_decreases(opt):
    """JAX's ``test_dlrm_hybrid_training_loss_decreases`` and its
    row-wise Adagrad twin on the port: 15 steps, the loss falls, the
    table learned, the accumulator tracked G**2."""
    _, cfg = _dlrm_cfgs()
    group = DeviceGroup(W, device="cpu")
    sparse = SparseEngine(group)
    step = td.make_train_step(cfg, CollectiveEngine(group, impl="ring"),
                              sparse, lr=0.2, emb_optimizer=opt)
    idx, dense, labels = td.toy_batch(cfg, workers=W, batch=16, seed=1)
    losses = [float(step(idx, dense, labels)) for _ in range(15)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.95, losses
    assert np.abs(sparse.store_array("dlrm_emb").numpy()).max() > 0
    if opt:
        assert (sparse.acc_array("dlrm_emb").numpy() > 0).any()


def test_dlrm_unknown_optimizer_refused():
    _, cfg = _dlrm_cfgs()
    group = DeviceGroup(W, device="cpu")
    with pytest.raises(Exception, match="unknown emb_optimizer"):
        td.make_train_step(cfg, CollectiveEngine(group), SparseEngine(group),
                           emb_optimizer="adam")


def test_dlrm_serving_helpers_match_jax_and_serve_exact_rows():
    """The serving helpers give JAX's values bit for bit, and the storms
    run over a port cluster of 2 servers with every checked row exact
    (the fan-out on the spread key layout touches both)."""
    kw = dict(num_rows=64, emb_dim=8)
    jcfg, tcfg = jd.DLRMConfig(**kw), td.DLRMConfig(**kw)
    for r in (0, 5, 63):
        np.testing.assert_array_equal(td.embedding_row(tcfg, r),
                                      jd.embedding_row(jcfg, r))
    np.testing.assert_array_equal(td.spread_row_keys(tcfg),
                                  jd.spread_row_keys(jcfg))
    np.testing.assert_array_equal(td.serving_keys(tcfg, 100, 3),
                                  jd.serving_keys(jcfg, 100, 3))
    for a, b in zip(td.toy_batch(tcfg, 2, 5, seed=4),
                    jd.toy_batch(jcfg, 2, 5, seed=4)):
        np.testing.assert_array_equal(a, b)
    for spread in (True, False):  # one cluster each: both hold key 0
        cluster = PortCluster(num_workers=1, num_servers=2)
        cluster.start()
        servers = []
        try:
            for po in cluster.servers:
                srv = KVServer(0, postoffice=po)
                srv.set_request_handle(KVServerDefaultHandle())
                servers.append(srv)
            worker = KVWorker(0, 0, postoffice=cluster.workers[0])
            td.push_embedding_table(worker, tcfg, spread=spread)
            if spread:
                assert all(len(s._handle.store) for s in servers)
                lats = td.serve_fanout_storm(worker, tcfg, 4, fanout=8,
                                             check_every=1)
                assert len(lats) == 4 and min(lats) > 0
            else:
                lats = td.serve_embedding_storm(worker, tcfg, 16,
                                                check_every=1)
                assert len(lats) == 16
            worker.stop()
        finally:
            for s in servers:
                s.stop()
            cluster.finalize()
