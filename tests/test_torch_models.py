"""pslite_tpu_torch's PSFormer and its PS training step against the JAX
package's ``models/transformer.py``, ``models/ps_step.py`` and
``models/train.py``.

The JAX step runs ``shard_map`` on the 8 virtual CPU devices of
``tests/conftest.py``; the port's on ``make_group((4, 2), ("dp", "sp"),
device="cpu")``, whose flat store is a CPU ``CollectiveEngine`` with
``impl="ring"`` (the plain version of K4's ring with the ``sgd`` handle).
Each step starts from JAX's params, carried across as its flat vector
(``convert.flat_from_jax``).

Tolerances of one step (the loss, and the store after it):
- float32 with bfloat16 matmuls: the loss within rtol 1e-5, every store
  element within ``2**-8`` (bfloat16's unit roundoff) of the largest
  update: the gradients are sums of bfloat16 products that round in
  other orders in the two packages, each within bfloat16's relative
  error of the exact sum;
- float64: the loss within rtol 1e-12, the store within ``2**-22`` of
  the largest update: the logits are float32 in both packages
  (transformer.py's final cast), so a float64 value that the two
  packages compute a few float64 ulps apart can round to neighbouring
  float32 logits, and the gradient inherits float32's rounding;
- the K4 push's own difference (``(lr / n) * agg`` against JAX's ``lr *
  (agg / n)``, another order of the ranks' rows) is a few float32 ulps of
  the update, inside both bars.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pslite_tpu.kv.kv_app import (KVServer as JKVServer,
                                  KVServerDefaultHandle as JHandle,
                                  KVWorker as JKVWorker)
from pslite_tpu.models import train as jtr
from pslite_tpu.models import transformer as jt
from pslite_tpu.parallel.mesh import make_mesh
from pslite_tpu_torch import KVServer, KVServerDefaultHandle, KVWorker
from pslite_tpu_torch.convert import flat_from_jax, params_from_jax
from pslite_tpu_torch.models import train as ttr
from pslite_tpu_torch.models import transformer as tt
from pslite_tpu_torch.models.ps_step import ravel_pytree, tree_leaves
from pslite_tpu_torch.ops import ring_collective
from pslite_tpu_torch.parallel import mesh as tm

from helpers import LoopbackCluster
from test_torch_msg_plane import (  # noqa: F401 - the fixture runs by name
    PortCluster,
    _port_loopback_isolation,
)
from torch_model_fixtures import (  # noqa: F401 - fixtures run by name
    _one_torch_thread, x64,
)


def _cfgs(**kw):
    return jt.ModelConfig(**kw), tt.ModelConfig(**kw)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("moe", [0, 4])
def test_init_params_layout_and_flat_order_match_jax(moe):
    """The port's params have JAX's keys, shapes, dtypes and scales, and
    its flat vector is ``ravel_pytree``'s: dict keys sorted (``embed,
    layers, ln_f``; per layer ``ln1, ln2, mlp_in, mlp_out, proj, qkv``,
    with ``moe`` between ``ln2`` and ``proj``)."""
    from jax.flatten_util import ravel_pytree as jravel

    jcfg, tcfg = _cfgs(vocab=48, dim=32, heads=2, layers=2, moe_experts=moe)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tt.init_params(torch.Generator().manual_seed(0), tcfg)
    jl, tl = jax.tree.leaves(jp), tree_leaves(tp)
    assert [a.shape for a in jl] == [tuple(b.shape) for b in tl]
    assert all(b.dtype == torch.float32 for b in tl)
    for a, b in zip(jl, tl):
        if a.ndim == 1:  # the norms: ones
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:  # N(0, 1) * dim**-0.5
            assert abs(float(b.std()) / float(jnp.std(a)) - 1) < 0.2
    flat, _ = jravel(jp)
    np.testing.assert_array_equal(flat_from_jax(_np_tree(jp)),
                                  np.asarray(flat))
    tflat, unravel = ravel_pytree(params_from_jax(_np_tree(jp)))
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(flat))
    back = unravel(tflat[None].expand(3, -1))  # any leading dims
    for a, b in zip(jl, tree_leaves(back)):
        np.testing.assert_array_equal(b[2].numpy(), np.asarray(a))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_single_device_forward_and_loss_match_jax(request, dtype):
    """``forward``/``loss_fn`` without a group, dense and MoE, remat on
    and off: float64 within 1e-9, float32 (bfloat16 matmuls) at JAX's
    bars."""
    if dtype == "float64":
        request.getfixturevalue("x64")
    bar = (dict(rtol=1e-9, atol=1e-9) if dtype == "float64"
           else dict(rtol=5e-2, atol=2e-2))
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 40, size=(2, 12)).astype(np.int32)
    targets = (tokens + 1) % 40
    for moe, remat in ((0, False), (4, True)):
        jcfg, tcfg = _cfgs(vocab=40, dim=32, heads=2, layers=2,
                           moe_experts=moe, remat=remat, dtype=dtype)
        jp = jt.init_params(jax.random.PRNGKey(moe), jcfg)
        tp = params_from_jax(_np_tree(jp))
        want = np.asarray(jax.jit(lambda p, t: jt.forward(p, t, jcfg))(
            jp, jnp.asarray(tokens)))
        got = tt.forward(tp, torch.tensor(tokens), tcfg)
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **bar)
        wl = float(jax.jit(lambda p, a, b: jt.loss_fn(p, a, b, jcfg))(
            jp, jnp.asarray(tokens), jnp.asarray(targets)))
        tl = float(tt.loss_fn(tp, torch.tensor(tokens),
                              torch.tensor(targets), tcfg))
        np.testing.assert_allclose(tl, wl, rtol=1e-6 if dtype == "float64"
                                   else 1e-3)


def _one_step(dtype, strategy, moe):
    """JAX's and the port's ``make_ps_train_step`` from JAX's params:
    (JAX loss, port loss, JAX store, port store, initial flat)."""
    jcfg, tcfg = _cfgs(vocab=32, dim=32, heads=2, layers=1, dtype=dtype,
                       moe_experts=moe)
    mesh = make_mesh((4, 2), ("dp", "sp"))
    step, store, tok, _ = jtr.make_ps_train_step(jcfg, mesh, lr=0.5,
                                                 sp_strategy=strategy)
    flat0 = flat_from_jax(_np_tree(jt.init_params(jax.random.PRNGKey(0),
                                                  jcfg)))
    np.testing.assert_array_equal(np.asarray(store)[:flat0.size], flat0)
    group = tm.make_group((4, 2), ("dp", "sp"), device="cpu")
    tstep, tstore = ttr.make_ps_train_step(tcfg, group, lr=0.5,
                                           sp_strategy=strategy)
    tstore.engine.set_store_array(tstore.name, flat0)
    inputs, targets = jtr.toy_batch(jcfg, batch=8, seq=16)
    store, loss = step(store, jax.device_put(inputs, tok),
                       jax.device_put(targets, tok))
    ring_collective.reset_launches()
    tloss = tstep(inputs, targets)
    assert ring_collective.launches["ring_push[float32]"] == 0  # CPU
    return (float(loss), float(tloss), np.asarray(store),
            tstore.array().numpy(), flat0)


STEPS = [("float32", "ring", 0), ("float32", "ulysses", 0),
         ("float32", "ring", 4), ("float32", "ulysses", 4),
         ("float64", "ring", 0), ("float64", "ulysses", 4)]


@pytest.mark.parametrize("dtype,strategy,moe", STEPS,
                         ids=[f"{d}-{s}-{'moe' if m else 'tp'}"
                              for d, s, m in STEPS])
def test_ps_train_step_matches_jax(request, dtype, strategy, moe):
    """One PS step on dp 4 x sp 2 (TP or MoE-EP on sp): the loss and the
    flat store after the K4 push against JAX's (bars in the module
    docstring)."""
    if dtype == "float64":
        request.getfixturevalue("x64")
    jl, tl, js, ts, flat0 = _one_step(dtype, strategy, moe)
    upd = np.abs(js[:flat0.size] - flat0).max()
    assert upd > 1e-3  # the step moved the store
    if dtype == "float32":
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        np.testing.assert_allclose(ts, js, rtol=0, atol=2.0 ** -8 * upd)
    else:
        np.testing.assert_allclose(tl, jl, rtol=1e-12)
        np.testing.assert_allclose(ts, js, rtol=0, atol=2.0 ** -22 * upd)
    assert ts.shape == js.shape  # the same padding to n_dev


def test_ps_train_step_loss_decreases():
    """JAX's ``test_ps_train_step_loss_decreases`` on the port: 10 steps
    on dp 4 x sp 2 at lr 0.5."""
    cfg = tt.ModelConfig(vocab=32, dim=32, heads=2, layers=1)
    group = tm.make_group((4, 2), ("dp", "sp"), device="cpu")
    step, store = ttr.make_ps_train_step(cfg, group, lr=0.5)
    inputs, targets = ttr.toy_batch(cfg, batch=8, seq=16)
    losses = [float(step(inputs, targets)) for _ in range(10)]
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0] * 0.9, losses
    assert store.array().shape[0] % 8 == 0


def test_ulysses_and_ring_steps_agree_and_remat_matches():
    """JAX's ``test_train_step_ulysses_strategy`` (dp 2 x sp 4, heads 4:
    the two strategies' losses agree) and ``test_train_step_remat_
    matches`` (the second step's loss, which reads the first step's
    gradients, is the same with ``remat``)."""
    group = tm.make_group((2, 4), ("dp", "sp"), device="cpu")
    cfg = tt.ModelConfig(vocab=64, dim=32, heads=4, layers=1)
    losses = {}
    for strategy in ("ring", "ulysses"):
        step, _ = ttr.make_ps_train_step(cfg, group, lr=0.1,
                                         sp_strategy=strategy)
        inputs, targets = ttr.toy_batch(cfg, batch=2, seq=32)
        losses[strategy] = float(step(inputs, targets))
    np.testing.assert_allclose(losses["ring"], losses["ulysses"], rtol=1e-4,
                               atol=1e-5)
    second = {}
    for remat in (False, True):
        cfg = tt.ModelConfig(vocab=64, dim=32, heads=2, layers=2,
                             remat=remat)
        step, _ = ttr.make_ps_train_step(cfg, group, lr=0.1)
        inputs, targets = ttr.toy_batch(cfg, batch=2, seq=16)
        step(inputs, targets)
        second[remat] = float(step(inputs, targets))
    np.testing.assert_allclose(second[False], second[True], rtol=1e-5)


BAD = [
    (dict(moe_experts=3), (4, 2), {}),  # experts over the model axis
    (dict(dim=30, mlp_ratio=1, heads=2), (2, 4), {}),  # hidden over sp
    ({}, (4, 2), dict(sp_strategy="zigzag")),
    (dict(heads=2), (2, 4), dict(sp_strategy="ulysses")),
]


@pytest.mark.parametrize("cfg_kw,shape,kw", BAD,
                         ids=["moe-split", "mlp-split", "strategy",
                              "ulysses-heads"])
def test_ps_train_step_value_errors_match_jax(cfg_kw, shape, kw):
    """``make_ps_train_step`` refuses what JAX's refuses (train.py:56-72),
    with the same message."""
    jcfg, tcfg = _cfgs(vocab=32, **{"dim": 32, **cfg_kw})
    with pytest.raises(ValueError) as jerr:
        jtr.make_ps_train_step(jcfg, make_mesh(shape, ("dp", "sp")), **kw)
    with pytest.raises(ValueError) as terr:
        ttr.make_ps_train_step(
            tcfg, tm.make_group(shape, ("dp", "sp"), device="cpu"), **kw)
    assert str(terr.value) == str(jerr.value)


def _kv_run(codec, ef, cfg, steps):
    cluster = PortCluster(num_workers=1, num_servers=1,
                          env_extra={"PS_CODEC_EF": "1" if ef else "0"})
    cluster.start()
    srv = KVServer(0, postoffice=cluster.servers[0])
    try:
        srv.set_request_handle(KVServerDefaultHandle())
        worker = KVWorker(0, 0, postoffice=cluster.workers[0])
        losses = ttr.kv_train_loop(worker, cfg, steps=steps, lr=0.1,
                                   codec=codec, device="cpu")
        worker.stop()
    finally:
        srv.stop()
        cluster.finalize()
    return losses


def _jax_kv_run(cfg, steps, codec=None):
    cluster = LoopbackCluster(num_workers=1, num_servers=1,
                              env_extra={"PS_CODEC_EF": "1"})
    cluster.start()
    srv = JKVServer(0, postoffice=cluster.servers[0])
    try:
        srv.set_request_handle(JHandle())
        worker = JKVWorker(0, 0, postoffice=cluster.workers[0])
        losses = jtr.kv_train_loop(worker, cfg, steps=steps, lr=0.1,
                                   codec=codec)
        worker.stop()
    finally:
        srv.stop()
        cluster.finalize()
    return losses


def test_kv_train_loop_fp8_error_feedback_guard(monkeypatch):
    """JAX's convergence guard (``tests/test_model_train.py:69-137``) over
    the port's loopback cluster: with ``fp8_e4m3`` and error feedback
    the final loss lands within 2 % of the uncompressed run's, and
    without error feedback it still trains.  All three runs start from
    JAX's params; the uncompressed run's first losses agree with JAX's
    own loop (rtol 1e-4: bfloat16 matmuls, float32 pushes)."""
    jcfg, tcfg = _cfgs(vocab=32, dim=32, heads=2, layers=1)
    params0 = params_from_jax(_np_tree(jt.init_params(jax.random.PRNGKey(0),
                                                      jcfg)))
    # The loop's seed-0 init, replaced by JAX's params.
    monkeypatch.setattr(ttr, "init_params", lambda gen, cfg: params0)

    def tail(losses):  # the last steps' mean: step noise damped
        return float(np.mean(losses[-5:]))

    base = _kv_run(None, True, tcfg, 150)
    fp8_ef = _kv_run("fp8_e4m3", True, tcfg, 150)
    fp8_noef = _kv_run("fp8_e4m3", False, tcfg, 150)
    np.testing.assert_allclose(base[:3], _jax_kv_run(jcfg, 3), rtol=1e-4)
    assert np.isfinite(base).all() and np.isfinite(fp8_ef).all()
    assert tail(base) < base[0] * 0.1, base
    gap_ef = abs(tail(fp8_ef) - tail(base)) / tail(base)
    gap_noef = abs(tail(fp8_noef) - tail(base)) / tail(base)
    assert gap_ef <= 0.02, (gap_ef, gap_noef)
    assert np.isfinite(fp8_noef).all() and tail(fp8_noef) < base[0] * 0.2


def test_kv_train_loop_full_width_fp8_gap_beside_jax(monkeypatch):
    """``chip_smoke.py``'s kv leg on the CPU: ``ModelConfig()`` (vocab
    256, dim 128, 2 layers), 30 steps at lr 0.1, raw against fp8_e4m3
    with error feedback, in both packages from JAX's params.  Each
    package's gap (the last 5 losses' means) is within JAX's 2 %, and
    the two raw runs end within 1 % of each other (their bfloat16
    products round apart, and 30 steps carry that forward).  Prints
    both gaps (``-s``)."""
    jcfg, tcfg = _cfgs()
    params0 = params_from_jax(_np_tree(jt.init_params(jax.random.PRNGKey(0),
                                                      jcfg)))
    monkeypatch.setattr(ttr, "init_params", lambda gen, cfg: params0)

    def tail(losses):
        return float(np.mean(losses[-5:]))

    port = {c: _kv_run(c, True, tcfg, 30) for c in (None, "fp8_e4m3")}
    ref = {c: _jax_kv_run(jcfg, 30, c) for c in (None, "fp8_e4m3")}
    gaps = {}
    for name, runs in (("port", port), ("jax", ref)):
        base = tail(runs[None])
        assert np.isfinite(runs[None]).all() and base < runs[None][0], runs
        gaps[name] = abs(tail(runs["fp8_e4m3"]) - base) / base
    print(f"fp8_e4m3 + EF gap at ModelConfig(), 30 steps, lr 0.1: port "
          f"{gaps['port']:.4%}, JAX {gaps['jax']:.4%}; raw tails port "
          f"{tail(port[None]):.6f}, JAX {tail(ref[None]):.6f}")
    assert gaps["port"] <= 0.02 and gaps["jax"] <= 0.02, gaps
    np.testing.assert_allclose(tail(port[None]), tail(ref[None]), rtol=1e-2)
