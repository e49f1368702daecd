"""pslite_tpu_torch's GPipe pipeline (``parallel/pipeline.py``) and its
PSFormer step (``models/train.py::make_pp_train_step``) against the JAX
package's.

JAX runs ``shard_map`` over ``pp`` (and ``dp``) on the 8 virtual CPU
devices of ``tests/conftest.py``; the port runs every rank at once on a
CPU device group.  Inputs are numpy arrays made from a seed; params and
state are JAX's, carried across with ``convert.params_from_jax``.

Tolerances:
- the schedule on JAX's toy layer (``x + tanh(x @ w)``) in float64:
  outputs, the loss and every stage's gradients within rtol/atol 1e-9
  (the two packages add in other orders);
- one PSFormer pp step in float32: the loss within rtol 1e-5 and the
  state within ``2**-8`` (bfloat16's unit roundoff) of the largest
  update, since the gradients are sums of bfloat16 products rounded in
  other orders; the first loss against the sequential forward at JAX's
  rtol 2e-2 (the pipeline's head always computes in bfloat16).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from pslite_tpu.models import train as jtr
from pslite_tpu.models import transformer as jt
from pslite_tpu.parallel import pipeline as jpipe
from pslite_tpu.parallel.mesh import shard_map_compat
from pslite_tpu_torch.convert import params_from_jax
from pslite_tpu_torch.models import train as ttr
from pslite_tpu_torch.models import transformer as tt
from pslite_tpu_torch.models.ps_step import tree_leaves
from pslite_tpu_torch.parallel import mesh as tm
from pslite_tpu_torch.parallel import pipeline as tpipe

from torch_model_fixtures import (  # noqa: F401 - fixtures run by name
    _one_torch_thread, x64,
)


D = 16
F64 = dict(rtol=1e-9, atol=1e-9)


def _mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def _jax_stage(stage_params, x):
    def body(x, w):
        return x + jnp.tanh(x @ w), None

    x, _ = jax.lax.scan(body, x, stage_params["w"])
    return x


def _port_stage(stage_params, x):
    w = stage_params["w"]  # [R, layers_per_stage, D, D]
    for i in range(w.shape[1]):
        x = x + torch.tanh(torch.matmul(x, w[:, i]))
    return x


def test_schedule_forward_loss_and_gradients_float64(x64):
    """JAX's ``test_forward_parity`` and ``test_gradient_parity`` (S = 4
    stages of 2 layers, M = 4 microbatches): the pipelined outputs, the
    last stage's loss replicated over pp, every stage's layer gradients
    and the head's (summed over pp) against JAX's ``pipeline_apply`` and
    ``pipeline_loss``."""
    S, L, M, mb = 4, 8, 4, 2
    rng = np.random.RandomState(1)
    ws = [{"w": rng.randn(D, D) * 0.3} for _ in range(L)]
    head = rng.randn(D, D) * 0.3
    x = rng.randn(M, mb, D)
    tgt = rng.randn(M, mb, D)
    stacked = jpipe.stack_layers([jax.tree.map(jnp.asarray, w) for w in ws])
    tstacked = tpipe.stack_layers([{"w": torch.tensor(w["w"])} for w in ws])
    np.testing.assert_array_equal(tstacked["w"].numpy(), stacked["w"])

    def jloss(sl, hr, xm, tm_):
        return jpipe.pipeline_loss(
            _jax_stage, lambda h, outs: jnp.mean((outs @ h - tm_) ** 2),
            sl, hr, xm, "pp", S)

    def body(sl, hr, xm, tm_):
        outs = jax.lax.psum(jpipe.pipeline_apply(_jax_stage, sl, xm, "pp",
                                                 S), "pp")
        loss, (gw, gh) = jax.value_and_grad(jloss, argnums=(0, 1))(
            sl, hr, xm, tm_)
        return outs, loss, gw, jax.lax.psum(gh, "pp")

    f = jax.jit(shard_map_compat(
        body, _mesh((S,), ("pp",)),
        in_specs=(P("pp"), P(None), P(None), P(None)),
        out_specs=(P(None), P(), P("pp"), P(None))))
    outs, loss, gw, gh = f(stacked, jnp.asarray(head), jnp.asarray(x),
                           jnp.asarray(tgt))

    g = tm.DeviceGroup(S, device="cpu", axis_name="pp")
    my = tm.axis_index(g, "pp")
    sl = {"w": tstacked["w"].reshape(S, L // S, D, D)[my].clone()
          .requires_grad_()}
    hr = torch.tensor(head)[None].expand(S, D, D).clone().requires_grad_()
    xm = torch.tensor(x)[None].expand(S, M, mb, D)
    tmr = torch.tensor(tgt)[None].expand(S, M, mb, D)
    touts = tm.psum(g, tpipe.pipeline_apply(g, _port_stage, sl, xm, "pp",
                                            S), "pp")
    tloss = tpipe.pipeline_loss(
        g, _port_stage,
        lambda h, o: ((torch.matmul(o, h[:, None]) - tmr) ** 2).flatten(
            1).mean(dim=1),
        sl, hr, xm, "pp", S)
    tgw, tgh = torch.autograd.grad(tloss.sum(), [sl["w"], hr])
    np.testing.assert_allclose(touts[0].detach().numpy(), np.asarray(outs),
                               **F64)
    np.testing.assert_allclose(tloss.detach().numpy(),
                               np.full(S, float(loss)), **F64)
    np.testing.assert_allclose(tgw.reshape(L, D, D).numpy(),
                               np.asarray(gw["w"]), **F64)
    np.testing.assert_allclose(tm.psum(g, tgh, "pp")[0].numpy(),
                               np.asarray(gh), **F64)


def _pp_step(shape, names, steps, lr, seed, M=2, mb=2, T=8, vocab=32):
    """JAX's and the port's pp steps from JAX's state: per-step losses
    of both, both final states, and the initial state."""
    kw = dict(vocab=vocab, dim=16, heads=2, layers=4)
    jcfg, tcfg = jt.ModelConfig(**kw), tt.ModelConfig(**kw)
    step, state, tok = jtr.make_pp_train_step(jcfg, _mesh(shape, names),
                                              lr=lr, num_micro=M)
    group = tm.make_group(shape, names, device="cpu")
    tstep, tstate = ttr.make_pp_train_step(tcfg, group, lr=lr, num_micro=M)
    assert ([tuple(x.shape) for s in tstate for x in tree_leaves(s)]
            == [x.shape for x in jax.tree.leaves(state)])
    tstate = tuple(params_from_jax(jax.tree.map(np.asarray, s))
                   for s in state)
    init = [np.asarray(x) for x in jax.tree.leaves(state)]
    rng = np.random.default_rng(seed)
    lead = (2,) if len(shape) == 2 else ()
    inputs = rng.integers(0, vocab, size=lead + (M, mb, T)).astype(np.int32)
    targets = (inputs + 1) % vocab
    jl, tl = [], []
    for _ in range(steps):
        state, loss = step(state, jax.device_put(inputs, tok),
                           jax.device_put(targets, tok))
        tstate, tloss = tstep(tstate, inputs, targets)
        jl.append(float(loss))
        tl.append(float(tloss))
    return jl, tl, state, tstate, init, (inputs, targets, tcfg)


@pytest.mark.parametrize("shape,names", [((4,), ("pp",)),
                                         ((2, 4), ("dp", "pp"))],
                         ids=["pp4", "dp2xpp4"])
def test_pp_step_matches_jax(shape, names):
    """One step of ``make_pp_train_step``: the loss and every leaf of
    ``(stacked_layers, head)`` after it against JAX's (head gradients
    summed over pp, then averaged over dp with the layers')."""
    jl, tl, state, tstate, init, _ = _pp_step(shape, names, 1, 0.15, 2)
    want = [np.asarray(x) for x in jax.tree.leaves(state)]
    got = [x.numpy() for s in tstate for x in tree_leaves(s)]
    upd = max(np.abs(w - i).max() for w, i in zip(want, init))
    assert upd > 1e-3
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=2.0 ** -8 * upd)


def test_pp_first_loss_matches_sequential():
    """JAX's ``test_pp_first_loss_matches_sequential``: the pipelined
    first loss (pp 4, M 4) against the single-device ``loss_fn`` of the
    same params over the whole batch."""
    jl, tl, _, _, init, (inputs, targets, tcfg) = _pp_step(
        (4,), ("pp",), 1, 0.1, 0, M=4)
    tstep, tstate = ttr.make_pp_train_step(
        tcfg, tm.DeviceGroup(4, device="cpu", axis_name="pp"), lr=0.1,
        num_micro=4)
    stacked, head = tstate
    params = dict(head, layers=[{k: v[i] for k, v in stacked.items()}
                                for i in range(tcfg.layers)])
    want = tt.loss_fn(params, torch.tensor(inputs.reshape(8, 8)),
                      torch.tensor(targets.reshape(8, 8)), tcfg)
    _, loss = tstep(tstate, inputs, targets)
    np.testing.assert_allclose(float(loss), float(want), rtol=2e-2)
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5)


@pytest.mark.parametrize("shape,names,steps,lr", [
    ((4,), ("pp",), 8, 0.3), ((2, 4), ("dp", "pp"), 14, 0.15)],
    ids=["pp4", "dp2xpp4"])
def test_pp_loss_decreases(shape, names, steps, lr):
    """JAX's ``test_pp_loss_decreases`` and ``test_pp_with_dp_axis`` on
    the port (vocab 16, dim 16, 4 layers)."""
    cfg = tt.ModelConfig(vocab=16, dim=16, heads=2, layers=4)
    step, state = ttr.make_pp_train_step(
        cfg, tm.make_group(shape, names, device="cpu"), lr=lr, num_micro=2)
    rng = np.random.default_rng(1 if len(shape) == 1 else 2)
    lead = (2,) if len(shape) == 2 else ()
    inputs = rng.integers(0, 16, size=lead + (2, 2, 8)).astype(np.int32)
    targets = (inputs + 1) % 16
    losses = []
    for _ in range(steps):
        state, loss = step(state, inputs, targets)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    if len(shape) == 1:
        assert losses[-1] < losses[0] * 0.8, losses
    else:
        assert min(losses[7:]) < losses[0] * 0.82, losses


@pytest.mark.parametrize("cfg_kw", [dict(layers=3), dict(moe_experts=4)],
                         ids=["layers-split", "moe"])
def test_pp_value_errors_match_jax(cfg_kw):
    """``make_pp_train_step`` refuses what JAX's refuses (train.py:139-143),
    with the same message."""
    kw = dict(vocab=16, dim=16, heads=2, **{"layers": 4, **cfg_kw})
    with pytest.raises(ValueError) as jerr:
        jtr.make_pp_train_step(jt.ModelConfig(**kw), _mesh((4,), ("pp",)))
    with pytest.raises(ValueError) as terr:
        ttr.make_pp_train_step(
            tt.ModelConfig(**kw),
            tm.DeviceGroup(4, device="cpu", axis_name="pp"))
    assert str(terr.value) == str(jerr.value)
