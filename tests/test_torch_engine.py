"""pslite_tpu_torch's CollectiveEngine against the JAX CollectiveEngine.

The port runs on ``DeviceGroup(8, device="cpu")`` (its plain PyTorch
versions); the JAX engine runs on the 8-device virtual CPU mesh (ring
kernels in interpret mode).  The same numpy grads go through both.

Tolerances: ``sum``/``assign`` and the bf16 sum are bit-exact (the port
adds worker rows in rank order on the torch path and in the TPU ring's
order on the ring path).  Handles where a multiply feeds an add
(``sgd:lr`` and the fused optimizers) differ in the last bits, because
XLA's CPU backend contracts them into one FMA and eager PyTorch does
not: rtol 1e-6 / atol 1e-6 for sgd, rtol 1e-5 / atol 1e-6 for the
optimizers.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pslite_tpu import checkpoint as jckpt
from pslite_tpu.parallel.engine import CollectiveEngine as JaxEngine
from pslite_tpu.parallel.mesh import default_mesh
from pslite_tpu.utils.logging import CheckError as JaxCheckError
from pslite_tpu_torch import CollectiveEngine, DeviceGroup
from pslite_tpu_torch.convert import load_engine_npz
from pslite_tpu_torch.utils.logging import CheckError

W = 8
# chunk0 = 16*1024/8 = 2048 = the bidirectional f32 tile chunk: both ring
# directions carry data.
KEYS, VAL_LEN = 16, 1024


def _engines(handle="sum", impl="xla"):
    return (JaxEngine(default_mesh(), server_handle=handle, impl=impl),
            CollectiveEngine(DeviceGroup(W, device="cpu"),
                             server_handle=handle, impl=impl))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _grads(seed, keys=KEYS, val_len=VAL_LEN):
    return np.random.RandomState(seed).randn(W, keys * val_len).astype(
        np.float32)


def _check(got, want, handle):
    if handle.startswith("sgd:"):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    elif handle in ("sum", "assign"):
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("handle", ["sum", "assign", "sgd:0.05"])
def test_push_pull_matches_jax(impl, handle):
    jeng, teng = _engines(handle, impl)
    assert teng.impl == {"xla": "torch", "pallas": "ring"}[impl]
    keys = np.arange(KEYS, dtype=np.uint64)
    init = np.random.RandomState(9).randn(KEYS * VAL_LEN).astype(np.float32)
    for eng in (jeng, teng):
        eng.register_dense("b", keys, VAL_LEN, init=init)
    want_impl = "pallas" if impl == "pallas" else "xla"
    assert jeng._effective_impl(np.float32, handle) == want_impl
    assert teng._effective_impl(torch.float32, handle) == teng.impl
    for step in range(2):
        g = _grads(step)
        _check(teng.push_pull("b", g), jeng.push_pull("b", g), handle)
    _check(teng.pull("b"), jeng.pull("b"), handle)


@pytest.mark.parametrize("handle", ["sgd_momentum:0.05,0.9", "adam:1e-2",
                                    "adagrad:0.05"])
def test_stateful_handles_match_jax(handle):
    jeng, teng = _engines(handle, "pallas")
    keys = np.arange(KEYS, dtype=np.uint64)
    for eng in (jeng, teng):
        eng.register_dense("b", keys, VAL_LEN)
    for step in range(3):
        g = _grads(20 + step)
        _check(teng.push_pull("b", g), jeng.push_pull("b", g), handle)
    jkind, jstate = jeng.opt_state("b")
    tkind, tstate = teng.opt_state("b")
    assert jkind == tkind == handle.split(":")[0]
    assert len(jstate) == len(tstate)
    for a, b in zip(tstate, jstate):
        _check(a, b, handle)


def test_push_then_pull_and_back_to_back_pushes():
    jeng, teng = _engines()
    keys = np.arange(4, dtype=np.uint64) + 100
    for eng in (jeng, teng):
        eng.register_dense("acc", keys, 16)
    for seed in range(3):
        g = np.random.RandomState(seed).randn(W, 64).astype(np.float32)
        jeng.push("acc", g)
        token = teng.push("acc", g)
        assert token.shape == (1,)
    np.testing.assert_array_equal(_np(teng.pull("acc")),
                                  _np(jeng.pull("acc")))
    assert (teng.push_bytes, teng.pull_bytes) == (jeng.push_bytes,
                                                  jeng.pull_bytes)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_padded_bucket(impl):
    """A bucket padded to a multiple of the 8 ranks (7 x 3 -> 24), and
    4 x 100 on the ring, where the tile chunk (2048) exceeds the real
    chunk (50) and the whole bucket sums in direction 0."""
    jeng, teng = _engines("sum", impl)
    keys = np.arange(4, dtype=np.uint64)
    keys7 = np.arange(7, dtype=np.uint64)
    for eng in (jeng, teng):
        b = eng.register_dense("p", keys, 100)
        assert (b.total_len, b.padded_len) == (400, 400)
        b = eng.register_dense("q", keys7, 3)
        assert (b.total_len, b.padded_len) == (21, 24)
    for step in range(2):
        if impl == "pallas":
            g = np.random.RandomState(step).randn(W, 400).astype(np.float32)
            np.testing.assert_array_equal(_np(teng.push_pull("p", g)),
                                          _np(jeng.push_pull("p", g)))
        else:
            g = np.random.RandomState(step).randn(W, 21).astype(np.float32)
            out = teng.push_pull("q", g)
            assert out.shape == (21,)
            np.testing.assert_array_equal(_np(out),
                                          _np(jeng.push_pull("q", g)))


def test_bf16_sum_matches_jax():
    jeng, teng = _engines()
    keys = np.arange(KEYS, dtype=np.uint64)
    jeng.register_dense("h", keys, VAL_LEN, dtype=jnp.bfloat16)
    teng.register_dense("h", keys, VAL_LEN, dtype=jnp.bfloat16)
    assert teng.bucket("h").dtype == torch.bfloat16
    for step in range(2):
        g = _grads(40 + step).astype(jnp.bfloat16)
        np.testing.assert_array_equal(_np(teng.push_pull("h", g)),
                                      _np(jeng.push_pull("h", g)))


def test_init_round_trip_and_store_restore():
    jeng, teng = _engines()
    keys = np.arange(5, dtype=np.uint64)
    init = np.arange(5 * 3, dtype=np.float32)
    for eng in (jeng, teng):
        eng.register_dense("i", keys, 3, init=init)
    np.testing.assert_array_equal(_np(teng.pull("i")), init)
    np.testing.assert_array_equal(_np(teng.store_array("i")),
                                  _np(jeng.store_array("i")))
    teng.set_store_array("i", init[::-1].copy())
    np.testing.assert_array_equal(_np(teng.pull("i")), init[::-1])
    with pytest.raises(CheckError, match="restore length"):
        teng.set_store_array("i", np.zeros(7, np.float32))


def test_kind_switch_rejected():
    jeng, teng = _engines("adam:1e-3")
    keys = np.arange(2, dtype=np.uint64)
    g = np.ones((W, 8), np.float32)
    for eng, err in ((jeng, JaxCheckError), (teng, CheckError)):
        eng.register_dense("k", keys, 4)
        eng.push_pull("k", g)
        with pytest.raises(err, match="cannot switch"):
            eng.push_pull("k", g, handle="sgd_momentum:0.1")


def test_grads_forms_agree():
    """[W, total], [W, padded], flat [W*padded] and a broadcast [total],
    from numpy or torch, reduce identically."""
    teng = CollectiveEngine(DeviceGroup(W, device="cpu"), impl="xla")
    keys = np.arange(7, dtype=np.uint64)
    g = np.random.RandomState(3).randn(W, 21).astype(np.float32)
    padded = np.pad(g, ((0, 0), (0, 3)))
    forms = [g, torch.from_numpy(g), padded, padded.reshape(-1),
             torch.from_numpy(padded.reshape(-1))]
    outs = []
    for i, form in enumerate(forms):
        teng.register_dense(f"f{i}", keys, 3)
        outs.append(_np(teng.push_pull(f"f{i}", form)))
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    jeng = JaxEngine(default_mesh())
    jeng.register_dense("bc", keys, 3)
    teng.register_dense("bc", keys, 3)
    np.testing.assert_array_equal(_np(teng.push_pull("bc", g[0])),
                                  _np(jeng.push_pull("bc", g[0])))
    with pytest.raises(CheckError, match="bad worker dim"):
        teng.push_pull("bc", g[:3])


def test_bf16_stateful_bucket_not_ported():
    """The bf16 stateful bucket that raised before the bf16 fused
    updates: adam on a bf16 bucket now runs, store and moments in bf16,
    the step in f32.  The JAX engine refuses it (its Pallas adam stores
    an f32 value into the bf16 ref), so it is held against float64 Adam
    on the bf16 grads' rank-order sums: within 4 bf16 ulps (2^-6
    relative) of each value plus 2^-6 of the lr per step, the rounding
    of m, v, sqrt(v) + eps and the store at each step.  sgd_momentum
    and adagrad bf16 are bit-exact with JAX (test_torch_bf16_update.py)."""
    jeng = JaxEngine(default_mesh(), server_handle="adam:1e-3")
    jeng.register_dense("h", np.arange(2, dtype=np.uint64), 4,
                        dtype=jnp.bfloat16)
    with pytest.raises(ValueError, match="Invalid dtype"):
        jeng.push_pull("h", np.ones((W, 8), np.float32))
    teng = CollectiveEngine(DeviceGroup(W, device="cpu"),
                            server_handle="adam:1e-3")
    teng.register_dense("h", np.arange(2, dtype=np.uint64), 4,
                        dtype=torch.bfloat16)
    rng = np.random.RandomState(5)
    s64, m64, v64 = np.zeros(8), np.zeros(8), np.zeros(8)
    for t in range(1, 4):
        g = torch.from_numpy(rng.randn(W, 8).astype(np.float32)).to(
            torch.bfloat16)
        out = teng.push_pull("h", g)
        assert out.dtype == torch.bfloat16
        agg = g.float().sum(0).to(torch.bfloat16).double().numpy()
        m64 = 0.9 * m64 + 0.1 * agg
        v64 = 0.999 * v64 + 0.001 * agg * agg
        alpha = 1e-3 * np.sqrt(1 - 0.999 ** t) / (1 - 0.9 ** t)
        s64 = s64 - alpha * m64 / (np.sqrt(v64) + 1e-8)
        err = np.abs(out.double().numpy() - s64)
        assert np.all(err <= 2.0 ** -6 * (np.abs(s64) + 1e-3 * t)), err
    kind, state = teng.opt_state("h")
    assert kind == "adam"
    assert [x.dtype for x in state] == [torch.bfloat16, torch.bfloat16,
                                        torch.float32]


def test_results_are_fresh_tensors():
    teng = CollectiveEngine(DeviceGroup(W, device="cpu"), impl="pallas")
    teng.register_dense("r", np.arange(2, dtype=np.uint64), 8)
    first = teng.push_pull("r", np.ones(16, np.float32))
    pulled = teng.pull("r")
    kept = first.clone()
    teng.push("r", np.ones(16, np.float32))
    assert torch.equal(first, kept) and torch.equal(pulled, kept)


def test_state_carries_from_a_jax_checkpoint(tmp_path):
    """JAX save_engine -> load_engine_npz -> one more step each: equal."""
    jeng, teng = _engines("adam:1e-2")
    keys = np.arange(KEYS, dtype=np.uint64)
    for eng in (jeng, teng):
        eng.register_dense("a", keys, VAL_LEN)
        eng.register_dense("s", keys[:3], 5)
    for step in range(2):
        jeng.push_pull("a", _grads(60 + step))
        jeng.push_pull("s", np.full((W, 15), step + 1.0, np.float32),
                       handle="sum")
    path = str(tmp_path / "ckpt.npz")
    jckpt.save_engine(jeng, path)
    load_engine_npz(teng, path)
    kind, state = teng.opt_state("a")
    assert kind == "adam" and float(state[2][0]) == 2.0
    g = _grads(70)
    _check(teng.push_pull("a", g), jeng.push_pull("a", g), "adam")
    g = np.full((W, 15), 0.5, np.float32)
    np.testing.assert_array_equal(_np(teng.push_pull("s", g, handle="sum")),
                                  _np(jeng.push_pull("s", g, handle="sum")))


def test_cuda_group_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CollectiveEngine()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceGroup(8)
