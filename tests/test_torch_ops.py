"""Kernels of pslite_tpu_torch against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions, and the
JAX kernels run in interpret mode on the virtual CPU mesh, as
tests/test_ring_collective.py runs them.  The same numpy inputs go
through both.

Tolerances:
- ring ``sum`` (f32 and bf16): bit-exact.  The port adds the rank rows
  in the TPU ring's order (per chunk, direction 0 sums ranks c+1..c,
  direction 1 sums c-1..c), rounding each hop to the dtype.
- ring ``sgd:lr`` and the fused optimizer updates: XLA's CPU backend
  contracts a*b + c into one FMA and eager PyTorch rounds the product
  first, so the last bits differ: rtol 1e-6 / atol 1e-6 for sgd,
  rtol 1e-5 / atol 1e-6 for the optimizers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from pslite_tpu.ops import fused_update as jfu
from pslite_tpu.ops import ring_collective as jring
from pslite_tpu.parallel.mesh import shard_map_compat as shard_map
from pslite_tpu_torch.ops import _native
from pslite_tpu_torch.ops import fused_update as tfu
from pslite_tpu_torch.ops import ring_collective as tring

_JAX_HANDLES = {
    "sum": lambda s, a: s + a,
    "sgd:0.05": lambda s, a: s - 0.05 * a,
}
_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(n, bidir, dtype, seed):
    jdt, tdt = _DTYPES[dtype]
    chunk = jring.ring_chunk_len(n * 1024, n, jdt, bidir=bidir)
    rng = np.random.RandomState(seed)
    grads = rng.randn(n, n * chunk).astype(np.float32)
    store = rng.randn(n * chunk).astype(np.float32)
    return chunk, grads, store


def _jax_ring(n, bidir, dtype, handle, with_ag, grads, store):
    jdt, _ = _DTYPES[dtype]
    chunk = grads.shape[1] // n
    fn = jring.ring_push_pull if with_ag else jring.ring_push

    def body(s, g):
        return fn(g[0].reshape(n, chunk), s, _JAX_HANDLES[handle], "kv", n,
                  bidir=bidir)

    f = jax.jit(shard_map(
        body, mesh=Mesh(np.array(jax.devices()[:n]), ("kv",)),
        in_specs=(P("kv"), P("kv", None)),
        out_specs=(P("kv"), P(None)) if with_ag else P("kv"),
    ))
    outs = f(jnp.asarray(store, jdt), jnp.asarray(grads, jdt))
    outs = outs if with_ag else (outs,)
    return [np.asarray(o.astype(jnp.float32)) for o in outs]


# (n, bidir, dtype, handle, with_ag): f32 sum at every ring size and
# direction mode; bf16 sum, sgd and push-only spread over sizes and modes.
_RING_CASES = [
    (n, bidir, "float32", "sum", True)
    for n in (2, 4, 8) for bidir in (True, False)
] + [
    (2, False, "bfloat16", "sum", True),
    (4, True, "bfloat16", "sum", True),
    (8, False, "bfloat16", "sum", True),
    (2, True, "float32", "sgd:0.05", True),
    (4, True, "float32", "sgd:0.05", True),
    (8, False, "float32", "sgd:0.05", True),
    (4, True, "float32", "sum", False),
    (2, False, "bfloat16", "sum", False),
]


@pytest.mark.parametrize("n,bidir,dtype,handle,with_ag", _RING_CASES)
def test_ring_matches_jax(n, bidir, dtype, handle, with_ag):
    _, grads, store = _inputs(n, bidir, dtype, seed=n + 10 * bidir)
    want = _jax_ring(n, bidir, dtype, handle, with_ag, grads, store)
    tdt = _DTYPES[dtype][1]
    g = torch.from_numpy(grads).to(tdt)
    s = torch.from_numpy(store).to(tdt)
    fn = tring.ring_push_pull if with_ag else tring.ring_push
    out = fn(g, s, handle, bidir=bidir)
    got = [s.float().numpy()] + ([out.float().numpy()] if with_ag else [])
    for a, b in zip(got, want):
        if handle == "sum":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_ring_order_differs_from_plain_sum():
    """The ring's order matters: a plain rank-order sum is not bit-exact
    with it, so the port cannot use ``grads.sum(0)``."""
    n = 8
    _, grads, store = _inputs(n, True, "float32", seed=3)
    g = torch.from_numpy(grads)
    s = torch.from_numpy(store)
    pulled = tring.ring_push_pull_reference(g, s.clone(), "sum")
    plain = s + g.sum(0)
    assert not torch.equal(pulled, plain)
    torch.testing.assert_close(pulled, plain, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("handle,code", [("sum", 0), ("assign", 1),
                                         ("sgd", 2), ("sgd:0.5", 2)])
def test_ring_handle_codes(handle, code):
    assert tring.ring_handle(handle)[0] == code
    if handle.startswith("sgd"):
        assert tring.ring_handle(handle)[1] == (
            0.5 if ":" in handle else 0.01)


@pytest.mark.parametrize("handle", ["sgd_momentum", "adam:1e-3", "bogus"])
def test_ring_rejects_other_handles(handle):
    with pytest.raises(ValueError):
        tring.ring_handle(handle)


def test_ring_wrappers_on_cpu_run_plain_versions():
    tring.reset_launches()
    n = 4
    g = torch.randn(n, n * 300, generator=torch.Generator().manual_seed(0))
    s0 = torch.randn(n * 300, generator=torch.Generator().manual_seed(1))
    s1, s2 = s0.clone(), s0.clone()
    out = tring.ring_push_pull(g, s1, "sum")
    ref = tring.ring_push_pull_reference(g, s2, "sum")
    assert torch.equal(out, ref) and torch.equal(s1, s2)
    assert out.data_ptr() != s1.data_ptr()  # pulled is a fresh tensor
    assert sum(tring.launches.values()) == 0


_CHUNK_GRID = [
    (total, n, dt, bidir, compress)
    for total in (1, 100, 1024, 4097, 12345, 10_240_000)
    for n in (1, 2, 3, 8, 16)
    for dt in ("float32", "bfloat16", "float16")
    for bidir in (True, False)
    for compress in (False, True)
]


def test_ring_chunk_len_matches_jax():
    for total, n, dt, bidir, compress in _CHUNK_GRID:
        jdt = jnp.dtype(dt)
        want = jring.ring_chunk_len(total, n, jdt, bidir=bidir,
                                    compress=compress)
        assert tring.ring_chunk_len(total, n, jdt, bidir=bidir,
                                    compress=compress) == want
        assert tring.ring_chunk_len(total, n, getattr(torch, dt),
                                    bidir=bidir, compress=compress) == want
    assert tring.ring_chunk_len(5000, 4) == jring.ring_chunk_len(5000, 4)


# -- fused optimizer updates ---------------------------------------------------

_N_UPDATE = 5000  # not a multiple of 128: the JAX kernels pad their tiles


@pytest.fixture()
def update_inputs():
    """Fresh inputs for each test, read-only: neither package may write
    into an array the other one reads."""
    rng = np.random.RandomState(5)
    x = {
        "store": rng.randn(_N_UPDATE).astype(np.float32),
        "state": rng.randn(_N_UPDATE).astype(np.float32),
        "pos": rng.rand(_N_UPDATE).astype(np.float32),
        "agg": rng.randn(_N_UPDATE).astype(np.float32),
    }
    for a in x.values():
        a.flags.writeable = False
    return x


def _t(a):
    return torch.from_numpy(a.copy())


def _j(a):
    """A JAX array that owns a copy of ``a`` (never a view of it)."""
    return jnp.array(a, copy=True)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_sgd_update_matches_jax(update_inputs):
    x = update_inputs
    ws, wm = jfu.sgd_update(_j(x["store"]), _j(x["state"]), _j(x["agg"]),
                            lr=0.05, momentum=0.9)
    s, m = _t(x["store"]), _t(x["state"])
    out = tfu.sgd_update(s, m, _t(x["agg"]), lr=0.05, momentum=0.9)
    assert out[0] is s and out[1] is m  # updated in place
    _close(s, ws)
    _close(m, wm)


def test_adagrad_update_matches_jax(update_inputs):
    x = update_inputs
    ws, wa = jfu.adagrad_update(_j(x["store"]), _j(x["pos"]), _j(x["agg"]),
                                lr=0.05)
    s, a = _t(x["store"]), _t(x["pos"])
    tfu.adagrad_update(s, a, _t(x["agg"]), lr=0.05)
    _close(s, ws)
    _close(a, wa)


@pytest.mark.parametrize("step", [1, 7])
def test_adam_update_matches_jax(update_inputs, step):
    x = update_inputs
    m0 = 0.1 * x["state"]
    v0 = 0.01 * x["pos"]
    ws, wm, wv = jfu.adam_update(
        _j(x["store"]), _j(m0), _j(v0), _j(x["agg"]), jnp.float32(step),
        lr=1e-3)
    s, m, v = _t(x["store"]), _t(m0), _t(v0)
    tfu.adam_update(s, m, v, _t(x["agg"]), torch.tensor([float(step)]),
                    lr=1e-3)
    _close(s, ws)
    _close(m, wm)
    _close(v, wv)


def test_adam_alpha_is_f32_on_the_step_device():
    a = tfu.adam_alpha(torch.tensor([3.0]), 1e-3)
    assert a.dtype == torch.float32 and a.shape == (1,)
    want = 1e-3 * np.sqrt(1 - 0.999 ** 3) / (1 - 0.9 ** 3)
    assert abs(float(a) - want) < 1e-9


def test_fused_updates_reject_bad_operands():
    s = torch.zeros(8)
    with pytest.raises(AssertionError, match="float32"):
        tfu.sgd_update(s, torch.zeros(8, dtype=torch.float64), torch.zeros(8))
    with pytest.raises(AssertionError, match="lengths"):
        tfu.adagrad_update(s, torch.zeros(8), torch.zeros(9))
    with pytest.raises(AssertionError, match="contiguous"):
        tfu.sgd_update(s, torch.zeros(16)[::2], torch.zeros(8))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc: the build raises instead of falling back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_native, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _native.build(force=True)
