"""bf16 stateful buckets: the port's fused updates K1-K3 on bf16 against
the JAX package.

The JAX engine keeps a bf16 bucket's store and optimizer state in bf16
and runs its Pallas kernels on them (``pslite_tpu/parallel/engine.py:
809-831``).  On the CPU those kernels run in interpret mode, and XLA's
CPU backend evaluates each bf16 operation in f32 and rounds it to bf16,
the Python constants rounded to bf16 first.  The port's plain versions
(and its CUDA kernels) do the same, so sgd_momentum and adagrad are
bit-exact: tolerance none, on the kernels alone and through the engines.

Adam: the JAX kernel refuses a bf16 store (``alpha_t * m`` is f32 and
the store ref bf16: ValueError at trace time).  The port defines it by
the same expression with the f32 quotient subtracted in f32 and rounded
once into the store; the test holds the plain version bit-exactly to an
independent numpy emulation of that definition.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pslite_tpu.ops import fused_update as jfu
from pslite_tpu.parallel.engine import CollectiveEngine as JaxEngine
from pslite_tpu.parallel.mesh import default_mesh
from pslite_tpu_torch import CollectiveEngine, DeviceGroup
from pslite_tpu_torch.ops import fused_update as tfu

N = 3000  # not a multiple of the kernels' 8-value vectors


def _rb(x):
    """float32 array -> nearest bf16 (ties to even), as float32."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16
    return b.astype(np.uint32).view(np.float32)


def _c(x):
    return float(_rb(np.float32(x)))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(11)
    return {k: _rb(v) for k, v in dict(
        store=rng.randn(N), state=rng.randn(N), agg=rng.randn(N),
        pos=np.abs(rng.randn(N)), m=0.1 * rng.randn(N),
        v=0.01 * np.abs(rng.randn(N))).items()}


def _t(x):
    return torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16)


def _j(x):
    return jnp.asarray(x, jnp.bfloat16)


def _same(got, want):
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(jnp.asarray(want, jnp.float32)))


@pytest.mark.parametrize("lr,momentum", [(0.01, 0.9), (0.05, 0.5)])
def test_sgd_update_bf16_bit_exact_with_jax(inputs, lr, momentum):
    x = inputs
    ws, wm = jfu.sgd_update(_j(x["store"]), _j(x["state"]), _j(x["agg"]),
                            lr=lr, momentum=momentum)
    s, m = _t(x["store"]), _t(x["state"])
    tfu.sgd_update(s, m, _t(x["agg"]), lr=lr, momentum=momentum)
    _same(s, ws)
    _same(m, wm)


@pytest.mark.parametrize("lr,eps", [(0.01, 1e-8), (0.2, 1e-3)])
def test_adagrad_update_bf16_bit_exact_with_jax(inputs, lr, eps):
    x = inputs
    ws, wa = jfu.adagrad_update(_j(x["store"]), _j(x["pos"]), _j(x["agg"]),
                                lr=lr, eps=eps)
    s, a = _t(x["store"]), _t(x["pos"])
    tfu.adagrad_update(s, a, _t(x["agg"]), lr=lr, eps=eps)
    _same(s, ws)
    _same(a, wa)


@pytest.mark.parametrize("step", [1, 7])
def test_adam_update_bf16_definition(inputs, step):
    x = inputs
    with pytest.raises(ValueError, match="Invalid dtype"):
        jfu.adam_update(_j(x["store"]), _j(x["m"]), _j(x["v"]), _j(x["agg"]),
                        jnp.float32(step), lr=1e-3)
    s, m, v = _t(x["store"]), _t(x["m"]), _t(x["v"])
    alpha = tfu.adam_alpha(torch.tensor([float(step)]), 1e-3)
    tfu.adam_update_with_alpha(s, m, v, _t(x["agg"]), alpha)
    # The definition, one bf16 rounding per operation, in numpy.
    g = x["agg"]
    m64 = _rb(_rb(_c(0.9) * x["m"]) + _rb(_c(1 - 0.9) * g))
    v64 = _rb(_rb(_c(0.999) * x["v"]) + _rb(_rb(_c(1 - 0.999) * g) * g))
    den = _rb(_rb(np.sqrt(v64)) + np.float32(_c(1e-8)))
    a = np.float32(alpha.item())
    s64 = _rb(x["store"] - (a * m64) / den)
    np.testing.assert_array_equal(m.float().numpy(), m64)
    np.testing.assert_array_equal(v.float().numpy(), v64)
    np.testing.assert_array_equal(s.float().numpy(), s64)


def test_bf16_wrappers_on_cpu_launch_nothing(inputs):
    tfu.reset_launches()
    x = inputs
    tfu.sgd_update(_t(x["store"]), _t(x["state"]), _t(x["agg"]))
    tfu.adagrad_update(_t(x["store"]), _t(x["pos"]), _t(x["agg"]))
    tfu.adam_update(_t(x["store"]), _t(x["m"]), _t(x["v"]), _t(x["agg"]), 1)
    assert not any(tfu.launches.values())
    with pytest.raises(AssertionError, match="one dtype"):
        tfu.sgd_update(_t(x["store"]), torch.zeros(N), _t(x["agg"]))


@pytest.mark.parametrize("handle", ["sgd_momentum:0.05,0.9", "adagrad:0.02"])
def test_bf16_stateful_engine_bit_exact_with_jax(handle):
    """The JAX engine's bf16 stateful push_pull against the port's on a
    CPU group: stores, pulls and optimizer states bit-equal, 3 steps."""
    keys = np.arange(4, dtype=np.uint64)
    init = np.random.RandomState(3).randn(4 * 33).astype(np.float32)
    jeng = JaxEngine(default_mesh(), server_handle=handle)
    teng = CollectiveEngine(DeviceGroup(8, device="cpu"),
                            server_handle=handle)
    jeng.register_dense("b", keys, 33, dtype=jnp.bfloat16, init=init)
    teng.register_dense("b", keys, 33, dtype=torch.bfloat16, init=init)
    rng = np.random.RandomState(4)
    for _ in range(3):
        g = rng.randn(8, 4 * 33).astype(np.float32)
        _same(teng.push_pull("b", torch.from_numpy(g).to(torch.bfloat16)),
              jeng.push_pull("b", jnp.asarray(g, jnp.bfloat16)))
    _, jstate = jeng.opt_state("b")
    _, tstate = teng.opt_state("b")
    for t, j in zip(tstate, jstate):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            t.float().numpy()[: 4 * 33],
            np.asarray(jnp.asarray(j, jnp.float32)).reshape(-1)[: 4 * 33])
