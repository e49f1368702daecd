"""pslite_tpu_torch's int8 quantize/dequantize against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
functions run their Pallas kernels in interpret mode, as tests/test_ops.py
runs them.  The same numpy inputs go through both.

Tolerance: bit-exact for codes, scales and dequantized values.  The JAX
kernel's ``amax / 127.0`` compiles to ``amax * f32(1/127)`` on XLA's CPU
backend, and the port computes it that way; the division by the scale is
a true division on both sides.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pslite_tpu.ops import quantize as jq
from pslite_tpu_torch.ops import quantize as tq

_SIZES = [1000, 4096, 100_003]


def _x(n, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n) * 10).astype(np.float32)


@pytest.fixture(scope="module", params=_SIZES)
def pair(request):
    """(n, x, JAX (q, scales), port (q, scales)) for one input size."""
    n = request.param
    x = _x(n, seed=n % 97)
    jqv, jsv = jq.quantize_int8(jnp.asarray(x))
    tqv, tsv = tq.quantize_int8(torch.from_numpy(x))
    return n, x, (np.array(jqv), np.array(jsv)), (tqv, tsv)


def test_quantize_matches_jax(pair):
    n, _, (jqv, jsv), (tqv, tsv) = pair
    rows = tq.quantized_rows(n)
    assert tqv.dtype == torch.int8 and tsv.dtype == torch.float32
    assert tuple(tqv.shape) == tuple(tsv.shape) == jqv.shape == (rows, 128)
    np.testing.assert_array_equal(tqv.numpy(), jqv)
    np.testing.assert_array_equal(tsv.numpy(), jsv)


@pytest.mark.parametrize("form", ["full", "compact", "column"])
def test_dequantize_matches_jax(pair, form):
    n, _, (jqv, jsv), (tqv, _) = pair
    scales = {"full": jsv, "compact": jsv[:, 0].copy(),
              "column": jsv[:, :1].copy()}[form]
    want = np.asarray(jq.dequantize_int8(jnp.asarray(jqv),
                                         jnp.asarray(scales), n))
    got = tq.dequantize_int8(tqv, torch.from_numpy(scales), n)
    assert got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dequantize_full_scales_are_read_per_value():
    """``[R, 128]`` scales multiply value by value (the JAX kernel's
    ``q_ref * s_ref``), not by their first column."""
    q = torch.ones((32, 128), dtype=torch.int8)
    s = torch.arange(32 * 128, dtype=torch.float32).reshape(32, 128)
    want = np.asarray(jq.dequantize_int8(jnp.asarray(q.numpy()),
                                         jnp.asarray(s.numpy()), 32 * 128))
    got = tq.dequantize_int8(q, s, 32 * 128)
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(got[5]) == 5.0


def test_roundtrip_error_bounded():
    """Mirror of tests/test_ops.py::test_quantize_roundtrip_error_bounded."""
    n = 5000
    x = _x(n, seed=2)
    q, scales = tq.quantize_int8(torch.from_numpy(x))
    out = tq.dequantize_int8(q, scales, n).numpy()
    per_elem_scale = np.repeat(scales.numpy()[:, 0], 128)[:n]
    assert np.all(np.abs(out - x) <= per_elem_scale * 0.5 + 1e-6)
    wire = q.numel() + scales[:, 0].numel() * 4
    assert wire * 3 <= x.nbytes + 4 * 128 * 32 * 4
    out2 = tq.dequantize_int8(q, scales[:, 0].clone(), n).numpy()
    np.testing.assert_array_equal(out2, out)


def test_zero_input_and_padding_rows():
    q, s = tq.quantize_int8(torch.zeros(1024))
    assert tuple(q.shape) == (32, 128)
    assert torch.all(q == 0) and torch.all(s == np.float32(1e-12))
    np.testing.assert_array_equal(tq.dequantize_int8(q, s, 1024).numpy(), 0)
    # Rows past the input (tile padding) hold q = 0 and scale 1e-12.
    q, s = tq.quantize_int8(torch.full((200,), 3.0))
    assert torch.all(q[2:] == 0) and torch.all(s[2:] == np.float32(1e-12))
    assert torch.all(q[0] == 127) and torch.all(q[1, :72] == 127)
    assert torch.all(q[1, 72:] == 0)


def test_dequantize_length_is_capped_at_the_codes():
    q, s = tq.quantize_int8(torch.ones(100))
    assert tq.dequantize_int8(q, s, 10 ** 9).shape == (32 * 128,)


def test_numpy_helpers_match_jax():
    x = _x(1000, seed=4)
    tqv, tsv, tn = tq.np_quantize_int8(x)
    jqv, jsv, jn = jq.np_quantize_int8(x)
    np.testing.assert_array_equal(tqv, jqv)
    np.testing.assert_array_equal(tsv, jsv)
    assert tn == jn == 1000
    np.testing.assert_array_equal(tq.np_dequantize_int8(tqv, tsv, tn),
                                  jq.np_dequantize_int8(jqv, jsv, jn))


def test_numpy_helper_scale_is_the_true_division():
    """The host helper divides by 127; the kernel multiplies by the f32
    reciprocal.  Both stay within one ulp of each other."""
    x = _x(128 * 512, seed=6)
    _, hs, _ = tq.np_quantize_int8(x)
    _, ks = tq.quantize_int8(torch.from_numpy(x))
    ks = ks.numpy()[: hs.size, 0]
    assert np.all(np.abs(hs - ks) <= np.spacing(hs))


def test_wrappers_on_cpu_count_no_launches():
    tq.reset_launches()
    q, s = tq.quantize_int8(torch.ones(10))
    tq.dequantize_int8(q, s, 10)
    assert sum(tq.launches.values()) == 0


def test_bad_operands_raise():
    with pytest.raises(AssertionError, match="float32"):
        tq.quantize_int8(torch.ones(10, dtype=torch.float64))
    q, s = tq.quantize_int8(torch.ones(10))
    with pytest.raises(AssertionError, match="int8"):
        tq.dequantize_int8(q.float(), s, 10)
    with pytest.raises(AssertionError, match="scales"):
        tq.dequantize_int8(q, s[:5], 10)


def test_ops_package_exports_match_jax():
    import pslite_tpu.ops as jops
    import pslite_tpu_torch.ops as tops

    assert sorted(tops.__all__) == sorted(jops.__all__)
    assert tops.quantize_int8 is tq.quantize_int8
