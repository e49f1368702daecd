"""pslite_tpu_torch's wire codecs against the JAX package's.

The same seeded numpy inputs go through ``pslite_tpu.ops.codecs`` and
``pslite_tpu_torch.ops.codecs``.  Tolerance: none.  Codes, scales and
flags are byte-equal, decoded values and error-feedback residuals
bit-equal (compared as uint32), NaN and +/-Inf included: both sides run
the same numpy arithmetic, and the port's fp8 tables and bf16 rounding
are built to equal ``ml_dtypes``' casts, which the JAX package uses
(its native C kernels, when built, are bit-identical to its numpy path
by its own test).  ``ml_dtypes`` is installed here; the port does not
use it.
"""

import ml_dtypes
import numpy as np
import pytest

from pslite_tpu.message import CodecInfo as JCodecInfo
from pslite_tpu.ops import codecs as jc
from pslite_tpu.ops import quantize as jq
from pslite_tpu.sarray import SArray as JSArray
from pslite_tpu_torch.message import CodecInfo as TCodecInfo
from pslite_tpu_torch.ops import codecs as tc
from pslite_tpu_torch.ops import quantize as tq
from pslite_tpu_torch.sarray import SArray as TSArray

CODECS = ["int8", "fp8_e4m3", "bf16"]
# Above the 2 MiB span threshold, with a ragged last block.
N = 600_037
LENS = np.array([1, 127, 128, 129, 5000, 300_000, 294_652])  # sums to N


def _payload(seed=0, n=N):
    """Gaussian values of mixed scales, with NaN, +/-Inf and -0.0."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * np.repeat(
        10.0 ** rng.integers(-6, 6, size=n // 128 + 1), 128)[:n]).astype(
        np.float32)
    x[[3, 777, 130_001 % n]] = np.nan
    x[[9, 50_000 % n]] = np.inf
    x[[11, 400_000 % n]] = -np.inf
    x[12] = -0.0
    x[-5] = -np.nan
    return x


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


def test_registry_names_and_wire_ids_match():
    assert tc.names() == jc.names() == ["bf16", "fp8_e4m3", "int8"]
    for name in CODECS:
        t, j = tc.get_codec(name), jc.get_codec(name)
        assert (t.wire_id, t.block, t.code_bytes_per_elem) == (
            j.wire_id, j.block, j.code_bytes_per_elem)
        assert tc.by_wire_id(t.wire_id) is t
    assert tc.BLOCK == jc.BLOCK and tc.FLAG_HAS_NAN == jc.FLAG_HAS_NAN
    assert tc._native_codec() is not None  # the native core, by default
    with pytest.raises(AssertionError, match="unknown codec"):
        tc.get_codec("fp4")
    with pytest.raises(AssertionError, match="unknown codec wire id"):
        tc.by_wire_id(9)
    with pytest.raises(AssertionError, match="scale-block length"):
        tc.check_block(TCodecInfo(codec=1, raw_len=4, block=64))


@pytest.mark.parametrize("threads", ["1", "4"])
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("name", CODECS)
def test_encode_decode_byte_equal(name, ragged, threads, monkeypatch):
    monkeypatch.setenv("PS_CODEC_THREADS", threads)
    x = _payload(seed=CODECS.index(name))
    lens = LENS if ragged else None
    jcodes, jscales, jflags = jc.get_codec(name).encode(x, lens=lens)
    tcodes, tscales, tflags = tc.get_codec(name).encode(x, lens=lens)
    assert tcodes.dtype == np.uint8 and tscales.dtype == np.float32
    np.testing.assert_array_equal(tcodes, jcodes)
    np.testing.assert_array_equal(_bits(tscales), _bits(jscales))
    assert tflags == jflags
    if name == "int8":
        assert tflags == tc.FLAG_HAS_NAN
    want = jc.get_codec(name).decode(jcodes, jscales, N, lens=lens,
                                     flags=jflags)
    got = tc.get_codec(name).decode(tcodes, tscales, N, lens=lens,
                                    flags=tflags)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # NaN stays NaN; Inf stays Inf in bf16 and saturates in the others.
    assert np.isnan(got[[3, 777, 130_001]]).all()
    if name == "bf16":
        assert np.isposinf(got[9]) and np.isneginf(got[11])
    else:
        assert np.isfinite(got[[9, 11]]).all()


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("name", CODECS)
def test_error_feedback_five_rounds(name, ragged):
    """Five encodes with the residual folded in: codes and residuals
    bit-equal every round."""
    lens = LENS if ragged else None
    jr, tr = np.zeros(N, np.float32), np.zeros(N, np.float32)
    for r in range(5):
        x = _payload(seed=10 + r)
        jcodes, jscales, jflags = jc.get_codec(name).encode(x, lens=lens,
                                                            resid=jr)
        tcodes, tscales, tflags = tc.get_codec(name).encode(x, lens=lens,
                                                            resid=tr)
        np.testing.assert_array_equal(tcodes, jcodes)
        np.testing.assert_array_equal(_bits(tscales), _bits(jscales))
        assert tflags == jflags
        np.testing.assert_array_equal(_bits(tr), _bits(jr))
        assert np.isfinite(tr).all()  # NaN/Inf errors are defined as 0
        assert np.abs(tr).max() > 0


@pytest.mark.parametrize("name", ["int8", "fp8_e4m3"])
def test_decode_key_ranges_on_key_subsets(name):
    n_keys, k = 64, 700  # 700 values per key: blocks straddle keys
    x = _payload(seed=3, n=n_keys * k)
    codes, scales, flags = tc.get_codec(name).encode(x)
    full = tc.get_codec(name).decode(codes, scales, x.size, flags=flags)
    tinfo = TCodecInfo(codec=tc.get_codec(name).wire_id, raw_len=x.nbytes,
                       block=tc.BLOCK, flags=flags)
    jinfo = JCodecInfo(codec=tinfo.codec, raw_len=x.nbytes, block=tc.BLOCK,
                       flags=flags)
    for positions in (None, np.array([0, 5, 63]), np.arange(1, 64, 4)):
        got = tc.decode_key_ranges(codes, scales, tinfo, n_keys, positions)
        want = jc.decode_key_ranges(codes, scales, jinfo, n_keys, positions)
        pos = np.arange(n_keys) if positions is None else positions
        assert len(got) == len(want) == len(pos)
        for p, g, w in zip(pos, got, want):
            np.testing.assert_array_equal(_bits(g), _bits(w))
            np.testing.assert_array_equal(
                _bits(g), _bits(full[p * k:(p + 1) * k]))


def test_decode_key_ranges_refuses_bf16_and_ragged_payloads():
    info = TCodecInfo(codec=3, raw_len=4 * 256, block=0)
    codes, _, _ = tc.get_codec("bf16").encode(np.ones(256, np.float32))
    with pytest.raises(AssertionError, match="no range decode"):
        tc.decode_key_ranges(codes, np.empty(0, np.float32), info, 2)
    with pytest.raises(AssertionError, match="fixed-k"):
        tc.decode_key_ranges(codes, np.empty(0, np.float32),
                             TCodecInfo(codec=1, raw_len=4 * 255,
                                        block=128), 2)


@pytest.mark.parametrize("name", CODECS)
def test_empty_and_non_float32_values_rejected(name):
    for mod in (jc, tc):
        with pytest.raises(ValueError, match="cannot encode empty"):
            mod.get_codec(name).encode(np.empty(0, np.float32))
    with pytest.raises(AssertionError, match="requires float32"):
        tc.get_codec(name).encode(np.ones(8, np.float64))
    with pytest.raises(AssertionError, match="lens sum"):
        tc.get_codec(name).encode(np.ones(8, np.float32), lens=[3, 4])


def test_fp8_tables_equal_ml_dtypes_all_bytes():
    """Every one of the 65,536 encode entries and 256 decode entries:
    torch's own cast differs from ``ml_dtypes`` on 14,720 encode entries
    (magnitudes above 464 and Inf) and on the two NaN decode entries;
    the port's patched tables do not."""
    jenc, jdec = jc.Fp8E4M3Codec._luts()
    tenc, tdec = tc._fp8_tables()
    np.testing.assert_array_equal(tenc, jenc)
    np.testing.assert_array_equal(_bits(tdec), _bits(jdec))
    h = np.arange(65536, dtype=np.uint16).view(np.float16).astype(np.float32)
    with np.errstate(invalid="ignore"):
        ref = h.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    np.testing.assert_array_equal(tenc, ref)


def test_bf16_nan_patterns_follow_ml_dtypes():
    """10^5 random NaN bit patterns (either sign) and 10^5 random
    patterns of any kind.  The port rounds as ``ml_dtypes`` does, NaN
    written as ``0x7FC0 | sign``.  The JAX package's numpy fallback (used
    only without ``ml_dtypes``) adds in uint32, which wraps for negative
    NaNs with a high mantissa and drops their sign: it differs on about
    0.4 % of these NaN patterns.  The port follows ``ml_dtypes``."""
    rng = np.random.default_rng(7)
    mant = rng.integers(1, 1 << 23, size=100_000).astype(np.uint32)
    sign = rng.integers(0, 2, size=100_000).astype(np.uint32) << 31
    nan = (sign | 0x7F800000 | mant).view(np.float32)
    anyp = rng.integers(0, 1 << 32, size=100_000,
                        dtype=np.uint64).astype(np.uint32).view(np.float32)
    for x in (nan, anyp):
        with np.errstate(invalid="ignore"):
            ref = x.astype(ml_dtypes.bfloat16).view(np.uint16)
        np.testing.assert_array_equal(tc._bf16_bits(x), ref)
        codes, _, _ = tc.get_codec("bf16").encode(x)
        np.testing.assert_array_equal(codes.view(np.uint16), ref)
    # The JAX package's fallback arithmetic (ops/codecs.py:683-688).
    u = nan.view(np.uint32)
    fb = ((u + (((u >> 16) & 1) + 0x7FFF)) >> 16).astype(np.uint16)
    fb = 0x7FC0 | (fb & 0x8000)
    with np.errstate(invalid="ignore"):
        ref = nan.astype(ml_dtypes.bfloat16).view(np.uint16)
    share = float(np.mean(fb != ref))
    assert 0.002 < share < 0.006, share


def test_error_feedback_slots_match():
    """Slot creation, reuse, reset on a size change and LRU eviction."""
    j, t = jc.ErrorFeedback(max_slots=2), tc.ErrorFeedback(max_slots=2)
    for ef in (j, t):
        r, _ = ef.slot(("a",), 4)
        r[:] = 1.0
        assert ef.slot(("a",), 4)[0] is r
        ef.slot(("b",), 4)
        ef.slot(("c",), 4)  # evicts ("a",), the least recently used
        assert ef.evictions == 1 and len(ef) == 2
        assert not ef.slot(("b",), 8)[0].any()  # resized: reset
    assert t.residual_norm() == j.residual_norm() == 0.0
    assert tc.ef_enabled() and tc.ef_slots() == 64


def test_decode_int8_payload_matches_jax():
    x = _payload(seed=4, n=4096)
    x[~np.isfinite(x)] = 0.0
    q, s, n = jq.np_quantize_int8(x)
    tq_, ts_, tn = tq.np_quantize_int8(x)
    np.testing.assert_array_equal(tq_, q)
    want = jq.decode_int8_payload(JSArray(q.reshape(-1)), JSArray(s),
                                  x.nbytes)
    got = tq.decode_int8_payload(TSArray(q.reshape(-1)), TSArray(s),
                                 x.nbytes)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_pooled_codes_are_not_reused_while_a_view_lives():
    """A queued frame holds a view of its codes: the buffer pool must not
    hand that block out again until the view is gone."""
    pool = tc._BufPool(64)
    a = pool.take(100_000)
    codes = a[:100_000]
    del a
    b = pool.take(100_000)
    assert not np.shares_memory(codes, b)
    del codes, b
    c = pool.take(100_000)
    d = pool.take(100_000)
    assert not np.shares_memory(c, d)
