"""The port's stress patterns (``pslite_tpu_torch/stress.py``) against
JAX's (``pslite_tpu/stress.py``): each pattern through JAX's
``run_pattern`` on the 8-device CPU mesh and the port's on
``DeviceGroup(8, device="cpu")``; the stores, tables and pulls after the
same calls are equal, and equal to a float64 numpy model (the sums are
integer-valued, so exact).  The port runs under both impls (the ring's
plain version and the rank-order adds); JAX's interpret-mode ring is
held against the port's in ``test_torch_stress_pallas.py``."""

import re

import numpy as np
import pytest

from pslite_tpu import stress as jstress
from pslite_tpu.parallel.engine import CollectiveEngine as JaxEngine
from pslite_tpu.parallel.sparse import SparseEngine as JaxSparse
from pslite_tpu_torch import stress as tstress
from pslite_tpu_torch.parallel.engine import CollectiveEngine
from pslite_tpu_torch.parallel.mesh import DeviceGroup
from pslite_tpu_torch.parallel.sparse import SparseEngine

W = 8
SIZE = 4096 * 8  # bytes per tensor: 8,192 f32, 64 table rows of 128
ITERS = 2


def _state(eng, sp, pattern: str, size: int) -> np.ndarray:
    """The pattern's bucket pulled, or its whole table (every row)."""
    name = f"stress_{pattern}_{size}"
    if pattern == "datascatter":
        tbl = f"{name}_tbl"
        rows = np.tile(np.arange(sp.table(tbl).num_rows, dtype=np.int32),
                       (W, 1))
        out = sp.pull(tbl, rows)
        return np.asarray(out.cpu() if hasattr(out, "cpu") else out)[0]
    out = eng.pull(name)
    return np.asarray(out.cpu() if hasattr(out, "cpu") else out)


def _model(pattern: str, size: int, calls: int) -> np.ndarray:
    """float64 numpy result of ``calls`` ops of the pattern (the warm-up
    included) on fresh state."""
    n = max(size // 4, W)
    if pattern == "datascatter":
        rows = max(n // 128, W)
        idx = np.random.default_rng(0).integers(0, rows, size=(W, rows // W))
        table = np.zeros((rows, 128), np.float64)
        for _ in range(calls):
            np.add.at(table, idx.reshape(-1), 1.0)
        return table
    if pattern == "gather":
        return np.zeros(n, np.float64)
    return np.full(n, float(W * calls))


def run_jax(impl, pattern, size=SIZE, iters=ITERS, measure=None):
    eng = JaxEngine(impl=impl)
    sp = JaxSparse(eng.mesh, eng.axis)
    gbps = jstress.run_pattern(eng, sp, pattern, size, iters, measure)
    return gbps, _state(eng, sp, pattern, size)


def run_port(impl, pattern, size=SIZE, iters=ITERS, measure=None):
    eng = CollectiveEngine(DeviceGroup(W, device="cpu"), impl=impl)
    sp = SparseEngine(eng.group, eng.axis)
    gbps = tstress.run_pattern(eng, sp, pattern, size, iters, measure)
    return gbps, _state(eng, sp, pattern, size)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("pattern", tstress.PATTERNS)
def test_pattern_matches_jax_and_float64(pattern, impl):
    """JAX's rank-order program against the port under ``impl`` (its
    ring's plain version on the CPU for ``pallas``): equal stores and
    tables, exact against float64."""
    jg, jax_state = run_jax("xla", pattern)
    tg, port_state = run_port(impl, pattern)
    assert jg > 0 and tg > 0
    np.testing.assert_array_equal(port_state, jax_state)
    np.testing.assert_array_equal(port_state.astype(np.float64),
                                  _model(pattern, SIZE, ITERS + 1))


def test_unavailable_clock_reads_as_zero_goodput():
    """``measure`` returning None (no device events in the trace) gives
    0.0 and never runs the timed loop, in both packages."""
    for pattern in tstress.PATTERNS:
        tg, port_state = run_port("xla", pattern, measure=lambda loop: None)
        jg, jax_state = run_jax("xla", pattern, measure=lambda loop: None)
        assert tg == jg == 0.0
        np.testing.assert_array_equal(port_state, jax_state)
        np.testing.assert_array_equal(port_state, _model(pattern, SIZE, 1))


def test_patterns_share_one_engine_and_the_clock_swap():
    """One engine for every pattern, as ``main`` drives them; a
    ``measure`` clock gives the same goodput formula in both packages."""
    eng = CollectiveEngine(DeviceGroup(W, device="cpu"))
    sp = SparseEngine(eng.group, eng.axis)
    jeng = JaxEngine(impl="xla")
    jsp = JaxSparse(jeng.mesh, jeng.axis)

    def measure(loop):
        loop()
        return 0.5

    for pattern in tstress.PATTERNS:
        got = tstress.run_pattern(eng, sp, pattern, SIZE, ITERS, measure)
        want = jstress.run_pattern(jeng, jsp, pattern, SIZE, ITERS, measure)
        assert got == want
        np.testing.assert_array_equal(_state(eng, sp, pattern, SIZE),
                                      _state(jeng, jsp, pattern, SIZE))


def test_threads_share_one_engine(capsys):
    """``--threads 2`` runs dense, gather and scatter from two host
    threads on one engine (datascatter stays single); one line per
    pattern, as JAX prints."""
    rc = tstress.main(["--ranks", "8", "--device", "cpu", "--len",
                       str(SIZE), "--repeat", "2", "--threads", "2"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == list(tstress.PATTERNS)
    # Three decimals, as JAX prints (a slow CPU may print 0.000).
    assert all(re.fullmatch(r"\w+: \d+\.\d{3} Gbps", ln) for ln in lines)


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstress.main(["--len", str(SIZE)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstress.make_group(ranks=8)
    assert tstress.make_group(device="cpu").num_ranks == 1
    assert tstress.make_group(8, "cpu").num_ranks == 8
