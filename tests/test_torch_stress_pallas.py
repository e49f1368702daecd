"""The stress patterns that launch K4 (``dense``: ``ring_push_pull``,
``scatter``: ``ring_push``) under ``PS_ICI_IMPL=pallas`` in both
packages: JAX's Pallas ring in interpret mode on the 8-device CPU mesh
against the port's ring (its plain version on the CPU), the pattern's
first call only (``measure`` reports the clock unavailable, so the timed
loop does not run: the interpreter takes seconds per call).  The store
and the pull are bit-equal, and exact against float64."""

import numpy as np
import pytest

from test_torch_stress import SIZE, _model, run_jax, run_port


@pytest.mark.parametrize("pattern", ["dense", "scatter"])
def test_ring_pattern_first_call_matches_jax_pallas(pattern):
    jg, jax_state = run_jax("pallas", pattern, measure=lambda loop: None)
    tg, port_state = run_port("pallas", pattern, measure=lambda loop: None)
    assert jg == tg == 0.0
    np.testing.assert_array_equal(port_state, jax_state)
    np.testing.assert_array_equal(port_state.astype(np.float64),
                                  _model(pattern, SIZE, 1))
