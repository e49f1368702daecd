"""The port's message-path tier harnesses (``_small_op_run``,
``_serving_fanin_run`` of ``pslite_tpu_torch/benchmark.py``) against
JAX's at quick sizes (0.5 s windows): real tcp clusters, one process per
node, under each package's launcher, run side by side.  The result keys
match, the batch planes really form, every spot-checked value is exact.
No timing is asserted."""

from test_torch_bench_harness import _both


def test_small_op_storm_leg_matches_jax_keys():
    want, got = _both("_small_op_run", 0.5, batch=True)
    assert sorted(got) == sorted(want)
    assert got["ops"] > 0 and got["msgs_per_s"] > 0
    assert got["ops_per_frame"] > 1.0  # multi-op frames really formed
    assert got["store_exact"] and want["store_exact"]
    assert got["p99_ms"] >= got["p50_ms"] >= 0


def test_serving_fanin_leg_matches_jax_keys():
    want, got = _both("_serving_fanin_run", 0.5, batch=True)
    assert sorted(got) == sorted(want)
    assert got["reqs"] > 0 and got["servers"] == want["servers"] == 2
    assert got["fanout"] == want["fanout"]
    assert got["frames_per_req"] < got["fanout"] / 4
    assert got["store_exact"] and want["store_exact"]
    assert got["p99_ms"] >= got["p50_ms"] >= 0
