"""The port's in-process benches and one subprocess harness
(``pslite_tpu_torch/benchmark.py``) against JAX's, mirroring
``tests/test_bench_smoke.py``'s harness tests at quick sizes: the same
result keys, the same work counted, the stores exact.  No timing is
asserted."""

import re
from concurrent.futures import ThreadPoolExecutor

import pslite_tpu.benchmark as jb
import pslite_tpu_torch.benchmark as tb

from test_torch_benchmark import _cli


def _both(name: str, *args, **kw):
    """JAX's and the port's ``name(*args, **kw)``, run side by side."""
    with ThreadPoolExecutor(2) as ex:
        fut = [ex.submit(getattr(m, name), *args, **kw) for m in (jb, tb)]
        return [f.result() for f in fut]


def test_chunk_run_matches_jax_keys():
    """One subprocess leg of ``--mode chunk_hol`` over the port's
    launcher (8 MiB pushes in 256 KiB chunks) gives JAX's result keys."""
    want, got = _both("_chunk_run", 8, 1, str(256 << 10))
    assert sorted(got) == sorted(want)
    assert got["push_gbps"] > 0 and got["pull_samples"] >= 1
    assert got["pull_p99_ms"] >= got["pull_p50_ms"] >= 0


def test_kv_loopback_storm_counts_jax_work():
    """The loopback storm: the same keys, nodes and work counters as
    JAX's (every push counted once, histograms filled)."""
    kw = dict(n_workers=2, n_servers=2, msgs_per_worker=12,
              keys_per_msg=4, val_len=64, telemetry=True)
    want, got = (jb.kv_loopback_storm(**kw), tb.kv_loopback_storm(**kw))
    assert sorted(got) == sorted(want)
    assert got["msgs"] == want["msgs"] == 24
    assert sorted(got["telemetry"]) == sorted(want["telemetry"])
    for node, snap in got["telemetry"].items():
        ref = want["telemetry"][node]
        assert sorted(snap) == sorted(ref), node
        if node.startswith("worker"):
            assert snap["counters"]["kv.pushes"] == 12
            assert snap["counters"]["kv.pulls"] == 1
            assert snap["histograms"]["kv.push_latency_s"]["count"] == 12
        for c in ("kv.pushes", "kv.pulls"):
            assert snap["counters"].get(c) == ref["counters"].get(c), node
    off = tb.kv_loopback_storm(n_workers=1, n_servers=1, msgs_per_worker=3,
                               telemetry=False)
    assert off["telemetry"] == {} and off["msgs"] == 3


def test_admission_probe_sheds_and_stays_exact():
    want, got = jb.admission_probe(), tb.admission_probe()
    assert sorted(got) == sorted(want)
    assert got["offered"] == want["offered"]
    assert got["applied"] + got["shed"] == got["offered"]
    assert got["shed"] > 0 and got["store_exact"]


def test_fused_push_pull_cli_checks_its_echo():
    """The fused ``push_pull`` mode (the main path's op) over the port's
    launcher: the last pull echoes the last push."""
    out = _cli("pslite_tpu_torch", mode="push_pull")
    assert "CHECK_OK" in out
    rates = re.findall(r"push_pull: ([0-9.]+) Gbps", out)
    assert rates and all(float(r) > 0 for r in rates)
