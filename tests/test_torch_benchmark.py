"""The port's benchmark CLI (``python -m pslite_tpu_torch.benchmark``)
under the port's launcher, mirroring ``tests/test_benchmark_cli.py``:
``push_then_pull`` at 16 KiB x 4 keys per server over tcp (the fused
``push_pull`` in ``test_torch_bench_harness.py``), and
``ENABLE_RECV_BUFFER=1`` over shm with in-place deliveries counted on
both sides.  Each run's lines carry the same tags as the JAX CLI's on
the same cluster, run beside it; no timing is asserted."""

import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(pkg: str, mode: str, van: str = "tcp", servers: int = 2,
         env_extra=None) -> str:
    env = dict(os.environ, NUM_KEY_PER_SERVER="4", **(env_extra or {}))
    proc = subprocess.run(
        [sys.executable, "-m", f"{pkg}.tracker.local", "-n", "1", "-s",
         str(servers), "--van", van, "--", sys.executable, "-m",
         f"{pkg}.benchmark", "--len", "16384", "--repeat", "4", "--mode",
         mode],
        capture_output=True, timeout=240, env=env, cwd=_REPO)
    out = proc.stdout.decode()
    assert proc.returncode == 0, (pkg, proc.stderr.decode()[-1500:])
    return out


def _both(**kw):
    with ThreadPoolExecutor(2) as ex:
        jax_out, port_out = ex.map(lambda pkg: _cli(pkg, **kw),
                                   ("pslite_tpu", "pslite_tpu_torch"))
    return jax_out, port_out


def _tags(out: str) -> list:
    """Each line's tag (``push``, ``CHECK_OK``, ...), numbers dropped."""
    return [re.split(r"[: ]", ln)[0] for ln in out.splitlines()
            if re.match(r"^(push|pull|push_pull|CHECK_OK|\w*RECV_BUFFER)",
                        ln)]


def test_benchmark_cli_over_the_port_launcher():
    jax_out, out = _both(mode="push_then_pull")
    assert "Gbps" in out and "CHECK_OK" in out
    assert _tags(out) == _tags(jax_out)
    for m in re.finditer(r"([0-9.]+) Gbps, avg latency ([0-9.]+) us/key",
                         out):
        assert float(m.group(1)) > 0 and float(m.group(2)) > 0


def test_benchmark_cli_recv_buffer_mode():
    """ENABLE_RECV_BUFFER=1 (test_benchmark.cc:268-320): registered
    buffers on both sides over the shm van, in-place deliveries counted
    and non-zero, as in JAX's run."""
    jax_out, out = _both(mode="push_then_pull", van="shm", servers=1,
                         env_extra={"ENABLE_RECV_BUFFER": "1"})
    assert "CHECK_OK" in out
    assert sorted(_tags(out)) == sorted(_tags(jax_out))
    hits = {m.group(1): int(m.group(2))
            for m in re.finditer(r"(\w*RECV_BUFFER_HITS) (\d+)", out)}
    want = {m.group(1): int(m.group(2))
            for m in re.finditer(r"(\w*RECV_BUFFER_HITS) (\d+)", jax_out)}
    assert sorted(hits) == sorted(want), (out[-1200:], jax_out[-1200:])
    assert hits.get("RECV_BUFFER_HITS", 0) > 0, out[-1200:]
    assert hits.get("SERVER_RECV_BUFFER_HITS", 0) > 0, out[-1200:]


def test_benchmark_main_needs_a_role():
    """Outside a launcher the CLI has no role, as JAX's."""
    from pslite_tpu_torch import benchmark

    env = {k: v for k, v in os.environ.items() if k != "DMLC_ROLE"}
    res = subprocess.run(
        [sys.executable, "-c", "import sys; from pslite_tpu_torch import "
         "benchmark; sys.exit(benchmark.main(['--repeat', '1']))"],
        capture_output=True, text=True, timeout=60, env=env, cwd=_REPO)
    assert res.returncode != 0 and "DMLC_ROLE" in res.stderr
    assert benchmark.MODES[:4] == ("push_then_pull", "push_pull",
                                   "push_only", "pull_only")

