"""Two workers of the port's benchmark CLI on the same keys: each one's
last push and pull run while the other waits at a barrier, so both echo
checks hold.  (The JAX CLI's check races there: the other worker's push
can land between them, and the assign handle then echoes its values.)"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(mode: str, van: str) -> tuple:
    env = dict(os.environ, NUM_KEY_PER_SERVER="4")
    proc = subprocess.run(
        [sys.executable, "-m", "pslite_tpu_torch.tracker.local", "-n", "2",
         "-s", "2", "--van", van, "--", sys.executable, "-m",
         "pslite_tpu_torch.benchmark", "--len", "16384", "--repeat", "2",
         "--mode", mode],
        capture_output=True, timeout=240, env=env, cwd=_REPO)
    return proc.returncode, proc.stdout.decode(), proc.stderr.decode()


@pytest.fixture(scope="module")
def runs():
    cases = [(m, v) for m in ("push_pull", "push_then_pull")
             for v in ("tcp", "shm")]
    with ThreadPoolExecutor(len(cases)) as ex:
        return dict(zip(cases, ex.map(lambda c: _run(*c), cases)))


@pytest.mark.parametrize("van", ["tcp", "shm"])
@pytest.mark.parametrize("mode", ["push_pull", "push_then_pull"])
def test_two_workers_check_their_echo_in_turn(runs, mode, van):
    rc, out, err = runs[(mode, van)]
    assert rc == 0, err[-1500:]
    assert out.count("CHECK_OK") == 2, out
