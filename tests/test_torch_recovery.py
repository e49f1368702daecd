"""Restart-based recovery through the port's launcher, mirroring
``tests/test_elastic.py``, on every socket plane and in mixed clusters.

``python -m pslite_tpu_torch.tracker.local -n 2 -s 1`` runs
``tests/torch_elastic_child.py`` per role: worker rank 1 crashes (exit
254) after its push, the launcher's keepalive restarts it, the
scheduler hands the restarted process its dead id back (``is_recovery``:
no startup barrier), and its peers reset their sequence state toward
it; worker rank 0 polls until the server's store holds every push.
Each push is 2 MiB, so it travels in chunks and a stale transfer-id
tombstone of the old life would swallow the new life's push.

- The port alone over tcp on the native core (1 and 2 crashes), on the
  Python plane (``PS_NATIVE=0``), over ``shm`` and over ``multi`` with
  2 rails.
- Mixed: JAX workers recovering into a port scheduler and server, and
  port workers into a JAX scheduler and server, with
  ``PS_FORCE_REQ_ORDER=1`` on the JAX nodes (the port refuses the knob)
  so a JAX node that receives from a recovered peer's survivors insists
  on sids from 0 (the port's native lane resets its sid:
  ``send_reset_sid``).  The server's store is bit-equal
  to the all-JAX run's (tolerance: none; the pushes are small integers,
  so every order of addition gives the same bits).

Every run is bounded by ``timeout`` (and the children's own deadline).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import torch_elastic_child as child
from pslite_tpu_torch.vans.shm_van import SHM_DIR

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_HERE)
CHILD = os.path.join(_HERE, "torch_elastic_child.py")
HB = {"PS_HEARTBEAT_INTERVAL": "1", "PS_HEARTBEAT_TIMEOUT": "2"}  # JAX's


def launch(tmp_path, crashes=1, van="tcp", launcher="pslite_tpu_torch",
           **extra):
    """One launcher run; returns (returncode, output, server store)."""
    marker = tmp_path / "crashed"
    env = dict(os.environ, PS_ELASTIC_CRASHES=str(crashes),
               PSTEST_OUT=str(tmp_path), **HB, **extra)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-m", f"{launcher}.tracker.local", "-n", "2", "-s",
         "1", "--van", van, "--", sys.executable, CHILD, str(marker)],
        capture_output=True, timeout=180 + 60 * crashes, env=env,
        cwd=_REPO)
    out = proc.stdout.decode() + proc.stderr.decode()
    store = None
    if os.path.exists(tmp_path / "server.npz"):
        with np.load(tmp_path / "server.npz") as z:
            store = {k: z[k] for k in z.files}
    return proc.returncode, out, store, marker


def check_recovered(rc, out, store, marker, crashes):
    assert rc == 0, out[-4000:]
    assert marker.read_text().strip() == str(crashes)
    assert out.count("restarting worker (exit 254)") == crashes, out[-4000:]
    assert out.count("RECOVERED_OK") == 1
    assert "POLL_OK" in out
    assert out.count("ELASTIC_DONE") == 4, out[-4000:]
    # Every life of rank 1 ran under the id of the first.
    lives = [ln for ln in out.splitlines()
             if ln.startswith("LIFE worker rank=1")]
    assert len(lives) == crashes + 1
    assert len({ln.split()[3] for ln in lives}) == 1
    assert [ln.endswith("recovery=1") for ln in lives] == (
        [False] + [True] * crashes)
    assert sorted(store) == [str(child.KEY)]
    assert (store[str(child.KEY)].tobytes()
            == child.expected(crashes).tobytes())


@pytest.mark.parametrize("van,crashes,extra", [
    ("tcp", 1, {}),
    ("tcp", 2, {}),
    ("tcp", 1, {"PS_NATIVE": "0"}),
    ("shm", 1, {}),
    ("multi", 1, {"DMLC_NUM_PORTS": "2"}),
], ids=["tcp-native", "tcp-native-2crashes", "tcp-python", "shm",
        "multi-2rails"])
def test_worker_crash_recovery_end_to_end(tmp_path, van, crashes, extra):
    if van == "shm":
        extra = dict(extra, PS_SHM_NS=f"torchrecov{os.getpid()}")
    try:
        check_recovered(*launch(tmp_path, crashes, van, **extra), crashes)
    finally:
        if van == "shm":
            # The crashed lives never unlinked their segments.
            for f in os.listdir(SHM_DIR):
                if extra["PS_SHM_NS"] in f:
                    try:
                        os.unlink(os.path.join(SHM_DIR, f))
                    except OSError:
                        pass


@pytest.fixture(scope="module")
def jax_store(tmp_path_factory):
    """The scenario on an all-JAX cluster through JAX's launcher."""
    tmp = tmp_path_factory.mktemp("alljax")
    rc, out, store, marker = launch(tmp, 1, launcher="pslite_tpu",
                                    PSTEST_PKG="jax",
                                    PS_FORCE_REQ_ORDER="1")
    check_recovered(rc, out, store, marker, 1)
    return store


@pytest.mark.parametrize("workers,rest", [("jax", "port"), ("port", "jax")],
                         ids=["jax_worker_port_cluster",
                              "port_worker_jax_cluster"])
def test_mixed_recovery_bit_equal_to_jax(tmp_path, jax_store, workers,
                                         rest):
    rc, out, store, marker = launch(
        tmp_path, 1, PSTEST_PKG_WORKER=workers, PSTEST_PKG_SERVER=rest,
        PSTEST_PKG_SCHEDULER=rest, PS_FORCE_REQ_ORDER="1")
    check_recovered(rc, out, store, marker, 1)
    assert store.keys() == jax_store.keys()
    for k in store:
        assert store[k].dtype == jax_store[k].dtype
        assert store[k].tobytes() == jax_store[k].tobytes()
