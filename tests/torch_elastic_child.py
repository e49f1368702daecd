"""One node of the recovery tests' clusters (tests/test_torch_recovery.py).

Launched once per role by a launcher with keepalive (the port's
``pslite_tpu_torch.tracker.local``), never by pytest itself, as
``tests/elastic_child.py`` is for JAX's launcher.  Worker rank 1 pushes,
then exits 254 (a crash after its push, before finalize) until it has
crashed ``PS_ELASTIC_CRASHES`` times, counted in the marker file
``argv[1]``; the launcher restarts it each time, and the scheduler's
recovery hands it its dead id back.  Worker rank 0 pulls until the
server's store holds every push, exactly: rank 0's once and rank 1's
once per life.  Every push is one key of ``VAL_LEN`` float32 (2 MiB, so
it travels in chunks: a restarted sender's transfer ids start at 1
again), seeded small integers, so any order of addition gives the same
bits.

- ``PSTEST_PKG`` (``port`` or ``jax``), or ``PSTEST_PKG_<ROLE>`` for one
  role: the package this node runs.
- ``PSTEST_OUT``: the server writes ``server.npz`` (its store) there.
- ``PS_FORCE_REQ_ORDER`` reaches only the JAX nodes.

Each node prints ``LIFE <role> rank=<r> id=<id> recovery=<0|1>``,
``RECOVERED_OK`` on a recovered life, ``POLL_OK`` when the store was
complete, and ``ELASTIC_DONE`` after finalize.
"""

import faulthandler
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import numpy as np  # noqa: E402

KEY = 42
VAL_LEN = 1 << 19  # 2 MiB of float32: chunked at the 1 MiB default
DEADLINE = float(os.environ.get("PSTEST_DEADLINE", "120"))


def push_vals(rank: int, life: int) -> np.ndarray:
    rng = np.random.default_rng(1000 * rank + life)
    return rng.integers(-8, 8, VAL_LEN).astype(np.float32)


def expected(crashes: int) -> np.ndarray:
    """Rank 0's push plus one push per life of rank 1."""
    want = push_vals(0, 0).copy()
    for life in range(crashes + 1):
        want += push_vals(1, life)
    return want


def api(role: str):
    pkg = os.environ.get(f"PSTEST_PKG_{role.upper()}",
                         os.environ.get("PSTEST_PKG", "port"))
    if pkg == "jax":
        import pslite_tpu as ps
        from pslite_tpu.message import Role

        return ps, Role[role.upper()]
    # Sid reordering is the JAX nodes' alone: the port delivers in
    # arrival order and refuses the knob by name.
    os.environ.pop("PS_FORCE_REQ_ORDER", None)
    import pslite_tpu_torch as ps

    return ps, role


def say(line: str) -> None:
    """One output line in one write: every node of the cluster shares
    the launcher's pipe, and under ``PYTHONUNBUFFERED=1`` ``print``
    writes the text and its newline apart, so another node's line can
    land between them (seen as ``LIFE scheduler ...LIFE worker ...`` on
    one line, which the test's line parsing then misses)."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def main() -> int:
    role = os.environ["DMLC_ROLE"]
    marker = sys.argv[1]
    want = int(os.environ.get("PS_ELASTIC_CRASHES", "1"))
    crashes = 0
    if os.path.exists(marker):
        crashes = int(open(marker).read().strip() or "0")
    if role == "worker" and crashes:
        # A recovered life: let the scheduler see the old id as dead.
        time.sleep(float(os.environ.get("PS_HEARTBEAT_TIMEOUT", "2")) + 1.5)
    ps, role_key = api(role)
    po = ps.Postoffice(role_key)
    po.start()
    rank = po.my_rank()
    say(f"LIFE {role} rank={rank} id={po.van.my_node.id} "
        f"recovery={int(po.is_recovery)}")
    server = None
    if role == "server":
        server = ps.KVServer(0, postoffice=po)
        server.set_request_handle(ps.KVServerDefaultHandle())
    if role == "worker":
        kv = ps.KVWorker(0, 0, postoffice=po)
        keys = np.array([KEY], np.uint64)
        kv.wait(kv.push(keys, push_vals(rank, crashes if rank == 1 else 0)))
        if rank == 1 and crashes < want:
            with open(marker, "w") as f:
                f.write(str(crashes + 1))
            os._exit(254)  # after the push, before finalize
        if po.is_recovery:
            say("RECOVERED_OK")
        if rank == 0:
            target = expected(want)
            out = np.zeros(VAL_LEN, np.float32)
            end = time.monotonic() + DEADLINE
            while time.monotonic() < end:
                kv.wait(kv.pull(keys, out))
                if out.tobytes() == target.tobytes():
                    say("POLL_OK")
                    break
                time.sleep(0.2)
            else:
                say(f"POLL_FAIL {float(out[:4].sum())}")
                return 1
        kv.stop()
    po.finalize()
    if server is not None:
        np.savez(os.path.join(os.environ["PSTEST_OUT"], "server.npz"),
                 **{str(k): v for k, v in server._handle.store.items()})
        server.stop()
    say(f"{role} ELASTIC_DONE")
    return 0


if __name__ == "__main__":
    faulthandler.dump_traceback_later(DEADLINE + 30, exit=True)
    sys.exit(main())
