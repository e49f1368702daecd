"""One process of the two-worker reshard crash tests of
tests/test_torch_reshard_crash.py, never run by pytest itself.

The parent sets the ``DMLC_*`` variables of an ``ici_tcp`` cluster,
``PS_RESHARD_TMO_S`` and:

- ``PSTEST_ROLES``: ``scheduler,server`` (started, then idle until the
  parent kills the process) or ``worker``;
- ``PSTEST_CRASH``: what this worker does: ``survive`` (reshards),
  ``exit_before`` (exits with code 42 before the reshard, sending no
  barrier request) or ``stage_fail`` (its staging fails at the first
  placement, then it reports as the others do).

A worker runs its engine on ``DeviceGroup(8, device="cpu")``, push_pulls
a registered bucket (8 x 1.0 per element), calls ``KVWorker.reshard``
onto 4 ranks, and prints ``CRASH_OK untouched=<bool> <error type>`` when
the reshard raised with its engine still on 8 ranks and its store whole,
or ``CRASH_FAIL ...``.  It then exits without ``finalize`` (the cluster
is degraded by design).  ``PSTEST_DEADLINE`` (default 60) seconds bound
every process.
"""

import faulthandler
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

DEADLINE = float(os.environ.get("PSTEST_DEADLINE", "60"))


def worker(ps, po) -> None:
    kv = ps.KVWorker(0, 0, postoffice=po)
    eng = kv.engine
    keys = np.arange(4, dtype=np.uint64)
    kv.register_dense("g", keys, 8)
    outs = np.zeros(32, np.float32)
    kv.wait(kv.push_pull(keys, np.ones(32, np.float32), outs))
    assert np.array_equal(outs, np.full(32, 8.0))
    mode = os.environ["PSTEST_CRASH"]
    if mode == "exit_before":
        sys.stdout.flush()
        os._exit(42)
    if mode == "stage_fail":
        from pslite_tpu_torch.parallel import placement

        real = placement.place

        def fail_first(*a, **kw):
            placement.place = real
            raise RuntimeError("injected staging failure")

        placement.place = fail_first
    padded = eng.bucket("g").padded_len
    try:
        kv.reshard(ps.DeviceGroup(4, device="cpu"))
        print("CRASH_FAIL reshard succeeded with a failed peer", flush=True)
    except Exception as exc:  # noqa: BLE001 - the expected abort
        ok = (eng.num_shards == 8 and eng.bucket("g").padded_len == padded
              and bool((eng.store_array("g") == 8.0).all()))
        print(f"CRASH_OK untouched={ok} {type(exc).__name__}: {exc}",
              flush=True)
    sys.stdout.flush()
    os._exit(0)


def main() -> int:
    import pslite_tpu_torch as ps
    from pslite_tpu_torch.environment import Environment

    roles = os.environ["PSTEST_ROLES"].split(",")
    nodes = [ps.Postoffice(r, env=Environment({})) for r in roles]
    for po in nodes:
        if po.is_worker:
            po.van.set_mesh(ps.DeviceGroup(8, device="cpu"))
    threads = [threading.Thread(target=po.start, daemon=True) for po in nodes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(DEADLINE)
    if any(t.is_alive() for t in threads):
        raise TimeoutError("a node did not start within the deadline")
    print(f"STARTED {roles}", flush=True)
    if nodes[0].is_worker:
        worker(ps, nodes[0])
    time.sleep(DEADLINE)  # the scheduler's process waits to be killed
    return 0


if __name__ == "__main__":
    faulthandler.dump_traceback_later(DEADLINE, exit=True)
    sys.exit(main())
