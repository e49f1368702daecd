"""Elastic recut + dispatch amortization on the collective data plane.

(The port's copy of ``examples/elastic_replay.py``.)  Single-process
demo (the ici van's in-process control plane) showing the round-3
tiers:

1. ``KVWorker.replay``   — T training steps in ONE call (one
   ``ring_replay`` launch where the ring serves the handle; the
   stateful handle here runs its steps back to back on the device).
2. ``KVWorker.push_pull_stream`` — host-origin gradients staged on a
   background thread while the collectives run (transfer/compute
   overlap).
3. ``KVWorker.reshard``  — live elastic recut of the server fleet: the
   kv axis shrinks to half the ranks mid-run, state (including fused
   optimizer slots) survives, training continues on the new fan-in.

Run (``--ranks`` virtual ranks on ``--device``, 8 on the card by
default, as the original's CPU recipe forces 8 devices)::

    python examples/torch/elastic_replay.py
    python examples/torch/elastic_replay.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

import pslite_tpu_torch as ps  # noqa: E402
from pslite_tpu_torch.environment import Environment  # noqa: E402
from pslite_tpu_torch.message import Role  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ranks", type=int, default=8,
                    help="virtual ranks (the original's devices)")
    ap.add_argument("--device", default="cuda:0",
                    help="torch device of every rank ('cpu' runs the "
                         "plain PyTorch versions)")
    args = ap.parse_args()
    env = {
        "DMLC_NUM_WORKER": "1",
        "DMLC_NUM_SERVER": "1",
        "DMLC_PS_ROOT_URI": "lo",
        "DMLC_PS_ROOT_PORT": "20700",
        "PS_VAN_TYPE": "ici",
        "PS_ICI_SERVER_HANDLE": "sgd_momentum:0.1,0.9",
    }
    import threading

    scheduler = ps.Postoffice(Role.SCHEDULER, env=Environment(env))
    server = ps.Postoffice(Role.SERVER, env=Environment(env))
    worker_po = ps.Postoffice(Role.WORKER, env=Environment(env))
    worker_po.van.set_mesh(ps.DeviceGroup(args.ranks, device=args.device))
    # Bootstrap concurrently: the scheduler's start blocks until every
    # node has registered.
    threads = [threading.Thread(target=po.start, args=(0,))
               for po in (scheduler, server, worker_po)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    kv = ps.KVWorker(0, 0, postoffice=worker_po)
    eng = kv.engine
    n = eng.num_shards
    print(f"mesh: {n} server shards (devices)")
    if n < 2:
        print(
            "NOTE: only 1 rank — the elastic recut below will be a "
            "no-op; run with --ranks 8 to see the fleet shrink."
        )

    keys = np.arange(8, dtype=np.uint64)
    val_len = 1024
    kv.register_dense("params", keys, val_len)
    total = 8 * val_len

    # --- 1. fused replay: 10 optimizer steps, one call -----------------
    rng = np.random.default_rng(0)
    seq = rng.normal(size=(10, total)).astype(np.float32) * 0.01
    pulled = kv.replay("params", seq).cpu().numpy()
    print(f"replay: 10 fused sgd+momentum steps -> params[0]="
          f"{pulled[-1][0]:+.5f}")

    # --- 2. streamed host-origin steps ---------------------------------
    batches = (rng.normal(size=(total,)).astype(np.float32) * 0.01
               for _ in range(5))
    last = None
    for out in kv.push_pull_stream("params", batches):
        last = out
    print(f"stream: 5 staged steps  -> params[0]="
          f"{float(last[0]):+.5f}")

    # --- 3. elastic recut: half the fleet ------------------------------
    half = ps.DeviceGroup(max(1, n // 2), device=eng.device)
    kv.reshard(half)
    print(f"reshard: {n} -> {eng.num_shards} shards (state preserved)")
    out = kv.replay("params", seq[:2], keep="last").cpu().numpy()
    print(f"post-recut replay ok    -> params[0]={out[0]:+.5f}")

    # Finalize concurrently (the shutdown barrier spans every role).
    fin = [threading.Thread(target=po.finalize, args=(0,))
           for po in (worker_po, server, scheduler)]
    for t in fin:
        t.start()
    for t in fin:
        t.join()
    print("DONE")


if __name__ == "__main__":
    main()
