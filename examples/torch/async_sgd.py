"""Asynchronous SGD with the optimizer ON the server.

(The port's copy of ``examples/async_sgd.py``.)

The reference's async mode (docs/overview.md there): workers push
gradients whenever ready — no inter-worker barrier — and the server
applies each push on arrival.  Here the server owns the optimizer
(``KVServerOptimizerHandle``), so workers exchange raw gradients and
pull ready-to-use parameters.

Run a 2-worker async cluster on one machine::

    python -m pslite_tpu_torch.tracker.local -n 2 -s 1 -- \
        python examples/torch/async_sgd.py
    PS_PRIORITY_SCHED=1 python -m pslite_tpu_torch.tracker.local -n 2 -s 1 -- \
        python examples/torch/async_sgd.py     # + priority send scheduling

Each worker fits y = Wx on its own data shard; staleness from async
application is tolerated by SGD (the classic PS trade described in the
reference's overview).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

import pslite_tpu_torch as ps  # noqa: E402

DIM = 8
KEYS = np.arange(4, dtype=np.uint64)  # 4 param blocks of DIM floats
STEPS = 40


def main() -> None:
    role = os.environ.get("DMLC_ROLE")
    if role is None:
        sys.exit(
            "DMLC_ROLE not set — run under the launcher:\n"
            "  python -m pslite_tpu_torch.tracker.local -n 2 -s 1 -- "
            "python examples/torch/async_sgd.py"
        )
    ps.start_ps()

    server = None
    if role in ("server", "joint"):
        server = ps.KVServer(0)
        server.set_request_handle(
            ps.KVServerOptimizerHandle(kind="sgd_momentum", lr=0.05)
        )

    if role in ("worker", "joint"):
        po = ps.postoffice(ps.Role.WORKER)
        kv = ps.KVWorker(0, 0)
        rank = po.my_rank()
        rng = np.random.default_rng(100 + rank)
        w_true = np.linspace(-1, 1, len(KEYS) * DIM).astype(np.float32)

        params = np.zeros(len(KEYS) * DIM, np.float32)
        last_loss = None
        for step in range(STEPS):
            # Local data shard -> gradient of 0.5*||w - w_true||^2 noise-
            # perturbed (stands in for a minibatch gradient).
            grad = (params - w_true) + rng.normal(
                scale=0.05, size=params.shape
            ).astype(np.float32)
            # Fire-and-forget push (async mode: NO barrier with the other
            # worker); wait only guards local buffer reuse.
            kv.wait(kv.push(KEYS, grad, priority=step % 4))
            kv.wait(kv.pull(KEYS, params))
            last_loss = float(0.5 * np.mean((params - w_true) ** 2))
            if rank == 0 and step % 10 == 0:
                print(f"step {step:3d}  loss {last_loss:.5f}", flush=True)
        print(f"worker {rank}: final loss {last_loss:.5f}", flush=True)
        assert last_loss < 0.05, last_loss

    ps.finalize()
    if server is not None:
        server.stop()
    print(f"{role} DONE", flush=True)


if __name__ == "__main__":
    main()
