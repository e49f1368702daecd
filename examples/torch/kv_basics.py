"""KV push/pull basics — the ps-lite "hello world", any van.

(The port's copy of ``examples/kv_basics.py``.)

Run a 2-worker cluster on one machine::

    python -m pslite_tpu_torch.tracker.local -n 2 -s 2 -- \
        python examples/torch/kv_basics.py
    python -m pslite_tpu_torch.tracker.local -n 2 -s 2 --van shm -- \
        python examples/torch/kv_basics.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

import pslite_tpu_torch as ps  # noqa: E402


def main() -> None:
    role = os.environ.get("DMLC_ROLE")
    if role is None:
        sys.exit(
            "DMLC_ROLE not set — run this under the launcher:\n"
            "  python -m pslite_tpu_torch.tracker.local -n 2 -s 2 -- "
            "python examples/torch/kv_basics.py"
        )
    ps.start_ps()

    server = None
    if role in ("server", "joint"):
        server = ps.KVServer(0)
        server.set_request_handle(ps.KVServerDefaultHandle())

    if role in ("worker", "joint"):
        po = ps.postoffice(ps.Role.WORKER)
        kv = ps.KVWorker(0, 0)

        # One key per server, 1024 floats each.
        ranges = po.get_server_key_ranges()
        keys = np.sort(
            np.array([r.begin + 1 for r in ranges], dtype=np.uint64)
        )
        grads = np.full(len(keys) * 1024, 1.0, dtype=np.float32)

        ts = kv.push(keys, grads)          # async; returns a timestamp
        kv.wait(ts)                        # ZPush/Wait semantics
        po.barrier(0, ps.WORKER_GROUP)     # all workers pushed

        params = np.zeros_like(grads)
        kv.wait(kv.pull(keys, params))     # aggregated across workers
        expected = float(po.num_workers)
        print(f"worker {po.my_rank()}: pulled {params[0]} "
              f"(expected {expected})")
        assert np.allclose(params, expected)

        # Wire-compressed push for bandwidth-limited links:
        kv.wait(kv.push(keys, grads, compress="int8"))

    ps.finalize()
    if server is not None:
        server.stop()


if __name__ == "__main__":
    main()
