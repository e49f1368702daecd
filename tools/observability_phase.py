"""``chip_smoke.py``'s ``observability`` phase alone, on one card.

Builds the CUDA kernels and the native transport core, times K4 (the
f32 ``ring_push_pull`` of the 40 x 1 MB bucket, as the kernels phase
does) and runs ``chip_smoke.drive_observability``: telemetry's cost on
BASELINE config 2 over tcp (three legs, windows alternating), the
critical-path split of a 1 MB round's tail-kept requests, the ``ici_tcp``
worker's K4 path under ``ENABLE_PROFILING`` and ``device_trace``, the
autopilot's storm and a join at the scheduler's load hint.

Run it from the root of a checkout on the card:
``python3 tools/observability_phase.py``.
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
import pslite_tpu_torch as ps  # noqa: E402
from pslite_tpu_torch.environment import Environment  # noqa: E402
from pslite_tpu_torch.ops import _native  # noqa: E402
from pslite_tpu_torch.ops import ring_collective as ring  # noqa: E402
from pslite_tpu_torch.vans import native as host_native  # noqa: E402


def k4_row(torch) -> dict:
    """K4's host-free ms at the main path's shape (CUDA-graph replay)."""
    dev = torch.device("cuda:0")
    g = torch.randn((cs.N, cs.P), device=dev)
    store = torch.zeros(cs.P, device=dev)
    ms = cs.graph_ms(lambda: ring.ring_push_pull(g, store, "sum"))
    return {"name": "ring_push_pull[float32]", "ms": ms}


def main() -> int:
    import torch

    t = time.time()
    _native.build(force=True)
    _native.lib()
    host_native.build(force=True)
    host_native.load()
    print(f"built in {time.time() - t:.1f} s", flush=True)
    smi = cs.nvidia_smi()
    print(smi)
    rows = [k4_row(torch)]
    print(f"K4 f32 {rows[0]['ms']:.4f} ms host-free", flush=True)
    ring.reset_launches()
    t = time.time()
    out, child = cs.drive_observability(ps, Environment, rows, smi)
    for r in out:
        print(f"row {r}")
    print(f"took {time.time() - t:.1f} s; worker-process launches "
          f"{ {k: v for k, v in child.items() if v} }", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
