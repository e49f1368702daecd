"""``chip_smoke.py``'s ``models`` phase alone, on one card.

Builds the CUDA kernels and runs ``chip_smoke.drive_models``: PSFormer
over dp 4 x sp 2 (ring and Ulysses attention, TP; MoE with EP), the
GPipe pipeline over dp 2 x pp 4, the CNN over dp 8, DLRM at 1,048,576 x
16 rows (sgd and row-wise Adagrad) and ``kv_train_loop`` over a loopback
cluster (raw and fp8_e4m3 with error feedback), each leg at the repo's
own full width with its loss, ms/step and K4/S1/S2/S3 launches.

Run it from the root of a checkout on the card:
``python3 tools/models_phase.py``.
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
from pslite_tpu_torch.ops import sparse_rows as sr  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("models_phase: CUDA is not available", file=sys.stderr)
        return 2
    t = time.time()
    _native.build(force=True)
    _native.lib()
    print(f"built in {time.time() - t:.1f} s", flush=True)
    smi = cs.nvidia_smi()
    print(smi)
    ring.reset_launches()
    sr.reset_launches()
    for r in cs.drive_models(torch, ps, ring, sr, Environment, smi):
        print(f"row {r}")
    print("launches " + ", ".join(
        f"{k} {v}" for c in (ring.launches, sr.launches)
        for k, v in c.items() if v))
    return 0


if __name__ == "__main__":
    sys.exit(main())
