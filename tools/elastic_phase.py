"""``chip_smoke.py``'s ``elastic-scale`` phase alone, on one card.

Builds the CUDA kernels and the native transport core, then runs
``chip_smoke.drive_elastic_scale`` ``ROUNDS`` times (default 1; pass a
count as the first argument) and prints each run's line and row, with
the K4 launches it counted: the quick check of elastic membership (2 ->
4 -> 2 servers mid storm, the bucket through the ring at each epoch,
then config 2's store migrated to a joiner and back) without the rest
of the script.

Run it from the root of a checkout on the card:
``python3 tools/elastic_phase.py [ROUNDS]``.
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


def main() -> int:
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    t = time.time()
    _native.build(force=True)
    _native.lib()
    host_native.build(force=True)
    host_native.load()
    print(f"built in {time.time() - t:.1f} s", flush=True)
    smi = cs.nvidia_smi()
    print(smi)
    for i in range(rounds):
        ring.reset_launches()
        t = time.time()
        print(f"elastic-scale run {i}",
              cs.drive_elastic_scale(ps, ring, Environment, smi)
              + cs.drive_elastic_migrate(ps, Environment, smi),
              flush=True)
        print(f"took {time.time() - t:.1f} s; launches "
              f"{ {k: v for k, v in ring.launches.items() if v} }",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
