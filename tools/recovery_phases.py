"""``chip_smoke.py``'s recovery phases alone, on one card.

Builds the CUDA kernels and the native transport core, then runs
``chaos-matrix``, ``deadline-timeout`` and ``recovery-keepalive``
(``chip_smoke.drive_*``) and prints each phase's line and row: the
quick check of the recovery tier without the rest of the script.

Run it from the root of a checkout on the card:
``python3 tools/recovery_phases.py``.
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
from pslite_tpu_torch.vans import native as host_native  # noqa: E402


def main() -> int:
    t = time.time()
    _native.build(force=True)
    _native.lib()
    host_native.build(force=True)
    host_native.load()
    print(f"built in {time.time() - t:.1f} s", flush=True)
    smi = cs.nvidia_smi()
    print(smi)
    for name, fn in (
            ("chaos-matrix",
             lambda: cs.drive_chaos_matrix(ps, Environment, smi)),
            ("deadline-timeout", lambda: cs.drive_deadline_timeout(smi)),
            ("recovery-keepalive",
             lambda: cs.drive_recovery_keepalive(smi))):
        t = time.time()
        print(name, fn(), flush=True)
        print(f"{name} took {time.time() - t:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
