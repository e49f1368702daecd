"""``chip_smoke.py``'s durability phases alone, on one card.

Builds the CUDA kernels and the native transport core, then runs
``replication-failover``, ``replica-read`` and ``durable-store``
(``chip_smoke.drive_*``) and prints each phase's lines and rows: the
quick check of chain replication, replica reads, namespaces, snapshots
and the tiered store without the rest of the script.

Run it from the root of a checkout on the card:
``python3 tools/durability_phases.py``.
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
            ("replication-failover",
             lambda: cs.drive_replication_failover(smi)),
            ("replica-read",
             lambda: cs.drive_replica_read(ps, Environment, smi)),
            ("durable-store",
             lambda: cs.drive_durable_store(ps, Environment, smi))):
        t = time.time()
        print(name, fn(), flush=True)
        print(f"{name} took {time.time() - t:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
