"""The host-bound steady-state cells of one checkout, alone.

Runs ``chip_smoke.steady_state_trace`` (every ``resnet50-*`` cell and
``replay-40x1MB``) from the checkout at ``argv[1]``, or with ``sparse``
as ``argv[2]`` ``chip_smoke.steady_state_sparse`` (the ``embedding-1m*``
cells), and prints one JSON line: cell -> [wall ms/step, CUDA-event
ms/step, device-busy ms/step, host-to-device GB/s or null].  Comparing
two commits on one card: unpack the parent with ``git archive`` into a
gitignored directory and run one process per pass, alternating, e.g.
parent, new, new, parent, parent, new, new, parent; the host-bound cells
spread too much between passes for fewer pairs.

    python3 chip_trace_cells.py <checkout> [sparse]
"""

import json
import os
import sys


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        print("chip_trace_cells: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import pslite_tpu_torch as ps
    from pslite_tpu_torch.environment import Environment
    from pslite_tpu_torch.models import embedding as emb
    from pslite_tpu_torch.models import resnet_trace as rt
    from pslite_tpu_torch.ops import _native

    _native.lib()
    if sys.argv[2:] == ["sparse"]:
        rows = cs.steady_state_sparse(torch, ps, Environment, emb)
    else:
        rows = cs.steady_state_trace(torch, ps, rt, Environment)
    cells = {r["cell"]: [r["wall_ms_per_step"], r["event_ms_per_step"],
                         r["busy_ms_per_step"], r.get("h2d_gbps_wall")]
             for r in rows}
    print(json.dumps({"root": sys.argv[1], "cells": cells}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
