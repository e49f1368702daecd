"""The dense engine's steady cells of one checkout, alone.

Runs ``chip_smoke.steady_state`` (``engine.push_pull`` of the 40 x 1 MB
bucket with device-resident grads on 8 ranks: ``pallas/sum``, ``xla/sum``,
``pallas/adam:1e-3`` and the int8 and 2-D cells, each with its
``torch.profiler`` breakdown) from the checkout at ``argv[1]`` and, where
that checkout has them, the D1/D2 kernel rows (``chip_smoke.reduce_rows``,
each held against its plain version), and prints one line, ``CELLS
{json}``: per cell its event, wall and busy ms per step and its top
kernels; per row its host-free and host-inclusive ms, the engine's path
before it, its plain version's and the library call's ms and its bound.
Comparing two commits on one card: unpack the parent with ``git archive``
into a gitignored directory and run one process per pass, parent, new,
new, parent (a fresh process each: the profiler keeps a window's device
events only early in a process's life).

    python3 tools/dense_cells.py <checkout>
"""

import json
import os
import sys

KEEP = ("ms", "ms_host", "earlier_ms", "plain_ms", "library_ms",
        "bound_ms", "singles_ms")


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        print("dense_cells: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import pslite_tpu_torch as ps

    cells = {r["cell"]: {k: r[k] for k in ("event_ms_per_step",
                                           "wall_ms_per_step",
                                           "busy_ms_per_step")}
             | {"kernels": r["kernels"][:4]}
             for r in cs.steady_state(torch, ps)}
    rows = {}
    if hasattr(cs, "reduce_rows"):
        from pslite_tpu_torch.models import resnet_trace as rt
        from pslite_tpu_torch.ops import fused_update as fu
        from pslite_tpu_torch.ops import reduce_update as ru

        dev = torch.device("cuda:0")
        gen = torch.Generator(device=dev).manual_seed(cs.SEED)

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=dev)

        rows = {r["name"]: {k: r[k] for k in KEEP if k in r}
                for r in cs.reduce_rows(torch, ru, fu, rt, randn)}
    print("CELLS", json.dumps({"root": sys.argv[1], "card": cs.nvidia_smi(),
                               "cells": cells, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
