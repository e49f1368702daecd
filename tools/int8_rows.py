"""The int8 ring's kernel rows of one checkout, alone.

Runs ``chip_smoke.ring_variant_rows`` and ``chip_smoke.group_rows`` (the
int8 ring at 8 ranks push_pull and push, the 2-D sub-rings, n = 2 where
the regions spill, and the grouped ResNet-50 trace, each held against its
plain version) from the checkout at ``argv[1]`` and prints one line,
``ROWS {json}``: per row its host-free and host-inclusive ms, its bound
and, for an int8 row, its launch shape (cluster, groups, waves) and ms at
each shape timed.  Comparing two commits on one card: unpack the parent
with ``git archive`` into a gitignored directory and run one process per
pass, parent, new, new, parent.

    python3 tools/int8_rows.py <checkout>
"""

import json
import os
import sys

KEEP = ("ms", "ms_host", "bound_ms", "cluster", "groups", "waves", "nregions",
        "ms_by_shape", "ms_by_cluster")


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        print("int8_rows: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from pslite_tpu_torch.models import resnet_trace as rt
    from pslite_tpu_torch.ops import ring_collective as ring

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    rows = (cs.ring_variant_rows(torch, ring, randn)
            + cs.group_rows(torch, ring, rt, randn))
    print("ROWS", json.dumps({
        "root": sys.argv[1], "card": cs.nvidia_smi(),
        "rows": {r["name"]: {k: r[k] for k in KEEP if k in r}
                 for r in rows}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
