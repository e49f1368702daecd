"""The sparse kernel rows of one checkout, alone.

Runs ``chip_smoke.sparse_rows_rows`` (S1-S3 at config 5's shapes) and,
where the checkout has them, ``chip_smoke.sparse_group_rows`` (the group
kernels at the Kaggle layer and at config 5 + the DLRM table) from the
checkout at ``argv[1]``, each held against its plain version as the
script holds it, and prints one line, ``ROWS {json}``: per row its
host-free and host-inclusive ms, its bound, for S1/S2 the profiler's
split into the push's three kernels, and for a group row the per-table
loop's ms.  With ``--width-classes`` it also times a group of
the 26 Kaggle tables (dim 16) and config 5's table (dim 64) pushed as
one chain, whose long-run clusters are sized for dim 64 (each taking
four dim-16 runs at once), against the same tables pushed as one chain
per width class (the long runs of each class on clusters of its own
width; two chains, six launches), the stores after each held equal.  Comparing two commits on one card: unpack
the parent with ``git archive`` into a gitignored directory and run one
process per pass, parent, new, new, parent.

    python3 tools/sparse_rows_cmp.py <checkout> [--width-classes]
"""

import json
import os
import sys

KEEP = ("ms", "ms_host", "bound_ms", "earlier_ms", "earlier_ms_host",
        "chain_floor_ms", "pieces_ms")


def width_classes(torch, cs, sr, emb):
    """(one chain ms, one chain per width class ms), host-free and
    host-inclusive, of the sum push of Kaggle's 26 tables beside config
    5's table."""
    dev = torch.device("cuda:0")
    spec = (cs.group_specs()["kaggle26"]
            + [("c5", cs.EMB_ROWS, cs.EMB_DIM, cs.EMB_BATCH, "float32", 0)])
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 40)
    rps = [cs.table_rps(r, d) for _, r, d, _, _, _ in spec]
    stores = [torch.randn((cs.N * p, d), generator=gen, device=dev)
              for p, (_, _, d, _, _, _) in zip(rps, spec)]
    idxs = [torch.from_numpy(i).to(dev) for i, _, _ in cs.group_stats(emb,
                                                                       spec)]
    rows = [torch.randn((cs.N, b, d), generator=gen, device=dev)
            for _, _, d, b, _, _ in spec]

    def one(ss):
        sr.scatter_add_group(ss, idxs, rows, cs.N, rps)

    def per_class(ss):
        sr.scatter_add_group(ss[:-1], idxs[:-1], rows[:-1], cs.N, rps[:-1])
        sr.scatter_add_group(ss[-1:], idxs[-1:], rows[-1:], cs.N, rps[-1:])

    a = [s.clone() for s in stores]
    b = [s.clone() for s in stores]
    one(a)
    per_class(b)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        cs.mismatches(x, y)
    out = {}
    for label, fn in (("one_chain", one), ("per_class", per_class),
                      ("per_class_2", per_class), ("one_chain_2", one)):
        out[label] = cs.kernel_times(lambda: fn(a))
    return out


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        print("sparse_rows_cmp: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from pslite_tpu_torch.models import embedding as emb
    from pslite_tpu_torch.ops import _native
    from pslite_tpu_torch.ops import sparse_rows as sr

    dev = torch.device("cuda:0")
    rows = cs.sparse_rows_rows(torch, sr, emb, dev, _native)
    if hasattr(cs, "sparse_group_rows"):
        rows += cs.sparse_group_rows(torch, sr, emb, dev)
    cs.push_pieces(torch, sr, emb, rows)
    out = {"root": sys.argv[1], "card": cs.nvidia_smi(),
           "rows": {r["name"]: {k: r[k] for k in KEEP if k in r}
                    for r in rows}}
    if "--width-classes" in sys.argv[2:]:
        out["width_classes"] = width_classes(torch, cs, sr, emb)
    print("ROWS", json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
