"""One process of the two-process group tests of
tests/test_torch_sparse_group.py, never run by pytest itself.

The parent sets ``DMLC_NUM_WORKER=2``, ``DMLC_RANK``, ``DMLC_PS_ROOT_URI``
and ``DMLC_PS_ROOT_PORT`` (the process group's coordinator listens on the
port after it) and ``PSTEST_OUT``.  The process joins the gloo group and,
on a 1-D group of 8 CPU ranks (4 in each process) and on a ``(kv 4, dp
2)`` group, pushes and pulls the tables of :data:`TABLES` as groups (sum,
then row-wise Adagrad) with the inputs of :func:`inputs` (the parent
makes the same), counting the engine's exchanges per op, and saves what
it pulled, the stores and the counts to ``PSTEST_OUT/group<rank>.npz``.
``PSTEST_DEADLINE`` (default 100) seconds bound the process.
"""

import faulthandler
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

DEADLINE = float(os.environ.get("PSTEST_DEADLINE", "100"))
OWNERS = (0, 0, 0, 0, 1, 1, 1, 1)
# (name, rows, dim, batch): different rows, dims and batches.
TABLES = (("a", 37, 4, 6), ("b", 9, 1, 3), ("c", 70, 16, 5))
ADAGRAD = "row_adagrad:0.1"
# (name, group shape, axis names, kv axis)
GROUPS = {"1d": (8, "kv", "kv"), "nd": ((4, 2), ("kv", "dp"), "kv")}


def inputs(seed: int = 13) -> dict:
    """Every global input: per group, step and table, ``[W, n]`` indices
    (W the kv shards) with out-of-range entries, and ``[W, n, dim]``
    rows."""
    rng = np.random.default_rng(seed)
    out = {}
    for gname, (shape, names, kv) in GROUPS.items():
        w = 8 if gname == "1d" else 4
        for step in range(3):
            for name, rows, dim, n in TABLES:
                idx = rng.integers(-2, rows + 3, size=(w, n)).astype(np.int32)
                idx[:, 0] = 1  # a row every worker pushes
                out[f"{gname}_{step}_{name}_idx"] = idx
                out[f"{gname}_{step}_{name}_g"] = rng.standard_normal(
                    (w, n, dim)).astype(np.float32)
    return out


def run(se, data: dict, gname: str, rows_of) -> dict:
    """Two group pushes (sum, then row-wise Adagrad) and a group pull
    after each on ``se``; ``rows_of`` picks the engine's worker rows of a
    global input.  Records the exchanges each op took."""
    names = [t[0] for t in TABLES]
    for name, rows, dim, _ in TABLES:
        se.register_sparse(name, rows, dim)
    out = {}
    for step, handle in ((0, None), (1, ADAGRAD)):
        idx = [rows_of(data[f"{gname}_{step}_{n}_idx"]) for n in names]
        gs = [rows_of(data[f"{gname}_{step}_{n}_g"]) for n in names]
        before = se.exchanges
        se.push_group(names, idx, gs, handle=handle)
        out[f"push{step}_exchanges"] = se.exchanges - before
        pidx = [rows_of(data[f"{gname}_2_{n}_idx"]) for n in names]
        before = se.exchanges
        pulled = se.pull_group(names, pidx)
        out[f"pull{step}_exchanges"] = se.exchanges - before
        for n, p in zip(names, pulled):
            out[f"pull{step}_{n}"] = np.asarray(p)
    for n in names:
        out[f"store_{n}"] = np.asarray(se.store_array(n))
        out[f"acc_{n}"] = np.asarray(se.acc_array(n))
    return {f"{gname}_{k}": v for k, v in out.items()}


def main() -> int:
    from pslite_tpu_torch import DeviceGroup, SparseEngine
    from pslite_tpu_torch.environment import Environment
    from pslite_tpu_torch.parallel import distributed, placement

    rank = int(os.environ["DMLC_RANK"])
    assert distributed.acquire(Environment({}))
    data = inputs()
    out = {}
    try:
        for gname, (shape, names, kv) in GROUPS.items():
            grp = DeviceGroup(shape, device="cpu", axis_name=names,
                              owners=OWNERS, process_index=rank)
            shard, _ = placement.shard_replicas(grp, (kv,))
            mine = [int(shard[r]) for r in grp.local_ranks]
            se = SparseEngine(grp, kv)
            out.update(run(se, data, gname, lambda x: x[mine]))
            se.close()
    finally:
        distributed.release()
    np.savez(os.path.join(os.environ["PSTEST_OUT"], f"group{rank}.npz"),
             **out)
    print(f"GROUP_OK {rank}", flush=True)
    return 0


if __name__ == "__main__":
    faulthandler.dump_traceback_later(DEADLINE, exit=True)
    sys.exit(main())
