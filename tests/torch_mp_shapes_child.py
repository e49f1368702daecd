"""One process of the two-process group-shape tests of
tests/test_torch_mp_shapes.py, never run by pytest itself.

The parent sets ``DMLC_NUM_WORKER=2``, ``DMLC_RANK``, ``DMLC_PS_ROOT_URI``
and ``DMLC_PS_ROOT_PORT`` (the process group's coordinator listens on the
port after it) and ``PSTEST_OUT``.  The process joins the gloo group and
runs every shape of :func:`scenarios` on groups of 8 CPU ranks, 4 in each
process, with the inputs of :func:`inputs` (the parent makes the same),
and saves what it pulled to ``PSTEST_OUT/shapes<rank>.npz``.
``PSTEST_DEADLINE`` (default 100) seconds bound the process.
"""

import faulthandler
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

DEADLINE = float(os.environ.get("PSTEST_DEADLINE", "100"))
OWNERS = (0, 0, 0, 0, 1, 1, 1, 1)
KEYS = np.arange(3, dtype=np.uint64)
VAL_LEN = 700  # 2,100 values: padded sub-chunks that are not tile-aligned
INT8_VAL_LEN = 1500  # 3,000 values: chunks far below the int8 tile
ROWS, DIM, BATCH = 40, 4, 5
ADAM = "adam:1e-3"
ADAGRAD = "row_adagrad:0.1"

# (name, group shape, axis names, kv axis, worker axis): the shapes that
# span both processes.
SHAPES = {
    "2d": ((4, 2), ("dp", "kv"), "kv", "dp"),
    "composite_wa": ((2, 2, 2), ("dp", "kv1", "kv2"), ("kv1", "kv2"), "dp"),
    "composite": ((2, 2, 2), ("dp", "kv1", "kv2"), ("kv1", "kv2"), None),
    "nd": ((4, 2), ("kv", "dp"), "kv", None),
}


def inputs(seed: int = 11) -> dict:
    """Every global input of every step (the parent's too): ``[W, total]``
    rows per shape (W the worker rows: dp on 2-D, the kv shards else)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    total = len(KEYS) * VAL_LEN
    out = {}
    for name, (shape, names, kv, wa) in SHAPES.items():
        w = dict(zip(names, shape))[wa] if wa else int(np.prod(
            [dict(zip(names, shape))[a] for a in
             (kv if isinstance(kv, tuple) else (kv,))]))
        out[name] = rng.standard_normal((4, w, total)).astype(f)
    out["int8"] = rng.standard_normal(
        (3, 8, len(KEYS) * INT8_VAL_LEN)).astype(f)
    out["sp_idx"] = rng.integers(0, ROWS, (3, 4, BATCH)).astype(np.int32)
    out["sp_g"] = rng.standard_normal((3, 4, BATCH, DIM)).astype(f)
    return out


def worker_rows(group, kv, rows):
    """This process's rows of a 1-D-family engine: the worker row of each
    of its ranks (its shard of its replica)."""
    from pslite_tpu_torch.parallel import placement

    kv_axes = kv if isinstance(kv, tuple) else (kv,)
    shard, _ = placement.shard_replicas(group, kv_axes)
    return rows[[int(shard[r]) for r in group.local_ranks]]


def scenarios(ps, rank: int, data: dict) -> dict:
    from pslite_tpu_torch import CollectiveEngine, DeviceGroup, SparseEngine

    out = {}

    def group(shape, names):
        return DeviceGroup(shape, device="cpu", axis_name=names,
                           owners=OWNERS, process_index=rank)

    for name, (shape, names, kv, wa) in SHAPES.items():
        g = data[name]

        def rows(step):
            return g[step] if wa else worker_rows(grp, kv, g[step])

        grp = group(shape, names)
        for impl in ("ring", "torch"):
            eng = CollectiveEngine(grp, axis_name=kv, worker_axis=wa,
                                   impl=impl)
            eng.register_dense("b", KEYS, VAL_LEN)
            out[f"{name}_{impl}_pp"] = eng.push_pull("b", rows(0)).numpy()
            eng.push("b", rows(1))
            out[f"{name}_{impl}_pull"] = eng.pull("b").numpy()
            out[f"{name}_{impl}_store"] = eng.store_array("b").numpy()
        eng = CollectiveEngine(grp, axis_name=kv, worker_axis=wa,
                               impl="ring", server_handle=ADAM)
        eng.register_dense("a", KEYS, VAL_LEN)
        for step in (2, 3):
            out[f"{name}_adam{step}"] = eng.push_pull("a", rows(step)).numpy()
        kind, state = eng.opt_state("a")
        out[f"{name}_adam_m"] = state[0].numpy()
        if wa:
            eng = CollectiveEngine(grp, axis_name=kv, worker_axis=wa,
                                   impl="ring", wire_compress="int8")
            eng.register_dense("c", KEYS, VAL_LEN)
            out[f"{name}_int8_pp"] = eng.push_pull("c", rows(0)).numpy()
            eng.push("c", rows(1))
            out[f"{name}_int8_pull"] = eng.pull("c").numpy()

    # 2-D stays 2-D across a recut onto another 2-D group spanning both.
    eng = CollectiveEngine(group((4, 2), ("dp", "kv")), worker_axis="dp",
                           impl="ring")
    eng.register_dense("r", KEYS, VAL_LEN)
    eng.push_pull("r", data["2d"][0])
    eng.reshard(group((2, 4), ("dp", "kv")))
    out["2d_recut_pull"] = eng.pull("r").numpy()
    out["2d_recut_pp"] = eng.push_pull("r", data["2d"][1][:2]).numpy()

    # int8 wire compression on the 1-D group.
    eng = CollectiveEngine(DeviceGroup(8, device="cpu", owners=OWNERS,
                                       process_index=rank),
                           impl="ring", wire_compress="int8")
    eng.register_dense("c", KEYS, INT8_VAL_LEN)
    mine = slice(4 * rank, 4 * rank + 4)
    out["int8_pp"] = eng.push_pull("c", data["int8"][0][mine]).numpy()
    eng.push("c", data["int8"][1][mine])
    out["int8_pull"] = eng.pull("c").numpy()
    out["int8_pp2"] = eng.push_pull("c", data["int8"][2][mine]).numpy()
    out["int8_store"] = eng.store_array("c").numpy()

    # A sparse table on the N-D group: sharded over kv, replicated over dp.
    grp = group((4, 2), ("kv", "dp"))
    se = SparseEngine(grp, "kv")
    se.register_sparse("emb", ROWS, DIM)

    def sp(key, step):
        return worker_rows(grp, "kv", data[key][step])

    se.push("emb", sp("sp_idx", 0), sp("sp_g", 0))
    out["sparse_sum_pull"] = se.pull("emb", sp("sp_idx", 2)).numpy()
    out["sparse_sum_store"] = se.store_array("emb").numpy()
    se.push("emb", sp("sp_idx", 1), sp("sp_g", 1), handle=ADAGRAD)
    out["sparse_pull"] = se.pull("emb", sp("sp_idx", 2)).numpy()
    out["sparse_store"] = se.store_array("emb").numpy()
    out["sparse_acc"] = se.acc_array("emb").numpy()
    return out


def main() -> int:
    import pslite_tpu_torch as ps
    from pslite_tpu_torch.environment import Environment
    from pslite_tpu_torch.parallel import distributed

    rank = int(os.environ["DMLC_RANK"])
    assert distributed.acquire(Environment({}))
    try:
        out = scenarios(ps, rank, inputs())
    finally:
        distributed.release()
    np.savez(os.path.join(os.environ["PSTEST_OUT"], f"shapes{rank}.npz"),
             **out)
    print(f"SHAPES_OK {rank}", flush=True)
    return 0


if __name__ == "__main__":
    faulthandler.dump_traceback_later(DEADLINE, exit=True)
    sys.exit(main())
