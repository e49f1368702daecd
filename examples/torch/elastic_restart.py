"""Elastic restart ACROSS FLEET SIZES: checkpoint -> exit 254 -> restore
into a smaller fleet -> continue training.

(The port's copy of ``examples/elastic_restart.py``.)  The reference's
keepalive launcher restarts any child that exits 254
(tracker/dmlc_local.py:16-25) but its recovery re-admits the SAME
roster; this framework closes the loop for a fleet whose size changed
across the restart: format-v2 checkpoints save GLOBAL logical state
(checkpoint.save_engine), so an 8-shard save restores into a 4-shard
engine — stores, fused-optimizer state (adam), and sparse tables with
row-Adagrad accumulators all carry over, verified here against a host
recurrence of the full uninterrupted run.

Run (the launcher supplies the keepalive; ``--ranks`` virtual ranks on
``--device``, 8 on the card by default, as the original's CPU recipe
forces 8 devices):

    python -m pslite_tpu_torch.tracker.local -n 0 -s 0 -- \
        python examples/torch/elastic_restart.py [--device cpu]

First incarnation: 8-shard engine, 2 training steps, save, exit 254.
Second incarnation (checkpoint exists): 4-shard engine on HALF the
ranks, restore, 2 more steps, verify, print ELASTIC_RESTART_OK.
``PS_CKPT`` names the checkpoint (default: under the temp directory);
``PS_CKPT_BACKEND=orbax`` is refused, as the port has no orbax half.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

LR, B1, B2, EPS = 1e-2, 0.9, 0.999, 1e-8
SLR, SEPS = 0.1, 1e-8
TOTAL = 100          # 1 key x 100 values: padding differs per fleet size
ROWS, DIM = 13, 4
STEPS = 4            # 2 before the restart, 2 after


def _grads(step: int) -> np.ndarray:
    return np.random.default_rng(100 + step).normal(
        size=TOTAL
    ).astype(np.float32)


def _row_grads(step: int) -> tuple:
    rng = np.random.default_rng(200 + step)
    idx = rng.integers(0, ROWS, size=6).astype(np.int32)
    g = rng.normal(size=(6, DIM)).astype(np.float32)
    return idx, g


def _host_model():
    """The uninterrupted 4-step run as a host recurrence (adam with
    bias correction exactly as the fused handle applies it, row-adagrad
    as parallel/sparse.py's row-wise Adagrad)."""
    store = np.zeros(TOTAL, np.float64)
    m = np.zeros(TOTAL, np.float64)
    v = np.zeros(TOTAL, np.float64)
    table = np.zeros((ROWS, DIM), np.float64)
    acc = np.zeros(ROWS, np.float64)
    for step in range(1, STEPS + 1):
        g = _grads(step - 1).astype(np.float64)
        m = B1 * m + (1 - B1) * g
        v = B2 * v + (1 - B2) * g * g
        alpha = LR * np.sqrt(1 - B2 ** step) / (1 - B1 ** step)
        store = store - alpha * m / (np.sqrt(v) + EPS)
        idx, rg = _row_grads(step - 1)
        G = np.zeros((ROWS, DIM), np.float64)
        np.add.at(G, idx, rg.astype(np.float64))
        acc = acc + np.mean(G ** 2, axis=1)
        table = table - SLR * G / (np.sqrt(acc)[:, None] + SEPS)
    return store, table


def _build(group):
    from pslite_tpu_torch.parallel.engine import CollectiveEngine
    from pslite_tpu_torch.parallel.sparse import SparseEngine

    eng = CollectiveEngine(group, server_handle=f"adam:{LR}")
    se = SparseEngine(group)
    eng.register_dense("w", np.arange(1, dtype=np.uint64), TOTAL)
    se.register_sparse("emb", ROWS, DIM)
    return eng, se


def _train(eng, se, steps) -> None:
    W = eng.num_shards
    for step in steps:
        g = _grads(step)
        eng.push_pull("w", np.tile(g / W, (W, 1)))
        idx, rg = _row_grads(step)
        # Worker 0 carries the batch; the rest push empty rows.
        idxs = np.zeros((W, len(idx)), np.int32)
        gs = np.zeros((W, len(idx), DIM), np.float32)
        idxs[0], gs[0] = idx, rg
        se.push("emb", idxs, gs, handle=f"row_adagrad:{SLR},{SEPS}")
        se.block("emb")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ranks", type=int, default=8,
                    help="virtual ranks of the full fleet (the "
                         "original's devices)")
    ap.add_argument("--device", default="cuda:0",
                    help="torch device of every rank ('cpu' runs the "
                         "plain PyTorch versions)")
    args = ap.parse_args()
    if os.environ.get("DMLC_ROLE", "scheduler") != "scheduler":
        return 0

    from pslite_tpu_torch import checkpoint
    from pslite_tpu_torch.parallel.mesh import DeviceGroup

    ckpt = os.environ.get("PS_CKPT", os.path.join(
        tempfile.gettempdir(), "pslite_elastic_restart_ck"))
    # Both fleet-portable backends drive the same loop (PS_CKPT_BACKEND
    # = npz | orbax): orbax saves a directory, npz a file.
    backend = os.environ.get("PS_CKPT_BACKEND", "npz")
    if backend == "orbax":
        ck_exists = os.path.isdir(ckpt)
        save = checkpoint.save_engine_orbax
        restore = checkpoint.restore_engine_orbax
    else:
        ck_exists = os.path.exists(ckpt + ".npz")
        save = checkpoint.save_engine
        restore = checkpoint.restore_engine
    if not ck_exists:
        # FIRST incarnation: the full 8-shard fleet, half the run.
        eng, se = _build(DeviceGroup(args.ranks, device=args.device))
        _train(eng, se, range(0, 2))
        save(eng, ckpt, sparse_engine=se)
        print(f"saved 2-step checkpoint from {eng.num_shards} shards; "
              f"exiting 254 for the keepalive restart", flush=True)
        return 254
    # SECOND incarnation: HALF the fleet (4 shards), restore, finish.
    eng, se = _build(DeviceGroup(max(1, args.ranks // 2),
                                 device=args.device))
    restore(eng, ckpt, sparse_engine=se)
    _train(eng, se, range(2, STEPS))
    store, table = _host_model()
    got = eng.pull("w").cpu().numpy()
    np.testing.assert_allclose(got, store, rtol=1e-4, atol=1e-4)
    all_rows = np.tile(np.arange(ROWS, dtype=np.int32),
                       (eng.num_shards, 1))
    got_t = se.pull("emb", all_rows).cpu().numpy()[0]
    np.testing.assert_allclose(got_t, table, rtol=1e-4, atol=1e-4)
    print(f"ELASTIC_RESTART_OK restored onto {eng.num_shards} shards, "
          f"training matches the uninterrupted run", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
