"""One process of the two-process data-plane tests of
tests/test_torch_ici_multiprocess.py, never run by pytest itself.

The parent sets the ``DMLC_*`` variables of an ``ici_tcp`` (or
``ici_shm``) cluster with ``PS_ICI_MULTIHOST=1``, ``PS_ICI_IMPL``, and:

- ``PSTEST_ROLES``: ``scheduler,server`` (both in this process) or
  ``worker`` (with ``DMLC_RANK``);
- ``PSTEST_OUT``: where a worker writes ``worker<rank>.npz``.

A worker joins the process group itself (its own lease beside the
van's), builds the global group of 4 ranks per process on the CPU,
installs it with ``set_mesh`` and runs ``tests/ici_tcp_child.py``'s
program through the port with seeded rows (``rows()``, the same in the
parent): two ``push_pull`` steps of a dense bucket, two adam steps of a
second one, a sparse push and pull, ``KVWorker.reshard`` onto 2 ranks
per process, then a pull, a ``push_pull``, an adam step and a sparse
pull on the 4 ranks.  It saves everything it pulled.  ``PSTEST_DEADLINE``
(default 100) seconds bound every process.
"""

import faulthandler
import os
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

DEADLINE = float(os.environ.get("PSTEST_DEADLINE", "100"))
KEYS = np.arange(4, dtype=np.uint64)
ADAM_KEYS = KEYS + 100
VAL_LEN = 9  # 36 values: padded to 40 on 8 ranks, to 36 on 4
ROWS, DIM, BATCH = 24, 4, 6
ADAM = "adam:1e-3"


def rows(seed: int = 7) -> dict:
    """Every global rank's inputs of every step (the parent's too)."""
    rng = np.random.default_rng(seed)
    total = len(KEYS) * VAL_LEN
    f = np.float32
    return {
        "dense": rng.standard_normal((2, 8, total)).astype(f),
        "adam": rng.standard_normal((2, 8, total)).astype(f),
        # Few rows, so that workers of both processes hit the same rows.
        "sp_idx": rng.integers(0, ROWS, (8, BATCH)).astype(np.int32),
        "sp_g": rng.standard_normal((8, BATCH, DIM)).astype(f),
        "sp_pull": rng.integers(0, ROWS, (8, BATCH)).astype(np.int32),
        "dense4": rng.standard_normal((4, total)).astype(f),
        "adam4": rng.standard_normal((4, total)).astype(f),
        "sp_pull4": rng.integers(0, ROWS, (4, BATCH)).astype(np.int32),
    }


def worker(ps) -> None:
    from pslite_tpu_torch.environment import Environment
    from pslite_tpu_torch.parallel import distributed

    rank = int(os.environ["DMLC_RANK"])
    env = Environment({})
    assert distributed.acquire(env)
    group = distributed.global_group(local_ranks=4, device="cpu")
    assert group.is_multiprocess and list(group.local_ranks) == list(
        range(4 * rank, 4 * rank + 4))
    po = ps.Postoffice("worker", env=env)
    po.van.set_mesh(group)
    po.start()
    kv = ps.KVWorker(0, 0, postoffice=po)
    eng, se = kv.engine, kv.sparse_engine
    assert eng.num_shards == 8 and se.num_shards == 8
    r = rows()
    mine = slice(4 * rank, 4 * rank + 4)
    out = {}
    total = len(KEYS) * VAL_LEN
    kv.register_dense("g", KEYS, VAL_LEN)
    kv.register_dense("a", ADAM_KEYS, VAL_LEN)
    for step in range(2):
        outs = np.zeros(total, np.float32)
        kv.wait(kv.push_pull(KEYS, r["dense"][step][mine], outs))
        out[f"dense{step}"] = outs
        out[f"adam{step}"] = eng.push_pull(
            "a", r["adam"][step][mine], handle=ADAM).numpy()
    se.register_sparse("emb", num_rows=ROWS, dim=DIM)
    kv.wait(kv.push_sparse("emb", r["sp_idx"][mine], r["sp_g"][mine]))
    got = np.zeros((4, BATCH, DIM), np.float32)
    kv.wait(kv.pull_sparse("emb", r["sp_pull"][mine], out=got))
    out["sparse_pull"] = got
    out["sparse_store"] = se.store_array("emb").numpy()
    out["store8"] = eng.store_array("g").numpy()

    # The recut onto 2 ranks of each process, on the live cluster.
    kv.reshard(distributed.global_group(local_ranks=2, device="cpu"))
    assert eng.num_shards == 4 and se.num_shards == 4
    mine4 = slice(2 * rank, 2 * rank + 2)
    pulled = np.zeros(total, np.float32)
    kv.wait(kv.pull(KEYS, pulled))
    out["pull4"] = pulled
    outs = np.zeros(total, np.float32)
    kv.wait(kv.push_pull(KEYS, r["dense4"][mine4], outs))
    out["dense4"] = outs
    out["adam4"] = eng.push_pull("a", r["adam4"][mine4],
                                 handle=ADAM).numpy()
    got = np.zeros((2, BATCH, DIM), np.float32)
    kv.wait(kv.pull_sparse("emb", r["sp_pull4"][mine4], out=got))
    out["sparse_pull4"] = got
    np.savez(os.path.join(os.environ["PSTEST_OUT"], f"worker{rank}.npz"),
             **out)
    po.finalize()
    distributed.release()
    print(f"WORKER_OK {rank}", flush=True)


def main() -> int:
    import pslite_tpu_torch as ps
    from pslite_tpu_torch.environment import Environment

    roles = os.environ["PSTEST_ROLES"].split(",")
    if roles == ["worker"]:
        worker(ps)
        return 0
    nodes = [ps.Postoffice(r, env=Environment({})) for r in roles]
    threads = [threading.Thread(target=po.start, daemon=True) for po in nodes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(DEADLINE)
    srv = [ps.KVServer(0, postoffice=po) for po in nodes if po.is_server]
    for s in srv:
        s.set_request_handle(ps.KVServerDefaultHandle())
    threads = [threading.Thread(target=po.finalize, daemon=True)
               for po in nodes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(DEADLINE)
    for s in srv:
        s.stop()
    print(f"{','.join(roles)} DONE", flush=True)
    return 0


if __name__ == "__main__":
    faulthandler.dump_traceback_later(DEADLINE, exit=True)
    sys.exit(main())
