"""A whole durability cluster in one process, its nodes from either package.

Run by tests/test_torch_replication.py and tests/test_torch_replica_read.py
(never by pytest itself): every node of the cluster, a scheduler,
``DMLC_NUM_SERVER`` servers and one worker, is its own Postoffice over
tcp in this process, each from the JAX package or the port, so a JAX
primary can forward to a port replica and back.  The parent sets the
``DMLC_*`` variables and:

- ``PSTEST_PKGS``: the package of each node, ``scheduler,server0,...,
  worker`` in that order (``jax`` or ``port``); server *i* asks for
  rank *i* (``DMLC_RANK``);
- ``PSTEST_RECOVER_PKG``: the package of the recovered server (the
  ``failover`` scenario);
- ``PSTEST_SCENARIO``:
  - ``failover``: pushes of every range, then server rank 0 dies (its
    van stops), the worker pulls and pushes its range through the
    replica, and a new server of ``PSTEST_RECOVER_PKG`` takes rank 0
    back and restores its ranges from the chain before serving;
  - ``reads``: replica reads (``PS_REPLICA_READS=1``): spread pulls of
    a pushed table, and push-then-pull read-your-writes probes;
  - ``batch``: 64 one-key pushes issued at once (with
    ``PS_BATCH_BYTES`` they ride ``EXT_BATCH`` frames, each sub-op
    forwarded on its own), then every server's store once the forwards
    landed;
- ``PSTEST_OUT``: the results, ``result.npz``.

Every pushed value is a small integer, so any order of addition gives
the same bits.  It prints one JSON line (``{"ok": true, ...}``) and
exits 0, or prints the error and exits 1; past ``PSTEST_DEADLINE``
seconds (default 90) it dumps its stacks and exits.
"""

import faulthandler
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
sys.path.insert(0, _HERE)

import numpy as np  # noqa: E402

from torch_mixed_child import api, run_all  # noqa: E402

DEADLINE = float(os.environ.get("PSTEST_DEADLINE", "90"))
DIM = 16
ROUNDS = 4


def range_keys(po, per_range: int = 2) -> np.ndarray:
    """``per_range`` keys at the start of every server's range."""
    return np.array(sorted(rng.begin + 3 + i
                           for rng in po.get_server_key_ranges()
                           for i in range(per_range)), dtype=np.uint64)


def pushes(n_keys: int, rounds: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(-8, 8, n_keys * DIM).astype(np.float32)
            for _ in range(rounds)]


def wait_until(pred, what: str, timeout: float = 30.0) -> None:
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return
        time.sleep(0.05)
    raise TimeoutError(f"{what} within {timeout}s")


def store_of(srv) -> dict:
    return {int(k): np.array(v) for k, v in list(srv._handle.store.items())}


def converged(servers, keys, want) -> bool:
    """Every key's value equals ``want`` on every server that holds it,
    and each key is held by as many servers as the chain length."""
    k = int(os.environ.get("PS_KV_REPLICATION", "1"))
    for i, key in enumerate(keys.tolist()):
        holders = [store_of(s).get(key) for _po, s in servers]
        held = [h for h in holders if h is not None]
        if len(held) < k or not all(
                np.array_equal(h, want[i * DIM:(i + 1) * DIM]) for h in held):
            return False
    return True


def make_node(pkg: str, role: str, rank=None):
    ps, Environment, role_of = api(pkg)
    env = {} if rank is None else {"DMLC_RANK": str(rank)}
    return ps, ps.Postoffice(role_of(role), env=Environment(env))


def scenario_failover(nodes, out: dict) -> dict:
    _sched, servers, (wpo, kv) = nodes
    keys = range_keys(wpo)
    k0 = keys[:2]  # rank 0's range
    vals = pushes(len(keys), ROUNDS, seed=11)
    for v in vals:
        kv.wait(kv.push(keys, v))
    want = np.sum(vals, axis=0)
    wait_until(lambda: converged(servers, keys, want), "forwards drained")
    for po, srv in servers:
        for key, v in store_of(srv).items():
            out[f"before_r{po.my_rank()}_{key}"] = v
    victim_po = next(po for po, _s in servers if po.my_rank() == 0)
    victim_id = victim_po.van.my_node.id
    victim_po.van.stop()  # the crash
    wait_until(lambda: victim_id in kv._down_servers, "death detected")
    got = np.zeros(len(k0) * DIM, np.float32)
    kv.wait(kv.pull(k0, got))
    out["failover_pull"] = got.copy()
    extra = pushes(len(keys), 1, seed=12)[0]
    kv.wait(kv.push(keys, extra))
    kv.wait(kv.pull(k0, got))
    out["failover_pull2"] = got.copy()
    # The recovered server takes rank 0 back and restores before serving.
    ps, rpo = make_node(os.environ["PSTEST_RECOVER_PKG"], "server", rank=0)
    rpo.start(0)
    assert rpo.is_recovery and rpo.van.my_node.id == victim_id
    rsrv = ps.KVServer(0, postoffice=rpo)
    rsrv.set_request_handle(ps.KVServerDefaultHandle())
    for key, v in store_of(rsrv).items():
        out[f"restored_{key}"] = v
    wait_until(lambda: victim_id not in kv._down_servers,
               "recovery heard by the worker")
    kv.wait(kv.pull(keys, np.zeros(len(keys) * DIM, np.float32)))
    got_all = np.zeros(len(keys) * DIM, np.float32)
    kv.wait(kv.pull(keys, got_all))
    out["after_restore"] = got_all
    return {"dead": [victim_po], "extra": [(rpo, rsrv)]}


def scenario_reads(nodes, out: dict) -> dict:
    _sched, _servers, (wpo, kv) = nodes
    rng0 = wpo.get_server_key_ranges()[0]
    rows = 48
    keys = np.arange(rng0.begin, rng0.begin + rows, dtype=np.uint64)
    table = np.stack([np.full(DIM, 1.0 + r, np.float32) for r in range(rows)])
    kv.wait(kv.push(keys, table.reshape(-1)))
    got = np.zeros(rows * DIM, np.float32)

    def settled():
        got[:] = 0
        kv.wait(kv.pull(keys, got))
        return np.array_equal(got.reshape(rows, DIM), table)

    wait_until(settled, "replicas serve the table")
    spread = []
    buf = np.zeros(8 * DIM, np.float32)
    for i in range(24):
        start = (i * 5) % (rows - 8)
        buf[:] = 0
        kv.wait(kv.pull(keys[start:start + 8], buf))
        spread.append(buf.copy())
    out["spread"] = np.stack(spread)
    probe = keys[rows - 8:]
    ryw = []
    for _ in range(20):
        kv.wait(kv.push(probe, np.ones(8 * DIM, np.float32)))
        buf[:] = 0
        kv.wait(kv.pull(probe, buf))
        ryw.append(buf.copy())
    out["ryw"] = np.stack(ryw)
    share = getattr(kv, "_read_share", {})
    return {"dead": [], "extra": [], "read_members": len(share)}


def scenario_batch(nodes, out: dict) -> dict:
    _sched, servers, (wpo, kv) = nodes
    rng = np.random.default_rng(13)
    ranges = wpo.get_server_key_ranges()
    keys = [np.array([ranges[i % len(ranges)].begin + int(k)], np.uint64)
            for i, k in enumerate(rng.integers(0, 8, 64))]
    vals = [rng.integers(-8, 8, DIM).astype(np.float32) for _ in keys]
    for ts in [kv.push(k, v) for k, v in zip(keys, vals)]:
        kv.wait(ts)
    uniq = np.unique(np.concatenate(keys))
    want = {int(k): sum(v for kk, v in zip(keys, vals) if int(kk[0]) == k)
            for k in uniq.tolist()}
    wait_until(lambda: converged(servers, uniq, np.concatenate(
        [want[int(k)] for k in uniq])), "batched forwards landed")
    for po, srv in servers:
        for key, v in store_of(srv).items():
            out[f"r{po.my_rank()}_{key}"] = v
    comb = getattr(kv, "combiner", None) or getattr(kv, "_combiner", None)
    return {"dead": [], "extra": [],
            "batch_frames": comb.flushed_frames if comb is not None else 0}


def main() -> int:
    pkgs = os.environ["PSTEST_PKGS"].split(",")
    n_srv = int(os.environ["DMLC_NUM_SERVER"])
    assert len(pkgs) == n_srv + 2, pkgs
    _ps, sched = make_node(pkgs[0], "scheduler")
    srv_nodes = [make_node(pkgs[1 + i], "server", rank=i)
                 for i in range(n_srv)]
    ps_w, wpo = make_node(pkgs[-1], "worker")
    all_pos = [sched] + [po for _ps, po in srv_nodes] + [wpo]
    run_all([po.start for po in all_pos])
    servers = []
    for ps, po in srv_nodes:
        srv = ps.KVServer(0, postoffice=po)
        srv.set_request_handle(ps.KVServerDefaultHandle())
        servers.append((po, srv))
    kv = ps_w.KVWorker(0, 0, postoffice=wpo)
    out: dict = {}
    scenario = {"failover": scenario_failover, "reads": scenario_reads,
                "batch": scenario_batch}[os.environ["PSTEST_SCENARIO"]]
    extra = {"dead": [], "extra": []}
    try:
        extra = scenario((sched, servers, (wpo, kv)), out)
    finally:
        kv.stop()
        for _po, srv in servers + extra["extra"]:
            srv.stop()
        # No finalize barrier: a dead node cannot join it.
        for po in all_pos + [p for p, _s in extra["extra"]]:
            try:
                po.van.stop()
            except Exception:  # noqa: BLE001 - already stopped
                pass
    np.savez(os.path.join(os.environ["PSTEST_OUT"], "result.npz"), **out)
    print(json.dumps({"ok": True, "pkgs": pkgs,
                      "read_members": extra.get("read_members", 0),
                      "batch_frames": extra.get("batch_frames", 0)}),
          flush=True)
    return 0


if __name__ == "__main__":
    faulthandler.dump_traceback_later(DEADLINE, exit=True)
    try:
        rc = main()
    except Exception as exc:  # noqa: BLE001 - reported to the parent
        import traceback

        traceback.print_exc()
        print(json.dumps({"ok": False, "error": repr(exc)}), flush=True)
        rc = 1
    # Daemon threads of the stopped nodes must not hold the exit.
    sys.stdout.flush()
    os._exit(rc)
