"""One process of a cluster that mixes the JAX package and the port.

Run by tests/test_torch_tcp.py and tests/test_torch_shm.py, never by
pytest itself.  The parent sets the ``DMLC_*`` variables of the cluster
and:

- ``PSTEST_PKG``: ``jax`` or ``port``, the package this process runs;
- ``PSTEST_ROLES``: the nodes this process hosts, e.g.
  ``scheduler,worker`` or ``server,server`` (each its own Postoffice,
  started on its own thread); a role may name its own package,
  ``server@port``, so one process hosts nodes of both;
- ``PSTEST_OUT``: a directory for the results: ``server<rank>.npz``
  (the server's store) and ``worker<rank>.npz`` (what it pulled);
- ``PSTEST_ZPULL=1``: the worker pulls into ``alloc_pull_buffer``;
- ``PSTEST_CPU_GROUP=N`` (port only): the worker's ``ici_tcp``/``ici_shm``
  engine runs on ``DeviceGroup(N, device="cpu")`` instead of the card,
  and pushes a registered bucket beside the message keys;
- ``PSTEST_CODEC``: a wire codec; the worker runs :func:`run_codec_worker`
  instead of :func:`run_worker`.
- ``PSTEST_TIERS=1``: the worker runs :func:`run_tier_worker` (small ops,
  ``multi_get``, tenants, repeat pulls), for clusters launched with
  ``PS_BATCH_BYTES``, ``PS_TENANTS`` or ``PS_HOT_CACHE``; it reports how
  many batch frames its combiner sent.
- ``PSTEST_STORM=1``: the worker runs :func:`run_storm_worker` (bulk
  pushes with priority pushes between them and int8-coded ones).

Port servers report ``streams_opened`` (chunked pushes applied as their
chunks landed); every process reports ``native`` and ``pipe_mode``, per
node whether its van runs the native core and its shared-memory pipes.

It prints one JSON line per process (``{"ok": true, ...}``) and exits 0,
or prints the error and exits 1.  A process still running after
``PSTEST_DEADLINE`` seconds (default 60) dumps its stacks and exits.
"""

import faulthandler
import json
import os
import sys
import threading

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import numpy as np  # noqa: E402

DEADLINE = float(os.environ.get("PSTEST_DEADLINE", "60"))

VAL_LEN = 256_000  # 1,024,000 B of f32 per key: 2 keys per message chunk
KEYS_PER_SERVER = 2
SEED = 7
BUCKET_KEYS = 4
BUCKET_VAL_LEN = 64


def api(pkg: str):
    """The package's names this scenario uses."""
    if pkg == "jax":
        import pslite_tpu as ps
        from pslite_tpu.environment import Environment
        from pslite_tpu.message import Role

        return ps, Environment, lambda name: Role[name.upper()]
    import pslite_tpu_torch as ps
    from pslite_tpu_torch.environment import Environment

    return ps, Environment, lambda name: name


def scenario_keys(po) -> np.ndarray:
    ranges = po.get_server_key_ranges()
    return np.array([r.begin + 1 + j for r in ranges
                     for j in range(KEYS_PER_SERVER)], np.uint64)


def scenario_pushes(n_keys: int):
    """Three seeded pushes of normal floats: one worker, so the server
    adds them in one order and the stores must be bit-equal."""
    rng = np.random.default_rng(SEED)
    return [rng.standard_normal(n_keys * VAL_LEN, dtype=np.float32)
            for _ in range(3)]


def run_worker(kv, po, zpull: bool = False) -> dict:
    """push, push, push_pull, pull of the keys: each message to a server
    is 2,048,000 B, chunked at the 1 MiB default.  Returns the pulls."""
    keys = scenario_keys(po)
    pushes = scenario_pushes(len(keys))
    out = {}
    for p in pushes[:2]:
        kv.wait(kv.push(keys, p))
    fused = np.zeros_like(pushes[2])
    kv.wait(kv.push_pull(keys, pushes[2], fused))
    out["push_pull"] = fused
    dst = (kv.alloc_pull_buffer(keys, VAL_LEN) if zpull else None)
    if zpull and dst is None:
        raise AssertionError("alloc_pull_buffer returned None")
    if dst is None:
        dst = np.zeros_like(pushes[0])
    kv.wait(kv.pull(keys, dst))
    out["pull"] = np.array(dst)
    out["keys"] = keys
    return out


def run_codec_worker(kv, po, codec: str) -> dict:
    """The scenario's pushes under ``codec``: the keys registered with
    ``register_bucket``, and the same keys + 50 with ``codec=`` on each
    call; three pushes of each, a push_pull of the registered keys (the
    push encoded, the response raw) and a pull of each (encoded
    responses).  Returns the pulls."""
    keys = scenario_keys(po)
    other = keys + np.uint64(50)
    kv.register_bucket(keys, codec=codec)
    pushes = scenario_pushes(len(keys))
    for p in pushes:
        kv.wait(kv.push(keys, p))
        kv.wait(kv.push(other, p, codec=codec))
    out = {"keys": keys}
    out["push_pull"] = np.zeros_like(pushes[0])
    kv.wait(kv.push_pull(keys, pushes[1], out["push_pull"]))
    out["pull"] = np.zeros_like(pushes[0])
    kv.wait(kv.pull(keys, out["pull"]))
    out["pull_codec_arg"] = np.zeros_like(pushes[0])
    kv.wait(kv.pull(other, out["pull_codec_arg"], codec=codec))
    return out


TIER_KEYS_PER_SERVER = 8
TIER_VAL_LEN = 16


def run_tier_worker(kv, po) -> dict:
    """Small ops for the message-path tiers: 30 pushes of one-row keys
    on each server (tenant ``train`` when tenants are configured),
    issued before any wait; a ``multi_get`` of every row (tenant
    ``serve``); three repeat pulls of one row; a push to it and its pull
    (never stale); a ``pull_multi`` of two lists.  Integer-valued, so
    every value is exact.  Returns the pulls."""
    ranges = po.get_server_key_ranges()
    keys = np.array([r.begin + 100 + j for r in ranges
                     for j in range(TIER_KEYS_PER_SERVER)], np.uint64)
    tenants = bool(os.environ.get("PS_TENANTS"))
    bulk = {"tenant": "train"} if tenants else {}
    serve = {"tenant": "serve"} if tenants else {}
    rng = np.random.default_rng(SEED + 2)
    n = len(keys) * TIER_VAL_LEN
    pushes = [rng.integers(-8, 8, size=n).astype(np.float32)
              for _ in range(30)]
    for ts in [kv.push(keys, p, **bulk) for p in pushes]:
        kv.wait(ts)
    rows = [keys[i:i + 1] for i in range(len(keys))]
    out = {"keys": keys}
    out["multi_get"] = np.stack(
        kv.multi_get(rows, val_len=TIER_VAL_LEN, **serve).wait())
    rep = np.zeros(TIER_VAL_LEN, np.float32)
    for _ in range(3):
        kv.wait(kv.pull(rows[3], rep, **serve))
    out["repeat"] = rep.copy()
    kv.wait(kv.push(rows[3], np.full(TIER_VAL_LEN, 5.0, np.float32), **bulk))
    kv.wait(kv.pull(rows[3], rep, **serve))
    out["after_push"] = rep.copy()
    out["pull_multi"] = np.concatenate(kv.pull_multi(
        [keys[:2], keys[-3:]], val_len=TIER_VAL_LEN, **serve).wait())
    return out


def run_storm_worker(kv, po) -> dict:
    """The native plane's storm (``tests/test_native_plane.py``'s
    ``_tcp_storm`` over the scenario's keys): 4 rounds of a bulk push
    and a priority-1 push of small keys in flight together, every other
    round also an int8-coded bulk push; then a pull of each.  Returns
    the pulls."""
    keys = scenario_keys(po)
    small = keys + np.uint64(7)
    rng = np.random.default_rng(SEED + 3)
    big = rng.standard_normal(len(keys) * VAL_LEN, dtype=np.float32)
    tiny = rng.standard_normal(len(keys) * 16, dtype=np.float32)
    for i in range(4):
        ts1 = kv.push(keys, big)
        ts2 = kv.push(small, tiny, priority=1)
        kv.wait(ts1)
        kv.wait(ts2)
        if i % 2:
            kv.wait(kv.push(keys, big, codec="int8"))
    out = {"keys": keys, "pull": np.zeros_like(big),
           "pull_small": np.zeros_like(tiny)}
    kv.wait(kv.pull(keys, out["pull"]))
    kv.wait(kv.pull(small, out["pull_small"]))
    return out


def native_of(van) -> bool:
    """Whether a van (every rail of a composite) runs the native core."""
    rails = getattr(van, "_rails", None)
    if rails is not None:
        return all(native_of(r) for r in rails)
    return getattr(van, "_native", None) is not None


def run_bucket(ps, kv, steps: int = 3) -> dict:
    """The engine path beside the message path: a registered bucket of
    integer-valued grads (exact sums in any order)."""
    keys = np.arange(BUCKET_KEYS, dtype=np.uint64)
    kv.register_dense("bucket", keys, BUCKET_VAL_LEN)
    n = kv.engine.group.num_ranks
    rng = np.random.default_rng(SEED + 1)
    total = np.zeros(BUCKET_KEYS * BUCKET_VAL_LEN)
    outs = np.zeros(BUCKET_KEYS * BUCKET_VAL_LEN, np.float32)
    for _ in range(steps):
        g = rng.integers(-8, 8, size=(n, BUCKET_KEYS * BUCKET_VAL_LEN)
                         ).astype(np.float32)
        kv.wait(kv.push_pull(keys, g, outs))
        total += g.astype(np.float64).sum(0)
        if not np.array_equal(outs, total):
            raise AssertionError("bucket push_pull off the exact sum")
    from pslite_tpu_torch.ops import ring_collective

    return {"bucket_steps": steps,
            "k4_launches": sum(ring_collective.launches.values())}


def run_all(fns) -> None:
    errors = []

    def wrap(fn):
        def run():
            try:
                fn()
            except BaseException as exc:  # noqa: BLE001 - re-raised
                errors.append(exc)
        return run

    threads = [threading.Thread(target=wrap(fn), daemon=True) for fn in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(DEADLINE)
    if any(t.is_alive() for t in threads):
        raise TimeoutError("a node did not finish within the deadline")
    if errors:
        raise errors[0]


def main() -> int:
    default_pkg = os.environ["PSTEST_PKG"]
    roles, pkgs = [], []
    for tok in os.environ["PSTEST_ROLES"].split(","):
        role, _, pkg = tok.partition("@")
        roles.append(role)
        pkgs.append(pkg or default_pkg)
    out_dir = os.environ["PSTEST_OUT"]
    if "jax" in pkgs and os.environ.get("PSTEST_CODEC") == "fp8_e4m3":
        # The JAX package sets its two fp8 tables one after the other,
        # so shard threads decoding at once may find the second unset
        # (ROADMAP Queue 3): build them before any thread starts.
        from pslite_tpu.ops import codecs

        codecs.Fp8E4M3Codec._luts()
    nodes, mods = [], {}
    for r, pkg in zip(roles, pkgs):
        ps, Environment, role_of = api(pkg)
        po = ps.Postoffice(role_of(r), env=Environment({}))
        nodes.append(po)
        mods[id(po)] = ps
    cpu_group = int(os.environ.get("PSTEST_CPU_GROUP", "0"))
    for po in nodes:
        if cpu_group and po.is_worker:
            po.van.set_mesh(mods[id(po)].DeviceGroup(cpu_group, device="cpu"))
    run_all([po.start for po in nodes])
    apps, report = [], {"ok": True, "pkg": pkgs[0] if len(set(pkgs)) == 1
                        else "both", "roles": roles,
                        "native": [native_of(po.van) for po in nodes],
                        "pipe_mode": [getattr(po.van, "_pipe_mode", False)
                                      for po in nodes]}
    try:
        servers = []
        for po in nodes:
            ps = mods[id(po)]
            if po.is_server:
                srv = ps.KVServer(0, postoffice=po)
                srv.set_request_handle(ps.KVServerDefaultHandle())
                servers.append((po, srv))
                apps.append(srv)

        def work(po):
            """Every node meets once the servers' handles are set, so no
            push races a server's ``set_request_handle`` (a JAX server
            drops a chunked push's first streamed partial when it lands
            before its apply pool exists, yet opens the stream at the
            next partial and answers with that key never applied:
            ROADMAP Queue 3); the worker's scenario; then every node
            meets again, so the servers save their stores after the last
            push."""
            po.barrier(0, mods[id(po)].ALL_GROUP)
            if po.is_worker:
                worker_scenario(po)
            po.barrier(0, mods[id(po)].ALL_GROUP)

        def worker_scenario(po):
            ps = mods[id(po)]
            kv = ps.KVWorker(0, 0, postoffice=po)
            apps.append(kv)
            if cpu_group:
                report.update(run_bucket(ps, kv))
            codec = os.environ.get("PSTEST_CODEC")
            if os.environ.get("PSTEST_STORM") == "1":
                res = run_storm_worker(kv, po)
            elif os.environ.get("PSTEST_TIERS") == "1":
                res = run_tier_worker(kv, po)
                comb = kv.combiner
                report["batch_frames"] = (comb.flushed_frames
                                          if comb is not None else 0)
            else:
                res = (run_codec_worker(kv, po, codec) if codec else
                       run_worker(kv, po,
                                  os.environ.get("PSTEST_ZPULL") == "1"))
            report["zpull_hits"] = kv.zpull_hits
            np.savez(os.path.join(out_dir, f"worker{po.my_rank()}.npz"),
                     **res)

        run_all([lambda po=po: work(po) for po in nodes])
        for po, srv in servers:
            np.savez(os.path.join(out_dir, f"server{po.my_rank()}.npz"),
                     **{str(k): v for k, v in srv._handle.store.items()})
    finally:
        for a in apps:
            a.stop()
        run_all([po.finalize for po in nodes])
    if report["pkg"] == "port":
        report["chunks"] = {r: [po.van.chunks_sent, po.van.chunks_recv]
                            for r, po in zip(roles, nodes)}
        report["streams_opened"] = [srv.streams_opened
                                    for _po, srv in servers]
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    # Armed here, not at import: the tests import this module too.
    faulthandler.dump_traceback_later(DEADLINE, exit=True)
    try:
        sys.exit(main())
    except Exception as exc:  # noqa: BLE001 - reported to the parent
        import traceback

        traceback.print_exc()
        print(json.dumps({"ok": False, "error": repr(exc)}), flush=True)
        sys.exit(1)
