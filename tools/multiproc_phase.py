"""``chip_smoke.py``'s ``multiprocess`` phase: one device group across
worker processes on one card (``PS_ICI_MULTIHOST=1``), and the DCN tier.

Legs, each a cluster of separate processes from the port's launcher
(``tracker/local.py``), every child under ``DEADLINE`` seconds:

- ``ici_tcp``: 1 scheduler + 1 server + 2 worker processes,
  ``PS_ICI_IMPL=pallas``; each worker joins the process group and
  installs ``global_group(local_ranks=4)`` on ``cuda:0``: 8 ranks.  The
  40 x 1 MB bucket (P = 10,240,000 f32): 5 ``sum`` steps through K4
  across processes, each held against the single-process
  ``pstt_ring_push_pull`` on all 8 rows (rebuilt from the seed in every
  worker) with 0 differing elements, and that against its plain version;
  2 ``adam:1e-3`` steps (the owned-shard K3 path) against the
  single-process engine; config 5's table (1,048,576 x 64 f32, 4,096
  Zipf(1.2) rows per rank, seed 0) pushed and pulled across both
  processes against the single-process ``SparseEngine``, bit for bit;
  ``KVWorker.reshard`` onto 2 ranks of each process, then one more exact
  ``push_pull``.  Per step: wall ms, the reduce and gather ms by CUDA
  events (each process's own launch, while the other's may share the
  card), the window from the first process's launch to the last one's
  sync (one host clock), the three host barriers' ms, and the new
  entries' launches.  Then each worker in turn, the other waiting at a
  barrier, times its two peer kernels alone as the kernels phase times
  every kernel (graph replay and back-to-back calls), beside their plain
  versions, the gather's library call (one ``torch.cat`` of the owners'
  shards through their IPC mappings) and the single-process K4 on the 8
  rows.
- ``ici_shm``: the first 2 ``sum`` steps over the shared-memory van.
- ``dcn``: 2 slice-leader processes, each on ``DeviceGroup(4)`` of
  ``cuda:0`` (K4 with ``assign`` on its own group), and 2 tcp servers:
  ``DcnKVWorker.push_pull_group`` of the bucket, plain (bit-exact against
  each slice's ring sum, K4's plain version, then the server's add) and
  with ``compress="int8"`` (within JAX's bound, tests/test_dcn.py:106).

Run alone from the root of a checkout on the card:
``python3 tools/multiproc_phase.py``.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

DEADLINE = 240.0
SEED = 1234
N, LOCAL = 8, 4          # ranks in all, ranks per worker process
ADAM = "adam:1e-3"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
KEYS, VAL_LEN = 40, 256_000  # the bucket: 40 x 1,024,000 B of f32
P = KEYS * VAL_LEN
ROWS, DIM, BATCH = 1 << 20, 64, 4096  # config 5's table, rows per rank
DEV = "cuda:0"


def _median(xs):
    return float(np.median(xs)) if xs else 0.0


# -- node processes -----------------------------------------------------------

def node_main() -> int:
    """One process of a leg (``multiproc_phase.py --node``); prints one
    JSON line, its last."""
    spec = json.loads(os.environ["MP_SPEC"])
    import pslite_tpu_torch as ps

    role = os.environ["DMLC_ROLE"]
    if role != "worker":
        ps.start_ps()
        srv = None
        if role == "server":
            srv = ps.KVServer(0)
            srv.set_request_handle(ps.KVServerDefaultHandle())
        ps.finalize()
        if srv is not None:
            srv.stop()
        print(json.dumps({"role": role, "ok": True}), flush=True)
        return 0
    report = (node_dcn(ps, spec) if spec["leg"] == "dcn"
              else node_mp(ps, spec))
    report.update(role=role, ok=True)
    print(json.dumps(report), flush=True)
    return 0


class _Uncounted:
    """Launches inside the block (the comparisons' single-process and
    plain runs) leave the launch counts as they were."""

    def __init__(self, *modules):
        self.modules = modules

    def __enter__(self):
        self.saved = [dict(m.launches) for m in self.modules]

    def __exit__(self, *exc):
        for m, saved in zip(self.modules, self.saved):
            m.launches.update(saved)


def _rows(torch, step: int, n: int):
    """Every global rank's grads of one step, the same in every process."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + step)
    return torch.randn((n, P), device=DEV, generator=gen)


def _events_ms(t: dict, key: str) -> float:
    ev = t.get(key)
    return float(ev[0].elapsed_time(ev[1])) if isinstance(ev, tuple) else 0.0


def time_alone(torch, ring, eng, rows8) -> dict:
    """This process's two peer kernels on the ``grads`` bucket, timed while
    the other worker waits at a barrier (no other context on the card):
    host-free from graph replay and host-inclusive, as ``chip_smoke.py``'s
    kernels phase times every kernel.  Beside them: the plain versions
    (the single-process plain ring on the 8 rows, which computes the
    whole bucket; a ``copy_`` per owner's shards), the gather's library
    call (one ``torch.cat`` of the owners' shards through their IPC
    mappings, which must give the same bits) and the single-process K4
    on the 8 rows.  The reduce writes a copy of the store."""
    import chip_smoke as cs

    bucket, store = eng._buckets["grads"], eng._stores["grads"]
    padded = bucket.padded_len
    lo, count = eng._local_span(bucket, eng.group)
    rows = eng._row_addrs("grads")
    segs = sorted(eng._store_segments("grads"), key=lambda seg: seg[1])
    if [seg[1] for seg in segs] != list(np.cumsum(
            [0] + [seg[2] for seg in segs[:-1]])) or \
            sum(seg[2] for seg in segs) != padded:
        raise AssertionError(f"the owners' shards do not tile the bucket: "
                             f"{segs}")
    views = [ring.device_view(addr, (n,), store.dtype, store.device)
             for addr, _off, n in segs]
    scratch, full = store.clone(), torch.zeros(padded, device=DEV)
    pulled, cat_out, plain_out = (torch.empty(padded, device=DEV)
                                  for _ in range(3))

    def plain_gather():
        for v, (_a, off, n) in zip(views, segs):
            plain_out[off:off + n].copy_(v)

    out = {"count": count, "padded": padded}
    out["reduce_ms"], out["reduce_ms_host"] = cs.kernel_times(
        lambda: ring.ring_reduce_peers(rows, scratch, lo, padded, "sum"))
    out["gather_ms"], out["gather_ms_host"] = cs.kernel_times(
        lambda: ring.ring_gather_peers(segs, pulled))
    lib = cs.library_time(lambda: torch.cat(views, out=cat_out))
    out["gather_library_ms"], out["gather_library_ms_host"] = lib[:2]
    out["reduce_plain_ms"] = cs.cuda_ms(
        lambda: ring.ring_push_pull_reference(rows8, full), iters=3,
        warmup=1)
    out["gather_plain_ms"] = cs.cuda_ms(plain_gather)
    out["single_k4_ms"] = cs.graph_ms(
        lambda: ring.ring_push_pull(rows8, full))
    torch.cuda.synchronize()
    out["gather_library_differing"] = int((cat_out != pulled).sum())
    out["gather_plain_differing"] = int((plain_out != pulled).sum())
    if out["gather_library_differing"] or out["gather_plain_differing"]:
        raise AssertionError(f"the gather alone: {out}")
    return out


def node_mp(ps, spec) -> dict:
    """A worker of the ``ici_tcp``/``ici_shm`` legs (see the module
    docstring); raises on any differing element."""
    import torch
    from pslite_tpu_torch.environment import Environment
    from pslite_tpu_torch.models import embedding as emb
    from pslite_tpu_torch.ops import fused_update as fu
    from pslite_tpu_torch.ops import ring_collective as ring
    from pslite_tpu_torch.ops import sparse_rows as sr
    from pslite_tpu_torch.parallel import distributed

    sync = torch.cuda.synchronize
    uncounted = _Uncounted(ring, fu, sr)
    keys = np.arange(KEYS, dtype=np.uint64)
    rank = int(os.environ["DMLC_RANK"])
    env = Environment({})
    assert distributed.acquire(env)  # this node's lease, beside the van's
    group = distributed.global_group(local_ranks=LOCAL, device=DEV)
    po = ps.Postoffice("worker", env=env)
    po.van.set_mesh(group)
    po.start()
    kv = ps.KVWorker(0, 0, postoffice=po)
    eng, se = kv.engine, kv.sparse_engine
    for m in (ring, fu, sr):
        m.reset_launches()
    mine = slice(LOCAL * rank, LOCAL * (rank + 1))
    kv.register_dense("grads", keys, VAL_LEN)
    lo = LOCAL * rank * (P // N)
    ref_store = torch.zeros(P, device=DEV)
    outs = torch.zeros(P, device=DEV)
    eng.peer_timing = {}
    steps, worst = [], 0.0
    for k in range(spec["sum_steps"]):
        rows8 = _rows(torch, k, N)
        with uncounted:
            before = ref_store.clone()
            ref = ring.ring_push_pull(rows8, ref_store)
            plain = ring.ring_push_pull_reference(rows8, before)
            sync()
            plain_diff = int((plain != ref).sum())
        g = rows8[mine].contiguous()
        sync()
        t0 = time.perf_counter()
        kv.wait(kv.push_pull(keys, g, outs))
        wall = (time.perf_counter() - t0) * 1e3
        diff = int((outs != ref).sum())
        store_diff = int((eng._stores["grads"]
                          != ref_store[lo:lo + LOCAL * P // N]).sum())
        worst = max(worst, float((outs - ref).abs().max()))
        t = eng.peer_timing
        steps.append({
            "wall_ms": wall, "reduce_ms": _events_ms(t, "reduce"),
            "gather_ms": _events_ms(t, "gather"),
            "reduce_window": t["reduce_window"],
            "gather_window": t["gather_window"],
            "barrier_ms": [t.get(b, 0.0) for b in
                           ("barrier_in_ms", "barrier_mid_ms",
                            "barrier_out_ms")],
            "differing": diff, "store_differing": store_diff,
            "plain_differing": plain_diff})
        if diff or store_diff or plain_diff:
            raise AssertionError(f"sum step {k}: {diff} pulled, "
                                 f"{store_diff} store and {plain_diff} "
                                 f"plain elements differ")
    report = {"steps": steps, "max_abs_err": worst, "rank": rank}
    if spec.get("alone"):
        for turn in range(len(group.processes)):
            distributed.barrier()
            if turn == rank:
                with uncounted:
                    report["alone"] = time_alone(torch, ring, eng, rows8)
        distributed.barrier()
    if spec.get("adam_steps"):
        ref_eng = ps.CollectiveEngine(ps.DeviceGroup(N, device=DEV),
                                      impl="ring")
        akeys = keys + 1_000
        for e in (eng, ref_eng):
            e.register_dense("adam", akeys, VAL_LEN)
        adam = []
        for k in range(spec["adam_steps"]):
            rows8 = _rows(torch, 100 + k, N)
            with uncounted:
                want = ref_eng.push_pull("adam", rows8, handle=ADAM)
            t0 = time.perf_counter()
            got = eng.push_pull("adam", rows8[mine].contiguous(),
                                handle=ADAM)
            sync()
            wall = (time.perf_counter() - t0) * 1e3
            adam.append({"wall_ms": wall,
                         "differing": int((got != want).sum()),
                         "max_abs_err": float((got - want).abs().max())})
            if not torch.allclose(got, want, rtol=1e-6, atol=0.0):
                raise AssertionError(f"adam step {k}: {adam[-1]}")
        report["adam"] = adam
    if spec.get("sparse"):
        ref_se = ps.SparseEngine(ps.DeviceGroup(N, device=DEV))
        for e in (se, ref_se):
            e.register_sparse("emb", ROWS, DIM)
        idx = torch.from_numpy(emb.skewed_indices(ROWS, N, BATCH,
                                                  seed=0)).to(DEV)
        pidx = torch.from_numpy(emb.skewed_indices(ROWS, N, BATCH,
                                                   seed=1)).to(DEV)
        gen = torch.Generator(device=DEV).manual_seed(SEED + 6)
        g = torch.randn((N, BATCH, DIM), device=DEV, generator=gen)
        with uncounted:
            ref_se.push("emb", idx, g)
            want = ref_se.pull("emb", pidx)
        got = torch.zeros((LOCAL, BATCH, DIM), device=DEV)
        sync()
        t0 = time.perf_counter()
        kv.wait(kv.push_sparse("emb", idx[mine].contiguous(),
                               g[mine].contiguous()))
        push_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        kv.wait(kv.pull_sparse("emb", pidx[mine].contiguous(), out=got))
        pull_ms = (time.perf_counter() - t0) * 1e3
        rps = se.table("emb").rows_per_shard
        lo_rows = LOCAL * rank * rps
        store_diff = int((se._stores["emb"] != ref_se._stores["emb"][
            lo_rows:lo_rows + LOCAL * rps]).sum())
        pull_diff = int((got != want[mine]).sum())
        report["sparse"] = {"push_ms": push_ms, "pull_ms": pull_ms,
                            "store_differing": store_diff,
                            "pull_differing": pull_diff}
        if store_diff or pull_diff:
            raise AssertionError(f"sparse: {report['sparse']}")
    if spec.get("reshard"):
        t0 = time.perf_counter()
        kv.reshard(distributed.global_group(local_ranks=2, device=DEV))
        reshard_ms = (time.perf_counter() - t0) * 1e3
        assert eng.num_shards == 4 and se.num_shards == 4
        rows4 = _rows(torch, 200, 4)
        with uncounted:
            ref = ring.ring_push_pull(rows4, ref_store)
        kv.wait(kv.push_pull(keys, rows4[2 * rank:2 * rank + 2].contiguous(),
                             outs))
        diff = int((outs != ref).sum())
        report["reshard"] = {"ms": reshard_ms, "differing": diff}
        if diff:
            raise AssertionError(f"after the reshard: {diff} elements "
                                 f"differ")
    report["launches"] = {k: v for m in (ring, fu, sr)
                          for k, v in m.launches.items() if v}
    po.finalize()
    distributed.release()
    return report


def node_dcn(ps, spec) -> dict:
    """A slice leader of the ``dcn`` leg: its 4 ranks' rows of the
    bucket through ``DcnKVWorker.push_pull_group``, plain and int8."""
    import torch
    from pslite_tpu_torch.ops import ring_collective as ring
    from pslite_tpu_torch.parallel.dcn import DcnKVWorker

    ps.start_ps()
    po = ps.postoffice("worker")
    kv = ps.KVWorker(0, 0)
    s = po.my_rank()
    ring.reset_launches()
    eng = ps.CollectiveEngine(ps.DeviceGroup(LOCAL, device=DEV),
                              impl="ring")
    plain = DcnKVWorker(kv, eng)
    quant = DcnKVWorker(kv, eng, compress="int8")
    keys = np.arange(KEYS, dtype=np.uint64)
    plain.register_dense("plain", keys, VAL_LEN)
    quant.register_dense("int8", keys + 10_000, VAL_LEN)
    rows8 = _rows(torch, 300, N)
    mine = rows8[LOCAL * s:LOCAL * (s + 1)].contiguous()
    t0 = time.perf_counter()
    (got,) = plain.push_pull_group(["plain"], [mine])
    plain_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    (got8,) = quant.push_pull_group(["int8"], [mine])
    int8_ms = (time.perf_counter() - t0) * 1e3
    launches = dict((k, v) for k, v in ring.launches.items() if v)
    # The plain composition: each slice's sum in the ring's order (K4's
    # plain version with assign), then the server's add (which commutes).
    sums = [ring.ring_push_pull_reference(
        rows8[LOCAL * i:LOCAL * (i + 1)].contiguous(),
        torch.zeros(P, device=DEV), "assign").cpu().numpy()
        for i in (0, 1)]
    want = sums[0] + sums[1]
    diff = int((got != want).sum())
    err = float(np.abs(got8 - want).max())
    scale = float(np.abs(want).max())
    ps.finalize()
    if diff:
        raise AssertionError(f"dcn plain: {diff} elements differ")
    if not err < 0.05 * max(scale, 1.0):
        raise AssertionError(f"dcn int8: max |err| {err} (scale {scale})")
    return {"slice": s, "plain_ms": plain_ms, "int8_ms": int8_ms,
            "int8_max_abs_err": err, "scale": scale, "differing": diff,
            "launches": launches}


# -- the parent ---------------------------------------------------------------

class Leg:
    """One cluster of the phase: its processes started at once, roles
    from the port's launcher, each under ``DEADLINE``; every child is
    killed when one fails or time runs out."""

    def __init__(self, van: str, workers: int, servers: int, spec: dict,
                 extra=None, ranks: bool = False):
        from pslite_tpu_torch.tracker.local import LocalLauncher, build_env
        from pslite_tpu_torch.utils.network import get_available_port

        self.label = spec["leg"]
        port = get_available_port()
        for _ in range(100):  # the process group listens on port + 1
            with socket.socket() as s:
                try:
                    s.bind(("", port + 1))
                    break
                except OSError:
                    port = get_available_port()
        roles = LocalLauncher(workers, servers, [], van=van,
                              root_port=port).roles()
        self.logdir = tempfile.mkdtemp(prefix="mp")
        self.procs = []
        worker = 0
        for i, role in enumerate(roles):
            env = build_env(role, workers, servers, "127.0.0.1", port, van,
                            extra=dict(extra or {}, DMLC_NODE_HOST="127.0.0.1",
                                       MP_SPEC=json.dumps(spec)))
            env.pop("DMLC_RANK", None)
            if role == "worker" and ranks:
                env["DMLC_RANK"] = str(worker)
            worker += role == "worker"
            path = os.path.join(self.logdir, f"{i}-{role}.log")
            with open(path, "w") as log:
                self.procs.append((role, path, subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--node"],
                    env=env, stdout=log, stderr=subprocess.STDOUT,
                    stdin=subprocess.DEVNULL, cwd=HERE)))
        self.end = time.monotonic() + DEADLINE

    def done(self) -> bool:
        """True when every child exited 0; raises when one failed."""
        codes = [p.poll() for _r, _l, p in self.procs]
        bad = next((i for i, c in enumerate(codes) if c not in (None, 0)),
                   None)
        if bad is None and time.monotonic() > self.end and None in codes:
            bad = codes.index(None)
        if bad is not None:
            self.kill()
            for role, path, _p in self.procs:
                with open(path) as f:
                    print(f"  [{self.label} {role}] " + "\n  ".join(
                        f.read().splitlines()[-15:]))
            raise AssertionError(f"multiprocess leg {self.label}: "
                                 f"{self.procs[bad][0]} failed")
        return None not in codes

    def reports(self) -> list:
        out = []
        for role, path, _p in self.procs:
            if role == "worker":
                with open(path) as f:
                    out.append(json.loads(f.read().strip().splitlines()[-1]))
        return out

    def kill(self) -> None:
        for _r, _l, p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def run_legs(legs) -> list:
    """Wait for every leg; the workers' reports of each."""
    try:
        while not all([leg.done() for leg in legs]):
            time.sleep(0.05)
        return [leg.reports() for leg in legs]
    finally:
        for leg in legs:
            leg.kill()


def _add(counts: dict, more: dict) -> None:
    for k, v in more.items():
        counts[k] = counts.get(k, 0) + v


def _span_ms(reports, k: int, part: str) -> float:
    """Step ``k``'s ``part`` across the worker processes: from the first
    launch to the last sync after it, on the host's monotonic clock."""
    windows = [r["steps"][k][f"{part}_window"] for r in reports]
    return (max(w[1] for w in windows) - min(w[0] for w in windows)) * 1e3


def drive_multiprocess(smi: str, kernel_rows=None):
    """The phase (module docstring).  Returns ``(results, launches)``: the
    main-path result rows and the launches the worker processes counted;
    appends the cross-process K4's two kernel rows to ``kernel_rows``."""
    t_phase = time.perf_counter()
    mp_env = {"PS_ICI_MULTIHOST": "1", "PS_ICI_IMPL": "pallas"}
    (main,) = run_legs([Leg("ici_tcp", 2, 1, dict(
        leg="mp", sum_steps=5, adam_steps=2, sparse=True, reshard=True,
        alone=True), extra=mp_env, ranks=True)])
    ns = f"mp{os.getpid()}"
    shm, dcn = run_legs([
        Leg("ici_shm", 2, 1, dict(leg="mp", sum_steps=2),
            extra=dict(mp_env, PS_SHM_NS=ns), ranks=True),
        Leg("tcp", 2, 2, dict(leg="dcn"))])
    ours = [f for f in os.listdir("/dev/shm") if ns in f]
    leftovers = [f for f in ours if not f.endswith(".lock")]
    if leftovers:
        raise AssertionError(f"ici_shm leg left /dev/shm segments "
                             f"{leftovers}")
    for f in ours:  # the pipes' lock files; the leg's processes are gone
        os.unlink(os.path.join("/dev/shm", f))
    launches: dict = {}
    for rep in main + shm + dcn:
        _add(launches, rep["launches"])
    for name in ("ring_reduce_peers[float32]", "ring_gather_peers[float32]"):
        if not launches.get(name):
            raise AssertionError(f"{name} never launched on the "
                                 f"multiprocess path")
    steps = len(main[0]["steps"])
    print(f"multiprocess ici_tcp: 2 worker processes x {LOCAL} ranks of "
          f"{DEV} (global group of {N}), bucket {KEYS} x {VAL_LEN} f32 "
          f"(P = {P}); {steps} sum steps, 0 differing elements against "
          f"the single-process pstt_ring_push_pull and its plain version "
          f"in every step [{smi}]")
    for k in range(steps):
        row = [(r["steps"][k]["wall_ms"], r["steps"][k]["reduce_ms"],
                r["steps"][k]["gather_ms"], r["steps"][k]["barrier_ms"])
               for r in main]
        print(f"    step {k}: reduce across both processes "
              f"{_span_ms(main, k, 'reduce'):.4f} ms, gather "
              f"{_span_ms(main, k, 'gather'):.4f} ms (first launch to last "
              f"sync, host clock); " + "; ".join(
                  f"worker {i}: wall {w:.3f} ms, own reduce {rd:.4f} ms, "
                  f"own gather {ga:.4f} ms (CUDA events), barriers "
                  f"in/mid/out {b[0]:.3f}/{b[1]:.3f}/{b[2]:.3f} ms host"
                  for i, (w, rd, ga, b) in enumerate(row)))
    alone = [r["alone"] for r in main]
    for r in main:
        a = r["alone"]
        print(f"    worker {r['rank']} alone (the other at a barrier): "
              f"reduce {a['reduce_ms']:.4f} ms ({a['reduce_ms_host']:.4f} "
              f"host), gather {a['gather_ms']:.4f} ms "
              f"({a['gather_ms_host']:.4f} host), torch.cat of the shards "
              f"{a['gather_library_ms']:.4f} ms "
              f"({a['gather_library_ms_host']:.4f} host, 0 differing); "
              f"plain ring on the 8 rows {a['reduce_plain_ms']:.3f} ms, "
              f"plain gather {a['gather_plain_ms']:.4f} ms; beside it one "
              f"process's 8 ranks: pstt_ring_push_pull "
              f"{a['single_k4_ms']:.4f} ms")
    for r in main:
        a, s, rs = r["adam"], r["sparse"], r["reshard"]
        print(f"    worker {r['rank']}: adam {ADAM} steps wall "
              + ", ".join(f"{x['wall_ms']:.3f}" for x in a)
              + " ms, differing elements against the single-process "
              f"engine {[x['differing'] for x in a]} (max |err| "
              f"{max(x['max_abs_err'] for x in a):.3g}); sparse "
              f"{ROWS} x {DIM}, {BATCH} Zipf(1.2) rows per rank: push "
              f"{s['push_ms']:.3f} ms, pull {s['pull_ms']:.3f} ms wall, "
              f"store/pull differing {s['store_differing']}/"
              f"{s['pull_differing']}; reshard to 2 ranks per process "
              f"{rs['ms']:.1f} ms, then push_pull differing "
              f"{rs['differing']}; launches {r['launches']}")
    print(f"multiprocess ici_shm: {len(shm[0]['steps'])} sum steps, 0 "
          f"differing elements; wall ms " + "; ".join(
              ", ".join(f"{s['wall_ms']:.3f}" for s in r["steps"])
              for r in shm))
    for r in dcn:
        print(f"multiprocess dcn slice {r['slice']}: push_pull_group plain "
              f"{r['plain_ms']:.3f} ms wall (0 differing against the slice "
              f"ring sums plus the server's add), int8 {r['int8_ms']:.3f} "
              f"ms wall, max |err| {r['int8_max_abs_err']:.4g} (bound "
              f"{0.05 * max(r['scale'], 1.0):.4g}); launches "
              f"{r['launches']}")
    b = 4  # f32
    count = max(a["count"] for a in alone)
    padded = alone[0]["padded"]
    # One launch's bytes (each input read once, each output written once)
    # and the op's, over both processes' launches: the reduce reads its
    # chunks of the n rows and reads and writes its store shards; the
    # gather reads the bucket from the owners' stores and writes it.
    launch_bytes = {"reduce": (N + 2) * count * b, "gather": 2 * padded * b}
    op_bytes = {"reduce": (N + 2) * padded * b,
                "gather": 2 * padded * b * len(main)}
    host = max(_median([sum(s["barrier_ms"]) for s in r["steps"]])
               for r in main)
    rows = []
    for part, entry in (("reduce", "pstt_ring_reduce_peers"),
                        ("gather", "pstt_ring_gather_peers")):
        # ms: each process's launch alone, the slower of the two.
        ms = max(a[f"{part}_ms"] for a in alone)
        in_op = max(_median([s[f"{part}_ms"] for s in r["steps"]])
                    for r in main)
        span = _median([_span_ms(main, k, part) for k in range(steps)])
        library = ((max(a["gather_library_ms"] for a in alone),
                    max(a["gather_library_ms_host"] for a in alone),
                    "torch.cat of the owners' shards through their IPC "
                    "mappings")
                   if part == "gather" else
                   (None, None, "no call walks a ring"))
        rows.append({
            "name": f"ring_{part}_peers[float32]", "route": "cuda",
            "source": "pslite_tpu_torch/csrc/ring_push_pull.cu",
            "replaces": "pslite_tpu/ops/ring_collective.py:445",
            "max_abs_err": max(r["max_abs_err"] for r in main),
            "ms": ms, "ms_host": max(a[f"{part}_ms_host"] for a in alone),
            "plain_ms": max(a[f"{part}_plain_ms"] for a in alone),
            "bound_ms": launch_bytes[part] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": library[0],
            "library_ms_host": library[1], "library_note": library[2],
            "in_op_ms": in_op, "span_ms": span,
            "op_bound_ms": op_bytes[part] / HBM_BYTES_PER_S * 1e3,
            "barrier_host_ms": host, "entry": entry,
            "across": "2 processes x 4 ranks, IPC peers"})
        r = rows[-1]
        lib_txt = "none" if library[0] is None else f"{library[0]:.4f} ms"
        print(f"kernel {r['name']} ({entry}, across 2 processes, IPC "
              f"peers): alone {ms:.4f} ms host-free, {r['ms_host']:.4f} "
              f"ms host-inclusive (the slower process), bound "
              f"{r['bound_ms'] * 1e3:.1f} us ({launch_bytes[part] / 1e6:.1f}"
              f" MB, one process's launch), plain {r['plain_ms']:.4f} ms, "
              f"library {lib_txt}; in the op {in_op:.4f} ms (its own events, the slower "
              f"process's median), both processes {span:.4f} ms (first "
              f"launch to last sync) against {r['op_bound_ms'] * 1e3:.1f} "
              f"us ({op_bytes[part] / 1e6:.1f} MB); host barriers "
              f"{host:.3f} ms per step [{smi}]")
    op_ms = sum(r["span_ms"] for r in rows)
    op_bound = sum(r["op_bound_ms"] for r in rows)
    print(f"multiprocess op: reduce + gather across both processes "
          f"{op_ms:.4f} ms against the op's bound {op_bound * 1e3:.1f} us "
          f"(share {op_bound / op_ms:.2f}), plus {host:.3f} ms of host "
          f"barriers [{smi}]")
    if kernel_rows is not None:
        kernel_rows.extend(rows)
    t_phase = time.perf_counter() - t_phase
    print(f"multiprocess phase: {t_phase:.1f} s")
    differing = sum(
        s["differing"] + s["store_differing"] + s["plain_differing"]
        for r in main + shm for s in r["steps"])
    differing += sum(x["differing"] for r in main for x in r["adam"])
    differing += sum(r["sparse"]["store_differing"]
                     + r["sparse"]["pull_differing"]
                     + r["reshard"]["differing"] for r in main)
    results = [{"config": "multiprocess ici_tcp 2 x 4 ranks",
                "ops": steps + 2 + 2 + 1, "differing_elements": differing,
                "phase_s": t_phase},
               {"config": "multiprocess dcn 2 slices x 4 ranks",
                "ops": 2,
                "differing_elements": sum(r["differing"] for r in dcn),
                "int8_max_abs_err": max(r["int8_max_abs_err"]
                                        for r in dcn)}]
    return results, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("multiproc_phase: CUDA is not available", file=sys.stderr)
        return 2
    from pslite_tpu_torch.ops import _native

    t = time.time()
    _native.lib()
    print(f"built in {time.time() - t:.1f} s", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    rows: list = []
    results, launches = drive_multiprocess(smi, rows)
    print("launches " + ", ".join(f"{k} {v}" for k, v in launches.items()))
    print(json.dumps({"kernels": rows, "results": results}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--node"]:
        sys.exit(node_main())
    sys.exit(main())
