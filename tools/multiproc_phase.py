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
  2 ``adam:1e-3`` steps (D2 over the owned pieces, their rows read
  through the peers' addresses) against the single-process engine; config 5's table (1,048,576 x 64 f32, 4,096
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
  After them, in the same processes, the group shapes beyond the 1-D
  ring (``node_shapes``), each engine on a group of both processes'
  ranks (``global_group(shape=)``) and each result held against the
  single-process port on the same global rows: a ``(dp 4, kv 2)``
  engine (``worker_axis="dp"``), 5 ``sum`` steps of the bucket through
  the dp sub-rings across processes (``ring_reduce_peers`` with
  ``kv_shards=2``), 2 ``adam:1e-3`` steps, 2 int8 steps
  (``ring_int8_peers`` on the sub-rings); a ``(dp 2, kv1 2, kv2 2)``
  engine with ``worker_axis`` (B = 4 sub-rings, 2 ``sum`` steps) and
  without (the torch path on each rank's kv shard, 2 steps); config 5's
  table on ``(kv 4, dp 2)`` (sharded over kv, replicated over dp), 2
  pushes and pulls; on the 1-D group and on ``(kv 4, dp 2)`` a
  ``push_group``/``pull_group`` of two tables (config 5's and a 65,536 x
  16 one) against the single-process group and the same tables pushed and
  pulled one by one, bit for bit, with the host barriers of each op
  counted (a group push 2 and a group pull 4, whatever the number of
  tables; one by one 2 and 4 per table).  Each new kernel's first launch is held against its
  plain version on clones of its inputs (``_HeldPeers``), and each
  process times its new kernels alone, as above.
- ``int8``: ``ici_tcp`` with ``PS_ICI_COMPRESS=int8`` in the workers'
  environment: ``KVWorker.push_pull`` of the bucket, 5 ``sum`` steps
  through ``ring_int8_peers`` across processes (the compressed ring on
  each process's chunks, the owners' dequantized chunks gathered), each
  bit-equal to the single-process compressed ``pstt_ring_int8`` on the 8
  rows; then each process times the kernel alone, at the launcher's
  ``(cluster, groups)`` and at every other shape the card runs (each
  held against the launcher's with 0 differing elements; the int8
  sub-rings of the main leg likewise).
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
    report = {"dcn": node_dcn, "int8": node_int8}.get(
        spec["leg"], node_mp)(ps, spec)
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


class _HeldPeers:
    """While open, the first launch of each new cross-process variant
    (``ring_int8_peers`` 1-D and 2-D, the dp sub-rings'
    ``ring_reduce_peers``) is held against ``ring_peers_reference`` on
    clones of its inputs: the rows read through their addresses, the
    store (and pulled) cloned before the launch.  ``differing`` maps each
    variant held to its count of differing elements; a nonzero one
    raises."""

    def __init__(self, torch, ring):
        self.torch, self.ring = torch, ring
        self.differing = {}

    def _rows(self, addrs, padded, dtype, device):
        views = [self.ring.device_view(a, (padded,), dtype, device)
                 for a in addrs]
        return self.torch.stack(views)

    def _check(self, name, real, pieces, store, pulled, padded, plain_kw,
               call):
        torch = self.torch
        if name in self.differing:
            return call()
        torch.cuda.synchronize()
        tables = {}
        plain_pieces = []
        for addrs, start, length, local in pieces:
            key = tuple(addrs)
            if key not in tables:
                tables[key] = self._rows(addrs, padded, store.dtype,
                                         store.device)
            plain_pieces.append((tables[key], start, length, local))
        st = store.clone()
        pl = pulled.clone() if pulled is not None else None
        self.ring.ring_peers_reference(plain_pieces, st, pl, padded,
                                       **plain_kw)
        out = call()
        torch.cuda.synchronize()
        diff = int((store != st).sum())
        if pulled is not None:
            diff += int(sum((pulled[lo:lo + n] != pl[lo:lo + n]).sum()
                            for _a, _s, n, lo in pieces))
        self.differing[name] = diff
        if diff:
            raise AssertionError(f"{name}: {diff} elements differ from "
                                 f"its plain version")
        return out

    def __enter__(self):
        ring = self.ring
        self.real = (ring.ring_int8_peers, ring.ring_reduce_peers)
        real_int8, real_reduce = self.real

        def int8(pieces, store, pulled, padded, handle="sum", with_ag=True,
                 kv_shards=None, bidir=True, cluster=None):
            name = ("ring_int8_peers_2d[float32]" if kv_shards
                    else "ring_int8_peers[float32]")
            return self._check(
                name, real_int8, pieces, store, pulled, padded,
                dict(handle=handle, with_ag=with_ag, compress=True,
                     kv_shards=kv_shards, bidir=bidir),
                lambda: real_int8(pieces, store, pulled, padded, handle,
                                  with_ag, kv_shards, bidir, cluster))

        def reduce(rows, store, lo, padded, handle="sum", bidir=True,
                   kv_shards=None):
            call = (lambda: real_reduce(rows, store, lo, padded, handle,
                                        bidir, kv_shards))
            if kv_shards is None:
                return call()
            pieces = [(rows, start, n, off) for start, n, off in
                      ring._segments(lo, store.numel())]
            return self._check(
                f"ring_reduce_peers_2d[{str(store.dtype)[6:]}]", real_reduce,
                pieces, store, None, padded,
                dict(handle=handle, kv_shards=kv_shards, bidir=bidir), call)

        ring.ring_int8_peers, ring.ring_reduce_peers = int8, reduce
        return self

    def __exit__(self, *exc):
        self.ring.ring_int8_peers, self.ring.ring_reduce_peers = self.real


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
    ((row_ids, local),) = eng._layouts["grads"].runs(eng.group.process_index)
    count = sum(n for _s, n, _o in local)
    rows = [eng._row_addr("grads", r) for r in row_ids]
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
        lambda: ring.ring_reduce_peers(rows, scratch, local, padded, "sum"))
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


GROUP_TABLES = (("grp_a", ROWS, DIM), ("grp_b", 65_536, 16))


def sparse_group_leg(torch, se, ref_se, idxs, gs, mine, uncounted,
                     local_of) -> dict:
    """A ``push_group``/``pull_group`` of :data:`GROUP_TABLES` across the
    processes (global inputs ``idxs``/``gs``, this process's worker rows
    ``mine``), bit-equal to the single-process ``ref_se``; the host
    barriers of each group op, and those of the same tables pushed and
    pulled one by one (the path before groups took one exchange)."""
    names = [t[0] for t in GROUP_TABLES]
    loops = ["loop_" + n for n in names]
    for e in (se, ref_se):
        for (n, rows, dim), ln in zip(GROUP_TABLES, loops):
            e.register_sparse(n, rows, dim)
            e.register_sparse(ln, rows, dim)
    with uncounted:
        ref_se.push_group(names, idxs, gs)
        want = ref_se.pull_group(names, idxs)
    mi = [x[mine].contiguous() for x in idxs]
    mg = [x[mine].contiguous() for x in gs]
    torch.cuda.synchronize()
    out = {}
    for label, run in (
            ("push", lambda: se.push_group(names, mi, mg)),
            ("pull", lambda: se.pull_group(names, mi)),
            ("loop_push", lambda: [se.push(n, i, g)
                                   for n, i, g in zip(loops, mi, mg)]),
            ("loop_pull", lambda: [se.pull(n, i)
                                   for n, i in zip(loops, mi)])):
        b0, x0 = se.barriers, se.exchanges
        t0 = time.perf_counter()
        got = run()
        torch.cuda.synchronize()
        out[f"{label}_ms"] = (time.perf_counter() - t0) * 1e3
        out[f"{label}_barriers"] = se.barriers - b0
        out[f"{label}_exchanges"] = se.exchanges - x0
        if label == "pull":
            pulled = got
        if label == "loop_pull":
            looped = got
    return dict(out, tables=len(names), **_check(
        "sparse group",
        pull_differing=sum(int((g != w[mine]).sum())
                           for g, w in zip(pulled, want)),
        loop_differing=sum(int((g != w).sum())
                           for g, w in zip(pulled, looped)),
        store_differing=sum(
            int((se._stores[n] != local_of(n, ref_se._stores[n])).sum())
            for n in names)))


def node_mp(ps, spec) -> dict:
    """A worker of the ``ici_tcp``/``ici_shm`` legs (see the module
    docstring); raises on any differing element."""
    import torch
    from pslite_tpu_torch.environment import Environment
    from pslite_tpu_torch.models import embedding as emb
    from pslite_tpu_torch.ops import fused_update as fu
    from pslite_tpu_torch.ops import reduce_update as ru
    from pslite_tpu_torch.ops import ring_collective as ring
    from pslite_tpu_torch.ops import sparse_rows as sr
    from pslite_tpu_torch.parallel import distributed

    sync = torch.cuda.synchronize
    uncounted = _Uncounted(ring, fu, sr, ru)
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
    for m in (ring, fu, sr, ru):
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
        sidx = torch.from_numpy(emb.skewed_indices(65_536, N, 1024,
                                                   seed=2)).to(DEV)
        sg = torch.randn((N, 1024, 16), device=DEV, generator=gen)

        def local_of(name, full):
            rps_n = se.table(name).rows_per_shard
            lo = LOCAL * rank * rps_n
            return full[lo:lo + LOCAL * rps_n]

        report["sparse_group"] = sparse_group_leg(
            torch, se, ref_se, [idx, sidx], [g, sg], mine, uncounted,
            local_of)
    if spec.get("shapes"):
        held = _HeldPeers(torch, ring)
        with held:
            report["shapes"] = node_shapes(ps, torch, ring, uncounted,
                                           spec["shapes"], rank)
        report["held"] = held.differing
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
    report["launches"] = {k: v for m in (ring, fu, sr, ru)
                          for k, v in m.launches.items() if v}
    po.finalize()
    distributed.release()
    return report


def _alone(torch, ring, cs, eng, name: str, compress: bool) -> dict:
    """The new cross-process kernel of ``eng``'s bucket ``name`` (the dp
    sub-rings' reduce, or the int8 ring), timed alone as ``time_alone``
    times the 1-D pair, beside its plain version (one call: the int8
    plain ring walks every region's quantizer in float64)."""
    bucket, store = eng._buckets[name], eng._stores[name]
    layout, me = eng._layouts[name], eng.group.process_index
    padded, kv = bucket.padded_len, eng._kv_shards()
    scratch = store.clone()
    out = {"count": layout.local_len(me), "padded": padded,
           "ring_n": len(layout.rows_of(layout.pieces[me][0]))}
    if compress:
        pieces = [([eng._row_addr(name, r) for r in rows], *seg)
                  for rows, segs in layout.runs(me) for seg in segs]
        pulled = torch.empty_like(store) if kv is None else None
        shape = ring.int8_peer_launch_shape(pieces, padded, kv, device=DEV)
        out.update(cluster=shape["cluster"], groups=shape["groups"],
                   waves=shape["waves"])
        out["launch_shape"] = {k: shape[k] for k in
                               ("regions", "waves", "max_active_clusters")}
        # Every (cluster, groups) the card runs, each held against the
        # launcher's own shape (0 differing elements; that one against
        # the plain version below) and timed: the cost model's pick
        # beside the measured best.
        want = store.clone()
        wpl = torch.empty_like(store) if pulled is not None else None
        ring.ring_int8_peers(pieces, want, wpl, padded, "sum", kv_shards=kv)
        out["by_cluster_ms"], off = {}, 0
        for key in shape["cost"]:
            c, g = (int(x) for x in key.split("x"))
            got = store.clone()
            gpl = torch.empty_like(store) if pulled is not None else None
            ring.ring_int8_peers(pieces, got, gpl, padded, "sum",
                                 kv_shards=kv, cluster=(c, g))
            off += int((got != want).sum()) + (
                int((gpl != wpl).sum()) if gpl is not None else 0)
            out["by_cluster_ms"][key] = cs.graph_ms(
                lambda c=c, g=g: ring.ring_int8_peers(
                    pieces, scratch, pulled, padded, "sum", kv_shards=kv,
                    cluster=(c, g)), iters=5)
        if off:
            raise AssertionError(f"int8 peers: {off} elements differ between "
                                 f"launch shapes")

        def fn():
            ring.ring_int8_peers(pieces, scratch, pulled, padded, "sum",
                                 kv_shards=kv)
    else:
        runs = [([eng._row_addr(name, r) for r in rows], segs)
                for rows, segs in layout.runs(me)]
        pieces = [(addrs, a, n, o) for addrs, segs in runs
                  for a, n, o in segs]

        def fn():
            for addrs, segs in runs:
                ring.ring_reduce_peers(addrs, scratch, segs, padded, "sum",
                                       kv_shards=kv)
    out["ms"], out["ms_host"] = cs.kernel_times(fn)
    rows = {}
    plain = []
    for addrs, start, n, local in pieces:
        if tuple(addrs) not in rows:
            rows[tuple(addrs)] = torch.stack(
                [ring.device_view(a, (padded,), store.dtype, store.device)
                 for a in addrs])
        plain.append((rows[tuple(addrs)], start, n, local))
    pl = torch.empty_like(store) if compress and kv is None else None
    if compress:
        ref = store.clone()
        ring.ring_peers_reference(plain, ref, pl, padded, "sum",
                                  compress=True, kv_shards=kv)
        off = int((ref != want).sum()) + (
            int((pl != wpl).sum()) if pl is not None else 0)
        if off:
            raise AssertionError(f"int8 peers: {off} elements differ from "
                                 f"the plain version")
    out["plain_ms"] = cs.cuda_ms(lambda: ring.ring_peers_reference(
        plain, scratch, pl, padded, "sum", compress=compress, kv_shards=kv),
        iters=1, warmup=0)
    return out


def _check(label: str, **counts) -> dict:
    if any(counts.values()):
        raise AssertionError(f"{label}: differing elements {counts}")
    return counts


def node_shapes(ps, torch, ring, uncounted, spec, rank: int) -> dict:
    """The group shapes beyond the 1-D ring, in a worker of the main leg
    (module docstring); raises on any differing element."""
    import chip_smoke as cs
    from pslite_tpu_torch.models import embedding as emb
    from pslite_tpu_torch.parallel import distributed, placement

    sync = torch.cuda.synchronize
    keys = np.arange(KEYS, dtype=np.uint64) + 50_000
    out = {}

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        got = fn()
        sync()
        return got, (time.perf_counter() - t0) * 1e3

    def local(eng, name, full):
        return eng._layouts[name].local_of(full, eng.group.process_index)

    # (dp 4, kv 2): sum on the ring, adam, int8.
    g2 = distributed.global_group(("dp", "kv"), local_ranks=LOCAL,
                                  device=DEV, shape=(4, 2))
    eng = ps.CollectiveEngine(g2, worker_axis="dp", impl="ring")
    eng.register_dense("d2", keys, VAL_LEN)
    ref_store = torch.zeros(P, device=DEV)
    steps = []
    for k in range(spec["sum_steps"]):
        rows4 = _rows(torch, 400 + k, 4)
        with uncounted:
            ref = ring.ring_push_pull(rows4, ref_store, kv_shards=2)
        got, wall = timed(lambda: eng.push_pull("d2", rows4))
        steps.append(dict(wall_ms=wall,
                          max_abs_err=float((got - ref).abs().max()), **_check(
            f"2-D sum step {k}", differing=int((got != ref).sum()),
            store_differing=int((eng._stores["d2"] != local(
                eng, "d2", ref_store)).sum()))))
    out["d2_sum"] = steps
    adam_eng = ps.CollectiveEngine(g2, worker_axis="dp", impl="ring",
                                   server_handle=ADAM)
    ref_eng = ps.CollectiveEngine(ps.make_group((4, 2), ("dp", "kv"),
                                                device=DEV),
                                  worker_axis="dp", impl="ring",
                                  server_handle=ADAM)
    for e in (adam_eng, ref_eng):
        e.register_dense("a2", keys, VAL_LEN)
    adam = []
    for k in range(spec["adam_steps"]):
        rows4 = _rows(torch, 420 + k, 4)
        with uncounted:
            want = ref_eng.push_pull("a2", rows4)
        got, wall = timed(lambda: adam_eng.push_pull("a2", rows4))
        err = float((got - want).abs().max())
        adam.append({"wall_ms": wall, "differing": int((got != want).sum()),
                     "max_abs_err": err})
        if not torch.allclose(got, want, rtol=1e-6, atol=0.0):
            raise AssertionError(f"2-D adam step {k}: {adam[-1]}")
    out["d2_adam"] = adam
    i8 = ps.CollectiveEngine(g2, worker_axis="dp", impl="ring",
                             wire_compress="int8")
    i8.register_dense("c2", keys, VAL_LEN)
    ref8 = torch.zeros(P, device=DEV)
    steps = []
    for k in range(spec["int8_steps"]):
        rows4 = _rows(torch, 440 + k, 4)
        with uncounted:
            ref = ring.ring_push_pull(rows4, ref8, compress=True,
                                      kv_shards=2)
        got, wall = timed(lambda: i8.push_pull("c2", rows4))
        steps.append(dict(wall_ms=wall,
                          max_abs_err=float((got - ref).abs().max()), **_check(
            f"2-D int8 step {k}", differing=int((got != ref).sum()),
            store_differing=int((i8._stores["c2"] != local(
                i8, "c2", ref8)).sum()))))
    out["d2_int8"] = steps
    del rows4, ref, got
    for turn in range(len(g2.processes)):
        distributed.barrier()
        if turn == rank:
            with uncounted:
                out["alone_d2"] = _alone(torch, ring, cs, eng, "d2", False)
                out["alone_d2_int8"] = _alone(torch, ring, cs, i8, "c2", True)
    distributed.barrier()
    for e in (eng, adam_eng, i8):
        e.close()

    # (dp 2, kv1 2, kv2 2): with worker_axis (B = 4 dp sub-rings) and
    # without (the torch path on each rank's kv shard of its replica).
    g3 = distributed.global_group(("dp", "kv1", "kv2"), local_ranks=LOCAL,
                                  device=DEV, shape=(2, 2, 2))
    kv = ("kv1", "kv2")
    wa_eng = ps.CollectiveEngine(g3, axis_name=kv, worker_axis="dp",
                                 impl="ring")
    nd_eng = ps.CollectiveEngine(g3, axis_name=kv, impl="ring")
    ref_nd = ps.CollectiveEngine(ps.make_group((2, 2, 2), ("dp", "kv1",
                                                           "kv2"), device=DEV),
                                 axis_name=kv, impl="ring")
    for e in (wa_eng, nd_eng, ref_nd):
        e.register_dense("c3", keys, VAL_LEN)
    shard, _ = placement.shard_replicas(g3, kv)
    mine = [int(shard[r]) for r in g3.local_ranks]
    ref_wa = torch.zeros(P, device=DEV)
    comp = []
    for k in range(2):
        rows2 = _rows(torch, 460 + k, 2)
        rows4 = _rows(torch, 470 + k, 4)
        with uncounted:
            ref = ring.ring_push_pull(rows2, ref_wa, kv_shards=4)
            want = ref_nd.push_pull("c3", rows4)
        got, wall = timed(lambda: wa_eng.push_pull("c3", rows2))
        got_nd, wall_nd = timed(
            lambda: nd_eng.push_pull("c3", rows4[mine].contiguous()))
        comp.append(dict(wall_ms=wall, wall_nd_ms=wall_nd, **_check(
            f"composite step {k}", differing=int((got != ref).sum()),
            store_differing=int((wa_eng._stores["c3"] != local(
                wa_eng, "c3", ref_wa)).sum()),
            nd_differing=int((got_nd != want).sum()))))
    out["composite"] = comp
    for e in (wa_eng, nd_eng):
        e.close()

    # Config 5's table on (kv 4, dp 2): sharded over kv, replicated over dp.
    gs = distributed.global_group(("kv", "dp"), local_ranks=LOCAL,
                                  device=DEV, shape=(4, 2))
    se = ps.SparseEngine(gs, "kv")
    ref_se = ps.SparseEngine(ps.make_group((4, 2), ("kv", "dp"), device=DEV),
                             "kv")
    for e in (se, ref_se):
        e.register_sparse("emb_nd", ROWS, DIM)
    shard, _ = placement.shard_replicas(gs, ("kv",))
    mine = [int(shard[r]) for r in gs.local_ranks]
    sparse = []
    for k in range(2):
        idx = torch.from_numpy(emb.skewed_indices(ROWS, 4, BATCH,
                                                  seed=10 + k)).to(DEV)
        gen = torch.Generator(device=DEV).manual_seed(SEED + 20 + k)
        g = torch.randn((4, BATCH, DIM), device=DEV, generator=gen)
        with uncounted:
            ref_se.push("emb_nd", idx, g)
            want = ref_se.pull("emb_nd", idx)
        _, push_ms = timed(lambda: se.push("emb_nd", idx[mine].contiguous(),
                                           g[mine].contiguous()))
        got, pull_ms = timed(lambda: se.pull("emb_nd",
                                             idx[mine].contiguous()))
        table = se.table("emb_nd")
        sparse.append(dict(push_ms=push_ms, pull_ms=pull_ms, **_check(
            f"sparse N-D step {k}",
            pull_differing=int((got != want[mine]).sum()),
            store_differing=int((se._stores["emb_nd"] != se._local_of(
                table, ref_se._stores["emb_nd"])).sum()))))
    out["sparse_nd"] = sparse
    idx = torch.from_numpy(emb.skewed_indices(ROWS, 4, BATCH,
                                              seed=30)).to(DEV)
    sidx = torch.from_numpy(emb.skewed_indices(65_536, 4, 1024,
                                               seed=31)).to(DEV)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 32)
    grads = [torch.randn((4, BATCH, DIM), device=DEV, generator=gen),
             torch.randn((4, 1024, 16), device=DEV, generator=gen)]
    out["sparse_group_nd"] = sparse_group_leg(
        torch, se, ref_se, [idx, sidx], grads, mine, uncounted,
        lambda name, full: se._local_of(se.table(name), full))
    se.close()
    return out


def node_int8(ps, spec) -> dict:
    """A worker of the ``int8`` leg: the bucket through ``KVWorker``
    under ``PS_ICI_COMPRESS=int8``; raises on any differing element."""
    import torch
    import chip_smoke as cs
    from pslite_tpu_torch.environment import Environment
    from pslite_tpu_torch.ops import ring_collective as ring
    from pslite_tpu_torch.parallel import distributed

    sync = torch.cuda.synchronize
    uncounted = _Uncounted(ring)
    keys = np.arange(KEYS, dtype=np.uint64)
    rank = int(os.environ["DMLC_RANK"])
    env = Environment({})
    assert distributed.acquire(env)
    group = distributed.global_group(local_ranks=LOCAL, device=DEV)
    po = ps.Postoffice("worker", env=env)
    po.van.set_mesh(group)
    po.start()
    kv = ps.KVWorker(0, 0, postoffice=po)
    eng = kv.engine
    assert eng.wire_compress == "int8", eng.wire_compress
    ring.reset_launches()
    mine = slice(LOCAL * rank, LOCAL * (rank + 1))
    kv.register_dense("grads", keys, VAL_LEN)
    ref_store = torch.zeros(P, device=DEV)
    outs = torch.zeros(P, device=DEV)
    held = _HeldPeers(torch, ring)
    steps, worst = [], 0.0
    with held:
        for k in range(spec["sum_steps"]):
            rows8 = _rows(torch, 500 + k, N)
            with uncounted:
                ref = ring.ring_push_pull(rows8, ref_store, compress=True)
            g = rows8[mine].contiguous()
            sync()
            t0 = time.perf_counter()
            kv.wait(kv.push_pull(keys, g, outs))
            wall = (time.perf_counter() - t0) * 1e3
            worst = max(worst, float((outs - ref).abs().max()))
            steps.append(dict(wall_ms=wall, **_check(
                f"int8 step {k}", differing=int((outs != ref).sum()),
                store_differing=int((eng._stores["grads"] != eng._layouts[
                    "grads"].local_of(ref_store, group.process_index)
                ).sum()))))
    report = {"steps": steps, "max_abs_err": worst, "rank": rank,
              "held": held.differing}
    del rows8, ref, g
    for turn in range(len(group.processes)):
        distributed.barrier()
        if turn == rank:
            with uncounted:
                report["alone"] = _alone(torch, ring, cs, eng, "grads", True)
    distributed.barrier()
    report["launches"] = {k: v for k, v in ring.launches.items() if v}
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


NEW_KERNELS = ("ring_reduce_peers_2d[float32]", "ring_int8_peers[float32]",
               "ring_int8_peers_2d[float32]")


def new_kernel_rows(main, int8, launches, smi) -> list:
    """The ``kernels`` rows of the variants this phase added: each
    process's launch alone, the slower of the two, with its bound (one
    launch's bytes: each of its ring's rows read once over its owned
    values, its store read and written, and the 1-D int8's pulled area
    written) and its plain version; no PyTorch call walks a ring."""
    b = 4
    rows = []
    shapes = [r["shapes"] for r in main]
    for name, key, reports, err in (
            ("ring_reduce_peers_2d[float32]", "alone_d2", shapes,
             max(x["max_abs_err"] for r in shapes for x in r["d2_sum"])),
            ("ring_int8_peers[float32]", "alone", int8,
             max(r["max_abs_err"] for r in int8)),
            ("ring_int8_peers_2d[float32]", "alone_d2_int8", shapes,
             max(x["max_abs_err"] for r in shapes for x in r["d2_int8"]))):
        alone = [r[key] for r in reports]
        a = max(alone, key=lambda x: x["ms"])
        pulled = 1 if name == "ring_int8_peers[float32]" else 0
        nbytes = (a["ring_n"] + 2 + pulled) * a["count"] * b
        src = ("ring_int8.cu" if "int8" in name else "ring_push_pull.cu")
        row = {"name": name, "route": "cuda",
               "source": f"pslite_tpu_torch/csrc/{src}",
               "replaces": "pslite_tpu/ops/ring_collective.py:445",
               "launches": launches.get(name, 0), "max_abs_err": err,
               "ms": a["ms"], "ms_host": a["ms_host"],
               "plain_ms": a["plain_ms"],
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes", "library_ms": None,
               "library_note": "no call walks a ring",
               "across": "2 processes x 4 ranks, IPC peers"}
        if "cluster" in a:
            row.update(cluster=a["cluster"], groups=a["groups"],
                       waves=a["waves"], by_cluster_ms=a["by_cluster_ms"])
        rows.append(row)
        print(f"kernel {name} (across 2 processes, IPC peers): alone "
              f"{row['ms']:.4f} ms host-free, {row['ms_host']:.4f} ms "
              f"host-inclusive (the slower process), bound "
              f"{row['bound_ms'] * 1e3:.1f} us ({nbytes / 1e6:.1f} MB: "
              f"{a['ring_n']} rows over {a['count']} owned values), share "
              f"{row['bound_ms'] / row['ms']:.2f}, plain "
              f"{row['plain_ms']:.3f} ms, launches {row['launches']}"
              + (f", cluster {a['cluster']} x groups {a['groups']}, "
                 f"waves {a['waves']} (regions, waves, clusters the card "
                 f"runs at once per size: {a['launch_shape']}; ms by "
                 f"cluster x groups {a['by_cluster_ms']})"
                 if "cluster" in a else "")
              + f" [{smi}]")
    return rows


def drive_multiprocess(smi: str, kernel_rows=None):
    """The phase (module docstring).  Returns ``(results, launches)``: the
    main-path result rows and the launches the worker processes counted;
    appends the cross-process K4's two kernel rows to ``kernel_rows``."""
    t_phase = time.perf_counter()
    mp_env = {"PS_ICI_MULTIHOST": "1", "PS_ICI_IMPL": "pallas"}
    (main,) = run_legs([Leg("ici_tcp", 2, 1, dict(
        leg="mp", sum_steps=5, adam_steps=2, sparse=True, reshard=True,
        alone=True, shapes=dict(sum_steps=5, adam_steps=2, int8_steps=2)),
        extra=mp_env, ranks=True)])
    (int8,) = run_legs([Leg("ici_tcp", 2, 1, dict(leg="int8", sum_steps=5),
                            extra=dict(mp_env, PS_ICI_COMPRESS="int8"),
                            ranks=True)])
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
    for rep in main + int8 + shm + dcn:
        _add(launches, rep["launches"])
    held: dict = {}
    for rep in main + int8:
        _add(held, rep["held"])
    # D2 across processes: the adam steps of the main leg (2 on the 1-D
    # group, 2 on the (dp 4, kv 2) group), one launch per process each.
    for name in ("ring_reduce_peers[float32]", "ring_gather_peers[float32]",
                 "reduce_adam[float32]") + NEW_KERNELS:
        if not launches.get(name):
            raise AssertionError(f"{name} never launched on the "
                                 f"multiprocess path")
    for name in NEW_KERNELS:
        if name not in held or held[name]:
            raise AssertionError(f"{name}'s first launch was not held "
                                 f"against its plain version: {held}")
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
    for r in main:
        sh = r["shapes"]
        print(f"    worker {r['rank']} shapes: (dp 4, kv 2) sum wall "
              + ", ".join(f"{x['wall_ms']:.3f}" for x in sh["d2_sum"])
              + " ms, adam "
              + ", ".join(f"{x['wall_ms']:.3f}" for x in sh["d2_adam"])
              + f" ms (max |err| "
              f"{max(x['max_abs_err'] for x in sh['d2_adam']):.3g} against "
              f"the single-process engine), int8 "
              + ", ".join(f"{x['wall_ms']:.3f}" for x in sh["d2_int8"])
              + " ms; (dp 2, kv1 2, kv2 2) with worker_axis "
              + ", ".join(f"{x['wall_ms']:.3f}" for x in sh["composite"])
              + " ms, without "
              + ", ".join(f"{x['wall_nd_ms']:.3f}" for x in sh["composite"])
              + f" ms; sparse {ROWS} x {DIM} on (kv 4, dp 2) push/pull "
              + ", ".join(f"{x['push_ms']:.3f}/{x['pull_ms']:.3f}"
                          for x in sh["sparse_nd"])
              + " ms; 0 differing elements against the single-process "
              f"port in every step; first launches held: {r['held']}")
    for r in main:
        for label, sg in (("1-D kv", r["sparse_group"]),
                          ("(kv 4, dp 2)", r["shapes"]["sparse_group_nd"])):
            print(f"    worker {r['rank']} sparse push_group/pull_group of "
                  f"{sg['tables']} tables on {label}: push "
                  f"{sg['push_ms']:.3f} ms wall, {sg['push_barriers']} host "
                  f"barriers ({sg['push_exchanges']} exchange); pull "
                  f"{sg['pull_ms']:.3f} ms, {sg['pull_barriers']} barriers "
                  f"({sg['pull_exchanges']} exchanges); the tables one by "
                  f"one: push {sg['loop_push_ms']:.3f} ms, "
                  f"{sg['loop_push_barriers']} barriers, pull "
                  f"{sg['loop_pull_ms']:.3f} ms, {sg['loop_pull_barriers']} "
                  f"barriers; 0 differing elements against the "
                  f"single-process group and the one-by-one ops [{smi}]")
            k = sg["tables"]
            want = (2, 1, 4, 2, 2 * k, 4 * k)
            got = tuple(sg[x] for x in (
                "push_barriers", "push_exchanges", "pull_barriers",
                "pull_exchanges", "loop_push_barriers", "loop_pull_barriers"))
            if got != want:
                raise AssertionError(f"sparse group barriers/exchanges "
                                     f"{got}, expected {want}")
    print(f"multiprocess int8: KVWorker.push_pull under PS_ICI_COMPRESS=int8"
          f", {len(int8[0]['steps'])} sum steps, 0 differing elements "
          f"against the single-process pstt_ring_int8 on the 8 rows; wall "
          f"ms " + "; ".join(", ".join(f"{s['wall_ms']:.3f}"
                                       for s in r["steps"]) for r in int8)
          + f"; first launch held: {int8[0]['held']}; launches "
          f"{int8[0]['launches']} [{smi}]")
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
    for part, entry in (("reduce", "pstt_ring_reduce_peers_segs"),
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
    rows.extend(new_kernel_rows(main, int8, launches, smi))
    op_ms = sum(r["span_ms"] for r in rows[:2])
    op_bound = sum(r["op_bound_ms"] for r in rows[:2])
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
    differing += sum(v for r in main for leg in (r["sparse_group"],)
                     for k, v in leg.items() if k.endswith("differing"))
    shape_diff = sum(v for r in main for leg in r["shapes"].values()
                     if isinstance(leg, list) for x in leg
                     for k, v in x.items() if k.endswith("differing"))
    shape_diff += sum(v for r in main
                      for k, v in r["shapes"]["sparse_group_nd"].items()
                      if k.endswith("differing"))
    shape_diff += sum(s["differing"] + s["store_differing"]
                      for r in int8 for s in r["steps"])
    results = [{"config": "multiprocess ici_tcp 2 x 4 ranks",
                "ops": steps + 2 + 2 + 1, "differing_elements": differing,
                "phase_s": t_phase},
               {"config": "multiprocess group shapes 2 x 4 ranks (2-D, "
                          "composite, N-D sparse, int8)",
                "ops": 5 + 2 + 2 + 2 + 2 + 2 * 2 + 5,
                "differing_elements": shape_diff,
                "adam_max_abs_err": max(x["max_abs_err"] for r in main
                                        for x in r["shapes"]["d2_adam"]),
                "int8_max_abs_err_vs_exact": max(r["max_abs_err"]
                                                 for r in int8)},
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
