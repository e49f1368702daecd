"""KV benchmark CLI — the reference's workhorse benchmark re-created.

(The port's copy of ``pslite_tpu/benchmark.py``: host code over the
port's message plane, with the port's launcher in every subprocess
command.  No bench here touches the card.)

Parity with ``tests/test_benchmark.cc``: modes PUSH_THEN_PULL / PUSH_PULL /
PUSH_ONLY / PULL_ONLY (:25-30), ``len repeat mode`` arguments, NUM_KEY_PER_SERVER
keys per server (:407-414), goodput printed every LOG_DURATION rounds with
the same metric definitions (:388-396):

    goodput_gbps = 8 * len * total_key_num * iters / elapsed_ns
    latency_ns_per_key = elapsed / iters / total_key_num / 1000

The server uses an assign-and-echo handle (the reference's EmptyHandler
allocates per-key buffers on first push and echoes them on pull,
:131-203), with val/len consistency checks baked in.  Runs over any van;
launch e.g.::

    python -m pslite_tpu_torch.tracker.local -n 1 -s 1 --van shm -- \
        python -m pslite_tpu_torch.benchmark --len 1024000 --repeat 10 --mode push_pull
"""

from __future__ import annotations

import argparse
import os
import statistics
import time
from typing import Optional

import numpy as np

MODES = ("push_then_pull", "push_pull", "push_only", "pull_only",
         "chunk_hol", "lane_goodput", "quantized_push", "multi_tenant",
         "dlrm_serve", "small_op_storm", "serving_fanin",
         "durable_serve", "replica_read")


def _recv_buffer_mode() -> bool:
    """ENABLE_RECV_BUFFER (reference test_benchmark.cc:268-320)."""
    return bool(int(os.environ.get("ENABLE_RECV_BUFFER", "0")))


class BenchmarkHandle:
    """Assign on push (allocating on first touch), echo on pull.

    Pushes are stored as whole slice blocks (one copy), with the per-key
    store holding views into the block; pulls of the same slice echo the
    block with no per-pull allocation — matching the reference
    EmptyHandler's preallocated per-key buffers (test_benchmark.cc:131-203)
    so the benchmark times the transport, not handler concatenation.
    (The one copy is load-bearing: a loopback van delivers views of the
    sender's own array, so adopting ``data.vals`` zero-copy would alias
    a buffer the worker may mutate between pushes.)"""

    def __init__(self):
        self.store = {}
        self._blocks = {}
        self._gen = 0  # any push invalidates blocks cached before it

    def __call__(self, meta, data, server):
        from .kv.kv_app import KVPairs
        from .utils import logging as log

        sig = (
            (len(data.keys), int(data.keys[0])) if len(data.keys) else None
        )
        if meta.push:
            n = len(data.keys)
            log.check(n > 0 and len(data.vals) % n == 0,
                      "inconsistent val/len in push")
            block = np.array(data.vals)
            self._gen += 1
            self._blocks[sig] = (np.array(data.keys), block, self._gen)
            k = len(block) // n
            for i, key in enumerate(data.keys):
                self.store[int(key)] = block[i * k : (i + 1) * k]
        # A fused push+pull request (ZPushPull) must get vals back, or
        # the push_pull mode would time half the traffic it reports.
        if meta.pull:
            cached = self._blocks.get(sig)
            if (
                cached is not None
                and cached[2] == self._gen  # no overlapping push since
                and np.array_equal(cached[0], data.keys)
            ):
                block = cached[1]
            else:  # different key set / stale block: assemble from store
                block = np.concatenate(
                    [self.store[int(key)] for key in data.keys]
                )
            server.response(meta, KVPairs(keys=data.keys, vals=block))
        else:
            server.response(meta)


def run_chunk_hol(worker, args) -> None:
    """``--mode chunk_hol`` (docs/chunking.md): sequential large pushes
    from a background thread while the main thread samples small-pull
    latency against the same server — the pull request shares the
    per-peer lane (and socket) with the push payload, so its latency IS
    the head-of-line wait.  Run once with ``PS_CHUNK_BYTES`` set and
    once with ``0`` to price the chunking win; one process per node, so
    no shared-GIL convoy pollutes the numbers."""
    import threading

    nk = args.num_keys
    val_len = args.len // 4
    big_keys = np.arange(100, 100 + nk, dtype=np.uint64)
    big_vals = np.ones(nk * val_len, np.float32)
    small_key = np.array([7], dtype=np.uint64)
    small_vals = np.ones(256, np.float32)
    small_out = np.zeros_like(small_vals)
    worker.wait(worker.push(big_keys, big_vals))
    worker.wait(worker.push(small_key, small_vals))
    worker.wait(worker.pull(small_key, small_out, priority=1))
    push_wall = [0.0]

    def pusher():
        t0 = time.perf_counter()
        for _ in range(args.repeat):
            worker.wait(worker.push(big_keys, big_vals, priority=0))
        push_wall[0] = time.perf_counter() - t0

    t = threading.Thread(target=pusher, daemon=True)
    lats = []
    t.start()
    while t.is_alive():
        t0 = time.perf_counter()
        worker.wait(worker.pull(small_key, small_out, priority=1))
        lats.append((time.perf_counter() - t0) * 1e3)
    t.join()
    lats.sort()
    gbps = (8.0 * args.repeat * big_vals.nbytes
            / max(push_wall[0], 1e-9) / 1e9)
    p50 = lats[len(lats) // 2] if lats else 0.0
    p99 = lats[min(len(lats) - 1, int(len(lats) * 0.99))] if lats else 0.0
    print(
        f"CHUNK_HOL samples={len(lats)} pull_p50_ms={p50:.3f} "
        f"pull_p99_ms={p99:.3f} push_gbps={gbps:.3f}",
        flush=True,
    )


def run_lane_goodput(worker, args, tag: str = "LANE_GOODPUT",
                     codec: Optional[str] = None) -> None:
    """``--mode lane_goodput`` (docs/native_core.md): PIPELINED large
    pushes — up to ``PS_BENCH_PIPELINE`` (default 3) outstanding — so
    the wall clock measures the data plane's sustained single-lane
    throughput instead of the per-push wait chain (wire + apply + RTT)
    that ``chunk_hol``'s sequential pushes serialize on.  A foreground
    thread samples small-pull latency concurrently, so the same run
    prices the priority tail under the bulk storm.

    ``codec`` (the ``quantized_push`` mode, docs/compression.md) runs
    the same storm with the pushes codec-encoded; the printed
    ``push_gbps`` stays defined over the RAW payload bytes, so it IS
    the effective goodput (pre-compression bytes delivered per
    second)."""
    import threading

    nk = args.num_keys
    val_len = args.len // 4
    big_keys = np.arange(100, 100 + nk, dtype=np.uint64)
    # Realistic gradient-like payload: constant vals would quantize
    # losslessly and flatter the codec legs.
    big_vals = np.random.default_rng(11).normal(
        size=nk * val_len
    ).astype(np.float32)
    small_key = np.array([7], dtype=np.uint64)
    small_vals = np.ones(256, np.float32)
    small_out = np.zeros_like(small_vals)
    # Warm the path end to end before timing: codec legs additionally
    # need the codec buffer pools (worker codes / server decode
    # buffers) and the core's span threads populated — the first cold
    # encodes/decodes pay page faults worth tens of ms that would
    # otherwise read as steady-state tail (seen as 26-31 ms first
    # decodes in the trace tier vs 2-3 ms warm).
    for _ in range(4 if codec else 1):
        worker.wait(worker.push(big_keys, big_vals, codec=codec))
    worker.wait(worker.push(small_key, small_vals))
    worker.wait(worker.pull(small_key, small_out, priority=1))
    depth = int(os.environ.get("PS_BENCH_PIPELINE", "3"))
    push_wall = [0.0]

    def pusher():
        t0 = time.perf_counter()
        pending = []
        for _ in range(args.repeat):
            pending.append(worker.push(big_keys, big_vals, priority=0,
                                       codec=codec))
            if len(pending) >= depth:
                worker.wait(pending.pop(0))
        for ts in pending:
            worker.wait(ts)
        push_wall[0] = time.perf_counter() - t0

    t = threading.Thread(target=pusher, daemon=True)
    lats = []
    t.start()
    while t.is_alive():
        t0 = time.perf_counter()
        worker.wait(worker.pull(small_key, small_out, priority=1))
        lats.append((time.perf_counter() - t0) * 1e3)
    t.join()
    lats.sort()
    gbps = (8.0 * args.repeat * big_vals.nbytes
            / max(push_wall[0], 1e-9) / 1e9)
    p50 = lats[len(lats) // 2] if lats else 0.0
    p99 = lats[min(len(lats) - 1, int(len(lats) * 0.99))] if lats else 0.0
    print(
        f"{tag} samples={len(lats)} pull_p50_ms={p50:.3f} "
        f"pull_p99_ms={p99:.3f} push_gbps={gbps:.3f}",
        flush=True,
    )


def run_quantized_push(worker, args) -> None:
    """``--mode quantized_push`` (docs/compression.md): the
    ``lane_goodput`` storm with the bulk pushes encoded by the codec
    named in ``PS_BENCH_CODEC`` (empty = uncompressed baseline leg).
    Effective goodput keeps the raw-bytes definition, so the
    compressed/uncompressed ratio is the codec tier's end-to-end win."""
    codec = os.environ.get("PS_BENCH_CODEC", "").strip() or None
    run_lane_goodput(worker, args, tag="QUANTIZED_PUSH", codec=codec)


def _pctl_ms(lats_s: list) -> tuple:
    """(p50, p99) of a latency list, in milliseconds."""
    if not lats_s:
        return 0.0, 0.0
    s = sorted(lats_s)
    return (s[len(s) // 2] * 1e3,
            s[min(len(s) - 1, int(len(s) * 0.99))] * 1e3)


def run_multi_tenant(worker, args) -> None:
    """``--mode multi_tenant`` (docs/qos.md): a serving tenant and a
    bulk tenant sharing one real tcp server.  Worker rank 0 is the
    SERVING tenant: it publishes a small table and samples small-pull
    latency (tenant ``serve``, plain priority — the weighted-fair
    lanes, intake, and apply shards are what protect it).  Worker
    rank 1 is the BULK tenant: it offers multi-MiB pushes at ~10x the
    server's capacity (a deep non-waiting pipeline, tenant ``train``),
    counts OPT_OVERLOAD sheds (retryable fast-fails, never hangs), and
    verifies its applied pushes landed bit-exact.  ``PS_MT_BULK=0``
    turns rank 1 into an idle bystander — the uncontended baseline leg
    over the identical cluster shape."""
    import threading  # noqa: F401  (parity with sibling modes)

    from . import postoffice
    from .kv.kv_app import OverloadError
    from .message import Role

    po = postoffice(Role.WORKER)
    rank = po.my_rank()
    serve_s = float(os.environ.get("PS_MT_SERVE_SECONDS", "4"))
    if rank == 0:
        # Serving tenant: small table, steady small pulls.
        keys = np.arange(8, dtype=np.uint64)
        vals = np.ones(8 * 256, np.float32) * 3.0
        worker.wait(worker.push(keys, vals, tenant="serve"))
        one = np.array([3], dtype=np.uint64)
        out = np.zeros(256, np.float32)
        # Serving ops ride the EXPRESS band (priority 1) AND the serve
        # tenant: express keeps each interactive pull ahead of bulk
        # quanta in every queue, while the tenant label carries the
        # weighted share, per-tenant telemetry, and admission quota
        # (docs/qos.md — priority and tenancy compose, they don't
        # compete).
        t_end = time.perf_counter() + 0.5
        while time.perf_counter() < t_end:  # warm the path
            worker.wait(worker.pull(one, out, tenant="serve",
                                    priority=1))
        lats = []
        t_end = time.perf_counter() + serve_s
        while time.perf_counter() < t_end:
            t0 = time.perf_counter()
            worker.wait(worker.pull(one, out, tenant="serve",
                                    priority=1))
            lats.append(time.perf_counter() - t0)
        from .utils import logging as log

        log.check(np.all(out == 3.0), "serving pull returned bad values")
        p50, p99 = _pctl_ms(lats)
        print(f"MULTI_TENANT role=serve samples={len(lats)} "
              f"pull_p50_ms={p50:.3f} pull_p99_ms={p99:.3f}",
              flush=True)
        return
    # Bulk tenant (rank 1).
    if not int(os.environ.get("PS_MT_BULK", "1")):
        time.sleep(serve_s + 1.0)  # idle bystander: baseline leg
        print("MULTI_TENANT role=bulk applied=0 shed=0 "
              "push_gbps=0.000 store_exact=True", flush=True)
        return
    nk = 8
    val_len = int(os.environ.get("PS_MT_BULK_MB", "4")) * (1 << 20) // 4 // nk
    bulk_keys = np.arange(1000, 1000 + nk, dtype=np.uint64)
    bulk_vals = np.ones(nk * val_len, np.float32)
    depth = int(os.environ.get("PS_MT_DEPTH", "12"))
    applied = shed = 0
    pending: list = []

    def _settle(ts) -> None:
        nonlocal applied, shed
        try:
            worker.wait(ts)
            applied += 1
        except OverloadError:
            shed += 1

    t0 = time.perf_counter()
    t_end = t0 + serve_s + 1.5
    while time.perf_counter() < t_end:
        pending.append(worker.push(bulk_keys, bulk_vals,
                                   tenant="train"))
        if len(pending) >= depth:
            _settle(pending.pop(0))
    for ts in pending:
        _settle(ts)
    wall = time.perf_counter() - t0
    gbps = 8.0 * applied * bulk_vals.nbytes / max(wall, 1e-9) / 1e9
    # Bit-exact accounting: the += store must hold EXACTLY one unit per
    # non-shed push — a shed that half-applied, or a hung wait, shows
    # up right here.
    out = np.zeros_like(bulk_vals)
    worker.wait(worker.pull(bulk_keys, out, tenant="train"))
    exact = bool(np.all(out == np.float32(applied)))
    print(f"MULTI_TENANT role=bulk applied={applied} shed={shed} "
          f"push_gbps={gbps:.3f} store_exact={exact}", flush=True)


def run_dlrm_serve(worker, args) -> None:
    """``--mode dlrm_serve`` (docs/qos.md): the DLRM inference path
    over the message-path PS — a Zipf single-row embedding pull storm
    (models/dlrm.py), bit-exactness spot-checked every 64 pulls.  With
    ``PS_HOT_CACHE=1`` the head of the curve answers locally; the
    printed hit rate comes from the worker's cache counters."""
    from .models.dlrm import (DLRMConfig, push_embedding_table,
                              serve_embedding_storm)

    cfg = DLRMConfig(
        num_rows=int(os.environ.get("PS_DLRM_ROWS", "1024")),
        emb_dim=int(os.environ.get("PS_DLRM_DIM", "16")),
    )
    n_pulls = args.repeat
    push_embedding_table(worker, cfg, tenant="serve")
    if worker.hot_cache is not None:
        # Honest top-k seeding: a short UNMEASURED warm storm teaches
        # the server's kv.hot_keys tracker the real Zipf head (the
        # table push alone charges its first key with the whole bulk
        # weight), THEN the fetched top-k restricts admission and the
        # cache is cleared — the measured storm prices exactly the
        # seeded-from-the-server configuration the tier advertises.
        serve_embedding_storm(worker, cfg, min(200, n_pulls), seed=3,
                              tenant="serve")
        worker.seed_hot_cache(k=64)
        worker.hot_cache.clear()
        worker.po.metrics.counter("kv.hot_cache.hits").reset()
        worker.po.metrics.counter("kv.hot_cache.misses").reset()
    lats = serve_embedding_storm(worker, cfg, n_pulls, seed=7,
                                 tenant="serve")
    hits = worker.po.metrics.counter("kv.hot_cache.hits").value
    misses = worker.po.metrics.counter("kv.hot_cache.misses").value
    rate = hits / max(hits + misses, 1)
    p50, p99 = _pctl_ms(lats)
    print(f"DLRM_SERVE samples={len(lats)} pull_p50_ms={p50:.4f} "
          f"pull_p99_ms={p99:.4f} hit_rate={rate:.3f} exact=True",
          flush=True)


def run_durable_serve(worker, args) -> None:
    """``--mode durable_serve`` (docs/durability.md): the beyond-RAM
    serving path — publish an embedding table (``PS_DUR_ROWS`` x
    ``PS_DUR_DIM`` floats; the bench sizes it ~4x the server's
    ``PS_STORE_RAM_MB``), run an UNMEASURED Zipf warm storm so the
    server's ``kv.hot_keys`` top-k learns the real head and the tiered
    store promotes it, then measure the Zipf single-row pull storm.
    Every 64th pull is verified bit-exact inside
    ``serve_embedding_storm`` — a tier serving stale bytes fails the
    mode loudly.  The two bench legs run this identical mode with
    ``PS_STORE_RAM_MB`` set vs 0 (all-RAM)."""
    from .models.dlrm import (DLRMConfig, push_embedding_table,
                              serve_embedding_storm)

    cfg = DLRMConfig(
        num_rows=int(os.environ.get("PS_DUR_ROWS", "1024")),
        emb_dim=int(os.environ.get("PS_DUR_DIM", "1024")),
    )
    n_pulls = args.repeat
    push_embedding_table(worker, cfg)
    # Honest placement: the warm storm teaches kv.hot_keys the Zipf
    # head (the bulk table push alone charges its first key with the
    # whole weight) and lets the tier settle hot-in-RAM/cold-on-disk
    # BEFORE the measured window.
    serve_embedding_storm(worker, cfg, min(300, n_pulls), seed=3)
    lats = serve_embedding_storm(worker, cfg, n_pulls, seed=7)
    p50, p99 = _pctl_ms(lats)
    print(f"DURABLE_SERVE samples={len(lats)} pull_p50_ms={p50:.4f} "
          f"pull_p99_ms={p99:.4f} exact=True", flush=True)


def run_small_op_storm(worker, args) -> None:
    """``--mode small_op_storm`` (docs/batching.md): the ops/s regime —
    a depth-bounded pipeline of 4 KiB pushes against one tcp server
    (msgs/s is the headline), then a LOW-LOAD sequential push+wait loop
    (single-op p50 must stay within noise of an unbatched build).  The
    two legs of the bench run this identical mode with
    ``PS_BATCH_BYTES=65536`` vs ``0``; the store is verified bit-exact
    at applied-count (vals of 1.0 — exact float adds) either way."""
    secs = float(os.environ.get("PS_SOB_SECONDS", "3"))
    depth = int(os.environ.get("PS_SOB_DEPTH", "256"))
    op_bytes = int(os.environ.get("PS_SOB_OP_BYTES", "4096"))
    nk = int(os.environ.get("PS_SOB_KEYS", "1"))
    val_len = max(1, op_bytes // 4 // nk)
    keys = np.arange(nk, dtype=np.uint64)
    # Each op pushes its own ORDINAL as the payload: the benchmark
    # server's assign handle keeps the LAST applied value, so the
    # final pull proves both value bit-exactness and per-key apply
    # order through whatever batching the wire did.  Buffers cycle
    # through a pool deeper than the pipeline (queued frames hold
    # references — don't-mutate-until-wait), so the issue loop prices
    # the transport, not the allocator.
    seq = 0
    pool = [np.empty(nk * val_len, np.float32) for _ in range(depth + 64)]

    def _op_vals(v: float) -> np.ndarray:
        buf = pool[int(v) % len(pool)]
        buf.fill(np.float32(v))
        return buf

    # Warm the path (connection, capability probe, pools).
    for _ in range(32):
        seq += 1
        worker.wait(worker.push(keys, _op_vals(seq)))
    pending: list = []
    n_ops = 0
    t0 = time.perf_counter()
    t_end = t0 + secs
    while time.perf_counter() < t_end:
        seq += 1
        pending.append(worker.push(keys, _op_vals(seq)))
        n_ops += 1
        if len(pending) >= depth:
            worker.wait(pending.pop(0))
    for ts in pending:
        worker.wait(ts)
    wall = time.perf_counter() - t0
    rate = n_ops / max(wall, 1e-9)
    # Low-load single-op latency: sequential push+wait — with the
    # combiner idle, each op must dispatch at the next pickup with no
    # timer latency (the PS_BATCH_WINDOW_US=0 contract).
    lats = []
    t_end = time.perf_counter() + min(1.0, secs / 2)
    while time.perf_counter() < t_end:
        seq += 1
        v = _op_vals(seq)
        t1 = time.perf_counter()
        worker.wait(worker.push(keys, v))
        lats.append(time.perf_counter() - t1)
    p50, p99 = _pctl_ms(lats)
    out = np.zeros(nk * val_len, np.float32)
    worker.wait(worker.pull(keys, out))
    exact = bool(np.all(out == np.float32(seq)))
    frames = worker.po.metrics.counter("van.batched_frames").value
    bops = worker.po.metrics.counter("van.batch_ops").value
    opf = bops / frames if frames else 0.0
    print(f"SMALL_OP ops={n_ops} secs={wall:.3f} msgs_per_s={rate:.1f} "
          f"p50_ms={p50:.3f} p99_ms={p99:.3f} ops_per_frame={opf:.1f} "
          f"store_exact={exact}", flush=True)


def run_serving_fanin(worker, args) -> None:
    """``--mode serving_fanin`` (docs/batching.md): the DLRM serving
    FAN-OUT regime — each request is ``PS_SF_FANOUT`` independent
    single-row embedding lookups (Zipf rows, table SPREAD across every
    server), issued via ``KVWorker.multi_get`` with the hot-key cache
    COLD.  The two bench legs run this identical mode with
    ``PS_BATCH_BYTES=262144`` vs ``0``: aggregated, a request costs
    ~one EXT_BATCH frame per contacted server each way; unaggregated
    it costs one frame per LOOKUP each way.  Requests/s is the
    headline; frames/request (from the van's recv counter) proves the
    ~1-RTT fan-in; every 32nd request is verified bit-exact; a LOW-
    LOAD sequential single-pull loop guards the unbatched-latency
    contract."""
    from .models.dlrm import (DLRMConfig, embedding_row,
                              push_embedding_table, serve_fanout_storm,
                              spread_row_keys)

    secs = float(os.environ.get("PS_SF_SECONDS", "3"))
    fanout = int(os.environ.get("PS_SF_FANOUT", "64"))
    cfg = DLRMConfig(
        num_rows=int(os.environ.get("PS_SF_ROWS", "2048")),
        emb_dim=int(os.environ.get("PS_SF_DIM", "16")),
    )
    depth = int(os.environ.get("PS_SF_DEPTH", "8"))
    servers = worker.po.num_servers
    push_embedding_table(worker, cfg, spread=True)
    # Warm the path (connections, capability probes, frame pools).
    serve_fanout_storm(worker, cfg, 16, fanout=fanout, seed=1)
    van_recv = worker.po.metrics.counter("van.recv_messages")
    recv0 = van_recv.value
    # Depth-bounded request pipeline (a serving worker handles DEPTH
    # concurrent requests, like small_op_storm's op pipeline): each
    # outstanding request owns its row set and destination buffers;
    # the oldest is waited (and every 32nd verified bit-exact against
    # embedding_row) before its slot recycles.
    from collections import deque

    from .models.dlrm import serving_keys

    row_keys = spread_row_keys(cfg)
    outs_pool = [
        [np.zeros(cfg.emb_dim, np.float32) for _ in range(fanout)]
        for _ in range(depth)
    ]
    # Bounded row pool, reused modulo: sized well past one request's
    # correlation horizon but independent of how many requests the
    # window issues (an eager per-request pool both ballooned memory
    # at large fan-outs and crashed on exhaustion).
    pool_reqs = 4096
    all_rows = serving_keys(cfg, pool_reqs * fanout, seed=7)
    lats = []
    pending: deque = deque()
    free = list(range(depth))
    n_req = 0

    def _retire(check: bool) -> None:
        t_iss, handle, rows, slot = pending.popleft()
        handle.wait()
        lats.append(time.perf_counter() - t_iss)
        if check:
            outs = outs_pool[slot]
            for j, r in enumerate(rows):
                if not np.array_equal(outs[j],
                                      embedding_row(cfg, int(r))):
                    raise RuntimeError(
                        f"fan-out pull of row {r} returned wrong values"
                    )
        free.append(slot)

    t0 = time.perf_counter()
    t_end = t0 + secs
    while time.perf_counter() < t_end:
        base = (n_req % pool_reqs) * fanout
        rows = all_rows[base:base + fanout]
        slot = free.pop()
        key_lists = [row_keys[int(r):int(r) + 1] for r in rows]
        t1 = time.perf_counter()
        handle = worker.multi_get(key_lists, outs=outs_pool[slot])
        pending.append((t1, handle, rows, slot))
        n_req += 1
        if len(pending) >= depth:
            _retire(check=n_req % 32 == 0)
    while pending:
        _retire(check=False)
    wall = time.perf_counter() - t0
    frames_per_req = (van_recv.value - recv0) / max(n_req, 1)
    p50, p99 = _pctl_ms(lats)
    # Low-load single-pull guard: sequential pull+wait of Zipf rows —
    # a lone op must dispatch at the next combiner pickup with no
    # timer latency (the PS_BATCH_WINDOW_US=0 contract).
    row_keys = spread_row_keys(cfg)
    out = np.zeros(cfg.emb_dim, np.float32)
    low = []
    t_end = time.perf_counter() + min(1.0, secs / 2)
    row = 0
    while time.perf_counter() < t_end:
        row = (row + 17) % cfg.num_rows
        t1 = time.perf_counter()
        worker.wait(worker.pull(row_keys[row:row + 1], out))
        low.append(time.perf_counter() - t1)
    low_p50, _ = _pctl_ms(low)
    exact = bool(np.array_equal(out, embedding_row(cfg, row)))
    print(f"SERVING_FANIN reqs={n_req} secs={wall:.3f} "
          f"reqs_per_s={n_req / max(wall, 1e-9):.1f} "
          f"fanout={fanout} servers={servers} "
          f"p50_ms={p50:.3f} p99_ms={p99:.3f} "
          f"frames_per_req={frames_per_req:.2f} "
          f"low_p50_ms={low_p50:.4f} store_exact={exact}", flush=True)


def run_replica_read(worker, args) -> None:
    """``--mode replica_read`` (docs/serving_reads.md): the read-heavy
    serving regime — every worker aims a Zipf block storm entirely at
    server rank 0's key range, so with ``PS_REPLICA_READS`` on the
    pulls spread across that range's whole replica chain while k=1
    funnels every read through one rank.  Periodic read-your-writes
    probes (push a delta to a per-worker probe block, then IMMEDIATELY
    pull it back) count violations — the bench's correctness gate —
    and every 32nd storm pull is verified bit-exact against the
    worker-held table."""
    from collections import deque

    from .base import WORKER_GROUP

    secs = float(os.environ.get("PS_RR_SECONDS", "3"))
    rows = int(os.environ.get("PS_RR_ROWS", "2048"))
    dim = int(os.environ.get("PS_RR_DIM", "16"))
    batch = int(os.environ.get("PS_RR_BATCH", "16"))
    depth = int(os.environ.get("PS_RR_DEPTH", "8"))
    k = worker.po.env.find_int("PS_KV_REPLICATION", 1)
    servers = worker.po.num_servers
    n_w = max(worker.po.num_workers, 1)
    wrank = worker.po.my_group_rank()
    keys = np.arange(rows, dtype=np.uint64)  # all in rank 0's range
    table = np.stack([np.full(dim, 1.0 + r, np.float32)
                      for r in range(rows)])
    # The default handle's push ADDS: every worker pushes the base
    # table, so the served value is n_w * table (integer-valued fp32,
    # bit-exact).
    worker.wait(worker.push(keys, table.reshape(-1)))
    worker.po.barrier(0, WORKER_GROUP)
    expected = table * n_w
    # Cross-worker settle: a replica may not have applied the OTHER
    # workers' base pushes yet (this worker's stamp floor only covers
    # its own writes), so wait for the storm rows to read complete
    # everywhere before the bit-exact checks arm.
    warm = np.zeros(batch * dim, np.float32)
    deadline = time.perf_counter() + 10.0
    while True:
        warm[:] = 0
        worker.wait(worker.pull(keys[:batch], warm))
        if np.array_equal(warm.reshape(batch, dim), expected[:batch]):
            break
        if time.perf_counter() > deadline:
            raise RuntimeError("base table never settled on replicas")
        time.sleep(0.05)
    worker.po.barrier(0, WORKER_GROUP)
    # Zipf block starts, precomputed; storm rows stay clear of every
    # worker's probe block at the table's top (those values change
    # mid-storm — an in-flight storm pull of a probe row would
    # spuriously mismatch the local expectation).
    rng = np.random.RandomState(7 + wrank)
    zipf = np.minimum(rng.zipf(1.3, size=65536) - 1,
                      rows - 8 * batch - 1).astype(np.int64)
    outs_pool = [np.zeros(batch * dim, np.float32)
                 for _ in range(depth)]
    pending: deque = deque()
    free = list(range(depth))
    lats: list = []
    n_req = 0
    violations = 0

    def _retire(check: bool) -> None:
        t_iss, ts, start, slot = pending.popleft()
        worker.wait(ts)
        lats.append(time.perf_counter() - t_iss)
        if check:
            got = outs_pool[slot].reshape(batch, dim)
            if not np.array_equal(got, expected[start:start + batch]):
                raise RuntimeError(
                    f"storm pull of rows [{start}, {start + batch}) "
                    f"returned wrong values")
        free.append(slot)

    # Per-worker probe block: only THIS worker writes it, so its own
    # push-stamp floor is exactly the read-your-writes frontier.
    p0 = rows - (wrank + 1) * batch
    probe_keys = keys[p0:p0 + batch]
    probe_expected = np.ascontiguousarray(expected[p0:p0 + batch])
    probe_delta = np.ones(batch * dim, np.float32)
    probe_out = np.zeros(batch * dim, np.float32)
    t0 = time.perf_counter()
    t_end = t0 + secs
    zi = 0
    while time.perf_counter() < t_end:
        n_req += 1
        if n_req % 64 == 0:
            # Read-your-writes probe: any replica whose applied stamp
            # trails this push must be rejected and re-pulled from the
            # primary — a violation here is a stale read.
            probe_expected += 1.0
            worker.wait(worker.push(probe_keys, probe_delta))
            probe_out[:] = 0
            worker.wait(worker.pull(probe_keys, probe_out))
            if not np.array_equal(probe_out.reshape(batch, dim),
                                  probe_expected):
                violations += 1
            continue
        start = int(zipf[zi % len(zipf)])
        zi += 1
        slot = free.pop()
        t1 = time.perf_counter()
        ts = worker.pull(keys[start:start + batch], outs_pool[slot])
        pending.append((t1, ts, start, slot))
        if len(pending) >= depth:
            _retire(check=n_req % 32 == 0)
    while pending:
        _retire(check=False)
    wall = time.perf_counter() - t0
    p50, p99 = _pctl_ms(lats)
    fallbacks = worker.po.metrics.counter("replica_read.fallbacks").value
    spread = worker.po.metrics.counter("replica_read.spread").value
    out = np.zeros(batch * dim, np.float32)
    worker.wait(worker.pull(keys[:batch], out))
    exact = bool(np.array_equal(out.reshape(batch, dim),
                                expected[:batch]))
    print(f"REPLICA_READ reqs={n_req} secs={wall:.3f} "
          f"reqs_per_s={n_req / max(wall, 1e-9):.1f} k={k} "
          f"servers={servers} ryw_violations={violations} "
          f"fallbacks={fallbacks} spread={spread} p50_ms={p50:.3f} "
          f"p99_ms={p99:.3f} exact={exact}", flush=True)
    worker.po.barrier(0, WORKER_GROUP)


def run_worker(args) -> None:
    from . import postoffice
    from .base import WORKER_GROUP
    from .kv.kv_app import KVWorker
    from .message import Role

    po = postoffice(Role.WORKER)
    worker = KVWorker(0, 0)
    if args.mode == "chunk_hol":
        run_chunk_hol(worker, args)
        return
    if args.mode == "lane_goodput":
        run_lane_goodput(worker, args)
        return
    if args.mode == "quantized_push":
        run_quantized_push(worker, args)
        return
    if args.mode == "multi_tenant":
        run_multi_tenant(worker, args)
        return
    if args.mode == "dlrm_serve":
        run_dlrm_serve(worker, args)
        return
    if args.mode == "small_op_storm":
        run_small_op_storm(worker, args)
        return
    if args.mode == "serving_fanin":
        run_serving_fanin(worker, args)
        return
    if args.mode == "durable_serve":
        run_durable_serve(worker, args)
        return
    if args.mode == "replica_read":
        run_replica_read(worker, args)
        return
    ranges = po.get_server_key_ranges()
    keys_per_server = args.num_keys
    val_len = args.len // 4  # fp32 elements per key
    keys = np.sort(
        np.concatenate(
            [
                np.arange(keys_per_server, dtype=np.uint64) + r.begin
                for r in ranges
            ]
        )
    )
    total_keys = len(keys)
    vals = np.random.default_rng(po.my_rank()).normal(
        size=total_keys * val_len
    ).astype(np.float32)
    outs = None

    def timed(fn, iters):
        t0 = time.perf_counter_ns()
        for _ in range(iters):
            fn()
        return time.perf_counter_ns() - t0

    def report(tag, elapsed_ns, iters, bytes_per_iter):
        goodput = 8.0 * bytes_per_iter * iters / max(elapsed_ns, 1)
        lat = elapsed_ns / max(iters, 1) / total_keys / 1000.0
        print(
            f"{tag}: {goodput:.3f} Gbps, avg latency {lat:.3f} us/key",
            flush=True,
        )

    # ENABLE_RECV_BUFFER: pulls land in a transport-registered buffer,
    # delivery-in-place counted.
    if _recv_buffer_mode():
        outs = worker.alloc_pull_buffer(keys, val_len)
        if outs is None:
            print("RECV_BUFFER unsupported on this van; plain pulls",
                  flush=True)
    if outs is None:
        outs = np.zeros_like(vals)

    # Warm up (registration / first-touch, as the reference's first rounds).
    worker.wait(worker.push(keys, vals))
    worker.wait(worker.pull(keys, outs))

    payload = total_keys * val_len * 4
    log_every = int(os.environ.get("LOG_DURATION", "10"))
    done = 0
    while done < args.repeat:
        iters = min(log_every, args.repeat - done)
        if args.mode == "push_then_pull":
            e1 = timed(lambda: worker.wait(worker.push(keys, vals)), iters)
            report("push", e1, iters, payload)
            e2 = timed(lambda: worker.wait(worker.pull(keys, outs)), iters)
            report("pull", e2, iters, payload)
        elif args.mode == "push_pull":
            e = timed(
                lambda: worker.wait(worker.push_pull(keys, vals, outs)),
                iters,
            )
            report("push_pull", e, iters, 2 * payload)
        elif args.mode == "push_only":
            e = timed(lambda: worker.wait(worker.push(keys, vals)), iters)
            report("push", e, iters, payload)
        else:  # pull_only
            e = timed(lambda: worker.wait(worker.pull(keys, outs)), iters)
            report("pull", e, iters, payload)
        done += iters

    # Correctness: the last pull must echo the last push (assign handle).
    # The workers check in turn: another worker's push landing between
    # this worker's push and pull would replace what it reads back (the
    # JAX CLI's check races so with two or more workers).  The barrier
    # first: a worker still in its timed loop would push between turn 0's
    # push and pull.
    if args.mode in ("push_then_pull", "push_pull"):
        po.barrier(0, WORKER_GROUP)
        for turn in range(po.num_worker_instances):
            if turn == po.my_rank():
                worker.wait(worker.push(keys, vals))
                worker.wait(worker.pull(keys, outs))
                np.testing.assert_allclose(outs, vals, rtol=1e-6)
                print("CHECK_OK", flush=True)
            po.barrier(0, WORKER_GROUP)
    if _recv_buffer_mode():
        # In-place deliveries observed (the identity check of
        # test_benchmark.cc:169-181, surfaced as a counter).
        print(f"RECV_BUFFER_HITS {worker.zpull_hits}", flush=True)


def fanout_wall_times(n_peers: int, delay_s: float,
                      rounds: int = 1) -> tuple:
    """Wall times of an N-peer data fan-out over a stub transport whose
    ``send_msg`` costs ``delay_s`` per message: ``(laned, serialized)``
    seconds (best of ``rounds``).

    Prices the Van's per-peer send-lane scheduler ALONE — no sockets,
    no backend, no scheduler bootstrap.  The serialized number replays
    the identical sends with ``PS_SEND_LANES=0``, the pre-lane
    one-message-at-a-time regime (what the old van-wide send lock
    enforced), so ``serialized / laned`` is the fan-out overlap factor.
    """
    from .environment import Environment
    from .message import Message
    from .vans.van import Van

    class _StubPo:
        def __init__(self, env):
            self.env = env

        @staticmethod
        def role_str() -> str:
            return "bench"

    class _SleepWireVan(Van):
        def send_msg(self, msg) -> int:
            time.sleep(delay_s)
            return msg.meta.data_size

    def _run(lanes: bool) -> float:
        van = _SleepWireVan(_StubPo(Environment(
            {"PS_SEND_LANES": "1" if lanes else "0"}
        )))
        best = None
        for _ in range(rounds):
            t0 = time.perf_counter()
            for peer in range(n_peers):
                m = Message()
                m.meta.sender = 1
                m.meta.recver = peer
                van.send(m)
            van._drain_send_lanes(timeout_s=60.0)
            wall = time.perf_counter() - t0
            best = wall if best is None else min(best, wall)
            van._lane_stop = False  # re-arm lanes for the next round
            van._lane_abort = False
        van.profiler.close()
        return best

    return _run(True), _run(False)


def apply_storm_rates(num_shards: int, n_workers: int = 4,
                      msgs_per_worker: int = 8, keys_per_msg: int = 8,
                      val_len: int = 1 << 20, rounds: int = 2) -> float:
    """Msgs/s of a server-side push storm through the apply path with
    ``PS_APPLY_SHARDS=num_shards`` (0 = the serial inline path), over a
    stub responder — no sockets, no scheduler bootstrap: prices the
    apply engine alone, tunnel-independent (the server_apply analog of
    :func:`fanout_wall_times`).

    ``n_workers`` stub workers enqueue pre-built push requests into ONE
    dispatcher thread (the ``Customer._receiving`` analog), which either
    runs the handle inline (serial, today's regime) or feeds the shard
    pool.  Every message pushes the SAME overlapping key set, so each
    apply is the ``store[key] += seg`` hot path and per-key ordering
    rides shard affinity; the clock stops when the last response is
    emitted.  Best of ``rounds``.

    Sizing note: per-key values default to the reference headline's
    MB-class blocks — numpy releases the GIL inside the add loops, but
    sub-MB segments spend comparable time in GIL handoff churn and the
    shards convoy instead of overlapping.
    """
    import threading

    from .kv.apply_shards import ApplyShardPool
    from .kv.kv_app import (KVMeta, KVPairs, KVServerDefaultHandle,
                            _push_segs)
    from .utils.queues import ThreadsafeQueue

    total = n_workers * msgs_per_worker
    keys = np.arange(keys_per_msg, dtype=np.uint64)
    payloads = [
        np.full(keys_per_msg * val_len, 1.0 + w, np.float32)
        for w in range(n_workers)
    ]

    best = None
    for _ in range(rounds):
        handle = KVServerDefaultHandle()
        done = threading.Event()

        class _StubServer:
            def __init__(self):
                self.responses = 0
                self._mu = threading.Lock()

            def response(self, req, res=None):
                with self._mu:
                    self.responses += 1
                    if self.responses >= total:
                        done.set()

            def response_error(self, req):
                self.response(req)

        server = _StubServer()
        pool = (ApplyShardPool(handle, num_shards, server)
                if num_shards > 0 else None)
        # Seed the store so every timed push takes the += path.
        seed_meta = KVMeta(push=True)
        seed_vals = np.zeros(keys_per_msg * val_len, np.float32)
        handle.apply_shard(seed_meta, keys,
                           _push_segs(seed_meta, keys, seed_vals))
        queue: ThreadsafeQueue = ThreadsafeQueue()

        def dispatcher():
            while True:
                item = queue.wait_and_pop()
                if item is None:
                    return
                meta, kvs = item
                if pool is not None:
                    pool.submit(meta, kvs)
                else:
                    handle(meta, kvs, server)

        def feeder(w: int):
            kvs = KVPairs(keys=keys, vals=payloads[w])
            for i in range(msgs_per_worker):
                queue.push((KVMeta(push=True, sender=9 + 2 * w,
                                   timestamp=i), kvs))

        disp = threading.Thread(target=dispatcher, daemon=True)
        disp.start()
        feeders = [threading.Thread(target=feeder, args=(w,), daemon=True)
                   for w in range(n_workers)]
        t0 = time.perf_counter()
        for t in feeders:
            t.start()
        finished = done.wait(timeout=300)
        dt = time.perf_counter() - t0
        for t in feeders:
            t.join(timeout=10)
        queue.push(None)
        disp.join(timeout=10)
        if pool is not None:
            pool.stop()
        if not finished:
            continue  # keep an earlier successful round's rate
        rate = total / max(dt, 1e-9)
        best = rate if best is None else max(best, rate)
    return best if best is not None else 0.0


def _loopback_cluster(num_workers: int, num_servers: int, ns: str,
                      env_extra: Optional[dict] = None,
                      van_type: str = "loopback") -> list:
    """Boot an in-process cluster and return its started Postoffices as
    ``[scheduler, *servers, *workers]`` — the shared harness of the
    host-side KV benches (storm, fault recovery, psmon demo).  The
    default transport is the loopback van; ``van_type="tcp"`` runs real
    sockets over 127.0.0.1 (the chunk-streaming bench needs socket
    semantics — monolithic frames block the peer socket for their full
    serialize time, which is exactly the head-of-line effect under
    measurement)."""
    import threading

    from .environment import Environment
    from .message import Role
    from .postoffice import Postoffice

    if van_type == "loopback":
        host, port = "lo", 42000 + os.getpid() % 1000
    else:
        from .utils.network import get_available_port

        host, port = "127.0.0.1", get_available_port()
    env_map = {
        "DMLC_NUM_WORKER": str(num_workers),
        "DMLC_NUM_SERVER": str(num_servers),
        "DMLC_PS_ROOT_URI": host,
        "DMLC_PS_ROOT_PORT": str(port),
        "DMLC_NODE_HOST": host,
        "PS_VAN_TYPE": van_type,
        "PS_LOOPBACK_NS": f"{ns}-{os.getpid()}",
    }
    if env_extra:
        env_map.update(env_extra)
    nodes = [Postoffice(Role.SCHEDULER, env=Environment(dict(env_map)))]
    nodes += [Postoffice(Role.SERVER, env=Environment(dict(env_map)))
              for _ in range(num_servers)]
    nodes += [Postoffice(Role.WORKER, env=Environment(dict(env_map)))
              for _ in range(num_workers)]
    threads = [threading.Thread(target=po.start, args=(0,), daemon=True)
               for po in nodes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    return nodes


def _teardown_cluster(nodes: list, workers: list, servers: list) -> None:
    for w in workers:
        try:
            w.stop()
        except Exception:
            pass
    for s in servers:
        try:
            s.stop()
        except Exception:
            pass
    for po in nodes:
        try:
            po.van.stop()
        except Exception:
            pass


# Counters whose WINDOWED rates ride the bench's kv_telemetry section
# (deltas over the measured storm interval — docs/observability.md).
_WINDOWED_COUNTERS = (
    "van.sent_messages", "van.recv_messages", "kv.pushes", "kv.pulls",
    "kv.server_push_requests", "kv.server_pull_requests",
    "apply.sharded_requests", "apply.global_requests",
    "qos.shed_requests", "resender.retransmits",
)


def _windowed_rates(pre: dict, post: dict, wall_s: float) -> dict:
    """``{counter: delta/wall}`` for the curated counter set — only
    counters the node actually has, negative deltas (registry reset)
    dropped."""
    out = {}
    for name in _WINDOWED_COUNTERS:
        if name not in post:
            continue
        delta = post[name] - pre.get(name, 0)
        if delta >= 0:
            out[name] = round(delta / max(wall_s, 1e-9), 2)
    return out


def _condense_snapshot(snap: dict) -> dict:
    """Registry snapshot condensed for a bench record: counters plus
    histogram quantiles (the raw buckets stay out of the JSON)."""
    m = snap.get("metrics", snap)
    return {
        "counters": m.get("counters", {}),
        "gauges": m.get("gauges", {}),
        "histograms": {
            name: {q: h.get(q) for q in
                   ("count", "p50", "p90", "p99", "max")}
            for name, h in m.get("histograms", {}).items()
        },
        "topk": m.get("topk", {}),
    }


def kv_loopback_storm(n_workers: int = 2, n_servers: int = 2,
                      msgs_per_worker: int = 50, keys_per_msg: int = 8,
                      val_len: int = 1024, telemetry: bool = True,
                      env_extra: Optional[dict] = None) -> dict:
    """A full message-path push/pull storm over a live loopback cluster
    (real bootstrap, real wire format, real apply pool) — the stub
    bench the telemetry-overhead guard compares on, and the source of
    the registry snapshot bench.py embeds next to its throughput
    numbers.

    The returned ``wall_s`` clocks ONLY the storm (bootstrap excluded);
    ``telemetry`` is the per-node snapshot of every node after the
    storm ({} when disabled), each carrying a ``windowed_per_s``
    sub-dict: counter DELTAS over the measured storm interval divided
    by the wall — true windowed rates (docs/observability.md), not the
    uptime averages that fold bootstrap time into every denominator.
    """
    from .kv.kv_app import KVServer, KVServerDefaultHandle, KVWorker

    env = {"PS_TELEMETRY": "1" if telemetry else "0"}
    if env_extra:
        env.update(env_extra)
    nodes = _loopback_cluster(n_workers, n_servers, "kv-storm", env)
    servers = []
    workers = []
    try:
        for po in nodes[1:1 + n_servers]:
            srv = KVServer(0, postoffice=po)
            srv.set_request_handle(KVServerDefaultHandle())
            servers.append(srv)
        workers = [KVWorker(0, 0, postoffice=po)
                   for po in nodes[1 + n_servers:]]
        span = (1 << 64) // max(keys_per_msg, 1)
        keys = np.arange(keys_per_msg, dtype=np.uint64) * span + 3
        vals = np.ones(keys_per_msg * val_len, np.float32)
        outs = [np.zeros_like(vals) for _ in workers]
        # Pre-storm counter baseline: the windowed rates below are
        # deltas over the MEASURED interval only (bootstrap excluded).
        pre_counters = {}
        if telemetry:
            for po in nodes:
                s = po.telemetry_snapshot()
                pre_counters[f"{s['role']}{s['node_id']}"] = dict(
                    s["metrics"].get("counters", {})
                )
        t0 = time.perf_counter()
        for i in range(msgs_per_worker):
            tss = [w.push(keys, vals) for w in workers]
            for w, ts in zip(workers, tss):
                w.wait(ts)
            if i % 10 == 9:
                for w, out in zip(workers, outs):
                    w.wait(w.pull(keys, out))
        wall = time.perf_counter() - t0
        total = n_workers * msgs_per_worker
        tel = {}
        if telemetry:
            for po in nodes:
                snap = po.telemetry_snapshot()
                name = f"{snap['role']}{snap['node_id']}"
                cond = _condense_snapshot(snap)
                cond["windowed_per_s"] = _windowed_rates(
                    pre_counters.get(name, {}),
                    snap["metrics"].get("counters", {}),
                    wall,
                )
                tel[name] = cond
        return {
            "wall_s": round(wall, 4),
            "msgs": total,
            "msgs_per_s": round(total / max(wall, 1e-9), 1),
            "telemetry": tel,
        }
    finally:
        _teardown_cluster(nodes, workers, servers)


def wire_observatory_storm(quick: bool = False) -> dict:
    """Wire-plane observatory numbers (docs/observability.md) over a
    live in-process tcp cluster: syscalls/op, frames/op, combiner
    batch fill, lane residency p99, and the zero-copy byte share —
    all from ``wire.*`` counter deltas across a bursty small-op push
    storm with the combiner on (the regime the occupancy histogram
    prices).  Both planes summed: a van is judged by its whole data
    plane, whichever half carried the traffic."""
    from .kv.kv_app import KVServer, KVServerDefaultHandle, KVWorker

    env = {"PS_BATCH_BYTES": str(64 << 10)}
    nodes = _loopback_cluster(1, 1, "wire-obs", env, van_type="tcp")
    servers: list = []
    workers: list = []
    try:
        srv = KVServer(0, postoffice=nodes[1])
        srv.set_request_handle(KVServerDefaultHandle())
        servers.append(srv)
        w = KVWorker(0, 0, postoffice=nodes[2])
        workers.append(w)
        keys = np.arange(8, dtype=np.uint64) * ((1 << 64) // 8) + 3
        vals = np.ones(8 * 256, np.float32)  # 8 KiB ops: batchable
        out = np.zeros_like(vals)
        rounds, burst = (6, 8) if quick else (20, 16)
        w.wait(w.push(keys, vals))  # warm the path before the window
        pre = [po.telemetry_snapshot()["metrics"] for po in nodes]
        t0 = time.perf_counter()
        for _ in range(rounds):
            tss = [w.push(keys, vals) for _ in range(burst)]
            for ts in tss:
                w.wait(ts)
            w.wait(w.pull(keys, out))
        wall = time.perf_counter() - t0
        post = [po.telemetry_snapshot()["metrics"] for po in nodes]
    finally:
        _teardown_cluster(nodes, workers, servers)

    def delta(name: str) -> int:
        tot = 0
        for p0, p1 in zip(pre, post):
            d = (p1.get("counters", {}).get(name, 0)
                 - p0.get("counters", {}).get(name, 0))
            if d > 0:
                tot += d
        return tot

    def both(suffix: str) -> int:
        return delta("wire." + suffix) + delta("wire.native." + suffix)

    ops = both("tx.ops") + delta("wire.rx.ops")
    syscalls = both("tx.syscalls") + both("rx.syscalls")
    frames = (both("tx.frames") + delta("wire.rx.frames")
              + delta("wire.native.rx.frames"))
    zc = (both("tx.bytes_zc") + delta("wire.rx.bytes_zc")
          + delta("wire.native.rx.bytes_zc"))
    copied = (delta("wire.tx.bytes_copy") + delta("wire.rx.bytes_copy")
              + delta("wire.native.rx.bytes_copy"))
    occ_n = 0
    occ_sum = 0.0
    res_p99 = 0.0
    for p0, p1 in zip(pre, post):
        h1 = p1.get("histograms", {}).get("wire.batch_occupancy") or {}
        h0 = p0.get("histograms", {}).get("wire.batch_occupancy") or {}
        occ_n += max(h1.get("count", 0) - h0.get("count", 0), 0)
        occ_sum += max(h1.get("sum", 0.0) - h0.get("sum", 0.0), 0.0)
        hr = p1.get("histograms", {}).get("wire.lane_residency_s") or {}
        res_p99 = max(res_p99, hr.get("p99") or 0.0)
    recs = delta("wire.telemetry.records")
    flushes = delta("wire.telemetry.flushes")
    return {
        "ops": ops,
        "wall_s": round(wall, 4),
        "ops_per_s": round(ops / max(wall, 1e-9), 1),
        "syscalls_per_op": (round(syscalls / ops, 3) if ops else None),
        "frames_per_op": (round(frames / ops, 3) if ops else None),
        "batch_fill": (round(occ_sum / occ_n, 2) if occ_n else None),
        "residency_p99_ms": round(res_p99 * 1e3, 3),
        "zc_share": (round(zc / (zc + copied), 3)
                     if zc + copied else None),
        "records_per_flush": (round(recs / flushes, 1)
                              if flushes else None),
    }


def kv_tracing_storm(n_workers: int = 2, n_servers: int = 2,
                     msgs_per_worker: int = 40, keys_per_msg: int = 8,
                     val_len: int = 512,
                     tail_spec: str = "slow:p95,errors,floor:0.05",
                     env_extra: Optional[dict] = None) -> dict:
    """The kv loopback storm with TAIL TRACING on, followed by a live
    ``TRACE_PULL`` assembly round (docs/observability.md): the
    condensed result — kept/assembled counts, walls, per-stage shares
    and the slow set's dominant stage — is what bench.py's
    ``kv_tracing`` section embeds next to the throughput numbers.
    Context only: stage shares are host-load-shaped, so
    ``tools/bench_diff.py`` notes but never gates them (like the
    windowed rates)."""
    from .kv.kv_app import KVServer, KVServerDefaultHandle, KVWorker

    env = {"PS_TRACE_TAIL": tail_spec}
    if env_extra:
        env.update(env_extra)
    nodes = _loopback_cluster(n_workers, n_servers, "kv-trace", env)
    servers = []
    workers = []
    try:
        for po in nodes[1:1 + n_servers]:
            srv = KVServer(0, postoffice=po)
            srv.set_request_handle(KVServerDefaultHandle())
            servers.append(srv)
        workers = [KVWorker(0, 0, postoffice=po)
                   for po in nodes[1 + n_servers:]]
        span = (1 << 64) // max(keys_per_msg, 1)
        keys = np.arange(keys_per_msg, dtype=np.uint64) * span + 3
        vals = np.ones(keys_per_msg * val_len, np.float32)
        outs = [np.zeros_like(vals) for _ in workers]
        t0 = time.perf_counter()
        for i in range(msgs_per_worker):
            tss = [w.push(keys, vals) for w in workers]
            for w, ts in zip(workers, tss):
                w.wait(ts)
            if i % 10 == 9:
                for w, out in zip(workers, outs):
                    w.wait(w.pull(keys, out))
        wall = time.perf_counter() - t0
        coll = nodes[0].collect_cluster_traces(timeout_s=10.0)
        agg = coll.aggregate()
        total = n_workers * msgs_per_worker
        return {
            "wall_s": round(wall, 4),
            "msgs_per_s": round(total / max(wall, 1e-9), 1),
            "assembled": agg["count"],
            "collected": len(coll),
            "top_stage": agg["top_stage"],
            "trace_wall_p50_us": agg["wall_p50_us"],
            "trace_wall_max_us": agg["wall_max_us"],
            "stage_shares": {
                name: info["share"]
                for name, info in (agg.get("slow") or {}).items()
            },
        }
    finally:
        _teardown_cluster(nodes, workers, servers)


def fault_recovery_times(quick: bool = True) -> dict:
    """End-to-end recovery latency of the fault-tolerance tier
    (docs/fault_tolerance.md), over an in-process loopback cluster —
    no sockets, host-side only, tunnel-independent.

    Timeline measured from the instant a server's van is killed
    mid-service (1 worker, 2 servers, ``PS_KV_REPLICATION=2``,
    deadlines on):

    - ``kill_to_detect_s``: kill -> the scheduler's failure detector
      broadcasts NODE_FAILURE and the worker's hook marks the rank down
      (bounded below by PS_HEARTBEAT_TIMEOUT).
    - ``detect_to_pull_s``: detection -> a pull of the dead rank's key
      range completes against the replica (the failover hot path).
    - ``kill_to_pull_s``: the sum the application experiences.
    """
    from .kv.kv_app import KVServer, KVServerDefaultHandle, KVWorker

    hb_interval, hb_timeout = (0.2, 0.8) if quick else (0.3, 1.0)
    nodes = _loopback_cluster(
        num_workers=1, num_servers=2, ns="fault-recovery",
        env_extra={
            "PS_KV_REPLICATION": "2",
            "PS_HEARTBEAT_INTERVAL": str(hb_interval),
            "PS_HEARTBEAT_TIMEOUT": str(hb_timeout),
            "PS_REQUEST_TIMEOUT": "0.5",
            "PS_REQUEST_RETRIES": "5",
        },
    )
    scheduler, server_pos, worker_po = nodes[0], nodes[1:3], nodes[3]
    servers = []
    for po in server_pos:
        srv = KVServer(0, postoffice=po)
        srv.set_request_handle(KVServerDefaultHandle())
        servers.append(srv)
    worker = KVWorker(0, 0, postoffice=worker_po)
    from .base import server_rank_to_id

    keys = np.array([7], dtype=np.uint64)
    vals = np.ones(256, dtype=np.float32)
    rounds = 3 if quick else 10
    for _ in range(rounds):
        worker.wait(worker.push(keys, vals))
    time.sleep(3 * hb_interval)  # replication forwards + steady beats

    victim_po = next(po for po in server_pos
                     if po.van.my_node.id == server_rank_to_id(0))
    dead_id = server_rank_to_id(0)
    t_kill = time.perf_counter()
    victim_po.van.stop()
    while dead_id not in worker._down_servers:
        if time.perf_counter() - t_kill > 60:
            raise TimeoutError("failure detector never fired")
        time.sleep(0.005)
    t_detect = time.perf_counter()
    out = np.zeros_like(vals)
    worker.wait(worker.pull(keys, out))
    t_pull = time.perf_counter()
    ok = bool(np.all(out == rounds))

    # Registry context next to the recovery numbers (timeouts, retries,
    # failovers, replication forwards) — the telemetry satellite of
    # docs/observability.md.
    telemetry = {
        "worker": _condense_snapshot(worker_po.telemetry_snapshot()),
        "survivor_server": _condense_snapshot(next(
            po for po in server_pos if po is not victim_po
        ).telemetry_snapshot()),
    }
    worker.stop()
    for srv, po in zip(servers, server_pos):
        if po is not victim_po:
            srv.stop()
    for po in [scheduler, worker_po] + [
        p for p in server_pos if p is not victim_po
    ]:
        try:
            po.van.stop()
        except Exception:
            pass
    return {
        "kill_to_detect_s": round(t_detect - t_kill, 3),
        "detect_to_pull_s": round(t_pull - t_detect, 3),
        "kill_to_pull_s": round(t_pull - t_kill, 3),
        "heartbeat_timeout_s": hb_timeout,
        "replica_data_exact": ok,
        "telemetry": telemetry,
    }


def elastic_scale_bench(quick: bool = True) -> dict:
    """End-to-end elasticity proof (docs/elasticity.md): scale an
    elastic cluster 2 -> 4 -> 2 servers in the middle of a push storm,
    with NO global restart, over real TCP sockets (in-process nodes —
    the measurement is comparative within one harness, so the shared
    GIL prices both windows identically).

    Two measured windows over the same cluster:

    - **base**: storm + priority small-pull sampling with membership
      static (the uncontended reference tail).
    - **migration**: the same storm while two servers join (live range
      splits + migrations) and then decommission (merges back).

    Acceptance: ``p99_ratio = migration p99 / base p99 <= 3``, the
    final store BIT-EXACT vs the completed push count (every ``wait``
    completed or raised — wrong-epoch slices re-route transparently),
    and zero hung requests.
    """
    import threading

    from .kv.kv_app import KVServer, KVServerDefaultHandle, KVWorker
    from .message import Role
    from .environment import Environment
    from .postoffice import Postoffice

    n_keys = 32
    val_len = 2048 if quick else 8192
    window_s = 1.5 if quick else 4.0
    env = {
        "PS_ELASTIC": "1",
        "PS_REQUEST_TIMEOUT": "3.0",
        "PS_REQUEST_RETRIES": "8",
    }
    nodes = _loopback_cluster(1, 2, "elastic-scale", env, van_type="tcp")
    servers = []
    workers = []
    joiner_pos: list = []
    joiner_srvs: list = []
    try:
        for po in nodes[1:3]:
            srv = KVServer(0, postoffice=po)
            srv.set_request_handle(KVServerDefaultHandle())
            servers.append(srv)
        worker = KVWorker(0, 0, postoffice=nodes[3])
        workers.append(worker)
        span = (1 << 64) // n_keys
        keys = (np.arange(n_keys, dtype=np.uint64) * np.uint64(span)
                + np.uint64(3))
        vals = np.arange(n_keys * val_len, dtype=np.float32) % 97 + 1.0
        hot_key = keys[:1]
        hot_out = np.zeros(val_len, np.float32)
        pushes = [0]
        stop = [False]
        errors: list = []

        def storm():
            while not stop[0]:
                try:
                    worker.wait(worker.push(keys, vals))
                    pushes[0] += 1
                except Exception as exc:  # noqa: BLE001
                    errors.append(repr(exc))
                    return

        def sample(lats, dur_s):
            deadline = time.perf_counter() + dur_s
            while time.perf_counter() < deadline:
                t0 = time.perf_counter()
                worker.wait(worker.pull(hot_key, hot_out, priority=1))
                lats.append(time.perf_counter() - t0)
                time.sleep(0.002)

        worker.wait(worker.push(keys, vals))
        pushes[0] += 1
        t = threading.Thread(target=storm, daemon=True)
        t.start()
        base_lats: list = []
        sample(base_lats, window_s)

        def join_one():
            po = Postoffice(Role.SERVER, env=Environment(dict(
                nodes[3].env._overrides)))
            po.start(0)
            srv = KVServer(0, postoffice=po)
            srv.set_request_handle(KVServerDefaultHandle())
            joiner_pos.append(po)
            joiner_srvs.append(srv)

        mig_lats: list = []
        t_mig = time.perf_counter()
        sampler = threading.Thread(
            target=sample, args=(mig_lats, window_s * 2 + 2.0),
            daemon=True)
        sampler.start()
        join_one()
        join_one()
        time.sleep(window_s / 2)
        for srv in joiner_srvs:
            srv.decommission(timeout_s=60)
        sampler.join(timeout=window_s * 4 + 20)
        mig_wall = time.perf_counter() - t_mig
        stop[0] = True
        t.join(timeout=30)
        n = pushes[0]
        out = np.zeros_like(vals)
        worker.wait(worker.pull(keys, out))
        exact = bool(np.array_equal(out, vals * n)) and not errors
        _, base_p99 = _pctl_ms(base_lats)
        _, mig_p99 = _pctl_ms(mig_lats)
        rt = nodes[3].current_routing()
        return {
            "pushes": n,
            "push_mb": round(vals.nbytes / 2**20, 2),
            "store_bitexact": exact,
            "errors": errors[:3],
            "joins": 2,
            "leaves": 2,
            "final_epoch": rt.epoch if rt else None,
            "final_active": list(rt.active) if rt else None,
            "scale_2_4_2_wall_s": round(mig_wall, 2),
            "base_p99_ms": base_p99,
            "migration_p99_ms": mig_p99,
            "p99_ratio": (round(mig_p99 / base_p99, 2)
                          if base_p99 > 0 else None),
            "wrong_owner_bounces": nodes[3].metrics.counter(
                "kv.wrong_owner_bounces").value,
        }
    finally:
        _teardown_cluster(nodes, workers, servers + joiner_srvs)
        for po in joiner_pos:
            try:
                po.van.stop()
            except Exception:
                pass


def autopilot_bench(quick: bool = True) -> dict:
    """Self-driving skew remediation (docs/autopilot.md): a Zipf-style
    hot-set storm lands almost entirely on ONE of two elastic servers;
    the autopilot senses the sustained per-server rate skew through the
    scheduler's ClusterHistory and rebalances the hot range — with ZERO
    operator actions.  In-process TCP cluster (comparative within one
    harness).

    Outputs the gate pair: ``load_skew_ratio`` (final-window max/mean
    per-server request rate; lower is better — ~2.0 means the skew was
    never fixed) and ``operator_actions`` (must be 0: every lever the
    run pulled was the autopilot's).
    """
    import threading

    from .cluster.autopilot import _server_rates
    from .kv.kv_app import KVServer, KVServerDefaultHandle, KVWorker

    n_keys = 32
    val_len = 1024 if quick else 4096
    storm_s = 6.0 if quick else 14.0
    env = {
        "PS_ELASTIC": "1",
        "PS_AUTOPILOT": "1",
        "PS_METRICS_INTERVAL": "0.25",
        "PS_AUTOPILOT_SUSTAIN": "2",
        # With TWO servers max >= 2.0x mean is unreachable (the cold
        # server would need literally zero traffic), so gate at 1.5x.
        "PS_AUTOPILOT_SKEW_RATIO": "1.5",
        "PS_AUTOPILOT_SKEW_COOLDOWN_S": "1.0",
        "PS_AUTOPILOT_MIN_RATE": "5.0",
        "PS_AUTOPILOT_MAX_ACTIONS": "8",
        "PS_AUTOPILOT_TRACE_EVERY": "0",
        "PS_REQUEST_TIMEOUT": "3.0",
        "PS_REQUEST_RETRIES": "8",
    }
    nodes = _loopback_cluster(1, 2, "autopilot", env, van_type="tcp")
    sched = nodes[0]
    servers = []
    workers = []
    try:
        for po in nodes[1:3]:
            srv = KVServer(0, postoffice=po)
            srv.set_request_handle(KVServerDefaultHandle())
            servers.append(srv)
        worker = KVWorker(0, 0, postoffice=nodes[3])
        workers.append(worker)
        span = (1 << 64) // n_keys
        keys = (np.arange(n_keys, dtype=np.uint64) * np.uint64(span)
                + np.uint64(3))
        vals = np.arange(n_keys * val_len, dtype=np.float32) % 97 + 1.0
        # The hot set: the lowest quarter of the key space — entirely
        # inside server 0's initial half.  It DRIFTS to an adjacent
        # band mid-storm (full mode), the ROADMAP acceptance shape.
        hot_a = keys[: n_keys // 4]
        hot_b = keys[n_keys // 4: n_keys // 2]
        hot_out = np.zeros(val_len * len(hot_a), np.float32)
        pushes = [0]
        stop = [False]
        errors: list = []

        def storm():
            t0 = time.perf_counter()
            while not stop[0]:
                try:
                    worker.wait(worker.push(keys, vals))
                    pushes[0] += 1
                    hot = (hot_a if quick or
                           time.perf_counter() - t0 < storm_s / 2
                           else hot_b)
                    for _ in range(8):
                        worker.wait(worker.pull(hot, hot_out))
                except Exception as exc:  # noqa: BLE001
                    errors.append(repr(exc))
                    return

        worker.wait(worker.push(keys, vals))
        pushes[0] += 1
        t = threading.Thread(target=storm, daemon=True)
        t.start()
        time.sleep(storm_s)
        stop[0] = True
        t.join(timeout=30)
        rates = _server_rates(sched.history) if sched.history else {}
        skew = None
        if len(rates) >= 2:
            mean = sum(rates.values()) / len(rates)
            skew = round(max(rates.values()) / max(mean, 1e-9), 2)
        n = pushes[0]
        out = np.zeros_like(vals)
        worker.wait(worker.pull(keys, out))
        exact = bool(np.array_equal(out, vals * n)) and not errors
        ap = sched.history.autopilot if sched.history else None
        counts = ap.counts() if ap else {}
        rt = sched.current_routing()
        return {
            "pushes": n,
            "store_bitexact": exact,
            "errors": errors[:3],
            "load_skew_ratio": skew,
            # Manual control-plane actions taken by this harness during
            # the storm — the autopilot pulled every lever.
            "operator_actions": 0,
            "decisions_acted": counts.get("acted", 0),
            "decisions_vetoed": counts.get("vetoed", 0),
            "final_epoch": rt.epoch if rt else None,
        }
    finally:
        _teardown_cluster(nodes, workers, servers)


def _chunk_run(push_mb: int, n_pushes: int,
               chunk_bytes: str, extra_env: dict = None,
               mode: str = "chunk_hol") -> dict:
    """One leg of the chunk_streaming bench: a REAL 1w+1s tcp cluster
    via the local tracker (one process per node — an in-process cluster
    would measure the shared-GIL convoy, not the transport), running
    ``--mode chunk_hol``: sequential ``push_mb``-MiB pushes from a
    background thread while the foreground samples small-pull latency
    against the same server.  The pull request rides the same per-peer
    lane and socket as the push payload, so its latency IS the
    head-of-line wait (docs/chunking.md)."""
    import re
    import subprocess
    import sys

    n_keys = 16
    cmd = [
        sys.executable, "-m", "pslite_tpu_torch.tracker.local",
        "-n", "1", "-s", "1", "--van", "tcp", "--",
        sys.executable, "-m", "pslite_tpu_torch.benchmark",
        "--mode", mode,
        "--len", str(push_mb * (1 << 20) // n_keys),
        "--num-keys", str(n_keys),
        "--repeat", str(n_pushes),
    ]
    env = dict(
        os.environ,
        PS_CHUNK_BYTES=chunk_bytes,
        # Cap kernel-buffered bytes (both legs, so the comparison is
        # fair): without it the already-accepted send/recv buffers —
        # not the lane — add a fixed term to the priority pull's wait.
        PS_TCP_SNDBUF=str(256 << 10),
        PS_TCP_RCVBUF=str(256 << 10),
        # Room for several in-flight 64 MiB reassembly buffers: blocks
        # falling out of the pool would re-pay the fresh-page fault tax
        # the pool exists to amortize (same setting both legs).
        PS_RECV_POOL_MB="512",
    )
    env.update(extra_env or {})
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                       env=env)
    tag = mode.upper()
    m = re.search(
        tag + r" samples=(\d+) pull_p50_ms=([0-9.]+) "
        r"pull_p99_ms=([0-9.]+) push_gbps=([0-9.]+)", r.stdout,
    )
    if m is None:
        raise RuntimeError(
            f"{mode} leg produced no result (rc={r.returncode}): "
            f"{r.stdout[-500:]}\n{r.stderr[-500:]}"
        )
    return {
        "pull_samples": int(m.group(1)),
        "pull_p50_ms": float(m.group(2)),
        "pull_p99_ms": float(m.group(3)),
        "push_gbps": float(m.group(4)),
    }


def chunk_streaming_bench(quick: bool = True) -> dict:
    """Chunked streaming transfers (docs/chunking.md) over a live
    loopback cluster: (a) large-push goodput chunked vs monolithic —
    the pipelining tax must stay small — and (b) small-pull p99 under a
    concurrent large background push, chunked vs ``PS_CHUNK_BYTES=0`` —
    the head-of-line win, the headline number."""
    push_mb = 64
    n_pushes = 4 if quick else 8
    # 512 KiB chunks: measured sweet spot on the host stub — small
    # enough that per-chunk GIL/copy bursts stay off the small-pull
    # tail, large enough that goodput beats monolithic.
    chunk_bytes = 512 << 10
    chunked = _chunk_run(push_mb, n_pushes, str(chunk_bytes))
    mono = _chunk_run(push_mb, n_pushes, "0")
    out = {
        "push_mb": push_mb,
        "chunk_bytes": chunk_bytes,
        "chunked_push_gbps": round(chunked["push_gbps"], 2),
        "mono_push_gbps": round(mono["push_gbps"], 2),
        "chunked_pull_p50_ms": round(chunked["pull_p50_ms"], 3),
        "chunked_pull_p99_ms": round(chunked["pull_p99_ms"], 3),
        "mono_pull_p50_ms": round(mono["pull_p50_ms"], 3),
        "mono_pull_p99_ms": round(mono["pull_p99_ms"], 3),
        "pull_samples": [chunked["pull_samples"], mono["pull_samples"]],
        # Headline: how much lower the small-pull tail is with the lane
        # interleaving between chunks instead of behind the monolith.
        "hol_p99_ratio": (
            round(mono["pull_p99_ms"] / chunked["pull_p99_ms"], 2)
            if chunked["pull_p99_ms"] > 0 else None),
        "push_tput_ratio": (
            round(chunked["push_gbps"] / mono["push_gbps"], 3)
            if mono["push_gbps"] > 0 else None),
    }
    return out


def native_goodput_bench(quick: bool = True) -> dict:
    """Native zero-copy data plane (docs/native_core.md) over a real
    1w+1s tcp cluster (one process per node): 64 MiB push goodput with
    the C++ sender lanes on (``PS_NATIVE=1``) vs the pure-Python path
    (``PS_NATIVE=0``), plus the small-pull p99 under the same bulk
    storm on both legs — the GIL-free plane must raise single-lane
    goodput (target: >= 2x) WITHOUT moving the priority tail.
    Both legs keep chunking on at the same size, so the ratio isolates
    the encode/dispatch plane, not the pipelining win (priced by
    chunk_streaming).  ``lane_goodput`` mode (pipelined pushes) rather
    than ``chunk_hol``: sequential waited pushes serialize on the
    per-push RTT + apply chain shared by both legs, which masks the
    data-plane difference.  The window is SUSTAINED (>= 6 GiB):
    goodput is a steady-state metric, and the two legs move in
    OPPOSITE directions as the storm lengthens — the native leg climbs
    as the frame/recv pools warm and the TCP windows grow (~17.4 Gbps
    at 16 pushes -> ~19.6-22 at 96+), while the GIL-bound leg SLIDES
    under the sustained convoy (~10.5 -> ~9-9.9) — so a short window
    underprices exactly the gap this section exists to price.  Each
    leg runs ``rounds`` times and reports the MEDIAN (per-round values
    attached): residual noise is one-sided scheduler luck and the
    median is robust to one lucky/unlucky draw where best-of-N would
    chase the outlier."""
    from .vans import native as _native_mod

    class _ForceOn:  # availability probe must ignore the parent's env
        @staticmethod
        def find(key, default=None):
            return "1"

    try:
        lib = _native_mod.load(_ForceOn())
    except Exception:  # noqa: BLE001 - the port's load raises
        lib = None
    if lib is None:
        # Without this guard the PS_NATIVE=1 child silently falls back
        # to pure Python and the section emits a bogus ~1.0 ratio that
        # reads "native gives no win" instead of "native absent".
        return {"skipped": "native core unavailable (libpslite_core.so "
                           "missing or ABI-stale; build with `make "
                           "native`)"}
    push_mb = 64
    n_pushes = 96 if quick else 128
    rounds = 3
    chunk_bytes = 2 << 20
    leg_runs = {"native": [], "python": []}
    # Rounds INTERLEAVE the two legs (native, python, native, ...):
    # host-load drift over the section's wall time then lands on both
    # legs symmetrically instead of biasing whichever leg ran last.
    for _ in range(rounds):
        for tag, ps_native in (("native", "1"), ("python", "0")):
            leg_runs[tag].append(_chunk_run(
                push_mb, n_pushes, str(chunk_bytes),
                # _chunk_run's 256 KiB socket-buffer caps stay: bounded
                # kernel buffering is what makes this a DATA-PLANE
                # measurement.  With autotuned (multi-MiB) buffers the
                # kernel pipelines around the GIL-bound leg's slow
                # encode (measured: the Python leg jumps ~11 -> ~15
                # Gbps while native holds ~19-20) and the ratio prices
                # the kernel knob, not the plane.  Under bounded
                # buffers throughput tracks how fast each side REFILLS/
                # DRAINS its window — exactly the send/recv hot path.
                extra_env={"PS_NATIVE": ps_native,
                           "PS_BENCH_PIPELINE": "4"},
                mode="lane_goodput",
            ))
    legs = {}
    med = statistics.median
    for tag, runs in leg_runs.items():
        legs[tag] = {
            "push_gbps": med(r["push_gbps"] for r in runs),
            "pull_p99_ms": med(r["pull_p99_ms"] for r in runs),
            "pull_samples": sum(r["pull_samples"] for r in runs),
            "rounds_gbps": [round(r["push_gbps"], 2) for r in runs],
        }
    nat, py = legs["native"], legs["python"]
    return {
        "push_mb": push_mb,
        "chunk_bytes": chunk_bytes,
        "rounds": rounds,
        "native_push_gbps": round(nat["push_gbps"], 2),
        "python_push_gbps": round(py["push_gbps"], 2),
        "native_rounds_gbps": nat["rounds_gbps"],
        "python_rounds_gbps": py["rounds_gbps"],
        "native_pull_p99_ms": round(nat["pull_p99_ms"], 3),
        "python_pull_p99_ms": round(py["pull_p99_ms"], 3),
        "pull_samples": [nat["pull_samples"], py["pull_samples"]],
        # Headline: single-lane goodput, GIL-free vs GIL-bound.
        "goodput_ratio": (
            round(nat["push_gbps"] / py["push_gbps"], 2)
            if py["push_gbps"] > 0 else None),
        # Guard: the native lanes must preserve the priority
        # discipline (<= 1 means the tail improved or held).
        "p99_ratio_native_vs_python": (
            round(nat["pull_p99_ms"] / py["pull_p99_ms"], 2)
            if py["pull_p99_ms"] > 0 else None),
    }


def quantized_push_bench(quick: bool = True) -> dict:
    """Quantized transport tier (docs/compression.md) over the real
    1w+1s tcp cluster: the 64 MiB ``quantized_push`` storm (pipelined
    pushes + concurrent priority small-pulls) uncompressed vs int8 vs
    fp8_e4m3, all legs sharing the van settings of ``native_goodput``
    (2 MiB chunks, bounded socket buffers, pipeline depth 4).

    Headline: ``goodput_ratio_<codec>`` — EFFECTIVE goodput (raw
    payload bytes per second, i.e. pre-compression) relative to the
    uncompressed leg — with the concurrent priority small-pull p99
    ratio as the tail guard (acceptance: >= 2x at p99 <= 1.3x).

    The headline codec legs run with error feedback OFF
    (``PS_CODEC_EF=0``): EF's fold+decode+update roughly doubles the
    encode memory traffic, and its convergence value is priced by the
    dedicated guard test, not this throughput section.  The ``int8_ef``
    leg re-runs int8 with EF ON so the bench records what the
    convergence-preserving configuration actually costs."""
    from .ops import codecs as codecs_mod

    push_mb = 64
    n_pushes = 32 if quick else 96
    rounds = 1 if quick else 3
    chunk_bytes = 2 << 20
    base_env = {
        "PS_BENCH_PIPELINE": "4",
        # Enough pooled decode buffers for the pipeline depth (the
        # first cold 64 MiB allocations cost tens of ms of page
        # faults; see _BufPool) — the warmup pushes then prime them.
        "PS_CODEC_POOL_MB": "1024",
    }
    legs_spec = [("raw", "", "0"), ("int8", "int8", "0")]
    if "fp8_e4m3" in codecs_mod.names():
        legs_spec.append(("fp8_e4m3", "fp8_e4m3", "0"))
    legs_spec.append(("int8_ef", "int8", "1"))
    leg_runs = {tag: [] for tag, _, _ in legs_spec}
    # Interleaved rounds (the native_goodput lesson): host-load drift
    # lands on every leg symmetrically instead of biasing the last.
    for _ in range(rounds):
        for tag, codec, ef in legs_spec:
            env = dict(base_env, PS_BENCH_CODEC=codec, PS_CODEC_EF=ef)
            leg_runs[tag].append(_chunk_run(
                push_mb, n_pushes, str(chunk_bytes),
                extra_env=env, mode="quantized_push",
            ))
    med = statistics.median
    legs = {}
    for tag, runs in leg_runs.items():
        legs[tag] = {
            "push_gbps": med(r["push_gbps"] for r in runs),
            "pull_p99_ms": med(r["pull_p99_ms"] for r in runs),
            "pull_samples": sum(r["pull_samples"] for r in runs),
        }
    raw = legs["raw"]
    out = {
        "push_mb": push_mb,
        "chunk_bytes": chunk_bytes,
        "rounds": rounds,
        "raw_push_gbps": round(raw["push_gbps"], 2),
        "raw_pull_p99_ms": round(raw["pull_p99_ms"], 3),
    }
    for tag, _, ef in legs_spec:
        if tag == "raw":
            continue
        leg = legs[tag]
        out[f"{tag}_push_gbps"] = round(leg["push_gbps"], 2)
        out[f"{tag}_pull_p99_ms"] = round(leg["pull_p99_ms"], 3)
        # Effective goodput ratio: raw-bytes throughput compressed vs
        # uncompressed (the >= 2x acceptance headline).
        out[f"goodput_ratio_{tag}"] = (
            round(leg["push_gbps"] / raw["push_gbps"], 2)
            if raw["push_gbps"] > 0 else None)
        # Tail guard: the priority small-pull p99 must not degrade
        # beyond 1.3x under the compressed storm.
        out[f"p99_ratio_{tag}"] = (
            round(leg["pull_p99_ms"] / raw["pull_p99_ms"], 2)
            if raw["pull_p99_ms"] > 0 else None)
    return out


def _mt_run(serve_s: float, bulk: bool, extra_env: dict = None) -> dict:
    """One leg of the multi_tenant bench: a REAL 2w+1s tcp cluster
    (one process per node) running ``--mode multi_tenant`` — rank 0
    serves, rank 1 storms (or idles for the baseline leg)."""
    import re
    import subprocess
    import sys

    cmd = [
        sys.executable, "-m", "pslite_tpu_torch.tracker.local",
        "-n", "2", "-s", "1", "--van", "tcp", "--",
        sys.executable, "-m", "pslite_tpu_torch.benchmark",
        "--mode", "multi_tenant", "--len", "1024", "--repeat", "1",
    ]
    env = dict(
        os.environ,
        PS_TENANTS="serve:8,train:1",
        PS_TENANT_QUEUE_LIMIT="8",
        PS_MT_SERVE_SECONDS=str(serve_s),
        PS_MT_BULK="1" if bulk else "0",
        # Fine scheduling quanta (both legs, so the baseline is fair):
        # 256 KiB wire chunks and 512 KiB apply task groups bound the
        # non-preemptible in-service wait an express pull can see to
        # well under a millisecond each.
        PS_CHUNK_BYTES=str(256 << 10),
        PS_APPLY_TASK_BYTES=str(512 << 10),
        # Bounded kernel buffers, like chunk_streaming: the serving
        # tail must measure the SCHEDULER, not unbounded socket bloat.
        PS_TCP_SNDBUF=str(256 << 10),
        PS_TCP_RCVBUF=str(256 << 10),
        PS_RECV_POOL_MB="512",
    )
    env.update(extra_env or {})
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                       env=env)
    ms = re.search(
        r"MULTI_TENANT role=serve samples=(\d+) pull_p50_ms=([0-9.]+) "
        r"pull_p99_ms=([0-9.]+)", r.stdout)
    mb = re.search(
        r"MULTI_TENANT role=bulk applied=(\d+) shed=(\d+) "
        r"push_gbps=([0-9.]+) store_exact=(True|False)", r.stdout)
    if ms is None or mb is None:
        raise RuntimeError(
            f"multi_tenant leg produced no result (rc={r.returncode}): "
            f"{r.stdout[-600:]}\n{r.stderr[-600:]}"
        )
    return {
        "samples": int(ms.group(1)),
        "pull_p50_ms": float(ms.group(2)),
        "pull_p99_ms": float(ms.group(3)),
        "applied": int(mb.group(1)),
        "shed": int(mb.group(2)),
        "bulk_gbps": float(mb.group(3)),
        "store_exact": mb.group(4) == "True",
    }


def _dlrm_run(n_pulls: int, cache: bool) -> dict:
    """One leg of the DLRM Zipf serving storm (real 1w+1s tcp cluster,
    ``--mode dlrm_serve``), hot cache on or off."""
    import re
    import subprocess
    import sys

    cmd = [
        sys.executable, "-m", "pslite_tpu_torch.tracker.local",
        "-n", "1", "-s", "1", "--van", "tcp", "--",
        sys.executable, "-m", "pslite_tpu_torch.benchmark",
        "--mode", "dlrm_serve", "--len", "1024",
        "--repeat", str(n_pulls),
    ]
    env = dict(
        os.environ,
        PS_HOT_CACHE="1" if cache else "0",
        PS_TENANTS="serve:8,train:1",
    )
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                       env=env)
    m = re.search(
        r"DLRM_SERVE samples=(\d+) pull_p50_ms=([0-9.]+) "
        r"pull_p99_ms=([0-9.]+) hit_rate=([0-9.]+) exact=True",
        r.stdout)
    if m is None:
        raise RuntimeError(
            f"dlrm_serve leg produced no result (rc={r.returncode}): "
            f"{r.stdout[-600:]}\n{r.stderr[-600:]}"
        )
    return {
        "samples": int(m.group(1)),
        "pull_p50_ms": float(m.group(2)),
        "pull_p99_ms": float(m.group(3)),
        "hit_rate": float(m.group(4)),
    }


def admission_probe(n_pushes: int = 64, limit: int = 4) -> dict:
    """Deterministic admission-control demonstration over an
    in-process loopback cluster (docs/qos.md): a bulk tenant floods a
    tiny-limit server with non-waited pushes; every wait() completes
    fast — applied or OverloadError, never a hang — and the store ends
    bit-exact at (applied x payload)."""
    import numpy as np

    from .kv.kv_app import (KVServer, KVServerDefaultHandle, KVWorker,
                            OverloadError)

    env = {"PS_TENANTS": "serve:8,train:1",
           "PS_TENANT_QUEUE_LIMIT": str(limit)}
    nodes = _loopback_cluster(1, 1, ns=f"mt-admit-{os.getpid()}",
                              env_extra=env)
    sched, srv_po, w_po = nodes
    servers, workers = [], []
    t0 = time.perf_counter()
    try:
        srv = KVServer(0, postoffice=srv_po)
        srv.set_request_handle(KVServerDefaultHandle())
        servers.append(srv)
        w = KVWorker(0, 0, postoffice=w_po)
        workers.append(w)
        keys = np.arange(8, dtype=np.uint64)
        # Small MONOLITHIC pushes (below PS_CHUNK_BYTES): each is one
        # apply-pool pending, so a fast burst outruns the shard
        # threads and the tenant's bounded queue trips — the shed
        # path under test.
        vals = np.ones(8 * 1024, np.float32)
        tss = [w.push(keys, vals, tenant="train")
               for _ in range(n_pushes)]
        applied = shed = 0
        for ts in tss:
            try:
                w.wait(ts)
                applied += 1
            except OverloadError:
                shed += 1
        out = np.zeros_like(vals)
        w.wait(w.pull(keys, out, tenant="train"))
        exact = bool(np.all(out == np.float32(applied)))
    finally:
        _teardown_cluster(nodes, workers, servers)
    return {
        "offered": n_pushes,
        "applied": applied,
        "shed": shed,
        "store_exact": exact,
        "wall_s": round(time.perf_counter() - t0, 2),
    }


def multi_tenant_bench(quick: bool = True) -> dict:
    """Multi-tenant serving QoS (docs/qos.md) over real tcp processes.

    Two headline halves (the acceptance):

    - **Isolation**: a bulk tenant (``train``, weight 1) offering
      multi-MiB pushes at ~10x capacity must not move the serving
      tenant's (``serve``, weight 8) small-pull p99 by more than 2x vs
      the uncontended baseline over the identical cluster shape —
      express scheduling + weighted-fair lanes/intake/apply shards
      with bounded per-tenant admission.  Legs run in INTERLEAVED
      rounds and report medians (host drift lands symmetrically).
    - **Hot-key cache**: the DLRM Zipf single-row pull storm's p50
      improves >= 5x with ``PS_HOT_CACHE=1`` at the default size, hit
      rate >= 60%, values spot-checked bit-exact.

    Plus the admission probe: a flooded tiny-limit server sheds with
    OPT_OVERLOAD fast-fails — no dropped or hanging wait()s, store
    bit-exact at applied-count."""
    serve_s = 3.0 if quick else 6.0
    n_pulls = 500 if quick else 2000
    rounds = 2 if quick else 3
    legs = {"base": [], "loaded": []}
    for _ in range(rounds):
        legs["base"].append(_mt_run(serve_s, bulk=False))
        legs["loaded"].append(_mt_run(serve_s, bulk=True))
    med = statistics.median
    base_p50 = med(r["pull_p50_ms"] for r in legs["base"])
    base_p99 = med(r["pull_p99_ms"] for r in legs["base"])
    load_p50 = med(r["pull_p50_ms"] for r in legs["loaded"])
    load_p99 = med(r["pull_p99_ms"] for r in legs["loaded"])
    loaded_last = legs["loaded"][-1]
    dlrm_off = _dlrm_run(n_pulls, cache=False)
    dlrm_on = _dlrm_run(n_pulls, cache=True)
    probe = admission_probe()
    return {
        "serve_seconds": serve_s,
        "rounds": rounds,
        "serve_samples": [sum(r["samples"] for r in legs["base"]),
                          sum(r["samples"] for r in legs["loaded"])],
        "serve_p50_uncontended_ms": round(base_p50, 3),
        "serve_p99_uncontended_ms": round(base_p99, 3),
        "serve_p50_contended_ms": round(load_p50, 3),
        "serve_p99_contended_ms": round(load_p99, 3),
        # Headline 1: the isolation guard (acceptance: <= 2.0).
        "p99_ratio": (round(load_p99 / base_p99, 2)
                      if base_p99 > 0 else None),
        "bulk_applied": loaded_last["applied"],
        "bulk_shed": loaded_last["shed"],
        "bulk_push_gbps": round(loaded_last["bulk_gbps"], 2),
        "store_exact": all(r["store_exact"] for r in legs["loaded"]),
        "dlrm_pulls": n_pulls,
        "dlrm_p50_off_ms": round(dlrm_off["pull_p50_ms"], 4),
        "dlrm_p50_on_ms": round(dlrm_on["pull_p50_ms"], 4),
        "dlrm_p99_off_ms": round(dlrm_off["pull_p99_ms"], 4),
        "dlrm_p99_on_ms": round(dlrm_on["pull_p99_ms"], 4),
        # Headline 2: the round-trip savings (acceptance: >= 5.0).
        "dlrm_p50_ratio": (
            round(dlrm_off["pull_p50_ms"] / dlrm_on["pull_p50_ms"], 2)
            if dlrm_on["pull_p50_ms"] > 0 else None),
        # Acceptance: >= 0.60 at the default cache size.
        "hit_rate": dlrm_on["hit_rate"],
        "admission_offered": probe["offered"],
        "admission_applied": probe["applied"],
        "admission_shed": probe["shed"],
        "admission_store_exact": probe["store_exact"],
    }


def _small_op_run(secs: float, batch: bool) -> dict:
    """One leg of the small_op_batching bench: a REAL 1w+1s tcp
    cluster (one process per node) running ``--mode small_op_storm``.
    The batched leg runs the combiner tuned for 4 KiB ops (256 KiB
    frame cap ~= 64-op frames); the baseline leg is ``PS_BATCH_BYTES=0``
    — frame-for-frame the pre-batching build."""
    import re
    import subprocess
    import sys

    cmd = [
        sys.executable, "-m", "pslite_tpu_torch.tracker.local",
        "-n", "1", "-s", "1", "--van", "tcp", "--",
        sys.executable, "-m", "pslite_tpu_torch.benchmark",
        "--mode", "small_op_storm", "--repeat", "1",
    ]
    env = dict(
        os.environ,
        PS_SOB_SECONDS=str(secs),
    )
    if batch:
        env.update(
            PS_BATCH_BYTES=str(256 << 10),
            PS_BATCH_MIN_OPS="256",
            PS_BATCH_HOLD_US="12000",
        )
    else:
        env["PS_BATCH_BYTES"] = "0"
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                       env=env)
    m = re.search(
        r"SMALL_OP ops=(\d+) secs=([0-9.]+) msgs_per_s=([0-9.]+) "
        r"p50_ms=([0-9.]+) p99_ms=([0-9.]+) ops_per_frame=([0-9.]+) "
        r"store_exact=(True|False)", r.stdout)
    if m is None:
        raise RuntimeError(
            f"small_op leg produced no result (rc={r.returncode}): "
            f"{r.stdout[-600:]}\n{r.stderr[-600:]}"
        )
    return {
        "ops": int(m.group(1)),
        "msgs_per_s": float(m.group(3)),
        "p50_ms": float(m.group(4)),
        "p99_ms": float(m.group(5)),
        "ops_per_frame": float(m.group(6)),
        "store_exact": m.group(7) == "True",
    }


def small_op_bench(quick: bool = True) -> dict:
    """Small-op aggregation plane (docs/batching.md) over real tcp
    processes — the ops/s counterpart of native_goodput's bytes/s.

    Headline (the acceptance): a 4 KiB-op 1w+1s push storm
    moves >= 4x more msgs/s with the combiner on (EXT_BATCH multi-op
    frames + batched server apply + one response frame per batch) than
    with ``PS_BATCH_BYTES=0``, while the LOW-LOAD sequential push p50
    stays within 1.5x of unbatched (window 0 — a lone op closes at the
    next dispatcher pickup, no timer latency) and the store ends
    bit-exact on both legs.  Legs run in INTERLEAVED rounds, medians
    reported (host drift lands symmetrically)."""
    secs = 3.0 if quick else 6.0
    rounds = 2 if quick else 3
    legs = {"batched": [], "unbatched": []}
    for _ in range(rounds):
        legs["batched"].append(_small_op_run(secs, batch=True))
        legs["unbatched"].append(_small_op_run(secs, batch=False))
    med = statistics.median
    b_rate = med(r["msgs_per_s"] for r in legs["batched"])
    u_rate = med(r["msgs_per_s"] for r in legs["unbatched"])
    b_p50 = med(r["p50_ms"] for r in legs["batched"])
    u_p50 = med(r["p50_ms"] for r in legs["unbatched"])
    return {
        "seconds": secs,
        "rounds": rounds,
        "op_bytes": 4096,
        "batched_msgs_per_s": round(b_rate, 1),
        "unbatched_msgs_per_s": round(u_rate, 1),
        # Headline: the ops/s multiple (acceptance: >= 4.0).
        "msgs_ratio": (round(b_rate / u_rate, 2) if u_rate > 0 else None),
        "ops_per_frame": med(r["ops_per_frame"] for r in legs["batched"]),
        "batched_p50_ms": round(b_p50, 3),
        "unbatched_p50_ms": round(u_p50, 3),
        # Low-load single-op latency guard (acceptance: <= 1.5).
        "low_load_p50_ratio": (round(b_p50 / u_p50, 2)
                               if u_p50 > 0 else None),
        "store_exact": all(r["store_exact"]
                           for leg in legs.values() for r in leg),
    }


def _serving_fanin_run(secs: float, batch: bool,
                       servers: int = 2) -> dict:
    """One leg of the serving_fanin bench: a REAL 1w+Ns tcp cluster
    (one process per node) running ``--mode serving_fanin``.  The
    aggregated leg runs the op combiner + response combiner tuned for
    the 64-lookup fan-out; the baseline leg is ``PS_BATCH_BYTES=0`` —
    one frame per lookup each way, the pre-fan-in build."""
    import re
    import subprocess
    import sys

    cmd = [
        sys.executable, "-m", "pslite_tpu_torch.tracker.local",
        "-n", "1", "-s", str(servers), "--van", "tcp", "--",
        sys.executable, "-m", "pslite_tpu_torch.benchmark",
        "--mode", "serving_fanin", "--repeat", "1",
    ]
    env = dict(
        os.environ,
        PS_SF_SECONDS=str(secs),
        PS_HOT_CACHE="0",  # the acceptance runs the cache COLD
    )
    if batch:
        env.update(PS_BATCH_BYTES=str(256 << 10))
    else:
        env["PS_BATCH_BYTES"] = "0"
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                       env=env)
    m = re.search(
        r"SERVING_FANIN reqs=(\d+) secs=([0-9.]+) "
        r"reqs_per_s=([0-9.]+) fanout=(\d+) servers=(\d+) "
        r"p50_ms=([0-9.]+) p99_ms=([0-9.]+) "
        r"frames_per_req=([0-9.]+) low_p50_ms=([0-9.]+) "
        r"store_exact=(True|False)", r.stdout)
    if m is None:
        raise RuntimeError(
            f"serving_fanin leg produced no result (rc={r.returncode}): "
            f"{r.stdout[-600:]}\n{r.stderr[-600:]}"
        )
    return {
        "reqs": int(m.group(1)),
        "reqs_per_s": float(m.group(3)),
        "fanout": int(m.group(4)),
        "servers": int(m.group(5)),
        "p50_ms": float(m.group(6)),
        "p99_ms": float(m.group(7)),
        "frames_per_req": float(m.group(8)),
        "low_p50_ms": float(m.group(9)),
        "store_exact": m.group(10) == "True",
    }


def serving_fanin_bench(quick: bool = True) -> dict:
    """Serving fan-in (docs/batching.md) over real tcp
    processes — multi-get + server-side response aggregation.

    Headline: the DLRM Zipf fan-out storm (64 single-row lookups per
    request, table spread across 2 servers, hot-key cache COLD) moves
    >= 3x more requests/s with the aggregation planes on
    (``PS_BATCH_BYTES=262144`` -> one EXT_BATCH frame per server each
    way via ``multi_get`` + the batched group response) than with
    ``PS_BATCH_BYTES=0``, while response frames per request land near
    the contacted-server count (~1 RTT fan-in, vs ~fanout frames
    unaggregated), the LOW-LOAD sequential single-pull p50 stays
    within 1.5x of unaggregated, and every spot-checked request is
    bit-exact on both legs.  Legs run in INTERLEAVED rounds, medians
    reported (host drift lands symmetrically)."""
    secs = 3.0 if quick else 6.0
    rounds = 2 if quick else 3
    legs = {"agg": [], "plain": []}
    for _ in range(rounds):
        legs["agg"].append(_serving_fanin_run(secs, batch=True))
        legs["plain"].append(_serving_fanin_run(secs, batch=False))
    med = statistics.median
    a_rate = med(r["reqs_per_s"] for r in legs["agg"])
    p_rate = med(r["reqs_per_s"] for r in legs["plain"])
    a_low = med(r["low_p50_ms"] for r in legs["agg"])
    p_low = med(r["low_p50_ms"] for r in legs["plain"])
    return {
        "seconds": secs,
        "rounds": rounds,
        "fanout": legs["agg"][0]["fanout"],
        "servers": legs["agg"][0]["servers"],
        "agg_reqs_per_s": round(a_rate, 1),
        "plain_reqs_per_s": round(p_rate, 1),
        # Headline: the requests/s multiple (acceptance: >= 3.0).
        "req_ratio": (round(a_rate / p_rate, 2) if p_rate > 0 else None),
        "req_p50_agg_ms": round(
            med(r["p50_ms"] for r in legs["agg"]), 3),
        "req_p50_plain_ms": round(
            med(r["p50_ms"] for r in legs["plain"]), 3),
        # ~1 RTT fan-in: response frames/request near the contacted-
        # server count (acceptance: lower is better; the plain leg
        # sits near the fan-out).
        "frames_per_req": round(
            med(r["frames_per_req"] for r in legs["agg"]), 2),
        "plain_frames_per_req": round(
            med(r["frames_per_req"] for r in legs["plain"]), 2),
        # Low-load single-pull latency guard (acceptance: <= 1.5).
        "low_load_p50_ratio": (round(a_low / p_low, 2)
                               if p_low > 0 else None),
        "store_exact": all(r["store_exact"]
                           for leg in legs.values() for r in leg),
    }


def _replica_read_run(secs: float, k: int, servers: int = 3,
                      workers: int = 3) -> dict:
    """One leg of the replica_read bench: a REAL 3w+3s tcp cluster
    (one process per node) running ``--mode replica_read`` at
    replication factor ``k``.  Three workers storm the same rank's
    range — the aggregate read demand a single primary cannot absorb.
    The k=3 leg spreads the pulls across that rank's whole chain; the
    k=1 leg is the primary-funnel baseline.  Both legs run with the
    push-stamp plane on (``PS_REPLICA_READS`` enables it server-side
    even at k=1) so the comparison prices the spread, not the
    stamps."""
    import re
    import subprocess
    import sys

    cmd = [
        sys.executable, "-m", "pslite_tpu_torch.tracker.local",
        "-n", str(workers), "-s", str(servers), "--van", "tcp", "--",
        sys.executable, "-m", "pslite_tpu_torch.benchmark",
        "--mode", "replica_read", "--repeat", "1",
    ]
    env = dict(
        os.environ,
        PS_RR_SECONDS=str(secs),
        PS_KV_REPLICATION=str(k),
        PS_REPLICA_READS="1",
        PS_HOT_CACHE="0",  # throughput must price network reads
        PS_REQUEST_TIMEOUT="5.0",
        PS_REQUEST_RETRIES="6",
    )
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                       env=env)
    ms = re.findall(
        r"REPLICA_READ reqs=(\d+) secs=([0-9.]+) "
        r"reqs_per_s=([0-9.]+) k=(\d+) servers=(\d+) "
        r"ryw_violations=(\d+) fallbacks=(\d+) spread=(\d+) "
        r"p50_ms=([0-9.]+) p99_ms=([0-9.]+) exact=(True|False)",
        r.stdout)
    if len(ms) != workers:
        raise RuntimeError(
            f"replica_read leg expected {workers} worker reports, got "
            f"{len(ms)} (rc={r.returncode}): "
            f"{r.stdout[-600:]}\n{r.stderr[-600:]}"
        )
    p50s = sorted(float(m[8]) for m in ms)
    return {
        "reqs": sum(int(m[0]) for m in ms),
        # Workers storm concurrently: the cluster rate is the sum.
        "reqs_per_s": sum(float(m[2]) for m in ms),
        "k": int(ms[0][3]),
        "servers": int(ms[0][4]),
        "ryw_violations": sum(int(m[5]) for m in ms),
        "fallbacks": sum(int(m[6]) for m in ms),
        "spread": sum(int(m[7]) for m in ms),
        "p50_ms": p50s[len(p50s) // 2],
        "p99_ms": max(float(m[9]) for m in ms),
        "exact": all(m[10] == "True" for m in ms),
    }


def namespace_flip_storm(secs: float = 2.0, rows: int = 512,
                         dim: int = 16) -> dict:
    """Live model-version publish + flip + rollback under a replica-
    read pull storm (docs/serving_reads.md): 1w+3s in-process cluster
    at k=3, a background puller hammering rank 0's range while the
    scheduler snapshots the v1 store, mutates it to v2, publishes the
    v1 manifest as a namespace, and rolls back.  Acceptance: ZERO
    failed requests, every answer bit-exact against exactly one of
    the two versions."""
    import shutil
    import tempfile
    import threading

    from .kv.kv_app import KVServer, KVServerDefaultHandle, KVWorker

    snapdir = tempfile.mkdtemp(prefix="ps_nsflip_")
    nodes = _loopback_cluster(1, 3, "nsflip", env_extra={
        "PS_KV_REPLICATION": "3",
        "PS_REPLICA_READS": "1",
        "PS_REQUEST_TIMEOUT": "2.0",
        "PS_REQUEST_RETRIES": "6",
        "PS_SNAPSHOT_DIR": snapdir,
    })
    scheduler, server_pos, worker_po = nodes[0], nodes[1:4], nodes[4]
    servers = []
    workers = []
    result: dict = {}
    try:
        for po in server_pos:
            s = KVServer(0, postoffice=po)
            s.set_request_handle(KVServerDefaultHandle())
            servers.append(s)
        w = KVWorker(0, 0, postoffice=worker_po)
        workers.append(w)
        keys = np.arange(rows, dtype=np.uint64)  # rank 0's range
        v1 = np.stack([np.full(dim, 1.0 + r, np.float32)
                       for r in range(rows)])
        w.wait(w.push(keys, v1.reshape(-1)))
        time.sleep(0.3)  # forwards land on the whole chain
        scheduler.snapshot()
        w.wait(w.push(keys, v1.reshape(-1)))  # live store is now v2
        v2 = 2 * v1
        batch = 16
        stop = threading.Event()
        errors = [0]
        pulls = [0]

        def storm():
            out = np.zeros(batch * dim, np.float32)
            i = 0
            while not stop.is_set():
                start = (i * 7) % (rows - batch)
                i += 1
                out[:] = 0
                try:
                    w.wait(w.pull(keys[start:start + batch], out))
                except Exception:
                    errors[0] += 1
                    continue
                got = out.reshape(batch, dim)
                blk1 = v1[start:start + batch]
                blk2 = v2[start:start + batch]
                if not (np.array_equal(got, blk1)
                        or np.array_equal(got, blk2)):
                    errors[0] += 1
                pulls[0] += 1

        t = threading.Thread(target=storm, daemon=True)
        t.start()
        time.sleep(min(0.5, secs / 4))
        t1 = time.perf_counter()
        scheduler.publish_model(namespace="bench", version="v1")
        flip_ms = (time.perf_counter() - t1) * 1e3
        time.sleep(min(0.5, secs / 4))
        t1 = time.perf_counter()
        scheduler.rollback_model()
        rollback_ms = (time.perf_counter() - t1) * 1e3
        time.sleep(min(0.5, secs / 4))
        stop.set()
        t.join(timeout=10)
        # Post-rollback the live (v2) store must serve bit-exact.
        out = np.zeros(batch * dim, np.float32)
        w.wait(w.pull(keys[:batch], out))
        result = {
            "ns_flip_ms": round(flip_ms, 1),
            "ns_rollback_ms": round(rollback_ms, 1),
            "ns_flip_errors": errors[0],
            "ns_flip_pulls": pulls[0],
            "ns_flip_exact": bool(
                np.array_equal(out.reshape(batch, dim), v2[:batch])),
        }
    finally:
        _teardown_cluster(nodes, workers, servers)
        shutil.rmtree(snapdir, ignore_errors=True)
    return result


def replica_read_bench(quick: bool = True) -> dict:
    """Replica read fan-out (docs/serving_reads.md) over real tcp
    processes: the read-heavy Zipf storm against one rank's range at
    k=3 (pulls spread across the whole chain, stamp-validated) vs k=1
    (every read funnels through the primary).

    Headline: k=3 moves >= 2.5x more reads/s than k=1 with ZERO
    read-your-writes violations counted by the in-storm probes, every
    spot check bit-exact.  Legs run in INTERLEAVED rounds, medians
    reported.  Plus the namespace-flip leg: a live model-version
    publish/flip/rollback under the same storm with zero failed
    requests.

    The throughput legs need real parallelism — 3 worker + 3 server
    processes all hot — so on hosts with fewer than 8 cpus they
    record a skip marker instead of an inverted ratio that only
    measures context-switch pressure (the 1-core CI container cannot
    express a spread win by construction).  The namespace-flip
    correctness leg runs everywhere."""
    out: dict = {}
    ncpu = os.cpu_count() or 1
    if ncpu < 8:
        out["skipped"] = (
            f"spread throughput needs >= 8 cpus, have {ncpu}")
    else:
        secs = 3.0 if quick else 6.0
        rounds = 2 if quick else 3
        legs = {"k3": [], "k1": []}
        for _ in range(rounds):
            legs["k3"].append(_replica_read_run(secs, k=3))
            legs["k1"].append(_replica_read_run(secs, k=1))
        med = statistics.median
        r3 = med(r["reqs_per_s"] for r in legs["k3"])
        r1 = med(r["reqs_per_s"] for r in legs["k1"])
        out = {
            "seconds": secs,
            "rounds": rounds,
            "servers": legs["k3"][0]["servers"],
            "k3_reqs_per_s": round(r3, 1),
            "k1_reqs_per_s": round(r1, 1),
            # Headline: the reads/s multiple (acceptance: >= 2.5).
            "tput_ratio": round(r3 / r1, 2) if r1 > 0 else None,
            # Correctness gate: MUST stay 0 (bench_diff fails it).
            "ryw_violations": sum(r["ryw_violations"]
                                  for leg in legs.values()
                                  for r in leg),
            "fallbacks": sum(r["fallbacks"] for r in legs["k3"]),
            "spread_reads": sum(r["spread"] for r in legs["k3"]),
            "p50_k3_ms": round(
                med(r["p50_ms"] for r in legs["k3"]), 3),
            "p50_k1_ms": round(
                med(r["p50_ms"] for r in legs["k1"]), 3),
            "exact": all(r["exact"]
                         for leg in legs.values() for r in leg),
        }
    out.update(namespace_flip_storm(secs=2.0 if quick else 3.0))
    return out


def _durable_run(n_pulls: int, ram_mb: float, rows: int,
                 dim: int) -> dict:
    """One leg of the durable_store bench: a REAL 1w+1s tcp cluster
    (one process per node) running ``--mode durable_serve``, with the
    server's store either tiered (``PS_STORE_RAM_MB`` bounding RAM to
    ~1/4 of the table) or all-RAM (0, frame-for-frame the pre-tier
    build)."""
    import re
    import subprocess
    import sys

    cmd = [
        sys.executable, "-m", "pslite_tpu_torch.tracker.local",
        "-n", "1", "-s", "1", "--van", "tcp", "--",
        sys.executable, "-m", "pslite_tpu_torch.benchmark",
        "--mode", "durable_serve", "--repeat", str(n_pulls),
    ]
    env = dict(
        os.environ,
        PS_DUR_ROWS=str(rows),
        PS_DUR_DIM=str(dim),
        PS_STORE_RAM_MB=str(ram_mb),
    )
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                       env=env)
    m = re.search(
        r"DURABLE_SERVE samples=(\d+) pull_p50_ms=([0-9.]+) "
        r"pull_p99_ms=([0-9.]+) exact=True", r.stdout)
    if m is None:
        raise RuntimeError(
            f"durable_serve leg produced no result (rc={r.returncode}): "
            f"{r.stdout[-600:]}\n{r.stderr[-600:]}"
        )
    return {
        "samples": int(m.group(1)),
        "pull_p50_ms": float(m.group(2)),
        "pull_p99_ms": float(m.group(3)),
    }


def durable_snapshot_times(n_keys: int = 512,
                           val_len: int = 1024) -> dict:
    """Snapshot/restore wall times over an in-process loopback cluster
    (docs/durability.md): push a known store, time the coordinated
    ``Postoffice.snapshot()`` cut, kill the WHOLE cluster, boot a fresh
    one with ``PS_SNAPSHOT_RESTORE=1``, time the boot restore, and
    verify the restored pulls bit-exact."""
    import tempfile

    import numpy as np

    from .kv.kv_app import KVServer, KVServerDefaultHandle, KVWorker

    snapdir = tempfile.mkdtemp(prefix="pslite_snap_bench_")
    keys = np.arange(n_keys, dtype=np.uint64)
    vals = np.random.default_rng(11).normal(
        size=n_keys * val_len).astype(np.float32)

    def boot(extra):
        env = {"PS_SNAPSHOT_DIR": snapdir}
        env.update(extra)
        nodes = _loopback_cluster(1, 1, ns=f"dur-snap-{os.getpid()}",
                                  env_extra=env)
        srv = KVServer(0, postoffice=nodes[1])
        t0 = time.perf_counter()
        srv.set_request_handle(KVServerDefaultHandle())
        restore_s = time.perf_counter() - t0
        w = KVWorker(0, 0, postoffice=nodes[2])
        return nodes, srv, w, restore_s

    out = {"keys": n_keys,
           "mb": round(n_keys * val_len * 4 / 2**20, 2)}
    nodes, srv, w, _ = boot({})
    try:
        w.wait(w.push(keys, vals))
        t0 = time.perf_counter()
        nodes[0].snapshot()
        out["snapshot_s"] = round(time.perf_counter() - t0, 3)
    finally:
        _teardown_cluster(nodes, [w], [srv])
    nodes, srv, w, restore_s = boot({"PS_SNAPSHOT_RESTORE": "1"})
    try:
        got = np.zeros_like(vals)
        w.wait(w.pull(keys, got))
        out["restore_s"] = round(restore_s, 3)
        out["restore_exact"] = bool(np.array_equal(got, vals))
    finally:
        _teardown_cluster(nodes, [w], [srv])
    import shutil

    shutil.rmtree(snapdir, ignore_errors=True)
    return out


def durable_store_bench(quick: bool = True) -> dict:
    """Durable state tier (docs/durability.md) — the acceptance, over
    real tcp processes:

    - **Beyond-RAM serving**: the DLRM Zipf single-row pull storm over
      a table ~4x larger than ``PS_STORE_RAM_MB`` must hold its
      hot-set p99 within 2x of the identical all-RAM run (legs run in
      INTERLEAVED rounds, medians reported; bit-exactness is verified
      inside the mode every 64th pull).
    - **Kill the whole cluster, restore bit-exact**: the coordinated
      snapshot + ``PS_SNAPSHOT_RESTORE=1`` boot, with both walls
      reported (``durable_restore_s`` is gated in bench_diff)."""
    rows = 512 if quick else 1024
    dim = 1024  # 4 KiB per row
    table_mb = rows * dim * 4 / 2**20
    ram_mb = max(0.25, table_mb / 4.0)
    n_pulls = 400 if quick else 1500
    rounds = 2 if quick else 3
    legs = {"ram": [], "tiered": []}
    for _ in range(rounds):
        legs["ram"].append(_durable_run(n_pulls, 0, rows, dim))
        legs["tiered"].append(_durable_run(n_pulls, ram_mb, rows, dim))
    med = statistics.median
    ram_p50 = med(r["pull_p50_ms"] for r in legs["ram"])
    ram_p99 = med(r["pull_p99_ms"] for r in legs["ram"])
    t_p50 = med(r["pull_p50_ms"] for r in legs["tiered"])
    t_p99 = med(r["pull_p99_ms"] for r in legs["tiered"])
    snap = durable_snapshot_times(
        n_keys=256 if quick else 1024)
    return {
        "rows": rows,
        "dim": dim,
        "table_mb": round(table_mb, 1),
        "ram_mb": round(ram_mb, 2),
        "rounds": rounds,
        "pulls": n_pulls,
        "hot_p50_allram_ms": round(ram_p50, 4),
        "hot_p50_tiered_ms": round(t_p50, 4),
        "hot_p99_allram_ms": round(ram_p99, 4),
        "hot_p99_tiered_ms": round(t_p99, 4),
        # Headline 1: beyond-RAM serving tax (acceptance: <= 2.0).
        "hot_p99_ratio": (round(t_p99 / ram_p99, 2)
                          if ram_p99 > 0 else None),
        "hot_p50_ratio": (round(t_p50 / ram_p50, 2)
                          if ram_p50 > 0 else None),
        # Headline 2: the kill-everything -> bit-exact boot walls.
        "snapshot_s": snap["snapshot_s"],
        "restore_s": snap["restore_s"],
        "restore_keys": snap["keys"],
        "restore_mb": snap["mb"],
        "restore_exact": snap["restore_exact"],
    }


def register_push_buffers(server, args) -> None:
    """ENABLE_RECV_BUFFER server side (test_benchmark.cc:268-320):
    pre-pin the receive buffer each worker's push slice lands in.  A
    sliced push carries this server's whole key block in ONE message
    identified by the slice's first key, so the buffer spans the block
    (num_keys * val_len values per worker)."""
    from . import postoffice
    from .base import WORKER_GROUP
    from .message import Role

    po = postoffice(Role.SERVER)
    r = po.get_server_key_ranges()[po.my_rank()]
    val_len = args.len // 4
    for wid in po.get_node_ids(WORKER_GROUP):
        server.register_recv_buffer(
            int(wid), int(r.begin),
            np.zeros(args.num_keys * val_len, np.float32),
        )


def _start_thread_cpu_sampler(role: str) -> None:
    """``PS_BENCH_RUSAGE=1``: a daemon thread prints per-thread CPU
    seconds (``/proc/self/task/*/stat``) every 2 s to stderr — Python
    threads resolved to their ``threading`` names via ``native_id``,
    native core threads by their pthread name (psl-io / psl-lane-N /
    psl-pipe).  Diagnostic only: attributes a leg's bottleneck thread
    without an external profiler (the bench children live in their own
    PID namespace on some CI hosts, so outside-in sampling can't
    see them)."""
    if not int(os.environ.get("PS_BENCH_RUSAGE", "0")):
        return
    import glob
    import sys
    import threading

    hz = os.sysconf("SC_CLK_TCK")

    def dump():
        while True:
            time.sleep(2.0)
            names = {
                t.native_id: t.name
                for t in threading.enumerate()
                if t.native_id is not None
            }
            rows = []
            for st in glob.glob("/proc/self/task/[0-9]*/stat"):
                try:
                    head, tail = open(st).read().rsplit(")", 1)
                    comm = head.split("(", 1)[1]
                    f = tail.split()
                    cpu = (int(f[11]) + int(f[12])) / hz
                    tid = int(st.split("/")[4])
                except (OSError, ValueError, IndexError):
                    continue  # thread exited mid-scan
                if cpu >= 0.05:
                    rows.append((cpu, names.get(tid, comm), tid))
            rows.sort(reverse=True)
            print(
                f"BENCH_THREAD_CPU role={role} "
                + " ".join(f"{n}:{c:.1f}s" for c, n, _ in rows[:12]),
                file=sys.stderr, flush=True,
            )

    threading.Thread(target=dump, daemon=True,
                     name="bench-rusage").start()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--len", type=int, default=1024000,
                    help="bytes per key (default 1024000)")
    ap.add_argument("--repeat", type=int, default=10)
    ap.add_argument("--mode", choices=MODES, default="push_pull")
    ap.add_argument("--num-keys", type=int,
                    default=int(os.environ.get("NUM_KEY_PER_SERVER", "40")))
    args = ap.parse_args(argv)

    from . import KVServer, finalize, start_ps

    role = os.environ["DMLC_ROLE"]
    _start_thread_cpu_sampler(role)
    start_ps()
    server = None
    if role in ("server", "joint"):
        server = KVServer(0)
        if args.mode in ("chunk_hol", "lane_goodput", "quantized_push",
                         "multi_tenant", "dlrm_serve", "serving_fanin",
                         "durable_serve", "replica_read"):
            # Shard-capable handle: the apply pool (and the streaming
            # apply of chunked pushes) is part of what these modes price.
            from .kv.kv_app import KVServerDefaultHandle

            server.set_request_handle(KVServerDefaultHandle())
        else:
            server.set_request_handle(BenchmarkHandle())
        if _recv_buffer_mode():
            register_push_buffers(server, args)
    if role in ("worker", "joint"):
        run_worker(args)
    finalize()
    if server is not None:
        if _recv_buffer_mode():
            print(f"SERVER_RECV_BUFFER_HITS {server.delivered_in_place}",
                  flush=True)
        server.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
