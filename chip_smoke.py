#!/usr/bin/env python3
"""Drive pslite_tpu_torch on one NVIDIA GPU and check it end to end.

Run from the root of a checkout, on a host with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and only a full pass prints the last
line):

1. The card: ``nvidia-smi`` name and power limit, torch's device name
   and count.
2. Build every CUDA kernel of the dense data plane from ``csrc/`` with
   nvcc and, beside it, the native transport core
   (``csrc/host/pslite_core.cc``) with g++ (its build time, library path
   and ABI stamp printed); print the build time and the ``-Xptxas -v``
   register/spill
   report (expected: no spill stores beyond a few bytes; the int8 ring's
   cluster kernel, ``ring_int8_cluster<4>``, ``<1>`` and ``<0>`` (float4,
   scalar, and per bucket), 72 bytes of static shared memory each), then
   the int8 ring's launch shape at the shapes it is timed at (cluster
   size, shared memory per CTA, co-resident clusters at each size 1-16,
   waves, scratch), the ResNet-50 trace's grouped launch included (with
   the launcher's cost of each size).
3. Kernels: each kernel at the main path's shapes (n = 8 ranks,
   P = 40 x 256,000 = 10,240,000 values; the 2-D sub-rings at dp = 4 x
   kv = 2; the int8 ring also at n = 2, where its regions spill out of
   shared memory) against its plain PyTorch version on the same inputs.
   Then the grouped ring over the ResNet-50 trace's 36 buckets (f32,
   bf16, dp = 4 x kv = 2, int8: one launch each), also against 36 single
   launches (the int8 group also at every cluster size the card runs),
   and
   ``ring_replay`` of 8 steps of the bucket (push_pull and push steps),
   also against 8 single launches: 0 differing elements everywhere.  The
   sparse row kernels at BASELINE config 5's shapes (a 1,048,576 x 64 f32
   table over 8 shards, 8 x 4,096 Zipf(1.2) rows): the sum push and the
   pull with 0 differing elements, row-wise Adagrad within rtol 1e-5 /
   atol 1e-6, each also timed with the L2 flushed before every launch,
   beside the longest run's chain of dependent adds and its SM cycles
   per add, read by the clock probe of ``pstt_sparse_walk_probe`` (a build
   of the long-run walk with ``clock64`` around each run, outside the
   push's own kernels); at the end of the run, after the steady states,
   each push split into its three kernels by the profiler (the sort, the
   long runs' walk, the short runs beside it).  The group kernels (one
   chain of three launches for every table of a ``push_group``, one
   launch for a ``pull_group``) at group (a), the embedding layer of
   facebookresearch/dlrm's Criteo Kaggle run (26 tables, 3 to 10,131,227
   rows at dim 16, 8 x 1,024 Zipf(1.2) lookups each), and (b), config 5's
   table beside the DLRM table (1,048,576 x 16): each against the
   per-table kernels (0 differing elements, row-wise Adagrad included)
   and the plain group version, beside the per-table loop's time
   (``earlier_ms``) and the hottest run's chain of adds.
   K1-K3 also on bf16 stores (0 differing elements: kernel and plain
   version round after every operation).  D1 and D2, the dense engine's
   reduce programs (``ops/reduce_update.py``), at the bucket over 8
   worker rows: D1 push_pull and push (f32), push_pull (bf16), every mode
   with 0 differing elements against the plain version; D2 with its pull
   for each optimizer (f32, bf16), 0 differing elements against the plain
   reduction followed by the K1-K3 launch and within K1-K3's tolerances of
   the all-PyTorch plain version; the trace's 36 buckets in one D1 group
   launch against the plain version and 36 single launches; each beside
   the engine's path before it (``earlier_ms``) and ``torch.sum(rows,
   0)``, the reduction alone in another order.
   ``ms`` is the mean of ITERS calls captured in one CUDA graph and
   replayed, timed with CUDA events (the host is out of the timing);
   ``ms_host`` is the mean of ITERS back-to-back Python calls (the host
   included).  Beside them: the plain version's time, the card's least
   time for the same work, and the time of one PyTorch call that
   computes the same function where there is one.
4. Main path (its paths in order; from ``codec-throughput`` on, the
   paths whose every node is a child process, ``SECOND_LANE``, run in a
   second thread beside the rest, their launches counted in their
   children): ``Postoffice("worker")`` + ``DeviceGroup(8)`` +
   ``KVWorker.push_pull``/``push``/``pull`` on the reference benchmark's
   40 x 1,024,000 B bucket under the ring (``PS_ICI_IMPL=pallas``,
   handle ``sum``, f32 and bf16, and f32 with ``PS_ICI_COMPRESS=int8``)
   and the fused optimizer handles (``adam``, ``sgd_momentum``,
   ``adagrad``, on f32 and bf16 buckets); ``CollectiveEngine`` on a ``make_group((4, 2), ("dp",
   "kv"))`` group with ``worker_axis="dp"`` for ``sum``, int8 and
   ``adam``; and an int8 quantize -> dequantize round trip of the
   bucket; K1-K3 through ``ps.ops.sgd_update``/``adam_update`` and
   ``fused_update.adagrad_update`` (f32 and bf16, 2 steps each); and
   ``KVWorker.push_pull`` with ``PS_ICI_IMPL`` unset (the torch impl, D1/D2:
   ``sum`` f32 and bf16 with a push and a pull, ``adam:1e-3``, 5 steps
   each, 0 differing elements against the plain versions on the card;
   the stateful handles above run D2 too).  Each is checked against a
   float64 numpy reference, and the ring and quantize results also
   against their plain versions on the card.  Kernel launch counts are zeroed just before and read just
   after; every kernel must have launched.  Then, with the counts zeroed
   again, the int8 ring at n = 2 (``CollectiveEngine`` on a 2-rank
   group, the spilling shape).  Then, each path with the counts zeroed
   before it: the ResNet-50 trace (BASELINE config 4: 36 buckets of 1,024
   to 1,048,576 f32 values, 8 ranks) through Postoffice/KVWorker per
   bucket, as one ``push_pull_group``, through the coalescer (36 tickets
   from 4 threads) and from host numpy grads (serial copies, and
   ``push_pull_multi_stream``'s pinned staging); the grouped bf16, 2-D
   and int8 rings over the trace and the torch impl's group (one D1
   launch); ``KVWorker.replay`` (ring keep all and last, torch: D1,
   adam: D2) against 8 sequential push_pulls; zero-copy and
   registered pulls (a stale handle must raise); the sparse tables (config
   5 through ``KVWorker.push_sparse``/``pull_sparse``, 3 steps with the sum
   handle and 3 with ``row_adagrad:0.01,1e-8``, against float64 numpy and
   each push against the plain version on the card; a
   ``push_group``/``pull_group`` of two tables against single ops; and
   ``models.embedding.replay``); the sparse groups (``sparse-groups``:
   groups (a), (b) and (c), an f32 and a bf16 table, through
   ``SparseEngine.push_group``/``pull_group``, 3 sum and 3 row-wise
   Adagrad steps, each group op's launches counted (3 per dtype, 1 for
   the pull, whatever the number of tables), every table against a twin
   pushed and pulled alone, the plain group version and float64);
   engine state that moves (``elastic``:
   the 40 x 1 MB adam bucket, a 40 x 1 MB sum bucket and config 5's
   table under row_adagrad through ``KVWorker`` on the ici van, 8 ranks:
   a ``save_engine`` restored by a fresh cluster and an
   ``AsyncEngineCheckpointer`` file against the live run and the sync
   file, a 4-rank restore against ``KVWorker.reshard`` 8 -> 4 and 3 more
   steps of both, within float64's bounds, then back to 8 and onto the
   composite ``(dp 2, kv1 2, kv2 2)`` axis against ``(dp 2, kv 4)``: 0
   differing elements everywhere; D2, K4 at n = 4 and on the composite
   sub-rings, S2 and S3 launched on the recut state; save/restore/async
   and reshard times printed with the host CPU).  The grouped int8 ring
   must count one launch per ``push_pull_group``, and the sparse kernels
   one launch per table and op.  Then the steady-state
   ``engine.push_pull`` time with device-resident grads (the ``xla/sum``
   and ``pallas/adam:1e-3`` steps must be one D1/D2 launch: no add
   kernel or device-to-device copy beside it but adam's step-size
   scalars), and the steady
   state of the trace's five paths (``resnet50-grouped-int8``: one
   ``push_pull_group`` per step under ``PS_ICI_COMPRESS=int8``) and of
   an 8-step replay (wall and event ms/step, the profiler's device time,
   host-to-device GB/s), and of config 5 through KVWorker: one push and
   one pull per step with grads on the card (``embedding-1m``), under
   ``row_adagrad`` (``embedding-1m-adagrad``) and from numpy grads
   (``embedding-1m-host``), and of each sparse group: the wall of a
   ``push_group`` + ``pull_group`` against the per-table loop.
   The message control plane, each phase with the counts zeroed before
   it, clusters started in this process with their own deadlines:
   ``msg-config2`` (BASELINE config 2's topology over the loopback van:
   1 scheduler + 2 servers + 2 workers, test_benchmark's 40 keys per
   server of 1,024,000 B, 2 warm-up and 10 timed rounds of push, worker
   barrier, pull, every pull checked exactly; the servers' apply-shard
   pool at its default, ``min(8, cores)`` shards; ms/round,
   test_benchmark's Gbit/s and the bytes each side sent per round,
   beside the card's name and power limit and the host CPU),
   ``msg-config2-serial`` (the same with ``PS_APPLY_SHARDS=0``),
   ``msg-pool-vs-serial`` (one worker's 3 pushes of normal floats and a
   pull, pool and serial stores and pulls bit-equal),
   ``msg-config2-int8``/``-fp8_e4m3``/``-bf16`` (2 warm-up and 3 timed
   rounds; both workers ``register_bucket`` the keys under the codec,
   normal floats; every
   pull within the codec's bound of the float64 sum of the pushes, each
   encode that reached it counted; a raw pull after each round gives
   the store's mean error) and ``msg-config2-int8-noef``
   (``PS_CODEC_EF=0``: error feedback must shrink the store's mean
   error), ``codec-throughput`` (encode and decode GB/s of an 81.92 MB
   f32 payload per codec, ``PS_CODEC_THREADS`` default and 1, the native
   core's kernels against numpy call by call, bit-equal),
   ``msg-ici-mixed`` (one ``KVWorker`` on an ``ici`` cluster: the 40 x
   1 MB bucket through K4 and 16 unregistered 1 MB keys over messages
   to the server under the int8 codec, 5 interleaved steps against
   float64, K4's launches and the server's keys checked) and
   ``msg-optimizer`` (``KVServerOptimizerHandle`` adam against float64).
   Then separate processes, one per node (``python3 chip_smoke.py
   --node``, roles and environment from the port's ``tracker/local.py``),
   every child under ``PROC_DEADLINE``, all killed when one fails, one
   JSON line back from each; every van on the native core unless a leg
   says ``PS_NATIVE=0``.  ``tcp-config1``, ``tcp-config2`` and
   ``shm-config3`` run a native and a Python leg, one cluster each, both
   up, 2 windows of 2 rounds alternating (``plane_legs``; 2 windows for
   ``tcp-config2``'s three planes):
   ``tcp-config1`` (BASELINE config 1, fused
   push_pull of 40 x 1,024,000 B), ``native-goodput`` (JAX's
   ``native_goodput_bench``: 1 + 1 processes, 96 pipelined pushes of 64
   MiB in 2 MiB chunks under 256 KiB socket buffers with a priority
   pull's latency sampled beside them, native against ``PS_NATIVE=0``,
   2 windows alternating, the store exact after each),
   ``tcp-config2`` (config 2, msg-config2's
   rounds at 80 x 1,024 B, 80 x 1,024,000 B and 2 x 64 MiB per worker;
   the 1 MB round also with ``DMLC_LOCAL=1``, no socket file left, and
   over ``multi``, 2 tcp rails), ``tcp-config2-pool``/``-serial``/
   ``-int8`` (the 1 MB round again with the pool at its default, the 1
   MiB chunks of each push streamed into it, with ``PS_APPLY_SHARDS=0``,
   and under the int8 codec, each pull within its bound; the servers
   count the pushes they streamed), ``shm-config3`` (config 3 on one host:
   the scheduler + 2 ``--joint`` processes over shm, registered push
   buffers and zero-copy pulls, the native leg with ``PS_SHM_RING=1``,
   no /dev/shm segment or pipe left) and
   ``ici-tcp-mixed`` (scheduler, server and an ``ici_tcp`` worker
   process, then ``ici_shm``: the bucket through K4 from device grads
   against float64 and 16 x 1 MB keys over messages; K4 counted in the
   worker process and added to the path's launches).  Every pull is
   checked exactly; each cell's ms/round and Gbit/s are printed beside
   the loopback ``msg-config2`` of the same run.
   Then the message-path tiers over tcp, one process per node: each leg
   one cluster, the two legs' clusters up at once and their 3 timed
   windows alternating (a, b, a, b, a, b) while the other idles,
   reported as medians, the windows' values and the round-by-round
   ratio:
   ``small-op-storm`` / ``-unbatched`` (1 worker + 1 server with an
   assign handle: one-key 4,096 B pushes of each op's ordinal at depth
   256 for 1 s, batched with ``PS_BATCH_BYTES=262144``,
   ``PS_BATCH_MIN_OPS=256``, ``PS_BATCH_HOLD_US=12000`` against
   ``PS_BATCH_BYTES=0``; ops/s, ops per frame, low-load push p50/p99,
   and the final pull equal to the last ordinal), ``serving-fanin`` /
   ``-unbatched`` (1 worker + 2 servers holding a 1,048,576 x 16 f32
   embedding table on the spread key layout: ``multi_get`` of 64
   Zipf(1.5) single-row lookups at depth 8 for 1 s, hot cache cold;
   requests/s, p50/p99, frames per request each way, every 32nd request
   and the last 8 bit-exact), ``hot-cache`` / ``-off`` (1 + 1, the serve
   tenant, ``dlrm_serve``'s 1,024 x 16 table: the read-only storm of
   2,000 Zipf single-row pulls, each checked exactly; p50/p99 and the
   hit rate from the frames sent; then, untimed, 32 rows each pulled,
   pushed +1 and pulled again: stale reads 0) and ``multi-tenant`` / ``-idle`` (2 workers + 1 server
   under ``PS_TENANTS=serve:8,train:1``, ``PS_TENANT_QUEUE_LIMIT=8``,
   the legs as alternating windows of one cluster: the serve worker's
   express single-row pulls while the train worker pushes 4 MiB at
   depth 12, or idles; serve p99 per leg, the bulk sheds and the bulk
   store exact at its applied count after every window), then JAX's
   admission probe (a loopback 1 + 1 at ``PS_TENANT_QUEUE_LIMIT=4``
   offered 64 pushes at once: applied, shed, store exact).
   ``msg-ici-mixed`` also runs with ``PS_BATCH_BYTES=262144`` and issues
   a ``multi_get`` of 64 single-row lookups of 64 B beside the bucket.
   Then recovery, each part with the card's name and power limit and
   the host CPU: ``recovery-keepalive`` (JAX's
   ``test_elastic.py::test_worker_crash_recovery_end_to_end`` through
   the port's launcher with keepalive: 1 scheduler, 1 server and 2
   worker processes over tcp, heartbeats 1 s / 2 s; the ``ici_tcp``
   worker, 8 ranks on cuda:0, pushes the 40 x 1 MB bucket through K4
   from device grads and 16 x 1 MB keys over messages in each life,
   exits 254 twice and finishes in its third life; each life must take
   the dead id back and launch K4, the other worker pulls until the
   store is exact; exit -> restart, restart -> the roster carrying
   ``is_recovery``, restart -> the first exact round),
   ``deadline-timeout`` (JAX's ``test_fault_tolerance.py::
   test_wait_raises_timeout_against_killed_server`` at full width: 1 +
   1 + 1 processes over tcp, heartbeats 0.3 s / 1.0 s,
   ``PS_REQUEST_TIMEOUT=0.3``, ``PS_REQUEST_RETRIES=2``, 8 pushes of the
   40 x 1 MB bucket in flight when the server process is SIGKILLed:
   every outstanding wait raises TimeoutError, none hangs, no callback
   fires; kill -> detection, kill -> the last raise) and
   ``chaos-matrix`` (JAX's ``test_chaos.py::
   test_chaos_matrix_healed_by_resender`` spec over ``chaos+tcp`` with
   ``PS_RESEND=1``: 1 worker + 2 servers in this process, 40 x 1 MB
   keys per server pushed and pulled, every pull exact, ms/round
   against a plain tcp leg, rounds alternating; the chaos counters).
   Last, ``observability`` (``drive_observability``): BASELINE config
   2 over tcp (native, 80 x 1,024,000 B per worker and round, pulls
   exact) under ``PS_TELEMETRY=0``, ``=1`` with
   ``PS_METRICS_INTERVAL=1`` and ``=1`` with ``PS_TRACE_TAIL=slow:p95,
   errors,floor:0.001``, 2 windows of 2 rounds alternating: ms/round and
   the ratio to the first leg, the wire families of one
   ``METRICS_PULL``, and the tail-kept requests' median critical-path
   stages; the ``ici_tcp`` worker under ``ENABLE_PROFILING=1`` (one
   ``push_pull`` engine event of 2 x 40.96 MB per K4 launch) with
   ``device_trace`` naming ``ring_kernel``; JAX's
   ``autopilot_bench(quick=False)`` (skew first and last window, 0
   operator actions, seconds to the rebalance, stores exact) and an
   elastic join cut at the scheduler's load hint.
   Then ``models`` (``drive_models``): the model zoo trains through the
   port's PS on 8 virtual ranks of cuda:0, each leg at the repo's own
   full width: PSFormer (``ModelConfig()``, batch 8 x seq 64,
   ``examples/train_flagship.py``'s defaults, 20 steps at lr 0.3) over
   dp 4 x sp 2 with ring attention and TP, with Ulysses, and with 8 MoE
   experts over EP; the GPipe pipeline over dp 2 x pp 4 (dim 64, 4
   layers, 2 microbatches of 2 x 32, ``examples/train_pipeline.py``, lr
   0.2); the CNN (``CNNConfig()``, dp 8, batch 64); DLRM at 1,048,576 x
   16 rows (8 workers x 1,024 examples = 4,096 lookups each, 15 steps,
   sgd and ``row_adagrad``); ``kv_train_loop`` over a loopback 1 + 1 +
   1 cluster, raw and fp8_e4m3 with error feedback, 30 steps each at
   the JAX guard's lr 0.1, the two within its 2 %.  Each leg's loss
   must fall and its K4 (``ring_push`` f32: one per PS step, the
   ``sgd`` handle for the flat stores, ``sum`` for DLRM's MLP), S1/S2
   and S3 launches must match its steps (none on the kv legs).  Each
   leg's first step holds every kernel launch it makes against the
   kernel's plain version on clones of the same inputs: K4 ``sum``, S1
   and S3 bit-exact, K4 ``sgd`` at rtol/atol 1e-6, S2 at rtol 1e-5 /
   atol 1e-6.  Each leg prints its first and last loss, ms/step by CUDA
   events and by the wall, and tokens or examples per second; on the
   dense ring leg the profiler gives the device busy share and the top
   kernels beside the model FLOPs per step.
   Then ``multiprocess`` (``tools/multiproc_phase.py``): one device
   group across worker processes (``PS_ICI_MULTIHOST=1``): 1 + 1 + 2
   processes over ``ici_tcp``, each worker 4 ranks of cuda:0; the 40 x
   1 MB bucket through K4 across processes (``ring_reduce_peers`` and
   ``ring_gather_peers`` over CUDA IPC peers), 5 ``sum`` steps each
   with 0 differing elements against the single-process K4 on all 8
   rows and its plain version, 2 adam steps (D2 on the owned pieces),
   config 5's table pushed and pulled across the processes (bit-exact
   against the single-process engine), ``KVWorker.reshard`` onto 2
   ranks per process and one more exact step; the first 2 steps over
   ``ici_shm``; the DCN tier (2 slice leaders of 4 ranks, 2 tcp
   servers; plain bit-exact, int8 within JAX's bound).  The same worker
   processes then run the group shapes beyond the 1-D ring, each held
   bit for bit against the single-process port on the same rows: a
   ``(dp 4, kv 2)`` engine (5 ``sum`` steps through the dp sub-rings
   across processes, 2 adam steps, 2 int8 steps), ``(dp 2, kv1 2, kv2
   2)`` with and without ``worker_axis`` (2 steps each), config 5's
   table on ``(kv 4, dp 2)`` (2 pushes and pulls); and an ``int8`` leg
   runs ``KVWorker.push_pull`` of the bucket under
   ``PS_ICI_COMPRESS=int8``, 5 steps.  Each new kernel's first launch is
   held against its plain version with 0 differing elements.  Its five
   kernel rows (the 1-D pair, the dp sub-rings' reduce, the int8 ring
   across processes 1-D and 2-D) join the kernels line.
5. One ``{"kernels": [...]}`` line, the nvidia-smi line, and the last
   line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import platform
import subprocess
import sys
import tempfile
import threading
import time
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N = 8
KEYS = 40
VAL_LEN = 256_000  # 1,024,000 B of f32 per key
P = KEYS * VAL_LEN
ITERS = 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
SEED = 1234


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()


def cuda_ms(fn, iters: int = ITERS, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back
    calls, from CUDA events, after a warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = ITERS, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` calls captured
    in one CUDA graph, from CUDA events around its replay: the launches'
    host cost is out of the timing.  The wrappers launch on the current
    stream, which is the capture stream inside ``torch.cuda.graph``; the
    warm-up runs there too, so what a wrapper keeps per stream (a region
    group's exchange words) exists before the capture."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def kernel_times(fn):
    """(host-free ms from graph replay, host-inclusive ms)."""
    return graph_ms(fn), cuda_ms(fn)


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the f32 rate (every kernel computes in f32)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_time(fn, *args, capturable: bool = True):
    """(ms, ms_host, note) of one PyTorch call: host-free from graph
    replay as the kernels', and host-inclusive; a call that cannot be
    captured in a CUDA graph reads its host-inclusive time in both, and
    the note says so; (None, None, reason) where the call does not run
    on this card."""
    try:
        host = cuda_ms(lambda: fn(*args))
    except (RuntimeError, NotImplementedError) as exc:
        return (None, None,
                f"{type(exc).__name__}: {str(exc).splitlines()[0][:120]}")
    if not capturable:
        return host, host, "host-inclusive: not capturable in a CUDA graph"
    return graph_ms(lambda: fn(*args)), host, None


def mismatches(got, want) -> int:
    """Elements where a kernel and its plain version (or its single
    launches) differ: none may.  They add in the same order, and the int8
    ones round ``fmaf`` once each and take the same region maxima, so an
    element off is a fault (a region or bucket boundary, say)."""
    count = int((got != want).sum())
    if count:
        worst = float((got - want).abs().max())
        raise AssertionError(f"{count} of {got.numel()} elements differ "
                             f"from the plain version, by up to {worst}")
    return count


def max_err(pairs) -> float:
    return max(float((a.float() - b.float()).abs().max()) for a, b in pairs)


def within(pairs, rtol: float, atol: float) -> bool:
    return all(
        bool(((a.float() - b.float()).abs()
              <= atol + rtol * b.float().abs()).all())
        for a, b in pairs
    )


@contextlib.contextmanager
def uncounted(*modules):
    """Launches inside the block (a comparison's plain version that
    launches a kernel of its own) leave the launch counts as they were."""
    saved = [dict(m.launches) for m in modules]
    try:
        yield
    finally:
        for m, counts in zip(modules, saved):
            m.launches.update(counts)


# -- phase 3: kernels against their plain versions ---------------------------

def kernel_phase(torch, ring, fu, qz, rt, dev):
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        grads = randn(N, P).to(dtype)
        store = randn(P).to(dtype)
        nb = dtype.itemsize
        for op, with_ag in (("ring_push_pull", True), ("ring_push", False)):
            kfn = ring.ring_push_pull if with_ag else ring.ring_push
            pfn = (ring.ring_push_pull_reference if with_ag
                   else ring.ring_push_reference)
            sk, sp = store.clone(), store.clone()
            outk, outp = kfn(grads, sk, "sum"), pfn(grads, sp, "sum")
            torch.cuda.synchronize()
            pairs = [(sk, sp)] + ([(outk, outp)] if with_ag else [])
            err = max_err(pairs)
            if err != 0.0:
                raise AssertionError(f"{op}[{tag}] sum not bit-exact: {err}")
            if dtype == torch.float32:
                # sgd:lr — the kernel's FMA vs eager rounding: rtol/atol 1e-6.
                sk, sp = store.clone(), store.clone()
                ok_ = kfn(grads, sk, "sgd:0.05"), pfn(grads, sp, "sgd:0.05")
                torch.cuda.synchronize()
                sgd_pairs = [(sk, sp)] + ([ok_] if with_ag else [])
                if not within(sgd_pairs, 1e-6, 1e-6):
                    raise AssertionError(
                        f"{op}[{tag}] sgd off by {max_err(sgd_pairs)}")
            sk, sp = store.clone(), store.clone()
            ms, ms_host = kernel_times(lambda: kfn(grads, sk, "sum"))
            plain_ms = cuda_ms(lambda: pfn(grads, sp, "sum"), iters=5,
                               warmup=1)
            nbytes = (N + (3 if with_ag else 2)) * P * nb
            b_ms, b_by = bound(nbytes, N * P)
            rows.append(dict(
                name=f"{op}[{tag}]", route="cuda",
                source="pslite_tpu_torch/csrc/ring_push_pull.cu",
                replaces="pslite_tpu/ops/ring_collective.py:445",
                max_abs_err=err, ms=ms, ms_host=ms_host, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                library_note="no single PyTorch call computes it",
            ))
        del grads, store

    rows += ring_variant_rows(torch, ring, randn)
    rows += group_rows(torch, ring, rt, randn)
    rows += replay_rows(torch, ring, randn)
    rows += quantize_rows(torch, qz, randn)
    from pslite_tpu_torch.ops import reduce_update as ru
    rows += reduce_rows(torch, ru, fu, rt, randn)

    agg = randn(P)
    store = randn(P)
    mom = randn(P)
    acc = torch.rand(P, generator=gen, device=dev)
    m = randn(P) * 0.1
    v = torch.rand(P, generator=gen, device=dev) * 0.01
    alpha = fu.adam_alpha(torch.ones(1, device=dev), 1e-3)  # step t = 1
    specs = [
        ("sgd_update", 70, (store, mom),
         lambda s: fu.sgd_update(*s, agg, lr=0.01, momentum=0.9),
         lambda s: fu.sgd_update_reference(*s, agg, 0.01, 0.9),
         5, 4, 1e-6),
        ("adagrad_update", 112, (store, acc),
         lambda s: fu.adagrad_update(*s, agg, lr=0.01),
         lambda s: fu.adagrad_update_reference(*s, agg, 0.01),
         5, 7, 1e-6),
        ("adam_update", 170, (store, m, v),
         lambda s: fu.adam_update_with_alpha(*s, agg, alpha),
         lambda s: fu.adam_update_reference(*s, agg, alpha),
         7, 12, 1e-5),
    ]
    # One PyTorch call computes K1 (momentum, dampening 0, no Nesterov,
    # not the first step) and K2 (no lr decay): the private fused
    # optimizers.  K3 has none: torch._fused_adam_ scales eps by
    # sqrt(1 - beta2^t), the TPU kernel does not.
    libs = {
        "sgd_update": lambda s: torch._fused_sgd_(
            [s[0]], [agg], [s[1]], weight_decay=0.0, momentum=0.9, lr=0.01,
            dampening=0.0, nesterov=False, maximize=False,
            is_first_step=False),
        "adagrad_update": lambda s: torch._fused_adagrad_(
            [s[0]], [agg], [s[1]], [torch.ones((), device=dev)], lr=0.01,
            lr_decay=0.0, weight_decay=0.0, eps=1e-8, maximize=False),
    }
    for name, line, state, kfn, pfn, words, flops, rtol in specs:
        sk = tuple(t.clone() for t in state)
        sp = tuple(t.clone() for t in state)
        kfn(sk)
        pfn(sp)
        torch.cuda.synchronize()
        pairs = list(zip(sk, sp))
        err = max_err(pairs)
        if not within(pairs, rtol, 1e-6):
            raise AssertionError(f"{name} off by {err} (rtol {rtol})")
        ms, ms_host = kernel_times(lambda: kfn(sk))
        plain_ms = cuda_ms(lambda: pfn(sp), iters=5, warmup=1)
        lib_ms, lib_host = None, None
        why = "no single PyTorch call computes it"
        if name in libs:
            sl = tuple(t.clone() for t in state)
            lib_ms, lib_host, why = library_time(libs[name], sl)
        b_ms, b_by = bound(words * 4 * P, flops * P)
        rows.append(dict(
            name=name, route="cuda",
            source="pslite_tpu_torch/csrc/fused_update.cu",
            replaces=f"pslite_tpu/ops/fused_update.py:{line}",
            max_abs_err=err, ms=ms, ms_host=ms_host, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            library_ms_host=lib_host, library_note=why,
        ))
    # K1-K3 on bf16 buckets (store and state bf16, adam's step f32): one
    # bf16 rounding per operation in kernel and plain version alike, so
    # 0 differing elements; the bound counts 2 bytes per value.
    bf = torch.bfloat16
    agg, store, mom, acc, m, v = (t.to(bf) for t in (agg, store, mom, acc,
                                                     m, v))
    specs = [(name + "_bf16", line, tuple(t.to(bf) for t in state), kfn,
              pfn, words, flops)
             for name, line, state, kfn, pfn, words, flops, _ in (
                 ("sgd_update", 70, (store, mom),
                  lambda s: fu.sgd_update(*s, agg, lr=0.01, momentum=0.9),
                  lambda s: fu.sgd_update_reference(*s, agg, 0.01, 0.9),
                  5, 4, 0),
                 ("adagrad_update", 112, (store, acc),
                  lambda s: fu.adagrad_update(*s, agg, lr=0.01),
                  lambda s: fu.adagrad_update_reference(*s, agg, 0.01),
                  5, 7, 0),
                 ("adam_update", 170, (store, m, v),
                  lambda s: fu.adam_update_with_alpha(*s, agg, alpha),
                  lambda s: fu.adam_update_reference(*s, agg, alpha),
                  7, 12, 0))]
    libs = {
        "sgd_update_bf16": lambda s: torch._fused_sgd_(
            [s[0]], [agg], [s[1]], weight_decay=0.0, momentum=0.9, lr=0.01,
            dampening=0.0, nesterov=False, maximize=False,
            is_first_step=False),
        "adagrad_update_bf16": lambda s: torch._fused_adagrad_(
            [s[0]], [agg], [s[1]], [torch.ones((), device=dev)], lr=0.01,
            lr_decay=0.0, weight_decay=0.0, eps=1e-8, maximize=False),
    }
    for name, line, state, kfn, pfn, words, flops in specs:
        sk = tuple(t.clone() for t in state)
        sp = tuple(t.clone() for t in state)
        kfn(sk)
        pfn(sp)
        torch.cuda.synchronize()
        err = max_err(list(zip(sk, sp)))
        for a, b in zip(sk, sp):
            mismatches(a, b)
        ms, ms_host = kernel_times(lambda: kfn(sk))
        plain_ms = cuda_ms(lambda: pfn(sp), iters=5, warmup=1)
        lib_ms, lib_host = None, None
        why = "no single PyTorch call computes it"
        if name in libs:
            sl = tuple(t.clone() for t in state)
            lib_ms, lib_host, why = library_time(libs[name], sl)
        b_ms, b_by = bound(words * 2 * P, flops * P)
        rows.append(dict(
            name=name, route="cuda",
            source="pslite_tpu_torch/csrc/fused_update.cu",
            replaces=f"pslite_tpu/ops/fused_update.py:{line}",
            max_abs_err=err, ms=ms, ms_host=ms_host, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            library_ms_host=lib_host, library_note=why,
        ))
    return rows


# The int8 push_pull at 2 ranks, whose regions spill to scratch; its
# launches are counted in its own main-path phase (drive_int8_spill).
SPILL_ROW = "ring_push_pull_int8[float32,n=2]"


def ring_variant_rows(torch, ring, randn):
    """The int8 ring (1-D, 8 ranks, push_pull and push; and push_pull at
    2 ranks, where each region spills out of shared memory) and the 2-D
    sub-rings (dp = 4 x kv = 2, uncompressed and int8) at P values,
    each against its plain version.  Bytes: n grads rows read, the
    store read and written, pulled written: (n+3)*4P, (n+2)*4P for a
    push (the int8 payload never crosses a link on one card)."""
    rows = []
    specs = [  # (name, ranks, kv_shards, compress, with_ag)
        ("ring_push_pull_int8[float32]", N, None, True, True),
        ("ring_push_int8[float32]", N, None, True, False),
        ("ring_push_pull_2d[float32]", 4, 2, False, True),
        ("ring_push_pull_2d_int8[float32]", 4, 2, True, True),
        (SPILL_ROW, 2, None, True, True),
    ]
    for name, n, kv, compress, with_ag in specs:
        grads = randn(n, P)
        store = randn(P)
        kw = dict(compress=compress, kv_shards=kv)
        kfn = ring.ring_push_pull if with_ag else ring.ring_push
        pfn = (ring.ring_push_pull_reference if with_ag
               else ring.ring_push_reference)
        sk, sp = store.clone(), store.clone()
        outk, outp = kfn(grads, sk, "sum", **kw), pfn(grads, sp, "sum", **kw)
        torch.cuda.synchronize()
        pairs = [(sk, sp)] + ([(outk, outp)] if with_ag else [])
        err = max_err(pairs)
        if compress:
            for a, b in pairs:
                mismatches(a, b)
        elif err != 0.0:
            raise AssertionError(f"{name} not bit-exact: {err}")
        extra = (int8_shapes_timed(torch, ring, grads, store, n, kv,
                                   with_ag, sp, outp) if compress else {})
        sk, sp = store.clone(), store.clone()
        ms, ms_host = kernel_times(lambda: kfn(grads, sk, "sum", **kw))
        plain_ms = cuda_ms(lambda: pfn(grads, sp, "sum", **kw), iters=3,
                           warmup=1)
        b_ms, b_by = bound((n + (3 if with_ag else 2)) * P * 4, n * P)
        rows.append(dict(
            name=name, route="cuda",
            source=("pslite_tpu_torch/csrc/ring_int8.cu" if compress
                    else "pslite_tpu_torch/csrc/ring_push_pull.cu"),
            replaces="pslite_tpu/ops/ring_collective.py:445",
            max_abs_err=err, ms=ms, ms_host=ms_host, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            library_note="no single PyTorch call computes it", **extra,
        ))
        del grads, store, sk, sp, outk, outp
    return rows


def int8_timed_shapes(ring, nregions: int, active: dict):
    """The launch shapes an int8 row is timed at: one cluster per region
    at each size the card runs, and at each size the largest region
    group that fits the card at once (and half of it)."""
    out = []
    for c in ring.INT8_CLUSTERS:
        if not active.get(c):
            continue
        out.append((c, 1))
        g = min(max(ring.INT8_GROUPS), active[c] // nregions)
        out += [(c, x) for x in sorted({g, g // 2}, reverse=True) if x > 1]
    return out


def int8_shapes_timed(torch, ring, grads, store, n, kv, with_ag, sp, outp):
    """An int8 row's launch shape (cluster, groups, waves) and its
    host-free time at each of ``int8_timed_shapes``, each forced and held
    against the plain version's store ``sp`` and pulled ``outp`` (0
    differing elements)."""
    shape = ring.int8_launch_shape(n, P, kv_shards=kv)
    geo = ring.ring_geometry(n, P, torch.float32, True, True, kv)
    by = {}
    for c, g in int8_timed_shapes(ring, shape["nregions"],
                                  shape["max_active_clusters"]):
        sk = store.clone()
        out = torch.empty_like(sk) if with_ag else None
        ring._launch_int8([grads], [sk], [out], [geo], 0, 0.0, with_ag,
                          (c, g))
        torch.cuda.synchronize()
        mismatches(sk, sp)
        if with_ag:
            mismatches(out, outp)
        by[f"{c}x{g}"] = graph_ms(lambda: ring._launch_int8(
            [grads], [sk], [out], [geo], 0, 0.0, with_ag, (c, g)), iters=5)
        del sk, out
    return dict(cluster=shape["cluster"], groups=shape["groups"],
                waves=shape["waves"], nregions=shape["nregions"],
                ms_by_shape=by)


def quantize_rows(torch, qz, randn):
    """K5 and K6 (both scale forms) at P values against their plain
    versions.  Bytes: quantize reads 4P and writes 1P of codes and 4P of
    lane-replicated scales; dequantize reads 1P + 4P ([R, 128] scales)
    or 1P + 4P/128 ([R] scales) and writes 4P."""
    x = randn(P) * 10
    qk, sk = qz.quantize_int8(x)
    qp, sp = qz.quantize_int8_reference(x)
    torch.cuda.synchronize()
    if not (torch.equal(qk, qp) and torch.equal(sk, sp)):
        raise AssertionError("quantize_int8 not bit-exact")
    rows_ = sk.shape[0]
    compact = sk[:, 0].contiguous()
    ms, ms_host = kernel_times(lambda: qz.quantize_int8(x))
    plain_ms = cuda_ms(lambda: qz.quantize_int8_reference(x), iters=5,
                       warmup=1)
    b_ms, b_by = bound(9 * P, 2 * P)
    out = [dict(
        name="quantize_int8", route="cuda",
        source="pslite_tpu_torch/csrc/quantize_int8.cu",
        replaces="pslite_tpu/ops/quantize.py:97", max_abs_err=0.0, ms=ms,
        ms_host=ms_host, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None,
        library_note="no PyTorch call finds the absmax scales and "
                     "quantizes in one call",
    )]
    # The library yardstick of the compact form: torch's per-channel
    # qint8 tensor of the same codes (scales per row, zero points 0),
    # dequantized.
    try:
        qt = torch.quantize_per_channel(
            qz.dequantize_int8_reference(qk, compact, rows_ * 128).view(
                rows_, 128),
            compact.double(), torch.zeros(rows_, dtype=torch.int64,
                                          device=x.device), 0, torch.qint8)
        lib = (torch.dequantize, qt)
    except (RuntimeError, NotImplementedError) as exc:
        lib = (None, f"{type(exc).__name__}: {str(exc).splitlines()[0][:120]}")
    for name, scales, nbytes in (("dequantize_int8", sk, 9 * P),
                                 ("dequantize_int8[compact]", compact,
                                  5 * P + 4 * rows_)):
        yk = qz.dequantize_int8(qk, scales, P)
        yp = qz.dequantize_int8_reference(qk, scales, P)
        torch.cuda.synchronize()
        if not torch.equal(yk, yp):
            raise AssertionError(f"{name} not bit-exact")
        ms, ms_host = kernel_times(lambda: qz.dequantize_int8(qk, scales, P))
        plain_ms = cuda_ms(lambda: qz.dequantize_int8_reference(qk, scales,
                                                                P),
                           iters=5, warmup=1)
        lib_ms, lib_host = None, None
        why = "no PyTorch call takes lane-replicated scales"
        if name.endswith("[compact]"):
            lib_ms, lib_host, why = (
                library_time(*lib, capturable=False) if lib[0] is not None
                else (None, None, lib[1]))
        b_ms, b_by = bound(nbytes, P)
        out.append(dict(
            name=name, route="cuda",
            source="pslite_tpu_torch/csrc/quantize_int8.cu",
            replaces="pslite_tpu/ops/quantize.py:129", max_abs_err=0.0,
            ms=ms, ms_host=ms_host, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms, library_ms_host=lib_host,
            library_note=why,
        ))
    return out


def trace_pads(rt, shards: int):
    """The ResNet-50 trace's 36 bucket lengths, each padded to a multiple
    of ``shards`` as the engine pads it."""
    return [-(-n // shards) * shards for _, n in rt.make_buckets()]


def group_rows(torch, ring, rt, randn):
    """The grouped ring over the ResNet-50 trace's 36 buckets (8 ranks;
    2-D dp = 4 x kv = 2): f32, bf16, the 2-D sub-rings, and int8 (one
    cluster launch over every bucket's regions).  Each against its plain
    version and against 36 single launches: 0 differing elements.  ``ms``
    is host-free (graph replay), ``ms_host`` the call with its host cost;
    ``singles_*`` the 36 single launches the group replaces.  The int8
    group also: its launch shape (cluster size, waves) and its host-free
    time at every cluster size the card runs, each forced, each with 0
    differing elements against the chosen size.  Bytes: (n+3)*P*itemsize
    over the trace's P values."""
    rows = []
    specs = [  # (name, ranks, kv_shards, compress, dtype)
        ("ring_push_pull_group[float32]", N, None, False, torch.float32),
        ("ring_push_pull_group[bfloat16]", N, None, False, torch.bfloat16),
        ("ring_push_pull_group_2d[float32]", 4, 2, False, torch.float32),
        ("ring_push_pull_group_int8[float32]", N, None, True, torch.float32),
    ]
    for name, n, kv, compress, dtype in specs:
        pads = trace_pads(rt, kv or n)
        grads = [randn(n, p).to(dtype) for p in pads]
        stores = [randn(p).to(dtype) for p in pads]
        kw = dict(compress=compress, kv_shards=kv)
        sk, sp, s1 = ([s.clone() for s in stores] for _ in range(3))
        outk = ring.ring_push_pull_group(grads, sk, "sum", **kw)
        outp = ring.ring_push_pull_group_reference(grads, sp, "sum", **kw)
        out1 = [ring.ring_push_pull(g, s, "sum", **kw)
                for g, s in zip(grads, s1)]
        torch.cuda.synchronize()
        # Against the plain version, then against the single launches.
        off_plain = sum(mismatches(a, b) for a, b in
                        list(zip(outk, outp)) + list(zip(sk, sp)))
        off_single = sum(mismatches(a, b) for a, b in
                         list(zip(outk, out1)) + list(zip(sk, s1)))
        del outk, outp, out1, sp, s1
        ms, ms_host = kernel_times(
            lambda: ring.ring_push_pull_group(grads, sk, "sum", **kw))
        single_ms, single_host = kernel_times(
            lambda: [ring.ring_push_pull(g, s, "sum", **kw)
                     for g, s in zip(grads, sk)])
        sp = [s.clone() for s in stores]
        plain_ms = cuda_ms(
            lambda: ring.ring_push_pull_group_reference(grads, sp, "sum",
                                                        **kw),
            iters=2, warmup=1)
        total = sum(pads)
        b_ms, b_by = bound((n + 3) * total * dtype.itemsize, n * total)
        extra = int8_group_sizes(torch, ring, grads, stores, pads) \
            if compress else {}
        rows.append(dict(
            name=name, route="cuda",
            source=("pslite_tpu_torch/csrc/ring_int8.cu" if compress
                    else "pslite_tpu_torch/csrc/ring_push_pull.cu"),
            replaces="pslite_tpu/ops/ring_collective.py:445",
            max_abs_err=0.0, ms=ms, ms_host=ms_host, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            library_note="no PyTorch call walks a ring",
            buckets=len(pads), values=total, singles_ms=single_ms,
            singles_ms_host=single_host, elements_off_plain=off_plain,
            elements_off_singles=off_single, **extra,
        ))
        del grads, stores, sk, sp
    return rows


def int8_group_sizes(torch, ring, grads, stores, pads):
    """The grouped int8 launch over the trace at every cluster size the
    card runs, forced: host-free ms per size, each store equal to the
    launcher's own choice's (0 differing elements), and the launch shape
    (chosen size, waves, the launcher's cost of each size)."""
    layout = ring.int8_layout(N, pads)
    shape = ring.int8_launch_shape(N, pads)
    geos = [geo for geo, _ in layout]
    ms_by = {}
    for c in ring.INT8_CLUSTERS:
        if not shape["max_active_clusters"][c]:
            continue
        sc = [s.clone() for s in stores]
        outs = [torch.empty_like(s) for s in sc]
        ring._launch_int8(grads, sc, outs, geos, 0, 0.0, True, c)
        want = [s.clone() for s in stores]
        ring.ring_push_pull_group(grads, want, "sum", compress=True)
        torch.cuda.synchronize()
        for a, b in zip(sc, want):
            mismatches(a, b)
        ms_by[c] = graph_ms(lambda: ring._launch_int8(
            grads, sc, outs, geos, 0, 0.0, True, c))
        del sc, outs, want
    return dict(cluster=shape["cluster"], waves=shape["waves"],
                nregions=shape["nregions"], ms_by_cluster=ms_by,
                cost_by_cluster=shape["cost"])


REPLAY_STEPS = 8


def replay_rows(torch, ring, randn):
    """ring_replay: T = 8 steps of the 40 x 1 MB bucket (8 ranks) in one
    call, push_pull steps (keep="all") and push steps (keep="last"),
    against T single launches and the plain version (0 differing
    elements).  ``ms`` is one call of T steps; ``ms_per_step`` beside
    it.  Bytes: T*(n+3)*4P, T*(n+2)*4P for push steps."""
    rows = []
    grads = randn(REPLAY_STEPS, N, P)
    store = randn(P)
    for keep, name in (("all", "ring_replay_push_pull[float32]"),
                       ("last", "ring_replay_push[float32]")):
        sk, ss, sp = store.clone(), store.clone(), store.clone()
        out = ring.ring_replay(grads, sk, "sum", keep=keep)
        single = ring.ring_push_pull if keep == "all" else ring.ring_push
        seq = [single(grads[t], ss, "sum") for t in range(REPLAY_STEPS)]
        plain = ring.ring_replay_reference(grads, sp, "sum", keep=keep)
        torch.cuda.synchronize()
        pairs = [(sk, ss), (sk, sp)]
        if keep == "all":
            pairs += [(out, torch.stack(seq)), (out, plain)]
        for a, b in pairs:
            mismatches(a, b)
        del out, seq, plain, ss
        ms, ms_host = kernel_times(
            lambda: ring.ring_replay(grads, sk, "sum", keep=keep))
        plain_ms = cuda_ms(
            lambda: ring.ring_replay_reference(grads, sp, "sum", keep=keep),
            iters=2, warmup=1)
        words = N + (3 if keep == "all" else 2)
        b_ms, b_by = bound(REPLAY_STEPS * words * P * 4,
                           REPLAY_STEPS * N * P)
        rows.append(dict(
            name=name, route="cuda",
            source="pslite_tpu_torch/csrc/ring_push_pull.cu",
            replaces="pslite_tpu/ops/ring_collective.py:445",
            max_abs_err=0.0, ms=ms, ms_host=ms_host, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            library_note="no PyTorch call walks a ring",
            steps=REPLAY_STEPS, ms_per_step=ms / REPLAY_STEPS,
            ms_host_per_step=ms_host / REPLAY_STEPS,
            bound_ms_per_step=b_ms / REPLAY_STEPS,
        ))
        del sk, sp
    del grads, store
    return rows


REDUCE_SRC = "pslite_tpu_torch/csrc/reduce_update.cu"
LIBRARY_SUM = "torch.sum(rows, 0): the reduction alone, in another order"
D2_SPECS = {  # kind: (params, rtol of K1-K3, flops per value)
    "sgd_momentum": ((0.01, 0.9), 1e-6, 4),
    "adagrad": ((0.01, 1e-8), 1e-6, 7),
    "adam": ((0.9, 0.999, 1e-8), 1e-5, 12),
}


def _lib(torch, grads):
    """``library_*`` of a reduce row: one ``torch.sum`` over the rows."""
    ms, host, why = library_time(torch.sum, grads, 0)
    return dict(library_ms=ms, library_ms_host=host,
                library_note=LIBRARY_SUM + (f"; {why}" if why else ""))


def reduce_rows(torch, ru, fu, rt, randn):
    """D1 and D2 (``ops/reduce_update.py``) at the main path's shapes:
    the 40 x 1 MB bucket over 8 worker rows (D1 push_pull and push on
    f32, push_pull on bf16; D2 with its pull for each optimizer, f32 and
    bf16) and the ResNet-50 trace's 36 buckets in one D1 group launch.
    D1 against its plain version (every mode): 0 differing elements.  D2
    against the plain reduction followed by the K1-K3 launch
    (``fused=True``): 0 differing elements; and against the all-PyTorch
    plain version within K1-K3's tolerances (bf16: 0 differing there
    too), which gives ``max_abs_err``.  ``earlier_ms`` is the time of the
    engine's path before this kernel (the plain reduction, then the
    handle or the K1-K3 launch, then the pulled copy).  The group also
    against 36 single D1 launches (``singles_*``).  ``library_ms`` is one
    ``torch.sum(rows, 0)``, the reduction alone in another order (none
    for the group: no one call reduces 36 buckets).  Bytes: (W+3)*P*b for
    a push_pull, (W+2)*P*b for a push, (W+5)*P*b for sgd_momentum and
    adagrad with the pull, (W+7)*P*b for adam."""
    rows = []
    for dtype, with_pull in ((torch.float32, True), (torch.float32, False),
                             (torch.bfloat16, True)):
        tag = str(dtype).replace("torch.", "")
        grads = randn(N, P).to(dtype)
        store = randn(P).to(dtype)
        pk = torch.empty_like(store) if with_pull else None
        pp = torch.empty_like(store) if with_pull else None
        off = 0
        for handle in ("assign", "sgd:0.05", "sum"):
            sk, sp = store.clone(), store.clone()
            ru.reduce_apply(grads, sk, handle, pk)
            ru.reduce_apply_reference(grads, sp, handle, pp)
            torch.cuda.synchronize()
            off += mismatches(sk, sp) + (mismatches(pk, pp) if with_pull
                                         else 0)
        ms, ms_host = kernel_times(
            lambda: ru.reduce_apply(grads, sk, "sum", pk))
        plain_ms = cuda_ms(
            lambda: ru.reduce_apply_reference(grads, sp, "sum", pp),
            iters=5, warmup=1)
        b_ms, b_by = bound((N + (3 if with_pull else 2)) * P
                           * dtype.itemsize, N * P)
        rows.append(dict(
            name=f"reduce_{'push_pull' if with_pull else 'push'}[{tag}]",
            route="cuda", source=REDUCE_SRC,
            replaces="pslite_tpu/parallel/engine.py:84-109,408",
            max_abs_err=0.0, ms=ms, ms_host=ms_host, plain_ms=plain_ms,
            earlier_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            elements_off_plain=off, **_lib(torch, grads)))
        del grads, store, sk, sp, pk, pp

    pads = trace_pads(rt, N)
    grads = [randn(N, p) for p in pads]
    stores = [randn(p) for p in pads]
    sk, sp, s1 = ([s.clone() for s in stores] for _ in range(3))
    outk = ru.reduce_group(grads, sk, "sum")
    outp = [torch.empty_like(s) for s in sp]
    out1 = [torch.empty_like(s) for s in s1]
    for g, s, o in zip(grads, sp, outp):
        ru.reduce_apply_reference(g, s, "sum", o)
    for g, s, o in zip(grads, s1, out1):
        ru.reduce_apply(g, s, "sum", o)
    torch.cuda.synchronize()
    off_plain = sum(mismatches(a, b) for a, b in
                    list(zip(outk, outp)) + list(zip(sk, sp)))
    off_single = sum(mismatches(a, b) for a, b in
                     list(zip(outk, out1)) + list(zip(sk, s1)))
    ms, ms_host = kernel_times(lambda: ru.reduce_group(grads, sk, "sum"))
    single_ms, single_host = kernel_times(
        lambda: [ru.reduce_apply(g, s, "sum", o)
                 for g, s, o in zip(grads, s1, out1)])
    plain_ms = cuda_ms(lambda: [ru.reduce_apply_reference(g, s, "sum", o)
                                for g, s, o in zip(grads, sp, outp)],
                       iters=2, warmup=1)
    total = sum(pads)
    b_ms, b_by = bound((N + 3) * total * 4, N * total)
    rows.append(dict(
        name="reduce_push_pull_group[float32]", route="cuda",
        source=REDUCE_SRC, replaces="pslite_tpu/parallel/engine.py:1333",
        max_abs_err=0.0, ms=ms, ms_host=ms_host, plain_ms=plain_ms,
        earlier_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        library_note=f"no one PyTorch call reduces {len(pads)} buckets' rows",
        buckets=len(pads), values=total, singles_ms=single_ms,
        singles_ms_host=single_host, elements_off_plain=off_plain,
        elements_off_singles=off_single))
    del grads, stores, sk, sp, s1, outk, outp, out1

    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        grads = randn(N, P).to(dtype)
        store = randn(P).to(dtype)
        mom = randn(P).to(dtype)
        pos = randn(P).abs().to(dtype)
        alpha = fu.adam_alpha(torch.ones(1, device=store.device), 1e-3)
        for kind, (params, rtol, flops) in D2_SPECS.items():
            state = {"sgd_momentum": (mom,), "adagrad": (pos,),
                     "adam": ((0.1 * mom).to(dtype),
                              (0.01 * pos).to(dtype))}[kind]
            runs = []
            for fused in (None, True, False):
                st = tuple(t.clone() for t in state)
                s, p = store.clone(), torch.empty_like(store)
                if fused is None:
                    ru.reduce_update(grads, s, st, kind, params, alpha, p)
                else:
                    ru.reduce_update_reference(grads, s, st, kind, params,
                                               alpha, p, fused=fused)
                runs.append((s, p) + st)
            torch.cuda.synchronize()
            off = sum(mismatches(a, b) for a, b in zip(runs[0], runs[1]))
            pairs = list(zip(runs[0], runs[2]))
            if dtype == torch.bfloat16:
                off += sum(mismatches(a, b) for a, b in pairs)
            elif not within(pairs, rtol, 1e-6):
                raise AssertionError(f"reduce_{kind}[{tag}] off the plain "
                                     f"version by {max_err(pairs)}")
            err = max_err(pairs)
            (sk, pk, *stk), (sf, pf, *stf), (sp, pp, *stp) = runs
            ms, ms_host = kernel_times(lambda: ru.reduce_update(
                grads, sk, stk, kind, params, alpha, pk))
            earlier_ms = cuda_ms(lambda: ru.reduce_update_reference(
                grads, sf, stf, kind, params, alpha, pf, fused=True),
                iters=5, warmup=1)
            plain_ms = cuda_ms(lambda: ru.reduce_update_reference(
                grads, sp, stp, kind, params, alpha, pp), iters=5, warmup=1)
            words = N + (7 if kind == "adam" else 5)
            b_ms, b_by = bound(words * P * dtype.itemsize, (N + flops) * P)
            rows.append(dict(
                name=f"reduce_{kind}[{tag}]", route="cuda",
                source=REDUCE_SRC,
                replaces="pslite_tpu/parallel/engine.py:754",
                max_abs_err=err, ms=ms, ms_host=ms_host, plain_ms=plain_ms,
                earlier_ms=earlier_ms, bound_ms=b_ms, bound_by=b_by,
                elements_off_plain=off, **_lib(torch, grads)))
            del runs, sk, pk, stk, sf, pf, stf, sp, pp, stp
        del grads, store, mom, pos
    return rows


# -- phase 4: the main path through the user's entry points ------------------

def _adam_ref(s, st, g, t, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
              eps_hat=False):
    """Step t of float64 Adam on numpy arrays or tensors (``st`` holds m
    and v): K3's form, eps added to sqrt(v), or with ``eps_hat`` the
    host optimizer handle's, eps added to sqrt(v / (1 - b2^t))."""
    st["m"] = b1 * st["m"] + (1 - b1) * g
    st["v"] = b2 * st["v"] + (1 - b2) * g * g
    c2 = np.sqrt(1 - b2 ** t)
    alpha = lr * c2 / (1 - b1 ** t)
    return s - alpha * st["m"] / (st["v"] ** 0.5 + (eps * c2 if eps_hat
                                                   else eps))


def _sgdm_ref(s, st, g, t, lr=0.01, mu=0.9):
    st["m"] = mu * st["m"] + g
    return s - lr * st["m"]


def _adagrad_ref(s, st, g, t, lr=0.01, eps=1e-8):
    st["m"] = st["m"] + g * g
    return s - lr * g / (np.sqrt(st["m"]) + eps)


def _sum_ref(s, st, g, t):
    return s + g


def drive(torch, ps, Environment, grads_steps):
    """Run every configuration through Postoffice/KVWorker, each checked
    against its float64 reference; returns per-configuration results."""
    keys = np.arange(KEYS, dtype=np.uint64)
    # (label, handle, dtype, push_pull steps, also push+pull, reference,
    #  rtol, atol, unit roundoff u).  A sum's tolerance grows by
    # (N+1)*u*sum|g| per op: each of the N hops and the store add rounds
    # once to the dtype, by at most u of its partial sum.
    configs = [
        ("ring sum f32", "sum", "float32", 5, True, _sum_ref, 0, 1e-6,
         2.0 ** -24),
        ("adam f32", "adam:1e-3", "float32", 5, False, _adam_ref, 1e-5, 1e-6,
         0),
        ("sgd_momentum f32", "sgd_momentum:0.01,0.9", "float32", 2, False,
         _sgdm_ref, 1e-5, 1e-5, 0),
        ("adagrad f32", "adagrad:0.01", "float32", 2, False, _adagrad_ref,
         1e-5, 1e-5, 0),
        ("ring sum bf16", "sum", "bfloat16", 2, True, _sum_ref, 0, 1e-3,
         2.0 ** -8),
        # bf16 stateful buckets (K1-K3 on bf16): held within 2^-6 of the
        # value plus lr x the update magnitudes so far (|m| for
        # sgd_momentum, 2 per step for adam and adagrad, whose steps are
        # about lr): each step rounds m, v, the quotient's terms and the
        # store to bf16, 2^-9 relative each.
        ("adam bf16", "adam:1e-3", "bfloat16", 3, False, _adam_ref, 0, 0,
         0),
        ("sgd_momentum bf16", "sgd_momentum:0.01,0.9", "bfloat16", 2, False,
         _sgdm_ref, 0, 0, 0),
        ("adagrad bf16", "adagrad:0.01", "bfloat16", 2, False, _adagrad_ref,
         0, 0, 0),
    ]
    results = []
    for (label, handle, dtype, steps, with_push, ref, rtol, atol,
         unit) in configs:
        env = Environment({"PS_VAN_TYPE": "ici", "PS_ICI_IMPL": "pallas",
                           "PS_ICI_SERVER_HANDLE": handle})
        po = ps.Postoffice("worker", env=env)
        po.van.set_mesh(ps.DeviceGroup(N))
        po.start()
        worker = ps.KVWorker(0, 0, postoffice=po)
        worker.register_dense("grads", keys, VAL_LEN,
                              dtype=getattr(torch, dtype))
        s64 = np.zeros(P)
        st = {"m": np.zeros(P), "v": np.zeros(P)}
        outs = np.zeros(P, np.float32)
        worst = 0.0
        mag = np.zeros(P)  # running sum of |g| over the ops so far
        bf16_opt = dtype == "bfloat16" and not unit
        lr = float(handle.split(":")[1].split(",")[0]) if bf16_opt else 0.0
        bmag = np.zeros(P)  # bf16 optimizers: update magnitudes so far
        seq = [("push_pull", k) for k in range(steps)]
        if with_push:
            seq.append(("push", steps))
        for op, k in seq:
            g = grads_steps[k]
            if dtype == "bfloat16":
                gt = torch.from_numpy(g).to(torch.bfloat16)
                g64 = gt.double().numpy()
                g_in = gt
            else:
                g64 = g.astype(np.float64)
                g_in = g
            if unit:
                agg = g64.sum(0)
            elif bf16_opt:
                # The engine's aggregate: f32 rank-order sum, one bf16
                # rounding.
                acc32 = gt[0].float().clone()
                for w in range(1, N):
                    acc32 += gt[w].float()
                agg = acc32.to(torch.bfloat16).double().numpy()
            else:
                # Optimizers: the float64 update of the engine's own f32
                # rank-order aggregate.  A float64 sum would differ where
                # the 8 rows nearly cancel, and Adam/Adagrad's first step
                # (about lr*sign(g)) turns that into an error of order lr.
                agg = g[0].copy()
                for w in range(1, N):
                    agg += g[w]
                agg = agg.astype(np.float64)
            s64 = ref(s64, st, agg, k + 1)
            mag += np.abs(g64).sum(0)
            if op == "push_pull":
                worker.wait(worker.push_pull(keys, g_in, outs))
            else:
                worker.wait(worker.push(keys, g_in))
                outs[:] = 0
                worker.wait(worker.pull(keys, outs))
            err = np.abs(outs.astype(np.float64) - s64)
            worst = max(worst, float(err.max()))
            if bf16_opt:
                bmag += np.abs(st["m"]) if "sgd_momentum" in handle else 2.0
                tol = 2.0 ** -6 * (np.abs(s64) + lr * bmag)
            else:
                tol = (atol + rtol * np.abs(s64)
                       + _sum_bound((k + 1) * (N + 1), mag, unit))
            if not np.all(err <= tol):
                raise AssertionError(
                    f"{label}: {op} step {k} off the float64 reference by "
                    f"{float(err.max())} (rtol {rtol}, atol {atol}, u {unit})")
            if not np.all(np.isfinite(outs)):
                raise AssertionError(f"{label}: non-finite output")
        results.append({"config": label, "ops": len(seq),
                        "max_abs_err_vs_f64": worst})
        worker.stop()
        po.finalize()
    return results


def _check_int8(label, op, k, out64, s64, bound_sum):
    """The int8 main path against float64: within the summed error
    bound of tests/test_ring_collective.py:172-177 and a relative error
    below 0.05, as the JAX test's."""
    err = float(np.abs(out64 - s64).max())
    rel = err / float(np.abs(s64).max())
    if not (err < bound_sum and rel < 0.05) or not np.all(np.isfinite(out64)):
        raise AssertionError(f"{label}: {op} step {k} off float64 by {err} "
                             f"(bound {bound_sum}, relative {rel})")
    return err, rel


@contextlib.contextmanager
def int8_process_env():
    """``PS_ICI_COMPRESS=int8`` in the process environment (where the
    engine reads it when it is built), restored afterwards."""
    saved = os.environ.get("PS_ICI_COMPRESS")
    os.environ["PS_ICI_COMPRESS"] = "int8"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("PS_ICI_COMPRESS")
        else:
            os.environ["PS_ICI_COMPRESS"] = saved


def int8_worker_postoffice(ps, Environment, handle: str = "sum"):
    """A started worker Postoffice on 8 ranks whose engine runs the int8
    ring (``PS_ICI_IMPL=pallas``, ``PS_ICI_COMPRESS=int8``)."""
    with int8_process_env():
        po = ps.Postoffice("worker", env=Environment({
            "PS_VAN_TYPE": "ici", "PS_ICI_IMPL": "pallas",
            "PS_ICI_SERVER_HANDLE": handle}))
        po.van.set_mesh(ps.DeviceGroup(N))
        po.start()
    return po


def drive_int8(torch, ps, ring, Environment, grads_steps):
    """KVWorker under PS_ICI_IMPL=pallas PS_ICI_COMPRESS=int8 on the
    40 x 1 MB bucket, 8 ranks: 3 push_pulls, a push, a pull.  Each op is
    checked against float64 and against the plain version on the card
    (the engine's store before the op, the same grads)."""
    keys = np.arange(KEYS, dtype=np.uint64)
    po = int8_worker_postoffice(ps, Environment)
    worker = ps.KVWorker(0, 0, postoffice=po)
    eng = worker.engine
    if eng.wire_compress != "int8":
        raise AssertionError("PS_ICI_COMPRESS=int8 did not reach the engine")
    worker.register_dense("grads", keys, VAL_LEN)
    s64 = np.zeros(P)
    outs = np.zeros(P, np.float32)
    bound_sum, worst, worst_rel, differ = 0.0, 0.0, 0.0, 0
    for op, k in [("push_pull", 0), ("push_pull", 1), ("push_pull", 2),
                  ("push", 3)]:
        g = grads_steps[k]
        before = eng.store_array("grads")
        g_dev = torch.from_numpy(g).cuda()
        bound_sum += float(2 * N * (np.abs(g).max() * N
                                    + np.abs(s64).max()) / 127)
        s64 = s64 + g.astype(np.float64).sum(0)
        if op == "push_pull":
            worker.wait(worker.push_pull(keys, g, outs))
            want = ring.ring_push_pull_reference(g_dev, before, "sum",
                                                 compress=True)
        else:
            worker.wait(worker.push(keys, g))
            want = ring.ring_push_reference(g_dev, before, "sum",
                                            compress=True)
            outs[:] = 0
            worker.wait(worker.pull(keys, outs))
        got = torch.from_numpy(outs.copy()).cuda()
        differ += mismatches(got, want)
        err, rel = _check_int8("ring int8 f32", op, k, outs.astype(np.float64),
                               s64, bound_sum)
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
    worker.stop()
    po.finalize()
    return {"config": "ring int8 f32 (KVWorker)", "ops": 5,
            "max_abs_err_vs_f64": worst, "max_rel_err_vs_f64": worst_rel,
            "error_bound": bound_sum, "elements_off_plain": differ}


def drive_int8_spill(torch, ps, ring, grads_steps):
    """CollectiveEngine with wire_compress="int8" on a 2-rank group over
    the 40 x 1 MB bucket: 2 push_pulls, a push, a pull.  Its regions
    (2,560,000 values) are longer than a cluster holds, so each CTA's
    slice spills to scratch.  Each op against the plain version on the
    card (0 elements may differ) and against float64."""
    n = 2
    keys = np.arange(KEYS, dtype=np.uint64)
    eng = ps.CollectiveEngine(ps.DeviceGroup(n), impl="pallas",
                              wire_compress="int8")
    eng.register_dense("grads", keys, VAL_LEN)
    s64 = np.zeros(P)
    bound_sum, worst, differ = 0.0, 0.0, 0
    for k, op in enumerate(["push_pull", "push_pull", "push"]):
        g = grads_steps[k][:n]
        g_dev = torch.from_numpy(g).cuda()
        before = eng.store_array("grads")
        bound_sum += float(2 * n * (np.abs(g).max() * n
                                    + np.abs(s64).max()) / 127)
        s64 = s64 + g.astype(np.float64).sum(0)
        if op == "push_pull":
            out = eng.push_pull("grads", g)
            want = ring.ring_push_pull_reference(g_dev, before, "sum",
                                                 compress=True)
        else:
            eng.push("grads", g)
            out = eng.pull("grads")
            want = ring.ring_push_reference(g_dev, before, "sum",
                                            compress=True)
        torch.cuda.synchronize()
        if tuple(out.shape) != (P,):
            raise AssertionError(f"int8 n=2: bad result {out.shape}")
        differ += mismatches(out, want)
        err, _ = _check_int8("ring int8 n=2", op, k,
                             out.double().cpu().numpy(), s64, bound_sum)
        worst = max(worst, err)
    eng.block()
    return {"config": "ring int8 f32 n=2 (CollectiveEngine, spilling)",
            "ops": 4, "max_abs_err_vs_f64": worst, "error_bound": bound_sum,
            "elements_off_plain": differ}


def drive_2d(torch, ps, ring, grads_steps):
    """CollectiveEngine on make_group((4, 2), ("dp", "kv")) with
    worker_axis="dp" and the ring impl, on the 40 x 1 MB bucket: sum and
    int8 (2 push_pulls, a push, a pull) and adam:1e-3 (2 push_pulls),
    each against float64; the ring ops also against their plain version
    on the card."""
    A, B = 4, 2
    keys = np.arange(KEYS, dtype=np.uint64)
    group = ps.make_group((A, B), ("dp", "kv"))
    results = []
    for label, handle, compress, ops in (
            ("2-D sum", "sum", None, ["push_pull", "push_pull", "push"]),
            ("2-D int8", "sum", "int8", ["push_pull", "push_pull", "push"]),
            ("2-D adam", "adam:1e-3", None, ["push_pull", "push_pull"])):
        eng = ps.CollectiveEngine(group, worker_axis="dp", impl="pallas",
                                  server_handle=handle,
                                  wire_compress=compress)
        eng.register_dense("grads", keys, VAL_LEN)
        s64 = np.zeros(P)
        st = {"m": np.zeros(P), "v": np.zeros(P)}
        mag = np.zeros(P)
        bound_sum, worst, differ = 0.0, 0.0, 0
        for k, op in enumerate(ops):
            g = grads_steps[k][:A]
            g_dev = torch.from_numpy(g).cuda()
            before = eng.store_array("grads")
            if handle == "sum":
                bound_sum += float(2 * A * (np.abs(g).max() * A
                                            + np.abs(s64).max()) / 127)
                s64 = s64 + g.astype(np.float64).sum(0)
            else:
                agg = g[0].copy()
                for w in range(1, A):
                    agg += g[w]
                s64 = _adam_ref(s64, st, agg.astype(np.float64), k + 1)
            mag += np.abs(g.astype(np.float64)).sum(0)
            kw = dict(compress=compress == "int8", kv_shards=B)
            if op == "push_pull":
                out = eng.push_pull("grads", g)
                want = (ring.ring_push_pull_reference(g_dev, before, "sum",
                                                      **kw)
                        if handle == "sum" else None)
            else:
                eng.push("grads", g)
                out = eng.pull("grads")
                want = (ring.ring_push_reference(g_dev, before, "sum", **kw)
                        if handle == "sum" else None)
            torch.cuda.synchronize()
            if tuple(out.shape) != (P,) or out.device.type != eng.device.type:
                raise AssertionError(f"{label}: bad result {out.shape}")
            if want is not None:
                if compress:
                    differ += mismatches(out, want)
                elif not torch.equal(out, want):
                    raise AssertionError(f"{label}: {op} differs from the "
                                         f"plain version")
            out64 = out.double().cpu().numpy()
            if compress:
                err, _ = _check_int8(label, op, k, out64, s64, bound_sum)
            else:
                err = float(np.abs(out64 - s64).max())
                if handle == "sum":
                    tol = 1e-6 + (k + 1) * (A + 1) * 2.0 ** -24 * mag
                else:
                    tol = 1e-6 + 1e-5 * np.abs(s64)
                if not np.all(np.abs(out64 - s64) <= tol):
                    raise AssertionError(f"{label}: {op} step {k} off "
                                         f"float64 by {err}")
            worst = max(worst, err)
        r = {"config": f"{label} (dp=4 x kv=2)", "ops": len(ops)
             + ops.count("push"), "max_abs_err_vs_f64": worst}
        if compress:
            r.update(error_bound=bound_sum, elements_off_plain=differ)
        results.append(r)
        eng.block()
    return results


def drive_quantize(torch, ps, qz, grads_steps):
    """ps.ops.quantize_int8 -> dequantize_int8 round trip of the bucket
    (one worker's grads), with [R, 128] and [R] scales: within half a
    step of the input (float64), and equal to the plain versions."""
    x = torch.from_numpy(grads_steps[0][0]).cuda()
    q, s = ps.ops.quantize_int8(x)
    y = ps.ops.dequantize_int8(q, s, P)
    yc = ps.ops.dequantize_int8(q, s[:, 0], P)
    qp, sp = qz.quantize_int8_reference(x)
    torch.cuda.synchronize()
    if not (torch.equal(q, qp) and torch.equal(s, sp) and torch.equal(y, yc)
            and torch.equal(y, qz.dequantize_int8_reference(qp, sp, P))):
        raise AssertionError("quantize round trip differs from the plain "
                             "versions")
    x64 = grads_steps[0][0].astype(np.float64)
    y64 = y.double().cpu().numpy()
    step = s.reshape(-1)[:P].double().cpu().numpy()
    err = np.abs(y64 - x64)
    if tuple(y.shape) != (P,) or not np.all(
            err <= 0.5 * step + np.spacing(np.abs(y64).astype(np.float32))):
        raise AssertionError(f"quantize round trip off by {err.max()}")
    return {"config": "int8 quantize -> dequantize", "ops": 3,
            "max_abs_err_vs_f64": float(err.max())}


def drive_fused_ops(torch, ps, fu, grads_steps):
    """The fused optimizer updates K1-K3 through their public entry
    points (``ps.ops.sgd_update``, ``ps.ops.adam_update``,
    ``ops.fused_update.adagrad_update``) on the bucket, f32 and bf16, 2
    steps each on the rank-order sum of the 8 rows: against float64 (f32
    rtol/atol 1e-5; bf16 within 2^-6 of the value plus lr x the update
    magnitudes so far, as ``drive`` holds the bf16 buckets)."""
    specs = (("sgd_update", _sgdm_ref, 0.01,
              lambda s, st, g, t: ps.ops.sgd_update(s, st[0], g, lr=0.01,
                                                    momentum=0.9)),
             ("adagrad_update", _adagrad_ref, 0.01,
              lambda s, st, g, t: fu.adagrad_update(s, st[0], g, lr=0.01)),
             ("adam_update", _adam_ref, 1e-3,
              lambda s, st, g, t: ps.ops.adam_update(s, st[0], st[1], g, t,
                                                     lr=1e-3)))
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, ref, lr, op in specs:
            store = torch.zeros(P, dtype=dtype, device="cuda")
            state = tuple(torch.zeros_like(store) for _ in range(2))
            s64, st = np.zeros(P), {"m": np.zeros(P), "v": np.zeros(P)}
            bmag, worst = np.zeros(P), 0.0
            for t in (1, 2):
                g = torch.from_numpy(grads_steps[t]).cuda().to(dtype)
                agg = g[0].float().clone()
                for w in range(1, N):
                    agg += g[w].float()
                agg = agg.to(dtype)
                op(store, state, agg, t)
                s64 = ref(s64, st, agg.double().cpu().numpy(), t)
                got = store.double().cpu().numpy()
                err = np.abs(got - s64)
                if dtype == torch.float32:
                    tol = 1e-5 + 1e-5 * np.abs(s64)
                else:
                    bmag += np.abs(st["m"]) if name == "sgd_update" else 2.0
                    tol = 2.0 ** -6 * (np.abs(s64) + lr * bmag)
                if not (np.all(np.isfinite(got)) and np.all(err <= tol)):
                    raise AssertionError(f"ps.ops {name} {dtype}: step {t} "
                                         f"off float64 by {err.max()}")
                worst = max(worst, float(err.max()))
            results.append({"config": f"ps.ops {name} {dtype}", "ops": 2,
                            "max_abs_err_vs_f64": worst})
    return results


def drive_default_impl(torch, ps, ru, fu, Environment, grads_steps):
    """``KVWorker.push_pull`` with ``PS_ICI_IMPL`` unset (the torch impl:
    D1/D2) on the 40 x 1 MB bucket, 8 ranks: ``sum`` f32 and bf16 (5
    push_pulls, then a push and a pull) and ``adam:1e-3`` (5 push_pulls),
    each pulled value equal to the plain versions run beside it on the
    card (the reduction, then the handle or the K3 launch: 0 differing
    elements), their launches left out of the counts."""
    keys = np.arange(KEYS, dtype=np.uint64)
    results = []
    for handle, dtype in (("sum", torch.float32), ("sum", torch.bfloat16),
                          ("adam:1e-3", torch.float32)):
        po = ps.Postoffice("worker", env=Environment({
            "PS_VAN_TYPE": "ici", "PS_ICI_SERVER_HANDLE": handle}))
        po.van.set_mesh(ps.DeviceGroup(N))
        po.start()
        worker = ps.KVWorker(0, 0, postoffice=po)
        if worker.engine.impl != "torch":
            raise AssertionError(f"PS_ICI_IMPL unset ran {worker.engine.impl}")
        worker.register_dense("grads", keys, VAL_LEN, dtype=dtype)
        store = torch.zeros(P, dtype=dtype, device="cuda")
        m, v = torch.zeros_like(store), torch.zeros_like(store)
        step = torch.zeros(1, device="cuda")
        outs = torch.zeros(P, dtype=dtype)
        ops = ["push_pull"] * 5 + (["push"] if handle == "sum" else [])
        differ = 0
        for k, op in enumerate(ops):
            g = torch.from_numpy(grads_steps[k]).to(dtype)
            if op == "push_pull":
                worker.wait(worker.push_pull(keys, g, outs))
            else:
                worker.wait(worker.push(keys, g))
                worker.wait(worker.pull(keys, outs))
            with uncounted(ru, fu):
                rows = g.cuda()
                if handle == "sum":
                    ru.reduce_apply_reference(rows, store, "sum")
                else:
                    alpha = fu.adam_alpha(step[:1] + 1.0, 1e-3, 0.9, 0.999,
                                          device=store.device)
                    ru.reduce_update_reference(
                        rows, store, (m, v), "adam", (0.9, 0.999, 1e-8),
                        alpha, fused=True)
                    step += 1.0
            differ += mismatches(outs, store.cpu())
        results.append({"config": f"KVWorker.push_pull PS_ICI_IMPL unset "
                                  f"{handle} {dtype} (D1/D2)",
                        "ops": len(ops) + ops.count("push"),
                        "elements_off_plain": differ})
        worker.stop()
        po.finalize()
    return results


def _sum_bound(adds, mag, unit=2.0 ** -24):
    """How far a float sum may stray from float64: every one of its
    ``adds`` adds (n + 1 for an op of n rows into the store) rounds once
    by at most ``unit`` of its partial sum, which is at most ``mag``, the
    sum of |g| over all the ops so far."""
    return adds * unit * mag


def _check_sum(label, got, s64, mag, k, n, unit=2.0 ** -24, atol=1e-6):
    """A ring sum of k ops of n rows each against float64, within
    :func:`_sum_bound` (+ atol)."""
    got64 = np.asarray(got, dtype=np.float64)
    err = np.abs(got64 - s64)
    if got64.shape != s64.shape or not np.all(np.isfinite(got64)):
        raise AssertionError(f"{label}: bad result {got64.shape}")
    if not np.all(err <= atol + _sum_bound(k * (n + 1), mag, unit)):
        raise AssertionError(f"{label}: off the float64 reference by "
                             f"{float(err.max())}")
    return float(err.max())


def trace_grads(rt, seed: int, rows: int = N):
    """Seeded host gradients for the ResNet-50 trace: one [rows, n] f32
    array per bucket."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((rows, n), dtype=np.float32)
            for _, n in rt.make_buckets()]


def drive_resnet(torch, ps, Environment, rt, host):
    """The ResNet-50 trace (36 buckets, 8 ranks, ring sum) through
    Postoffice/KVWorker: per-bucket ``KVWorker.push_pull``, one
    ``push_pull_group`` of the 36 buckets, the coalescer with 36 tickets
    from 4 threads, and the host-origin paths (36 push_pulls of numpy
    grads, and ``push_pull_multi_stream`` with pinned staging).  Each op
    adds the same grads, so after op k every bucket holds k*sum(g): each
    result is checked against that in float64."""
    env = Environment({"PS_VAN_TYPE": "ici", "PS_ICI_IMPL": "pallas",
                       "PS_ICI_SERVER_HANDLE": "sum"})
    po = ps.Postoffice("worker", env=env)
    po.van.set_mesh(ps.DeviceGroup(N))
    po.start()
    worker = ps.KVWorker(0, 0, postoffice=po)
    eng = worker.engine
    buckets = rt.make_buckets()
    names = [name for name, _ in buckets]
    keys = [np.array([i], np.uint64) for i in range(len(buckets))]
    for k, (name, n) in zip(keys, buckets):
        worker.register_dense(name, k, n)
    sum64 = [g.astype(np.float64).sum(0) for g in host]
    mag = [np.abs(g).astype(np.float64).sum(0) for g in host]
    dev = [torch.from_numpy(g).cuda() for g in host]
    results = []

    def check(label, k, outs):
        worst = max(_check_sum(f"{label} {name}", o, k * s, m, k, N)
                    for name, o, s, m in zip(names, outs, sum64, mag))
        results.append({"config": f"resnet50 {label} (36 buckets)",
                        "ops": len(names), "max_abs_err_vs_f64": worst})

    outs = [np.zeros(n, np.float32) for _, n in buckets]
    for k, g, o in zip(keys, host, outs):
        worker.wait(worker.push_pull(k, g, o))
    check("per-bucket KVWorker.push_pull", 1, outs)

    pulled = eng.push_pull_group(names, dev)
    check("grouped push_pull_group", 2, [p.cpu().numpy() for p in pulled])

    tickets = {}
    with worker.coalescer(window_us=5_000) as disp:
        def issue(tid):
            for i in range(tid, len(names), 4):
                tickets[names[i]] = disp.push_pull(names[i], dev[i])

        threads = [threading.Thread(target=issue, args=(t,))
                   for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        got = [tickets[n].result().cpu().numpy() for n in names]
    check("coalescer (4 threads)", 3, got)

    got = [eng.push_pull(n, g).cpu().numpy() for n, g in zip(names, host)]
    check("host-origin serial", 4, got)
    got = [p.cpu().numpy() for p in eng.push_pull_multi_stream(
        zip(names, host), depth=2)]
    check("host-origin stream (pinned, copy stream)", 5, got)
    worker.stop()
    po.finalize()
    return results


def drive_groups(torch, ps, rt, host):
    """``push_pull_group`` of the 36 trace buckets on the other grouped
    configurations: bf16 (8 ranks), the 2-D sub-rings (dp = 4 x kv = 2),
    int8 (8 ranks) and the torch impl (8 ranks: one D1 launch over the
    36 buckets, JAX's _group_program off the ring), two steps each,
    against float64 (int8: within the summed error bound, relative error
    < 0.05)."""
    names = [name for name, _ in rt.make_buckets()]
    results = []
    for label, group, waxis, dtype, compress, impl in (
            ("bf16", ps.DeviceGroup(N), None, torch.bfloat16, None,
             "pallas"),
            ("2-D dp4xkv2", ps.make_group((4, 2), ("dp", "kv")), "dp",
             torch.float32, None, "pallas"),
            ("int8", ps.DeviceGroup(N), None, torch.float32, "int8",
             "pallas"),
            ("torch impl", ps.DeviceGroup(N), None, torch.float32, None,
             "xla")):
        eng = ps.CollectiveEngine(group, impl=impl, worker_axis=waxis,
                                  wire_compress=compress)
        rows = eng.num_workers
        grads = [torch.from_numpy(g[:rows]).cuda().to(dtype) for g in host]
        for (name, n) in rt.make_buckets():
            eng.register_dense(name, np.arange(1, dtype=np.uint64), n,
                               dtype=dtype)
        g64 = [g.double().sum(0).cpu().numpy() for g in grads]
        mag = [g.double().abs().sum(0).cpu().numpy() for g in grads]
        amax = [float(g.float().abs().max()) for g in grads]
        worst, bound_sum = 0.0, [0.0] * len(names)
        for k in (1, 2):
            pulled = eng.push_pull_group(names, grads)
            for i, (name, p) in enumerate(zip(names, pulled)):
                got = p.double().cpu().numpy()
                if compress:
                    bound_sum[i] += 2 * rows * (amax[i] * rows + (k - 1)
                                                * amax[i] * rows) / 127
                    err, _ = _check_int8(f"group int8 {name}", "push_pull",
                                         k, got, k * g64[i], bound_sum[i])
                else:
                    unit = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -24
                    err = _check_sum(f"group {label} {name}", got,
                                     k * g64[i], mag[i], k, rows, unit)
                worst = max(worst, err)
        results.append({"config": f"push_pull_group {label} (36 buckets)",
                        "ops": 2 * len(names), "max_abs_err_vs_f64": worst})
        eng.block()
        del eng, grads
    return results


def drive_replay(torch, ps, Environment, dev_steps):
    """``KVWorker.replay`` of T = 8 steps on the 40 x 1 MB bucket (8
    ranks): the ring with keep "all" and "last", the torch path, and adam;
    each result equal to T sequential push_pulls of a second worker (0
    differing elements)."""
    keys = np.arange(KEYS, dtype=np.uint64)
    results = []
    for label, impl, handle, keep in (
            ("ring keep=all", "pallas", "sum", "all"),
            ("ring keep=last", "pallas", "sum", "last"),
            ("torch keep=all", "xla", "sum", "all"),
            ("adam keep=all", "pallas", "adam:1e-3", "all")):
        workers = []
        for _ in range(2):
            po = ps.Postoffice("worker", env=Environment({
                "PS_VAN_TYPE": "ici", "PS_ICI_IMPL": impl,
                "PS_ICI_SERVER_HANDLE": handle}))
            po.van.set_mesh(ps.DeviceGroup(N))
            po.start()
            w = ps.KVWorker(0, 0, postoffice=po)
            w.register_dense("grads", keys, VAL_LEN)
            workers.append((po, w))
        (po_a, wa), (po_b, wb) = workers
        got = wa.replay("grads", dev_steps, keep=keep)
        seq = [wb.engine.push_pull("grads", dev_steps[t])
               for t in range(REPLAY_STEPS)]
        want = torch.stack(seq) if keep == "all" else seq[-1]
        torch.cuda.synchronize()
        if tuple(got.shape) != tuple(want.shape):
            raise AssertionError(f"replay {label}: shape {tuple(got.shape)}")
        results.append({"config": f"KVWorker.replay {label} (T = "
                                  f"{REPLAY_STEPS})", "ops": REPLAY_STEPS,
                        "elements_off_sequential": mismatches(got, want)})
        for po, w in workers:
            w.stop()
            po.finalize()
        del got, seq, want
    return results


def drive_zero_copy(torch, ps, Environment, grads_steps):
    """Zero-copy and registered pulls through the user's entry points:
    ``push_pull(zero_copy=True)`` on a 1-rank group returns a handle on
    the store's memory (same address) with the right values, which the
    next push_pull makes stale (a use raises, ``is_deleted()``); a
    registered pull buffer on the 8-rank ring receives every
    ``KVWorker.pull`` at one address, each pull's handle stale after the
    next."""
    keys = np.arange(KEYS, dtype=np.uint64)
    eng = ps.CollectiveEngine(ps.DeviceGroup(1), impl="xla")
    eng.register_dense("z", keys, VAL_LEN)
    want, mag, worst = np.zeros(P), np.zeros(P), 0.0
    prev = None
    for k in range(2):
        g = grads_steps[k][:1]
        out = eng.push_pull("z", g, zero_copy=True)
        want = want + g[0].astype(np.float64)
        mag = mag + np.abs(g[0]).astype(np.float64)
        if out.data_ptr() != eng._stores["z"].data_ptr():
            raise AssertionError("zero_copy push_pull did not return the "
                                 "store")
        worst = max(worst, _check_sum("zero-copy push_pull",
                                      out.cpu().numpy(), want, mag, k + 1,
                                      1))
        if prev is not None:
            expect_stale(prev, "zero-copy push_pull")
        prev = out
    po = ps.Postoffice("worker", env=Environment({
        "PS_VAN_TYPE": "ici", "PS_ICI_IMPL": "pallas",
        "PS_ICI_SERVER_HANDLE": "sum"}))
    po.van.set_mesh(ps.DeviceGroup(N))
    po.start()
    worker = ps.KVWorker(0, 0, postoffice=po)
    worker.register_dense("grads", keys, VAL_LEN)
    prev = worker.register_pull_buffer("grads")
    addr = prev.data_ptr()
    s64, mag, outs = np.zeros(P), np.zeros(P), np.zeros(P, np.float32)
    for k in range(2):
        g = grads_steps[k]
        worker.wait(worker.push(keys, g))
        worker.wait(worker.pull(keys, outs))
        s64 = s64 + g.astype(np.float64).sum(0)
        mag = mag + np.abs(g).astype(np.float64).sum(0)
        live = worker.engine.pinned_pull_buffer("grads")
        if live.data_ptr() != addr:
            raise AssertionError("the registered pull buffer moved")
        expect_stale(prev, "registered pull buffer")
        prev = live
        worst = max(worst,
                    _check_sum("registered pull buffer", outs, s64, mag,
                               k + 1, N),
                    _check_sum("registered pull buffer (device)",
                               live.cpu().numpy(), s64, mag, k + 1, N))
    worker.stop()
    po.finalize()
    return [{"config": "zero-copy push_pull (1 rank) + registered pull "
                       "buffer (8 ranks)", "ops": 6,
             "max_abs_err_vs_f64": worst}]


def expect_stale(handle, label):
    """A handle replaced by its bucket's next op reports
    ``is_deleted()`` and raises on use, as a donated JAX array."""
    if not handle.is_deleted():
        raise AssertionError(f"{label}: a replaced handle is not deleted")
    try:
        handle.cpu()
    except RuntimeError:
        return
    raise AssertionError(f"{label}: a stale handle did not raise")


# Idle time, in seconds, at each end of the recorded window of
# device_breakdown's attempts, one entry per attempt.
PROFILE_PADS = (0.01, 0.05, 0.2, 0.5, 1.0)


def launch_offsets(prof):
    """(launches with no kernel event, least kernel start minus its
    launch's start in µs) of a profiled window, from its Chrome trace:
    a negative offset is the device clock read earlier than the host's."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    launch, kernel = {}, {}
    for ev in events:
        corr = (ev.get("args") or {}).get("correlation")
        if corr is None:
            continue
        if ev.get("cat") == "kernel":
            kernel[corr] = float(ev["ts"])
        elif (ev.get("cat") == "cuda_runtime"
              and "LaunchKernel" in ev.get("name", "")):
            launch[corr] = float(ev["ts"])
    offsets = [kernel[c] - t for c, t in launch.items() if c in kernel]
    return (sum(c not in kernel for c in launch),
            min(offsets) if offsets else None)


def device_breakdown(torch, step, iters: int = 5, attempts: int = 5):
    """torch.profiler over ``iters`` steps: (device-busy ms per step,
    [(kernel, ms per step)] by time).  The kernels run on one stream, so
    their times add.  (The profiler slows the host, so the busy share is
    taken against an unprofiled step's wall time, not this window's.)
    The profiler drops a device event that its clock places outside the
    recorded window, and an H100 has lost the first kernel of a window
    of the ring's 5 steps in five windows in a row, a warm-up step
    traced and discarded before them or not.  So the recorded window is
    padded with idle host time at both ends, ``PROFILE_PADS[i]`` seconds
    in attempt i.  A window whose device events do not each come in
    multiples of ``iters`` is profiled again (the rule of
    ``tools/harness_phase.py``'s ``traced_measure``); each such window is
    reported with its launches that have no kernel event and its least
    kernel-minus-launch start, and ``attempts`` incomplete windows
    raise."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    lost = []
    for attempt in range(attempts):
        pad = PROFILE_PADS[min(attempt, len(PROFILE_PADS) - 1)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1,
                                       active=iters)) as prof:
            step()
            # The warm-up step's kernels end before recording starts.
            torch.cuda.synchronize()
            prof.step()
            time.sleep(pad)
            for _ in range(iters):
                step()
            torch.cuda.synchronize()
            time.sleep(pad)
        kernels, counts = [], []
        for ev in prof.key_averages():
            # Kernel events only: an aten op's self device time repeats
            # the time of the kernels it launched, and the schedule's
            # step annotation spans them.
            if (ev.device_type == DeviceType.CUDA and ev.self_device_time_total
                    and not ev.key.startswith("ProfilerStep")):
                kernels.append((ev.key[:60],
                                ev.self_device_time_total / iters / 1e3))
                counts.append((ev.key[:60], ev.count))
        kernels.sort(key=lambda kv: -kv[1])
        busy_ms = sum(ms for _, ms in kernels)
        if busy_ms > 0 and all(c % iters == 0 for _, c in counts):
            return busy_ms, kernels
        missing, offset_us = launch_offsets(prof)
        lost.append({"pad_s": pad, "counts": counts,
                     "launches_without_kernel": missing,
                     "least_kernel_minus_launch_us": offset_us})
        print(f"device_breakdown: window {attempt + 1} of {iters} steps "
              f"incomplete: {lost[-1]}", file=sys.stderr, flush=True)
    raise AssertionError(f"the profiler lost device events in {attempts} "
                         f"windows of {iters} steps: {lost}")


def copy_ms(kernels) -> float:
    """The device time of memory copies and sets in a breakdown (they run
    on the copy stream beside the kernels in the host-origin cells)."""
    return sum(ms for k, ms in kernels if k.startswith(("Memcpy", "Memset")))


def steady_state(torch, ps):
    """ms/step and goodput of iterated engine.push_pull with grads
    already on the device (bench.py's _measure loop), and where the
    device time of a step goes."""
    out = []
    cells = [  # (label, impl, handle, group, worker_axis, wire_compress)
        ("pallas/sum", "pallas", "sum", None, None, None),
        ("xla/sum", "xla", "sum", None, None, None),
        ("pallas/adam:1e-3", "pallas", "adam:1e-3", None, None, None),
        ("pallas/sum int8", "pallas", "sum", None, None, "int8"),
        ("pallas/sum 2-D dp4xkv2", "pallas", "sum", (4, 2), "dp", None),
        ("pallas/sum 2-D dp4xkv2 int8", "pallas", "sum", (4, 2), "dp",
         "int8"),
    ]
    for label, impl, handle, shape, waxis, compress in cells:
        group = (ps.DeviceGroup(N) if shape is None
                 else ps.make_group(shape, ("dp", "kv")))
        eng = ps.CollectiveEngine(group, server_handle=handle, impl=impl,
                                  worker_axis=waxis, wire_compress=compress)
        eng.register_dense("b", np.arange(KEYS, dtype=np.uint64), VAL_LEN)
        inp = torch.ones(eng.num_workers * eng.bucket("b").padded_len,
                         device="cuda")

        def step():
            eng.push_pull("b", inp)

        event_ms = cuda_ms(step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / ITERS
        busy_ms, kernels = device_breakdown(torch, step)
        payload = P * 4
        out.append({
            "cell": label, "event_ms_per_step": event_ms,
            "wall_ms_per_step": wall_ms, "busy_ms_per_step": busy_ms,
            "busy_share": busy_ms / wall_ms, "kernels": kernels,
            "goodput_gbps_event": 2 * payload / event_ms / 1e6,
            "goodput_gbps_wall": 2 * payload / wall_ms / 1e6,
        })
        del eng, inp
    return out


def check_reduce_breakdown(r) -> None:
    """The torch impl's and a stateful handle's step is one D1/D2 launch:
    ``reduce_kernel`` takes the step's device time, with no PyTorch add
    or device-to-device copy beside it; the only other kernels allowed
    are adam's step-size and step-counter scalars (a few microseconds)."""
    kernels = r["kernels"]
    if not kernels or "reduce_kernel" not in kernels[0][0]:
        raise AssertionError(f"{r['cell']}: the step's top kernel is not "
                             f"D1/D2: {kernels[:3]}")
    others = [(k, ms) for k, ms in kernels[1:]
              if ms >= 0.01 or k.startswith("Memcpy")]
    if others:
        raise AssertionError(f"{r['cell']}: kernels beside D1/D2 "
                             f"{others}")


def steady_state_trace(torch, ps, rt, Environment):
    """Steady state of the ResNet-50 trace (36 buckets, 8 ranks, ring sum)
    through ``resnet_trace.replay`` on a KVWorker's engine, per cell:
    per-bucket push_pulls of device grads, one grouped push_pull (exact,
    and ``resnet50-grouped-int8`` on an engine built under
    ``PS_ICI_COMPRESS=int8``), and host-origin numpy grads copied serially
    in each push_pull or staged by ``push_pull_multi_stream``; and
    ``replay`` of T = 8 steps of the 40 x 1 MB bucket.  Each cell: wall
    ms/step (host clock to a synchronize), CUDA-event ms/step, and the
    profiler's device time per step (kernels, and copies on their own),
    busy share against the wall time; host-origin cells also the
    host-to-device GB/s of their grads.  After the int8 cell, two more
    grouped steps on fresh stores are pulled and checked against float64
    within the int8 bound."""
    po = ps.Postoffice("worker", env=Environment({
        "PS_VAN_TYPE": "ici", "PS_ICI_IMPL": "pallas",
        "PS_ICI_SERVER_HANDLE": "sum"}))
    po.van.set_mesh(ps.DeviceGroup(N))
    po.start()
    eng = ps.KVWorker(0, 0, postoffice=po).engine
    po8 = int8_worker_postoffice(ps, Environment)
    eng8 = ps.KVWorker(0, 0, postoffice=po8).engine
    if eng8.wire_compress != "int8":
        raise AssertionError("PS_ICI_COMPRESS=int8 did not reach the engine")

    def events(loop):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loop()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3

    out = []
    host_bytes = sum(N * p * 4 for p in trace_pads(rt, N))
    for cell, engine, grouped, host_origin, overlap, steps in (
            ("resnet50-per-bucket", eng, False, False, False, ITERS),
            ("resnet50-grouped", eng, True, False, False, ITERS),
            ("resnet50-grouped-int8", eng8, True, False, False, ITERS),
            ("resnet50-host-serial", eng, False, True, False, 5),
            ("resnet50-host-overlap", eng, False, True, True, 5)):
        kw = dict(grouped=grouped, host_origin=host_origin, overlap=overlap)
        nbytes, wall_s = rt.replay(engine, steps=steps, **kw)
        _, event_s = rt.replay(engine, steps=steps, measure=events, **kw)
        seen = {}

        def profiled(loop):
            seen["busy"], seen["kernels"] = device_breakdown(
                torch, loop, iters=1)
            return seen["busy"] / 1e3

        rt.replay(engine, steps=3, measure=profiled, **kw)
        busy = seen["busy"] / 3
        kernels = [(k, ms / 3) for k, ms in seen["kernels"]]
        wall_ms = wall_s * 1e3
        row = {"cell": cell, "wall_ms_per_step": wall_ms,
               "event_ms_per_step": event_s * 1e3, "busy_ms_per_step": busy,
               "copy_ms_per_step": copy_ms(kernels),
               "busy_share": busy / wall_ms, "kernels": kernels,
               "goodput_gbps_wall": nbytes / wall_s / 1e9}
        if host_origin:
            row["h2d_gbps_wall"] = host_bytes / wall_s / 1e9
        out.append(row)
    # The int8 cell's pulled values: 2 grouped steps of ones (as the cell
    # pushes) on fresh stores.
    names = [name for name, _ in rt.make_buckets()]
    for name, n in rt.make_buckets():
        eng8.register_dense(name, np.arange(1, dtype=np.uint64), n)
    ones = [torch.ones((N, eng8.bucket(name).padded_len), device=eng8.device)
            for name in names]
    for _ in range(2):
        pulled = eng8.push_pull_group(names, ones)
    bound_sum = sum(2 * N * (N + (k - 1) * N) / 127 for k in (1, 2))
    out[2]["max_abs_err_vs_f64"] = max(
        _check_int8(f"resnet50-grouped-int8 {name}", "push_pull", 2,
                    p.double().cpu().numpy(), np.full(p.numel(), 2.0 * N),
                    bound_sum)[0]
        for name, p in zip(names, pulled))
    out[2]["error_bound"] = bound_sum
    po.finalize()
    po8.finalize()

    eng = ps.CollectiveEngine(ps.DeviceGroup(N), impl="pallas")
    eng.register_dense("b", np.arange(KEYS, dtype=np.uint64), VAL_LEN)
    seq = torch.ones((REPLAY_STEPS, N, P), device=eng.device)

    def step():
        eng.replay("b", seq, keep="last")

    event_ms = cuda_ms(step) / REPLAY_STEPS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / ITERS / REPLAY_STEPS
    busy, kernels = device_breakdown(torch, step)
    busy /= REPLAY_STEPS
    kernels = [(k, ms / REPLAY_STEPS) for k, ms in kernels]
    out.append({"cell": "replay-40x1MB", "wall_ms_per_step": wall_ms,
                "event_ms_per_step": event_ms, "busy_ms_per_step": busy,
                "copy_ms_per_step": copy_ms(kernels),
                "busy_share": busy / wall_ms, "kernels": kernels,
                "goodput_gbps_wall": 2 * P * 4 / wall_ms / 1e6})
    del eng, seq
    return out


# -- sparse tables: BASELINE config 5 -----------------------------------------

EMB_ROWS = 1 << 20  # BASELINE.md:30, pslite_tpu/models/embedding.py
EMB_DIM = 64
EMB_BATCH = 4096
EMB_HANDLE = "row_adagrad:0.01,1e-8"
FADD_CYCLES = 4  # dependent f32 add latency on Hopper


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock, from nvidia-smi."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True,
    ).stdout.split()[0]
    return float(mhz) * 1e6


def emb_layout():
    """(S, rows_per_shard) of config 5's table, as SparseEngine lays it
    out (dim 64: the JAX packing factor 2 rounds rps)."""
    rps = -(-EMB_ROWS // N)
    return N, -(-rps // 2) * 2


def emb_stats(emb, idx_np):
    """Distinct in-range rows and the longest run of one row among the
    config-5 batch's updates."""
    counts = np.bincount(idx_np.reshape(-1), minlength=EMB_ROWS)
    return int((counts > 0).sum()), int(counts.max())


def flush_l2(torch, dev):
    """A function that evicts the L2 (50 MB) by writing 128 MB."""
    buf = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    return lambda: buf.zero_()


def cold_ms(torch, fn, flush):
    """Host-free ms of ``fn`` with the L2 flushed before each launch: a
    graph of flush + fn, less a graph of the flushes alone."""
    return graph_ms(lambda: (flush(), fn())) - graph_ms(flush)


# The push's kernels, by the profiler's kernel names.
PUSH_PIECES = (("sort", "sort_kernel"), ("long runs", "long_runs_kernel"),
               ("short runs", "_short_kernel"))


def push_pieces(torch, sr, emb, rows):
    """Each push's kernels at config 5, from the profiler (device ms per
    call; the short runs overlap the long runs, so their time includes
    waiting beside them), into the S1 and S2 rows.  Run after the steady
    states: a profiler window taken between CUDA-graph timings has come
    back without device events on the card."""
    S, rps = emb_layout()
    dev = torch.device("cuda:0")
    idx = torch.from_numpy(emb.skewed_indices(EMB_ROWS, N, EMB_BATCH,
                                              seed=0)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    g = torch.randn((N, EMB_BATCH, EMB_DIM), generator=gen, device=dev)
    store = torch.randn((S * rps, EMB_DIM), generator=gen, device=dev)
    acc = torch.rand(S * rps, generator=gen, device=dev)
    pushes = {
        "sparse_scatter_add": lambda: sr.scatter_add(store, idx, g, S, rps),
        "sparse_row_adagrad": lambda: sr.row_adagrad(store, acc, idx, g, S,
                                                     rps, 0.01, 1e-8)}
    for r in rows:
        if r["name"] in pushes:
            _, kernels = device_breakdown(torch, pushes[r["name"]])
            r["pieces_ms"] = {piece: sum(ms for k, ms in kernels if key in k)
                              for piece, key in PUSH_PIECES}


def walk_cycles(torch, _native, store, idx, rows, sr, S, rps):
    """(SM cycles per add, length) of the longest run's walk in a sum
    push of ``rows``: the clock probe's build of the long-run kernel on a
    copy of the store (its time includes the ring's first fill)."""
    m, dim = idx.numel(), store.shape[1]
    work = sr._sorted_runs(idx, S, rps)
    target = store.clone()
    probe = torch.zeros(4 * m, dtype=torch.int64, device=store.device)
    _native.call("pstt_sparse_walk_probe", target.data_ptr(),
                 rows.data_ptr(), work.data_ptr(), m, dim, 0,
                 probe.data_ptr(), _native.stream_ptr(store.device))
    torch.cuda.synchronize()
    lens, cycles = probe.view(-1, 4).cpu()[:, :2].unbind(1)
    h = int(lens.argmax())
    return float(cycles[h]) / float(lens[h]), int(lens[h])


def sparse_rows_rows(torch, sr, emb, dev, _native):
    """S1-S3 at config 5's shapes (1,048,576 x 64 f32 over 8 shards, 8 x
    4,096 Zipf(1.2) rows, seed 0) against their plain versions."""
    S, rps = emb_layout()
    idx_np = emb.skewed_indices(EMB_ROWS, N, EMB_BATCH, seed=0)
    distinct, max_run = emb_stats(emb, idx_np)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    idx = torch.from_numpy(idx_np).to(dev)
    rows = torch.randn((N, EMB_BATCH, EMB_DIM), generator=gen, device=dev)
    store = torch.randn((S * rps, EMB_DIM), generator=gen, device=dev)
    acc = torch.rand(S * rps, generator=gen, device=dev)
    flat = sr.target_rows(idx, S, rps).reshape(-1)
    rows2 = rows.reshape(-1, EMB_DIM)
    flush = flush_l2(torch, dev)
    m = N * EMB_BATCH
    row_b = EMB_DIM * 4
    # The hottest row's updates are one dependent chain of adds.
    chain_ms = max_run * FADD_CYCLES / max_sm_clock_hz() * 1e3
    out = []

    # S1: sum push.  The same function in another order of addition:
    # index_add_ (atomics on the card), not bit-exact.
    sk, sp = store.clone(), store.clone()
    sr.scatter_add(sk, idx, rows, S, rps)
    sr.scatter_add_reference(sp, idx, rows, S, rps)
    torch.cuda.synchronize()
    err = float(mismatches(sk, sp))
    ms, ms_host = kernel_times(lambda: sr.scatter_add(sk, idx, rows, S, rps))
    ms_cold = cold_ms(torch, lambda: sr.scatter_add(sk, idx, rows, S, rps),
                      flush)
    plain_ms = cuda_ms(lambda: sr.scatter_add_reference(sp, idx, rows, S,
                                                        rps), iters=2,
                       warmup=1)
    lib = library_time(lambda s: s.index_add_(0, flat, rows2), store.clone())
    b_ms, b_by = bound(m * row_b + m * 4 + 2 * distinct * row_b, m * EMB_DIM)
    cpa, hot = walk_cycles(torch, _native, store, idx, rows, sr, S, rps)
    out.append(dict(
        name="sparse_scatter_add", route="cuda",
        source="pslite_tpu_torch/csrc/sparse_rows.cu",
        replaces="pslite_tpu/parallel/sparse.py:137",
        max_abs_err=err, ms=ms, ms_host=ms_host, ms_cold=ms_cold,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        chain_floor_ms=chain_ms, library_ms=lib[0], library_ms_host=lib[1],
        library_note=lib[2] or "index_add_: the same sums in another order "
                               "of addition (atomics), not bit-exact",
        distinct_rows=distinct, max_run=max_run,
        hot_run_cycles_per_add=cpa, hot_run=hot))

    # S2: row-wise Adagrad.  No single PyTorch call computes it.
    sk, ak = store.clone(), acc.clone()
    sp, ap = store.clone(), acc.clone()
    sr.row_adagrad(sk, ak, idx, rows, S, rps, 0.01, 1e-8)
    sr.row_adagrad_reference(sp, ap, idx, rows, S, rps, 0.01, 1e-8)
    torch.cuda.synchronize()
    pairs = [(sk, sp), (ak, ap)]
    err = max_err(pairs)
    if not within(pairs, 1e-5, 1e-6):
        raise AssertionError(f"sparse_row_adagrad off the plain version by "
                             f"{err} (rtol 1e-5, atol 1e-6)")
    ms, ms_host = kernel_times(
        lambda: sr.row_adagrad(sk, ak, idx, rows, S, rps, 0.01, 1e-8))
    ms_cold = cold_ms(
        torch, lambda: sr.row_adagrad(sk, ak, idx, rows, S, rps, 0.01, 1e-8),
        flush)
    plain_ms = cuda_ms(lambda: sr.row_adagrad_reference(
        sp, ap, idx, rows, S, rps, 0.01, 1e-8), iters=2, warmup=1)
    b_ms, b_by = bound(m * row_b + m * 4 + 2 * distinct * (row_b + 4),
                       m * EMB_DIM + distinct * 6 * EMB_DIM)
    out.append(dict(
        name="sparse_row_adagrad", route="cuda",
        source="pslite_tpu_torch/csrc/sparse_rows.cu",
        replaces="pslite_tpu/parallel/sparse.py:179",
        max_abs_err=err, ms=ms, ms_host=ms_host, ms_cold=ms_cold,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        chain_floor_ms=chain_ms, library_ms=None, library_ms_host=None,
        library_note="no single PyTorch call computes it",
        distinct_rows=distinct, max_run=max_run))

    # S3: pull.  index_select computes the same function (every index of
    # config 5 is in range).
    got = sr.gather_rows(store, idx, S, rps)
    want = sr.gather_rows_reference(store, idx, S, rps)
    torch.cuda.synchronize()
    err = float(mismatches(got, want))
    ms, ms_host = kernel_times(lambda: sr.gather_rows(store, idx, S, rps))
    ms_cold = cold_ms(torch, lambda: sr.gather_rows(store, idx, S, rps),
                      flush)
    plain_ms = cuda_ms(lambda: sr.gather_rows_reference(store, idx, S, rps))
    lib = library_time(lambda f: torch.index_select(store, 0, f), flat)
    b_ms, b_by = bound(distinct * row_b + m * 4 + m * row_b, 0)
    out.append(dict(
        name="sparse_gather_rows", route="cuda",
        source="pslite_tpu_torch/csrc/sparse_rows.cu",
        replaces="pslite_tpu/parallel/sparse.py:246",
        max_abs_err=err, ms=ms, ms_host=ms_host, ms_cold=ms_cold,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib[0],
        library_ms_host=lib[1], library_note=lib[2] or "torch.index_select",
        distinct_rows=distinct, max_run=max_run))
    del store, rows, acc, sk, sp, ak, ap
    return out


def emb_worker(ps, Environment):
    """A worker Postoffice on 8 virtual ranks of the card, its KVWorker
    and the van's SparseEngine with config 5's table ``emb``."""
    po = ps.Postoffice("worker", env=Environment({"PS_VAN_TYPE": "ici"}))
    po.van.set_mesh(ps.DeviceGroup(N))
    po.start()
    worker = ps.KVWorker(0, 0, postoffice=po)
    se = worker.sparse_engine
    if se is None or se.group is not po.van.engine.group:
        raise AssertionError("the ici van built no SparseEngine on its group")
    se.register_sparse("emb", EMB_ROWS, EMB_DIM)
    return po, worker, se


def _adagrad64(ref, acc, idx, g, lr=0.01, eps=1e-8):
    G = np.zeros(ref.shape)
    np.add.at(G, idx.reshape(-1), g.reshape(-1, ref.shape[1]))
    acc += np.mean(G ** 2, axis=1)
    ref -= lr * G / (np.sqrt(acc)[:, None] + eps)


def drive_sparse(torch, ps, Environment, emb, sr):
    """Config 5 through Postoffice/IciVan/KVWorker: 3 steps of
    ``push_sparse`` + ``pull_sparse`` with the sum handle and 3 with
    ``row_adagrad:0.01,1e-8`` (a second table), each against a float64
    numpy reference and each push against the plain version on the card
    (sum: 0 differing elements); one ``push_group``/``pull_group`` over two
    tables against single pushes (0 differing elements); and
    ``models.embedding.replay`` (2 steps)."""
    po, worker, se = emb_worker(ps, Environment)
    S, rps = se.num_shards, se.table("emb").rows_per_shard
    se.register_sparse("emb_ag", EMB_ROWS, EMB_DIM)
    idx = emb.skewed_indices(EMB_ROWS, N, EMB_BATCH, seed=0)
    idx_dev = torch.from_numpy(idx).cuda()
    rng = np.random.default_rng(SEED + 6)
    results = []
    for name, handle in (("emb", None), ("emb_ag", EMB_HANDLE)):
        ref = np.zeros((EMB_ROWS, EMB_DIM))
        mag = np.zeros((EMB_ROWS, EMB_DIM))
        cnt = np.zeros(EMB_ROWS)
        acc64 = np.zeros(EMB_ROWS)
        worst = 0.0
        for k in range(3):
            g = rng.standard_normal((N, EMB_BATCH, EMB_DIM), dtype=np.float32)
            snap = se.store_array(name)
            acc_snap = (se.acc_array(name) if handle and k else
                        torch.zeros(S * rps, device="cuda"))
            worker.wait(worker.push_sparse(name, idx, g, handle=handle))
            out = np.zeros((N, EMB_BATCH, EMB_DIM), np.float32)
            worker.wait(worker.pull_sparse(name, idx, out=out))
            g_dev = torch.from_numpy(g).cuda()
            if handle is None:
                sr.scatter_add_reference(snap, idx_dev, g_dev, S, rps)
                mismatches(se.store_array(name), snap)
                np.add.at(ref, idx.reshape(-1),
                          g.reshape(-1, EMB_DIM).astype(np.float64))
                np.add.at(mag, idx.reshape(-1),
                          np.abs(g.reshape(-1, EMB_DIM)).astype(np.float64))
                np.add.at(cnt, idx.reshape(-1), 1.0)
                # Recursive summation: each add rounds by at most u of its
                # partial sum, so |err| <= adds * u * sum|g| per row.
                tol = (cnt * 2.0 ** -24)[:, None] * mag + 1e-6
            else:
                sr.row_adagrad_reference(snap, acc_snap, idx_dev, g_dev, S,
                                         rps, 0.01, 1e-8)
                pairs = [(se.store_array(name), snap),
                         (se.acc_array(name), acc_snap)]
                if not within(pairs, 1e-5, 1e-6):
                    raise AssertionError(f"{name}: row_adagrad step {k} off "
                                         f"the plain version by "
                                         f"{max_err(pairs)}")
                _adagrad64(ref, acc64, idx, g.astype(np.float64))
                tol = 1e-4 + 1e-4 * np.abs(ref)
            want = ref[idx]
            err = np.abs(out.astype(np.float64) - want)
            if not (np.all(np.isfinite(out))
                    and np.all(err <= tol[idx])):
                raise AssertionError(f"{name}: step {k} off the float64 "
                                     f"reference by {float(err.max())}")
            mismatches(torch.from_numpy(out).cuda(),
                       sr.gather_rows_reference(se.store_array(name),
                                                idx_dev, S, rps))
            worst = max(worst, float(err.max()))
        results.append({"config": f"config 5 KVWorker {handle or 'sum'} "
                                  f"(1,048,576 x 64, 8 x 4,096 Zipf)",
                        "ops": 6, "max_abs_err_vs_f64": worst})
        del ref, mag, acc64

    # Groups: two tables pushed and pulled together, and their twins one
    # at a time.
    small = emb.skewed_indices(65_536, N, 1024, seed=1)
    g_small = rng.standard_normal((N, 1024, 16), dtype=np.float32)
    g_big = rng.standard_normal((N, EMB_BATCH, EMB_DIM), dtype=np.float32)
    for t in ("grp_a", "one_a"):
        se.register_sparse(t, EMB_ROWS, EMB_DIM)
    for t in ("grp_b", "one_b"):
        se.register_sparse(t, 65_536, 16)
    for handle in (None, EMB_HANDLE):
        se.push_group(["grp_a", "grp_b"], [idx, small], [g_big, g_small],
                      handle=handle)
        se.push("one_a", idx, g_big, handle=handle)
        se.push("one_b", small, g_small, handle=handle)
    outs = se.pull_group(["grp_a", "grp_b"], [idx, small])
    for got, twin, ix in zip(outs, ("one_a", "one_b"), (idx, small)):
        mismatches(got, se.pull(twin, ix))
        mismatches(se.store_array("grp" + twin[3:]), se.store_array(twin))
    results.append({"config": "config 5 push_group/pull_group (2 tables, "
                              "sum then row_adagrad) vs single ops",
                    "ops": 3, "max_abs_err_vs_f64": 0.0})

    nbytes, dt = emb.replay(se, num_rows=EMB_ROWS, dim=EMB_DIM,
                            batch=EMB_BATCH, steps=2)
    if nbytes != 2 * 4 * N * EMB_BATCH * EMB_DIM or not dt > 0:
        raise AssertionError(f"embedding.replay: {nbytes} B, {dt} s")
    results.append({"config": "models.embedding.replay (2 steps, host "
                              "grads)", "ops": 6, "ms_per_step_wall":
                    dt * 1e3})
    worker.stop()
    po.finalize()
    return results


def steady_state_sparse(torch, ps, Environment, emb):
    """Steady state of config 5 through KVWorker: one ``push_sparse`` +
    ``pull_sparse`` per step with grads already on the card
    (``embedding-1m``), the same under ``row_adagrad``
    (``embedding-1m-adagrad``), and with numpy grads and indices that the
    push copies to the card (``embedding-1m-host``, as
    ``models.embedding.replay``).  Each: wall ms/step (host clock to a
    synchronize), CUDA-event ms/step, the profiler's device time per step
    by kernel, busy share against the wall."""
    po, worker, se = emb_worker(ps, Environment)
    idx = emb.skewed_indices(EMB_ROWS, N, EMB_BATCH, seed=0)
    idx_dev = torch.from_numpy(idx).cuda()
    g_host = np.ones((N, EMB_BATCH, EMB_DIM), np.float32)
    g_dev = torch.randn((N, EMB_BATCH, EMB_DIM), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(
                            SEED + 7))
    out = []
    for cell, ix, g, handle in (
            ("embedding-1m", idx_dev, g_dev, None),
            ("embedding-1m-adagrad", idx_dev, g_dev, EMB_HANDLE),
            ("embedding-1m-host", idx, g_host, None)):
        def step():
            worker.push_sparse("emb", ix, g, handle=handle)
            return worker.pull_sparse("emb", ix)

        def loop(steps):
            for _ in range(steps):
                ts = step()
            worker.wait(ts)
            torch.cuda.synchronize()

        loop(3)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loop(ITERS)
        end.record()
        torch.cuda.synchronize()
        event_ms = start.elapsed_time(end) / ITERS
        t0 = time.perf_counter()
        loop(ITERS)
        wall_ms = (time.perf_counter() - t0) * 1e3 / ITERS
        busy, kernels = device_breakdown(torch, lambda: loop(1))
        out.append({"cell": cell, "wall_ms_per_step": wall_ms,
                    "event_ms_per_step": event_ms, "busy_ms_per_step": busy,
                    "copy_ms_per_step": copy_ms(kernels),
                    "busy_share": busy / wall_ms, "kernels": kernels,
                    "goodput_gbps_wall": 2 * 4 * N * EMB_BATCH * EMB_DIM
                    / wall_ms / 1e6})
    worker.stop()
    po.finalize()
    return out


# -- sparse groups: the group program, one chain per push_group --------------

# The embedding layer of facebookresearch/dlrm's Criteo Kaggle run
# (--data-set=kaggle, --arch-sparse-feature-size=16): the rows of its 26
# categorical features after its preprocessing (33,762,577 rows: 2.16 GB
# of f32 stores at dim 16).
KAGGLE_ROWS = (1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145,
               5683, 8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4,
               7046547, 18, 15, 286181, 105, 142572)
KAGGLE_DIM = 16
KAGGLE_BATCH = 1024  # examples per rank, one lookup per table
DLRM_ROWS, DLRM_DIM = 1 << 20, 16  # models/dlrm.py's table at its 1M rows
GROUP_STEPS = 3      # steps of each handle


def group_specs():
    """The sparse groups: name -> [(table, rows, dim, batch per rank,
    dtype, index seed)]: (a) the Kaggle embedding layer, (b) config 5's
    table beside the DLRM table (mixed dims), (c) an f32 and a bf16 table
    (one chain per dtype)."""
    return {
        "kaggle26": [(f"kaggle{t}", r, KAGGLE_DIM, KAGGLE_BATCH, "float32",
                      t) for t, r in enumerate(KAGGLE_ROWS)],
        "c5+dlrm": [("c5", EMB_ROWS, EMB_DIM, EMB_BATCH, "float32", 0),
                    ("dlrm", DLRM_ROWS, DLRM_DIM, EMB_BATCH, "float32", 1)],
        "f32+bf16": [("small_f32", 65_536, 32, 1024, "float32", 2),
                     ("small_bf16", 65_536, 32, 1024, "bfloat16", 3)],
    }


def table_rps(rows: int, dim: int) -> int:
    """rows_per_shard of a table on N shards, as SparseEngine lays it out
    (rounded to the JAX packing factor)."""
    pack = 128 // dim if (dim < 128 and 128 % dim == 0) else 1
    rps = -(-rows // N)
    return -(-rps // pack) * pack


def group_stats(emb, spec):
    """Per table (indices [N, b], distinct rows, longest run)."""
    out = []
    for _, rows, _, b, _, seed in spec:
        idx = emb.skewed_indices(rows, N, b, seed=seed)
        counts = np.bincount(idx.reshape(-1), minlength=rows)
        out.append((idx, int((counts > 0).sum()), int(counts.max())))
    return out


def sparse_group_rows(torch, sr, emb, dev):
    """The grouped kernels (one chain for every table of a group) at
    group (a), the Kaggle embedding layer, and (b), config 5's table
    beside the DLRM table: held against the per-table kernels (0
    differing elements, row-wise Adagrad too) and the plain group
    versions (sum and pull 0 differing, row-wise Adagrad rtol 1e-5 / atol
    1e-6); timed host-free and host-inclusive beside the per-table loop
    on the same inputs (``earlier_ms``) and the plain version."""
    out = []
    clock = max_sm_clock_hz()
    for gname in ("kaggle26", "c5+dlrm"):
        spec = group_specs()[gname]
        stats = group_stats(emb, spec)
        gen = torch.Generator(device=dev).manual_seed(SEED + 30)
        rps = [table_rps(r, d) for _, r, d, _, _, _ in spec]
        stores = [torch.randn((N * p, d), generator=gen, device=dev)
                  for p, (_, _, d, _, _, _) in zip(rps, spec)]
        accs = [torch.rand(N * p, generator=gen, device=dev) for p in rps]
        idxs = [torch.from_numpy(i).to(dev) for i, _, _ in stats]
        rows = [torch.randn((N, b, d), generator=gen, device=dev)
                for _, _, d, b, _, _ in spec]
        row_b = [d * 4 for _, _, d, _, _, _ in spec]
        ms_ = [N * b for _, _, _, b, _, _ in spec]
        push_b = sum(m * rb + m * 4 + 2 * dist * rb
                     for m, rb, (_, dist, _) in zip(ms_, row_b, stats))
        ops = sum(m * d for m, (_, _, d, _, _, _) in zip(ms_, spec))
        dist_ops = sum(dist * 6 * d for (_, dist, _), (_, _, d, _, _, _)
                       in zip(stats, spec))
        hot = max(h for _, _, h in stats)
        chain_ms = hot * FADD_CYCLES / clock * 1e3
        k = len(spec)

        def clones(ts):
            return [t.clone() for t in ts]

        def loop_push(ss, aa, adagrad):
            for s, a, ix, g, p in zip(ss, aa, idxs, rows, rps):
                if adagrad:
                    sr.row_adagrad(s, a, ix, g, N, p, 0.01, 1e-8)
                else:
                    sr.scatter_add(s, ix, g, N, p)

        cases = (
            ("sparse_scatter_add_group", False,
             lambda ss, aa: sr.scatter_add_group(ss, idxs, rows, N, rps),
             lambda ss, aa: sr.scatter_add_group_reference(ss, idxs, rows,
                                                           N, rps),
             push_b, ops),
            ("sparse_row_adagrad_group", True,
             lambda ss, aa: sr.row_adagrad_group(ss, aa, idxs, rows, N, rps,
                                                 0.01, 1e-8),
             lambda ss, aa: sr.row_adagrad_group_reference(
                 ss, aa, idxs, rows, N, rps, 0.01, 1e-8),
             push_b + sum(2 * dist * 4 for _, dist, _ in stats),
             ops + dist_ops))
        for name, adagrad, group, plain, nbytes, nops in cases:
            sk, ak = clones(stores), clones(accs)
            group(sk, ak)
            sl, al = clones(stores), clones(accs)
            loop_push(sl, al, adagrad)
            sp, ap = clones(stores), clones(accs)
            plain(sp, ap)
            torch.cuda.synchronize()
            for a, b in zip(sk + ak, sl + al):
                mismatches(a, b)  # the per-table kernels: 0 differing
            pairs = list(zip(sk + ak, sp + ap))
            err = max_err(pairs)
            if adagrad:
                if not within(pairs, 1e-5, 1e-6):
                    raise AssertionError(f"{name}[{gname}] off the plain "
                                         f"version by {err}")
            else:
                for a, b in pairs:
                    mismatches(a, b)
            del sl, al, sp, ap
            ms, ms_host = kernel_times(lambda: group(sk, ak))
            loop_ms, loop_host = kernel_times(
                lambda: loop_push(sk, ak, adagrad))
            sp, ap = clones(stores), clones(accs)
            plain_ms = cuda_ms(lambda: plain(sp, ap), iters=2, warmup=1)
            del sp, ap, sk, ak
            b_ms, b_by = bound(nbytes, nops)
            out.append(dict(
                name=f"{name}[{gname}]", counter=name, route="cuda",
                source="pslite_tpu_torch/csrc/sparse_rows.cu",
                replaces="pslite_tpu/parallel/sparse.py:670",
                max_abs_err=err, ms=ms, ms_host=ms_host, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, chain_floor_ms=chain_ms,
                library_ms=None, library_ms_host=None,
                library_note="no single PyTorch call pushes several tables",
                earlier_ms=loop_ms, earlier_ms_host=loop_host,
                earlier_note=f"the per-table loop ({k} pushes, {3 * k} "
                             f"launches)", tables=k, max_run=hot,
                distinct_rows=sum(d for _, d, _ in stats)))

        # The pull: one launch for every table.
        got = sr.gather_rows_group(stores, idxs, N, rps)
        want = sr.gather_rows_group_reference(stores, idxs, N, rps)
        loop = [sr.gather_rows(s, ix, N, p)
                for s, ix, p in zip(stores, idxs, rps)]
        torch.cuda.synchronize()
        for a, b, c in zip(got, want, loop):
            mismatches(a, b)
            mismatches(a, c)
        ms, ms_host = kernel_times(
            lambda: sr.gather_rows_group(stores, idxs, N, rps))
        loop_ms, loop_host = kernel_times(
            lambda: [sr.gather_rows(s, ix, N, p)
                     for s, ix, p in zip(stores, idxs, rps)])
        plain_ms = cuda_ms(
            lambda: sr.gather_rows_group_reference(stores, idxs, N, rps))
        b_ms, b_by = bound(sum(dist * rb + m * 4 + m * rb for m, rb,
                               (_, dist, _) in zip(ms_, row_b, stats)), 0)
        out.append(dict(
            name=f"sparse_gather_rows_group[{gname}]",
            counter="sparse_gather_rows_group", route="cuda",
            source="pslite_tpu_torch/csrc/sparse_rows.cu",
            replaces="pslite_tpu/parallel/sparse.py:670", max_abs_err=0.0,
            ms=ms, ms_host=ms_host, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None, library_ms_host=None,
            library_note="no single PyTorch call gathers several tables",
            earlier_ms=loop_ms, earlier_ms_host=loop_host,
            earlier_note=f"the per-table loop ({k} launches)", tables=k,
            distinct_rows=sum(d for _, d, _ in stats)))
        del stores, accs, rows, got, want, loop
    return out


def _touched(idx):
    """(distinct rows, each index's position among them, occurrences of
    each) of a table's indices."""
    u, inv, cnt = np.unique(idx.reshape(-1), return_inverse=True,
                            return_counts=True)
    return u, inv.reshape(idx.shape), cnt


def drive_sparse_groups(torch, ps, Environment, emb, sr):
    """The three groups of ``group_specs`` through
    ``SparseEngine.push_group``/``pull_group`` of the ici van's engine (8
    ranks of the card): ``GROUP_STEPS`` steps of the sum handle, then as
    many of ``row_adagrad:0.01,1e-8``, each a group push and a group
    pull.  Each step: the launches of the group ops counted (3 per dtype
    for the push, 1 for the pull, whatever the number of tables); every
    table against its twin pushed and pulled alone (S1/S2/S3: 0 differing
    elements in pulls, stores and accumulators); the first step of each
    handle against the plain group version on snapshots (sum and pull 0
    differing, row-wise Adagrad rtol 1e-5 / atol 1e-6); every pull
    against a float64 numpy reference of the touched rows."""
    po, worker, se = emb_worker(ps, Environment)
    rng = np.random.default_rng(SEED + 31)
    lr, eps = 0.01, 1e-8
    results = []
    for gname, spec in group_specs().items():
        names = [t[0] for t in spec]
        for n, rows, dim, _, dt, _ in spec:
            se.register_sparse(n, rows, dim, dtype=dt)
            se.register_sparse("twin_" + n, rows, dim, dtype=dt)
        idx = [i for i, _, _ in group_stats(emb, spec)]
        idx_dev = [torch.from_numpy(i).cuda() for i in idx]
        touched = [_touched(i) for i in idx]
        rps = [se.table(n).rows_per_shard for n in names]
        dtypes = {dt for _, _, _, _, dt, _ in spec}
        worst, launches, wall = 0.0, [], []
        for handle in (None, EMB_HANDLE):
            counter = ("sparse_row_adagrad_group" if handle
                       else "sparse_scatter_add_group")
            # float64 reference of the touched rows, from the stores now.
            ref = [se._stores[n][sr.target_rows(torch.from_numpy(u).cuda(),
                                                N, p)].double().cpu().numpy()
                   for n, (u, _, _), p in zip(names, touched, rps)]
            mag = [np.abs(r) for r in ref]
            adds = [np.zeros(len(u)) for u, _, _ in touched]
            acc64 = [np.zeros(len(u)) for u, _, _ in touched]
            dacc = [np.zeros(len(u)) for u, _, _ in touched]
            dstep = [np.zeros_like(r) for r in ref]
            for k in range(GROUP_STEPS):
                gs = [rng.standard_normal((N, b, d), dtype=np.float32)
                      for _, _, d, b, _, _ in spec]
                g_dev = [torch.from_numpy(g).cuda().to(getattr(torch, dt))
                         for g, (_, _, _, _, dt, _) in zip(gs, spec)]
                if k == 0:
                    snaps = [se._stores[n].clone() for n in names]
                    accs = [se._acc[n].clone() if n in se._acc else
                            torch.zeros(se._stores[n].shape[0],
                                        device="cuda") for n in names]
                before = dict(sr.launches)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                se.push_group(names, idx_dev, g_dev, handle=handle)
                outs = se.pull_group(names, idx_dev)
                torch.cuda.synchronize()
                wall.append((time.perf_counter() - t0) * 1e3)
                launches.append((sr.launches[counter] - before[counter],
                                 sr.launches["sparse_gather_rows_group"]
                                 - before["sparse_gather_rows_group"]))
                if launches[-1] != (3 * len(dtypes), 1):
                    raise AssertionError(f"{gname}: push_group/pull_group "
                                         f"launched {launches[-1]}")
                for n, ix, g, o in zip(names, idx_dev, g_dev, outs):
                    se.push("twin_" + n, ix, g, handle=handle)
                    mismatches(o, se.pull("twin_" + n, ix))
                    mismatches(se._stores[n], se._stores["twin_" + n])
                    if handle:
                        mismatches(se._acc[n], se._acc["twin_" + n])
                if k == 0:
                    if handle:
                        sr.row_adagrad_group_reference(snaps, accs, idx_dev,
                                                       g_dev, N, rps, lr, eps)
                        pairs = list(zip([se._stores[n] for n in names]
                                         + [se._acc[n] for n in names],
                                         snaps + accs))
                        if not within(pairs, 1e-5, 1e-6):
                            raise AssertionError(
                                f"{gname}: row_adagrad off the plain group "
                                f"version by {max_err(pairs)}")
                    else:
                        sr.scatter_add_group_reference(snaps, idx_dev, g_dev,
                                                       N, rps)
                        for n, sn in zip(names, snaps):
                            mismatches(se._stores[n], sn)
                        for o, w in zip(outs, sr.gather_rows_group_reference(
                                snaps, idx_dev, N, rps)):
                            mismatches(o, w)
                    del snaps, accs
                for t, ((u, inv, cnt), g, o) in enumerate(
                        zip(touched, g_dev, outs)):
                    g64 = g.double().cpu().numpy().reshape(-1, g.shape[-1])
                    G = np.zeros_like(ref[t])
                    np.add.at(G, inv.reshape(-1), g64)
                    bf = spec[t][4] == "bfloat16"
                    unit = 2.0 ** -8 if bf else 2.0 ** -24
                    Gabs = np.zeros_like(G)
                    np.add.at(Gabs, inv.reshape(-1), np.abs(g64))
                    if handle:
                        acc64[t] += np.mean(G ** 2, axis=1)
                        step = lr * G / (np.sqrt(acc64[t])[:, None] + eps)
                        ref[t] -= step
                        if bf:
                            # The row's G summed in bf16 (each add off by
                            # at most u of its partial sum), its error
                            # carried into acc and the step, then the
                            # step's and the store's roundings.
                            dG = (cnt * unit)[:, None] * Gabs
                            dacc[t] += np.mean(2 * np.abs(G) * dG + dG ** 2,
                                               axis=1)
                            dstep[t] += lr * (dG + np.abs(G) * (
                                dacc[t] / (2 * acc64[t]))[:, None]) / (
                                np.sqrt(acc64[t])[:, None]) + unit * (
                                np.abs(step) + np.abs(ref[t]))
                            tol = 1e-4 + dstep[t]
                        else:
                            tol = 1e-4 + 1e-4 * np.abs(ref[t])
                    else:
                        ref[t] += G
                        mag[t] += Gabs
                        adds[t] += cnt
                        # Each add rounds by at most u of its partial sum.
                        tol = ((adds[t] + 1) * unit)[:, None] * mag[t] + 1e-6
                    got = o.double().cpu().numpy()
                    err = np.abs(got - ref[t][inv])
                    if not (np.all(np.isfinite(got)) and np.all(
                            err <= tol[inv])):
                        raise AssertionError(
                            f"{gname} {spec[t][0]}: {handle or 'sum'} step "
                            f"{k} off the float64 reference by "
                            f"{float(err.max())}")
                    worst = max(worst, float(err.max()))
        for n in names:
            for t in (n, "twin_" + n):
                se._stores.pop(t)
                se._acc.pop(t, None)
        results.append({
            "config": f"sparse group {gname} ({len(names)} tables, "
                      f"{len(dtypes)} dtype{'s' * (len(dtypes) > 1)}) "
                      f"push_group/pull_group sum then row_adagrad vs "
                      f"per-table twins and the plain group version",
            "ops": 4 * GROUP_STEPS, "max_abs_err_vs_f64": worst,
            "push_group_launches": launches[0][0],
            "pull_group_launches": launches[0][1],
            "wall_ms_first": wall[0], "wall_ms_median": float(
                np.median(wall[1:]))})
        torch.cuda.empty_cache()
    worker.stop()
    po.finalize()
    return results


def steady_state_groups(torch, ps, Environment, emb):
    """The wall of one ``push_group`` + ``pull_group`` (grads on the
    card) against the per-table loop (``push`` + ``pull`` per table) on
    the same engine and inputs, each group and handle: 4 windows of ITERS
    steps, grouped and loop in turns (group, loop, loop, group), each a
    host clock to a synchronize; medians."""
    po, worker, se = emb_worker(ps, Environment)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 32)
    out = []
    for gname, spec in group_specs().items():
        names = [t[0] for t in spec]
        for n, rows, dim, _, dt, _ in spec:
            se.register_sparse(n, rows, dim, dtype=dt)
        idx = [torch.from_numpy(i).cuda() for i, _, _ in group_stats(emb,
                                                                      spec)]
        gs = [torch.randn((N, b, d), generator=gen, device="cuda").to(
            getattr(torch, dt)) for _, _, d, b, dt, _ in spec]
        for handle in (None, EMB_HANDLE):
            def grouped():
                se.push_group(names, idx, gs, handle=handle)
                return se.pull_group(names, idx)

            def loop():
                for n, ix, g in zip(names, idx, gs):
                    se.push(n, ix, g, handle=handle)
                return [se.pull(n, ix) for n, ix in zip(names, idx)]

            def window(fn):
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(ITERS):
                    fn()
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3 / ITERS

            walls = {"group": [], "loop": []}
            for leg in ("group", "loop", "loop", "group"):
                walls[leg].append(window(grouped if leg == "group"
                                         else loop))
            out.append({"cell": f"sparse-group-{gname}-{handle and 'adagrad' or 'sum'}",
                        "tables": len(names),
                        "group_wall_ms": float(np.median(walls["group"])),
                        "loop_wall_ms": float(np.median(walls["loop"])),
                        "group_walls": walls["group"],
                        "loop_walls": walls["loop"]})
        for n in names:
            se._stores.pop(n)
            se._acc.pop(n, None)
        torch.cuda.empty_cache()
    worker.stop()
    po.finalize()
    return out


# -- the message control plane in one process ---------------------------------

MSG_ROUNDS, MSG_WARMUP = 10, 2
CODEC_ROUNDS = 1  # each codec round also checks 20.48M values per worker
MSG_KEYS_PER_SERVER = 40  # test_benchmark.cc:25-30 NUM_KEY_PER_SERVER
MSG_LOOSE_KEYS = 16  # unregistered 1 MB keys of the mixed ici phase
MSG_DEADLINE = 300.0
_msg_ports = iter(range(47000, 48000))


def cpu_model() -> str:
    """The host CPU's model name (or, where the host hides it, vendor,
    family, model and stepping), architecture and usable cores."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break  # the first processor is enough
                key, _, val = line.partition(":")
                info[key.strip()] = val.strip()
    except OSError:
        pass
    name = info.get("model name") or info.get("Model") or "unknown"
    if name == "unknown" and "vendor_id" in info:
        name = (f"{info['vendor_id']} family {info.get('cpu family', '?')} "
                f"model {info.get('model', '?')} stepping "
                f"{info.get('stepping', '?')}")
    return (f"{name}, {platform.machine()}, "
            f"{len(os.sched_getaffinity(0))} cores")


def run_threads(fns, what: str) -> None:
    """Run each callable on its own thread; join all within MSG_DEADLINE
    or fail; re-raise the first error."""
    errors = []

    def wrap(fn):
        def run():
            try:
                fn()
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                errors.append(exc)
        return run

    threads = [threading.Thread(target=wrap(fn), name=f"{what}-{i}",
                                daemon=True) for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    end = time.monotonic() + MSG_DEADLINE
    for t in threads:
        t.join(max(0.0, end - time.monotonic()))
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"{what} did not finish within {MSG_DEADLINE} s")
    if errors:
        raise errors[0]


# A cluster in this process hosts many nodes in one interpreter: a CHECK
# failure takes its node dark instead of ending the run, and the phase
# that needed the node fails.  Node processes keep the default (a CHECK
# failure exits 134, and a launcher's keepalive restarts the node).
IN_PROCESS = {"PS_CHECK_FATAL": "0"}


def msg_cluster(ps, Environment, workers: int, servers: int,
                van: str = "loopback", ranks: int = N, env=None):
    """A started scheduler + ``servers`` servers + ``workers`` workers in
    this process (on ``ici``, each worker's engine on ``ranks`` ranks of
    this card, ring kernel); ``env`` adds variables."""
    base = {"DMLC_NUM_WORKER": str(workers), "DMLC_NUM_SERVER": str(servers),
            "DMLC_PS_ROOT_URI": "lo",
            "DMLC_PS_ROOT_PORT": str(next(_msg_ports)),
            "DMLC_NODE_HOST": "lo", "PS_VAN_TYPE": van,
            "PS_LOOPBACK_NS": f"chip-smoke-{os.getpid()}",
            "PS_ICI_IMPL": "pallas", **IN_PROCESS, **(env or {})}
    nodes = [ps.Postoffice("scheduler", env=Environment(base))]
    nodes += [ps.Postoffice("server", env=Environment(base))
              for _ in range(servers)]
    wk = [ps.Postoffice("worker", env=Environment(base))
          for _ in range(workers)]
    if van == "ici":
        for po in wk:
            po.van.set_mesh(ps.DeviceGroup(ranks))
    nodes += wk
    run_threads([po.start for po in nodes], "cluster start")
    return nodes


def msg_finalize(nodes, apps) -> None:
    for a in apps:
        a.stop()
    run_threads([po.finalize for po in nodes], "cluster finalize")


# What one encode of a value can be off by, per 128-value block, in units
# of the block's largest magnitude (ops/codecs.py): int8 half a scale step
# (1/254; 1 % more for the error-feedback residual folded in), fp8 e4m3
# 2^-4 of the value plus the float16 step before it and the subnormal
# floor (0.075 covers them), bf16 2^-8 of the value (0.004).
CODEC_UNIT = {"int8": 1.01 / 254, "fp8_e4m3": 0.075, "bf16": 0.004}
CODECS = ("int8", "fp8_e4m3", "bf16")


def codec_block_err(codec: str, x) -> np.ndarray:
    """Per 128-value block of ``x``: the most one encode can be off by."""
    a = np.abs(np.asarray(x, dtype=np.float64).reshape(-1))
    pad = (-a.size) % 128
    if pad:
        a = np.concatenate([a, np.zeros(pad)])
    return CODEC_UNIT[codec] * a.reshape(-1, 128).max(axis=1)


class CodecBound:
    """The bound a codec pull must lie within of the float64 sum of what
    was pushed: the encode errors of every push and of every pull
    response that reached it, summed (each at most ``codec_block_err``;
    with error feedback the residual folded into an encode is one such
    error too), plus float32 rounding of the server's adds."""

    def __init__(self, codec: str, n: int, pullers: int):
        self.codec = codec
        self.s64 = np.zeros(n)
        self.mag = np.zeros(n)
        self.adds = 0
        self.push = np.zeros(-(-n // 128))
        self.pull = [np.zeros(-(-n // 128)) for _ in range(pullers)]

    def pushed(self, x) -> None:
        self.s64 += x
        self.mag += np.abs(x)
        self.adds += 1
        self.push += codec_block_err(self.codec, x)

    def check(self, label: str, i: int, got) -> float:
        """Worker ``i``'s encoded pull (adds its encode), within bound;
        returns its max |err|."""
        self.pull[i] += (codec_block_err(self.codec, self.s64)
                         + CODEC_UNIT[self.codec] * self.push)
        n = self.s64.size
        bound = (np.repeat(self.push + self.pull[i], 128)[:n]
                 + (self.adds + 1) * 2.0 ** -24 * self.mag)
        err = np.abs(got.astype(np.float64) - self.s64)
        if not np.all(err <= bound):
            bad = int((err > bound).sum())
            raise AssertionError(f"{label}: {bad} values off the float64 "
                                 f"sum beyond the {self.codec} bound (max "
                                 f"|err| {float(err.max()):.4g})")
        return float(err.max())


def drive_msg_config2(ps, Environment, smi: str, label: str = "msg-config2",
                      env=None, codec=None, rounds: int = MSG_ROUNDS):
    """BASELINE config 2's topology in one process over the loopback van:
    test_benchmark's PUSH_PULL workload (40 keys per server of 1,024,000
    B), each round both workers push on their own threads, meet at a
    worker barrier, then pull.  ``env`` adds node variables (e.g.
    ``PS_APPLY_SHARDS=0``, the serial server).  Raw: integer-valued f32
    pushes, so every pulled value is checked exactly, whatever order the
    two workers' pushes arrive in.  With ``codec``, both workers
    ``register_bucket`` the keys (pushes and pulls encoded), push seeded
    normal f32, and each pull must lie within :class:`CodecBound` of the
    float64 sum; after each round worker 0 also pulls raw (untimed),
    whose mean |err| is the store's.  ``rounds`` timed rounds follow
    ``MSG_WARMUP`` untimed ones."""
    nodes = msg_cluster(ps, Environment, 2, 2, env=env)
    srv_pos, wk_pos = nodes[1:3], nodes[3:]
    apps = []
    try:
        handles, servers = [], []
        for po in srv_pos:
            srv = ps.KVServer(0, postoffice=po)
            handles.append(ps.KVServerDefaultHandle())
            srv.set_request_handle(handles[-1])
            servers.append(srv)
        apps += servers
        workers = [ps.KVWorker(0, 0, postoffice=po) for po in wk_pos]
        apps += workers
        keys = np.array([r.begin + i for r in wk_pos[0].get_server_key_ranges()
                         for i in range(MSG_KEYS_PER_SERVER)], np.uint64)
        n = len(keys) * VAL_LEN
        rng = np.random.default_rng(SEED + 3)
        if codec is None:
            base = [rng.integers(-8, 8, size=n).astype(np.float32)
                    for _ in range(2)]
        else:
            base = [rng.standard_normal(n, dtype=np.float32)
                    for _ in range(2)]
            for w in workers:
                w.register_bucket(keys, codec=codec)
        bufs = [np.empty_like(b) for b in base]
        outs = [np.zeros_like(b) for b in base]
        bound = CodecBound(codec, n, 2) if codec else None
        s64 = np.zeros(n)
        raw = np.zeros(n, np.float32)

        phases = {"push": [], "barrier": [], "pull": []}

        def work(i):
            w = workers[i]
            t0 = time.perf_counter()
            w.wait(w.push(keys, bufs[i]))
            t1 = time.perf_counter()
            wk_pos[i].barrier(0, ps.WORKER_GROUP)
            t2 = time.perf_counter()
            w.wait(w.pull(keys, outs[i]))
            t3 = time.perf_counter()
            if r >= MSG_WARMUP:
                for name, dt in (("push", t1 - t0), ("barrier", t2 - t1),
                                 ("pull", t3 - t2)):
                    phases[name].append(dt)

        def sent():
            return (sum(po.van.send_bytes for po in wk_pos),
                    sum(po.van.send_bytes for po in srv_pos))

        times, worst, store_err, wire = [], 0.0, [], [0, 0]
        for r in range(MSG_WARMUP + rounds):
            for i in range(2):
                np.add(base[i], np.float32(r), out=bufs[i])
            before = sent()
            t0 = time.perf_counter()
            run_threads([lambda i=i: work(i) for i in range(2)],
                        f"{label} round {r}")
            times.append(time.perf_counter() - t0)
            if r >= MSG_WARMUP:
                after = sent()
                wire = [wire[j] + after[j] - before[j] for j in range(2)]
            for i in range(2):
                s64 += bufs[i]
                if bound is not None:
                    bound.pushed(bufs[i])
            for i in range(2):
                if bound is not None:
                    worst = max(worst, bound.check(f"{label} round {r} "
                                                   f"worker {i}", i, outs[i]))
                elif not np.array_equal(outs[i], s64):
                    bad = int((outs[i] != s64).sum())
                    raise AssertionError(f"{label} round {r}: worker {i} "
                                         f"pulled {bad} wrong values")
            if bound is not None:
                workers[0].wait(workers[0].pull(keys, raw, codec="raw"))
                store_err.append(float(np.abs(raw - s64).mean()))
        if [len(h.store) for h in handles] != [MSG_KEYS_PER_SERVER] * 2:
            raise AssertionError(f"{label}: servers hold the wrong keys")
        streams = sum(s.streams_opened for s in servers)
        shards = [s._apply_pool.num_shards if s._apply_pool else 0
                  for s in servers]
        elapsed = sum(times[MSG_WARMUP:])
        nbytes = VAL_LEN * 4
        gbps = 8 * nbytes * len(keys) * rounds / (elapsed * 1e9)
        ms = elapsed / rounds * 1e3
        up, down = (b / rounds for b in wire)
        detail = (f"every pull within the {codec} bound of the float64 sum "
                  f"(max |err| {worst:.4g}); store mean |err| by round "
                  f"(raw pulls) {', '.join(f'{e:.3g}' for e in store_err)}"
                  if codec else f"{MSG_WARMUP + rounds} rounds checked "
                  f"exactly")
        print(f"{label} (1 scheduler + 2 servers + 2 workers, loopback van, "
              f"{len(keys)} keys x {nbytes} B per worker and round, apply "
              f"shards per server {shards}, codec {codec or 'raw'}): "
              f"{ms:.3f} ms/round (push, worker barrier, pull; host path, "
              f"no device work; rounds "
              f"{', '.join(f'{t * 1e3:.1f}' for t in times[MSG_WARMUP:])} "
              f"ms), {gbps:.4f} Gbit/s per worker by test_benchmark's "
              f"8*len*total_key_num*iters/elapsed_ns, {2 * gbps:.4f} both "
              f"workers; wire bytes per round: workers sent {up:.0f}, "
              f"servers sent {down:.0f}; {detail}; per worker and round: "
              + ", ".join(f"{k} {sum(v) / len(v) * 1e3:.1f} ms"
                          for k, v in phases.items())
              + f" [{smi}] [host CPU {cpu_model()}]")
        row = {"config": label, "ops": 4 * (MSG_WARMUP + rounds),
               "max_abs_err_vs_f64": worst, "ms_per_round": ms,
               "gbps_per_worker": gbps, "wire_up_bytes_per_round": up,
               "wire_down_bytes_per_round": down, "streams": streams}
        if codec:
            row["store_mean_err"] = sum(store_err) / len(store_err)
        return [row]
    finally:
        msg_finalize(nodes, apps)


def drive_msg_codecs(ps, Environment, smi: str):
    """``msg-config2`` under each codec (error feedback on), and int8 again
    with ``PS_CODEC_EF=0``: error feedback must shrink the store's mean
    error over the rounds."""
    rows = []
    for codec in CODECS:
        rows += drive_msg_config2(ps, Environment, smi,
                                  label=f"msg-config2-{codec}", codec=codec,
                                  rounds=CODEC_ROUNDS)
    rows += drive_msg_config2(ps, Environment, smi,
                              label="msg-config2-int8-noef",
                              env={"PS_CODEC_EF": "0"}, codec="int8",
                              rounds=CODEC_ROUNDS)
    ef, noef = rows[0]["store_mean_err"], rows[-1]["store_mean_err"]
    if not ef < noef:
        raise AssertionError(f"error feedback did not shrink the store's mean "
                             f"error: {ef:.4g} with, {noef:.4g} without")
    print(f"msg-config2-int8: error feedback, store mean |err| over "
          f"{MSG_WARMUP + CODEC_ROUNDS} rounds {ef:.4g} against {noef:.4g} "
          f"with PS_CODEC_EF=0 ({noef / ef:.2f}x)")
    return rows


def drive_msg_pool_vs_serial(ps, Environment):
    """One worker, one server, the 80 x 1 MB keys: 3 pushes of seeded
    normal f32 and a pull, with the apply-shard pool (the default) and
    with ``PS_APPLY_SHARDS=0``: stores and pulls bit-equal."""
    keys = np.arange(2 * MSG_KEYS_PER_SERVER, dtype=np.uint64)
    rng = np.random.default_rng(SEED + 6)
    pushes = [rng.standard_normal(len(keys) * VAL_LEN, dtype=np.float32)
              for _ in range(3)]
    results = []
    for env in ({}, {"PS_APPLY_SHARDS": "0"}):
        nodes = msg_cluster(ps, Environment, 1, 1, env=env)
        apps = []
        try:
            srv = ps.KVServer(0, postoffice=nodes[1])
            handle = ps.KVServerDefaultHandle()
            srv.set_request_handle(handle)
            apps.append(srv)
            w = ps.KVWorker(0, 0, postoffice=nodes[2])
            apps.append(w)
            for p in pushes:
                w.wait(w.push(keys, p))
            out = np.zeros_like(pushes[0])
            w.wait(w.pull(keys, out))
            results.append((srv._apply_pool is not None, out,
                            {k: v.tobytes() for k, v in handle.store.items()}))
        finally:
            msg_finalize(nodes, apps)
    (pooled, out_a, st_a), (serial_pool, out_b, st_b) = results
    if not pooled or serial_pool:
        raise AssertionError("msg-pool-vs-serial: the pool did not run where "
                             "it should")
    if out_a.tobytes() != out_b.tobytes() or st_a != st_b:
        raise AssertionError("msg-pool-vs-serial: pool and serial stores "
                             "differ")
    print(f"msg-pool-vs-serial: 1 worker, {len(keys)} x {VAL_LEN * 4} B, 3 "
          f"pushes + pull: pool and PS_APPLY_SHARDS=0 stores and pulls "
          f"bit-equal")
    return [{"config": "msg-pool-vs-serial", "ops": 8,
             "max_abs_err_vs_f64": 0.0}]


@contextlib.contextmanager
def codec_plane(codecs, native: bool):
    """The codec module on the native core's kernels or on numpy for a
    leg (``PS_CODEC_NATIVE=0``'s choice, made in this process without a
    restart: the module keeps its probe in two globals)."""
    saved = (codecs._native_lib, codecs._native_probed)
    lib = codecs._native_codec()
    codecs._native_lib, codecs._native_probed = (lib if native else None,
                                                 True)
    try:
        yield
    finally:
        codecs._native_lib, codecs._native_probed = saved


def drive_codec_throughput(smi: str):
    """Encode and decode GB/s (raw bytes / host time) of one 81.92 MB
    float32 payload per codec, with ``PS_CODEC_THREADS`` at its default
    and at 1, on the native core's kernels and on numpy
    (``PS_CODEC_NATIVE=0``; bf16 is numpy in both), the legs alternating
    call by call; mean of 3 calls after one warm-up; the two legs'
    codes, scales, flags and decodes bit-equal, each decode within the
    codec's bound of the input."""
    from pslite_tpu_torch.ops import codecs

    x = np.random.default_rng(SEED + 7).standard_normal(
        2 * MSG_KEYS_PER_SERVER * VAL_LEN, dtype=np.float32)
    rows = []
    saved = os.environ.get("PS_CODEC_THREADS")
    try:
        for threads in (None, "1"):
            if threads is None:
                os.environ.pop("PS_CODEC_THREADS", None)
            else:
                os.environ["PS_CODEC_THREADS"] = threads
            nt = codecs.codec_threads()
            for name in CODECS:
                c = codecs.get_codec(name)
                legs = ("native", "numpy") if c.native_kind >= 0 else (
                    "numpy",)
                times = {(leg, op): [] for leg in legs
                         for op in ("encode", "decode")}
                last = {}
                for rep in range(4):
                    for leg in legs:
                        with codec_plane(codecs, leg == "native"):
                            t0 = time.perf_counter()
                            codes, scales, flags = c.encode(x)
                            t1 = time.perf_counter()
                            y = c.decode(codes, scales, x.size, flags=flags)
                            t2 = time.perf_counter()
                        if rep:
                            times[leg, "encode"].append(t1 - t0)
                            times[leg, "decode"].append(t2 - t1)
                        last[leg] = (codes.tobytes(), scales.tobytes(),
                                     flags, y.tobytes())
                        del codes, scales
                if len(set(last.values())) != 1:
                    raise AssertionError(f"codec {name}: the native and "
                                         f"numpy legs differ")
                y = np.frombuffer(last[legs[0]][3], np.float32)
                err = np.abs(y.astype(np.float64) - x)
                if not np.all(err <= np.repeat(codec_block_err(name, x),
                                               128)[:x.size]):
                    raise AssertionError(f"codec {name}: decode off its bound")
                wire = len(last[legs[0]][0]) + len(last[legs[0]][1])
                gbs = {k: x.nbytes / (sum(v) / len(v)) / 1e9
                       for k, v in times.items()}
                print(f"codec-throughput {name} (PS_CODEC_THREADS "
                      f"{threads or 'default'} = {nt} span threads): "
                      + "; ".join(
                          f"{leg}: encode {gbs[leg, 'encode']:.3f} GB/s, "
                          f"decode {gbs[leg, 'decode']:.3f} GB/s"
                          for leg in legs)
                      + f" of {x.nbytes} B f32 -> {wire} B on the wire "
                      f"({x.nbytes / wire:.2f}x); legs bit-equal; max |err| "
                      f"{float(err.max()):.3g} [{smi}] [host CPU "
                      f"{cpu_model()}]")
                for leg in legs:
                    rows.append({"config": f"codec-throughput {name} {leg} "
                                 f"threads {nt}", "ops": 6,
                                 "max_abs_err_vs_f64": float(err.max()),
                                 "encode_gbs": gbs[leg, "encode"],
                                 "decode_gbs": gbs[leg, "decode"],
                                 "wire_bytes": wire})
                del last, y
    finally:
        if saved is None:
            os.environ.pop("PS_CODEC_THREADS", None)
        else:
            os.environ["PS_CODEC_THREADS"] = saved
    return rows


def drive_msg_ici_mixed(ps, ring, Environment, grads_steps, smi: str):
    """The JAX IciVan's contract on the card: one KVWorker on an ``ici``
    cluster push_pulls the registered 40 x 1 MB bucket through K4 and
    pushes/pulls 16 unregistered 1 MB keys over messages to the server,
    those under the int8 codec (``register_bucket``), interleaved for 5
    steps, each against float64 numpy (the messages within the codec's
    bound).  Batching is on (``PS_BATCH_BYTES=262144``): then a
    ``multi_get`` of 64 single-row lookups of 64 B over messages, bit for
    bit, in one batch frame."""
    from pslite_tpu_torch.models import dlrm

    nodes = msg_cluster(ps, Environment, 1, 1, van="ici",
                        env={"PS_BATCH_BYTES": str(256 << 10)})
    apps = []
    try:
        srv = ps.KVServer(0, postoffice=nodes[1])
        handle = ps.KVServerDefaultHandle()
        srv.set_request_handle(handle)
        apps.append(srv)
        w = ps.KVWorker(0, 0, postoffice=nodes[2])
        apps.append(w)
        bucket = np.arange(KEYS, dtype=np.uint64)
        w.register_dense("grads", bucket, VAL_LEN)
        loose = np.arange(MSG_LOOSE_KEYS, dtype=np.uint64) + 1_000_000
        w.register_bucket(loose, codec="int8")
        lbound = CodecBound("int8", MSG_LOOSE_KEYS * VAL_LEN, 1)
        rng = np.random.default_rng(SEED + 4)
        lbase = rng.integers(-8, 8, size=MSG_LOOSE_KEYS * VAL_LEN).astype(
            np.float32)
        lbuf, lout = np.empty_like(lbase), np.zeros_like(lbase)
        outs = np.zeros(P, np.float32)
        s64, mag, worst = np.zeros(P), np.zeros(P), 0.0
        t_bucket, t_push, t_pull = [], [], []
        steps = 5
        for k in range(steps):
            g = grads_steps[k]
            t0 = time.perf_counter()
            w.wait(w.push_pull(bucket, g, outs))
            t_bucket.append(time.perf_counter() - t0)
            s64 += g.astype(np.float64).sum(0)
            mag += np.abs(g).astype(np.float64).sum(0)
            err = np.abs(outs - s64)
            worst = max(worst, float(err.max()))
            if not np.all(err <= 1e-6 + (k + 1) * (N + 1) * 2.0 ** -24 * mag):
                raise AssertionError(f"msg-ici-mixed: bucket step {k} off "
                                     f"float64 by {float(err.max())}")
            np.add(lbase, np.float32(k), out=lbuf)
            t0 = time.perf_counter()
            w.wait(w.push(loose, lbuf))
            t1 = time.perf_counter()
            w.wait(w.pull(loose, lout))
            t_push.append(t1 - t0)
            t_pull.append(time.perf_counter() - t1)
            lbound.pushed(lbuf)
            lworst = lbound.check(f"msg-ici-mixed: message step {k}", 0,
                                  lout)
        rows = np.arange(64, dtype=np.uint64) + 2_000_000
        table = dlrm.embedding_row(dlrm.DLRMConfig(), np.arange(64)).reshape(-1)
        w.wait(w.push(rows, table))
        frames0 = w.combiner.flushed_frames
        t0 = time.perf_counter()
        got = w.multi_get([rows[i:i + 1] for i in range(64)],
                          val_len=FANIN_DIM).wait()
        mg_ms = (time.perf_counter() - t0) * 1e3
        mg_frames = w.combiner.flushed_frames - frames0
        if not np.array_equal(np.concatenate(got), table) or mg_frames != 1:
            raise AssertionError(f"msg-ici-mixed: the multi_get of 64 rows "
                                 f"came back wrong or in {mg_frames} batch "
                                 f"frames")
        if sorted(handle.store) != loose.tolist() + rows.tolist():
            raise AssertionError(f"msg-ici-mixed: the server holds keys "
                                 f"{sorted(handle.store)[:4]}..., not exactly "
                                 f"the unregistered ones")
        k4 = ring.launches["ring_push_pull[float32]"]
        if k4 < steps:
            raise AssertionError(f"msg-ici-mixed: K4 launched {k4} times for "
                                 f"{steps} push_pulls")
        ms = {name: sum(t) / len(t) * 1e3 for name, t in (
            ("bucket", t_bucket), ("push", t_push), ("pull", t_pull))}
        print(f"msg-ici-mixed (1 scheduler + 1 server + 1 worker, ici van on "
              f"{N} ranks of cuda:0): {steps} steps; K4 "
              f"ring_push_pull[float32] launches {k4}; server store holds "
              f"exactly the {MSG_LOOSE_KEYS} unregistered keys and the 64 "
              f"rows; host ms per "
              f"op: bucket push_pull {ms['bucket']:.3f} (numpy grads, "
              f"host-to-device copy and result copy included), message push "
              f"{ms['push']:.3f}, message pull {ms['pull']:.3f} "
              f"({MSG_LOOSE_KEYS} x {VAL_LEN * 4} B, int8 codec, within its "
              f"bound: max |err| {lworst:.3g}); bucket max |err| vs "
              f"float64 {worst:.3g}; multi_get of 64 x {FANIN_DIM * 4} B "
              f"rows bit-exact in {mg_frames} batch frame, {mg_ms:.3f} ms "
              f"[{smi}]")
        return [{"config": "msg-ici-mixed", "ops": 3 * steps,
                 "max_abs_err_vs_f64": worst, "k4_launches": k4,
                 "bucket_ms": ms["bucket"], "msg_push_ms": ms["push"],
                 "msg_pull_ms": ms["pull"], "multi_get_ms": mg_ms}]
    finally:
        msg_finalize(nodes, apps)


def drive_msg_optimizer(ps, Environment):
    """KVServerOptimizerHandle adam over loopback: 3 pushes of the 40 x
    1 MB bucket and a pull, against float64 numpy Adam (rtol 1e-5, atol
    1e-6: the handle updates in float32 numpy)."""
    nodes = msg_cluster(ps, Environment, 1, 1)
    apps = []
    try:
        srv = ps.KVServer(0, postoffice=nodes[1])
        srv.set_request_handle(ps.KVServerOptimizerHandle(kind="adam",
                                                          lr=1e-3))
        apps.append(srv)
        w = ps.KVWorker(0, 0, postoffice=nodes[2])
        apps.append(w)
        keys = np.arange(KEYS, dtype=np.uint64)
        rng = np.random.default_rng(SEED + 5)
        p64, st = np.zeros(P), {"m": np.zeros(P), "v": np.zeros(P)}
        for t in range(1, 4):
            g = rng.standard_normal(P, dtype=np.float32)
            w.wait(w.push(keys, g))
            p64 = _adam_ref(p64, st, g.astype(np.float64), t, eps_hat=True)
        out = np.zeros(P, np.float32)
        w.wait(w.pull(keys, out))
        err = np.abs(out - p64)
        if not np.all(err <= 1e-6 + 1e-5 * np.abs(p64)):
            raise AssertionError(f"msg-optimizer: adam off float64 by "
                                 f"{float(err.max())}")
        print(f"msg-optimizer: adam over loopback, 3 pushes + 1 pull of "
              f"{KEYS} x {VAL_LEN * 4} B, max |err| vs float64 "
              f"{float(err.max()):.3g}")
        return [{"config": "msg-optimizer adam", "ops": 4,
                 "max_abs_err_vs_f64": float(err.max())}]
    finally:
        msg_finalize(nodes, apps)


# -- engine state that moves: checkpoints and reshard -------------------------

EL_KEYS = np.arange(KEYS, dtype=np.uint64)
EL_RING_KEYS = EL_KEYS + 1_000  # the sum bucket, beside the adam one
EL_HANDLE = "adam:1e-3"
EL_STEPS = 3


def elastic_cluster(ps, Environment, ranks: int):
    """1 scheduler + 1 server + 1 worker on the ``ici`` van, the worker's
    engines on ``ranks`` ranks of cuda:0 (ring impl, default handle
    ``adam:1e-3``), and through its KVWorker the 40 x 1,024,000 B bucket
    ``grads`` (adam), a bucket ``ring`` of the same size (pushed with the
    ``sum`` handle: K4) and config 5's table ``emb``."""
    nodes = msg_cluster(ps, Environment, 1, 1, van="ici", ranks=ranks,
                        env={"PS_ICI_SERVER_HANDLE": EL_HANDLE})
    srv = ps.KVServer(0, postoffice=nodes[1])
    srv.set_request_handle(ps.KVServerDefaultHandle())
    w = ps.KVWorker(0, 0, postoffice=nodes[2])
    w.register_dense("grads", EL_KEYS, VAL_LEN)
    w.register_dense("ring", EL_RING_KEYS, VAL_LEN)
    w.sparse_engine.register_sparse("emb", EMB_ROWS, EMB_DIM)
    return nodes, [w, srv], w


def elastic_grads(torch, emb, k: int, rows: int):
    """Step k's inputs for ``rows`` workers, made on the card from a seed
    drawn with numpy from SEED: dense grads ``[rows, P]``, config 5's
    Zipf rows ``[rows, 4096]`` and their grads ``[rows, 4096, 64]``."""
    seed = int(np.random.default_rng([SEED, k]).integers(1 << 31))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn((rows, P), device="cuda", generator=gen)
    rows_g = torch.randn((rows, EMB_BATCH, EMB_DIM), device="cuda",
                         generator=gen)
    return g, emb.skewed_indices(EMB_ROWS, rows, EMB_BATCH, seed=seed), rows_g


def elastic_step(torch, w, inputs, outs) -> int:
    """One step through the worker: adam push_pull of ``grads``
    (rank-order adds + K3), a ring sum push_pull of ``ring`` (K4), a
    row-Adagrad push of the table (S2) and its pull (S3) into a tensor,
    held bit for bit against the table's rows at the step's indices.
    Returns the shard count the pull ran on."""
    g, idx, rows_g = inputs
    w.wait(w.push_pull(EL_KEYS, g, outs))
    w.engine.push_pull("ring", g, handle="sum")
    w.wait(w.push_sparse("emb", idx, rows_g, handle=EMB_HANDLE))
    pulled = torch.empty(rows_g.shape, dtype=rows_g.dtype, device="cuda")
    w.wait(w.pull_sparse("emb", idx, out=pulled))
    se = w.sparse_engine
    want = se.store_global_device("emb")[
        torch.from_numpy(idx).long().cuda()]
    bad = int((pulled != want).sum())
    if bad:
        raise AssertionError(f"elastic: S3 pulled {bad} elements that differ "
                             f"from the table's rows at {se.num_shards} "
                             f"shards")
    return se.num_shards


class Elastic64:
    """The float64 reference of the elastic phase's state, on the card:
    adam on the engine's own f32 rank-order aggregate (as ``drive``), the
    ring bucket's exact sum, and row-wise Adagrad of the table."""

    def __init__(self, torch):
        z = lambda *s: torch.zeros(s, dtype=torch.float64, device="cuda")
        self.torch, self.t, self.adds = torch, 0, 0
        self.s, self.st = z(P), {"m": z(P), "v": z(P)}
        self.r, self.mag = z(P), z(P)
        self.table, self.acc = z(EMB_ROWS, EMB_DIM), z(EMB_ROWS)

    def dense(self, g) -> None:
        """Both buckets' step on the grads ``g`` [rows, P]."""
        agg = g[0].clone()
        for w in range(1, g.shape[0]):
            agg += g[w]
        self.t += 1
        self.s = _adam_ref(self.s, self.st, agg.double(), self.t)
        self.adds += g.shape[0] + 1
        self.r += g.double().sum(0)
        self.mag += g.abs().double().sum(0)

    def step(self, inputs) -> None:
        """A whole ``elastic_step``: the buckets and the table."""
        torch = self.torch
        g, idx, rows_g = inputs
        self.dense(g)
        G = torch.zeros_like(self.table)
        G.index_add_(0, torch.from_numpy(idx.reshape(-1)).long().cuda(),
                     rows_g.reshape(-1, EMB_DIM).double())
        self.acc += (G * G).mean(1)
        self.table -= 0.01 * G / (self.acc.sqrt()[:, None] + 1e-8)

    def check(self, state) -> float:
        """Max |err| of the buckets and, where ``state`` holds it, the
        table against the reference, within drive's bounds: adam rtol
        1e-5 / atol 1e-6; the sum :func:`_sum_bound` + 1e-6; the table
        1e-4 + 1e-4 |value|."""
        worst = 0.0
        for key, ref, tol in (
                ("grads", self.s, 1e-6 + 1e-5 * self.s.abs()),
                ("ring", self.r, 1e-6 + _sum_bound(self.adds, self.mag)),
                ("table", self.table, 1e-4 + 1e-4 * self.table.abs())):
            if key not in state:
                continue
            got = state[key].double()
            if not bool(got.isfinite().all()):
                raise AssertionError(f"elastic: non-finite {key}")
            err = (got - ref).abs()
            if not bool((err <= tol).all()):
                raise AssertionError(f"elastic: {key} off float64 by "
                                     f"{float(err.max())}")
            worst = max(worst, float(err.max()))
        return worst


def elastic_state(w, eng=None, se=None) -> dict:
    """Copies of the logical state (``[:P]``, tables in global row
    order) of a worker's engines, or of ``eng``/``se``."""
    eng = eng or w.engine
    kind, st = eng.opt_state("grads")
    out = {"grads": eng.store_array("grads")[:P], "m": st[0][:P],
           "v": st[1][:P], "step": st[2][:1],
           "ring": eng.store_array("ring")[:P]}
    se = se or (w.sparse_engine if w is not None else None)
    if se is not None:
        out["table"] = se.store_global_device("emb")
        out["acc"] = se.acc_global_device("emb")
    return out


def differing(a: dict, b: dict, what: str) -> int:
    """Elements where two states differ: none may (a recut and a restore
    move data only)."""
    if a.keys() != b.keys():
        raise AssertionError(f"{what}: states hold {sorted(a)} and "
                             f"{sorted(b)}")
    count = 0
    for k in a:
        if a[k].shape != b[k].shape:
            raise AssertionError(f"{what}: {k} shapes {tuple(a[k].shape)} "
                                 f"and {tuple(b[k].shape)}")
        count += int((a[k] != b[k]).sum())
    if count:
        raise AssertionError(f"{what}: {count} elements differ")
    return count


def timed(torch, fn) -> float:
    """Milliseconds of ``fn()`` on the host clock, to a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def async_matches_sync(async_path: str, sync_path: str, shards: int,
                       rps: int) -> int:
    """Differing elements between the async checkpointer's v1 file and
    the v2 file of the same point, each read in its layout: padded
    stores and states cut to P, the per-shard adam step against the
    scalar, the interleaved table and accumulator in global row order."""
    from pslite_tpu_torch.parallel.sparse import _deinterleave_rows

    count = 0
    with np.load(async_path) as a, np.load(sync_path) as s:
        if set(a.files) != set(s.files):
            raise AssertionError(f"async file members {sorted(a.files)}, "
                                 f"sync {sorted(s.files)}")
        for k in ("dense/grads", "dense/ring", "opt/grads/0", "opt/grads/1"):
            count += int((a[k][:P] != s[k]).sum())
        count += int((a["opt/grads/2"] != s["opt/grads/2"][0]).sum())
        for k in ("sparse/emb", "sparse_acc/emb"):
            count += int((_deinterleave_rows(a[k], EMB_ROWS, rps, shards)
                          != s[k]).sum())
    if count:
        raise AssertionError(f"async checkpoint: {count} elements differ "
                             f"from the sync file of the same point")
    return count


def drive_elastic(torch, ps, ring, emb, Environment, smi: str):
    """Engine state that moves, at full size on cuda:0 (the 40 x 1 MB
    adam bucket, a 40 x 1 MB sum bucket, config 5's table under
    row_adagrad), through KVWorker on the ici van:

    1. run A (8 ranks): 3 steps, ``save_engine`` (v2) and an
       ``AsyncEngineCheckpointer.save``, 3 more steps at once; run B, a
       fresh cluster, restores the v2 file and runs the same 3 steps: A
       and B bit-equal; every step's S3 pull, at 8 shards here and at 4
       in step 3, equals the table's rows at its indices bit for bit;
    2. the async (v1) file equals the v2 file of that point, bit for bit;
    3. run A reshards 8 -> 4 through ``KVWorker.reshard``; a 4-rank
       cluster C restores the v2 file that ``save_engine`` writes of run A
       at that point: bit-equal, and after 3 more steps of the same 4-row
       grads (K4 1-D at n = 4, K3, S2, S3) still, and within the float64
       reference's bounds; run B's engines reshard 8 -> 4 -> 8, dense and
       sparse apart (timed), and equal A at 4;
    4. run A reshards back to 8; its dense state restored into a (dp 2,
       kv 4) engine (worker_axis dp, ring) that reshards onto
       ``make_group((2, 2, 2), ("dp", "kv1", "kv2"))`` with the composite
       axis, and into a (dp 2, kv 4) engine: 3 steps of the same 2-row
       grads on both, bit-equal (K4's dp sub-rings over the composite
       axis, counted), and the composite engine's buckets within the
       float64 reference's bounds;
    5. 5 adam push_pulls with an async write pending against 5 without.

    Prints each timing with the card and the host CPU; removes its
    files."""
    from pslite_tpu_torch import checkpoint as ckpt

    host = cpu_model()
    tag = f"[{smi}; host {host}]"
    results = []
    outs = np.zeros(P, np.float32)
    ref = Elastic64(torch)
    pulls = []  # the shard count of every S3 pull, each checked
    steps = [elastic_grads(torch, emb, k, N) for k in range(2 * EL_STEPS)]
    with tempfile.TemporaryDirectory(prefix="chip-smoke-elastic-") as tmp:
        f3, f3a, f6 = (os.path.join(tmp, n) for n in
                       ("step3.npz", "step3-async", "step6.npz"))
        nodes_a, apps_a, wa = elastic_cluster(ps, Environment, N)
        clusters = [(nodes_a, apps_a)]
        try:
            for k in range(EL_STEPS):
                pulls.append(elastic_step(torch, wa, steps[k], outs))
                ref.step(steps[k])
            save_ms = timed(torch, lambda: ckpt.save_engine(
                wa.engine, f3, sparse_engine=wa.sparse_engine))
            mb = os.path.getsize(f3) / 1e6
            ck = ckpt.AsyncEngineCheckpointer()
            t0 = time.perf_counter()
            ck.save(wa.engine, f3a, sparse_engine=wa.sparse_engine)
            async_ms = (time.perf_counter() - t0) * 1e3
            for k in range(EL_STEPS, 2 * EL_STEPS):
                pulls.append(elastic_step(torch, wa, steps[k], outs))
                ref.step(steps[k])
            ck.wait()
            print(f"elastic save_engine (v2, 40 x 1 MB adam + 40 x 1 MB sum "
                  f"+ 1,048,576 x 64 table and accumulator): {save_ms:.1f} "
                  f"ms, {mb:.1f} MB, {mb / save_ms * 1e3:.1f} MB/s {tag}")
            print(f"elastic AsyncEngineCheckpointer.save: {async_ms:.3f} ms "
                  f"host per call (clones on the card; the write ran under "
                  f"the next 3 steps) {tag}")
            rps8 = wa.sparse_engine.table("emb").rows_per_shard
            results.append({"config": "elastic async v1 file vs sync v2 "
                                      "file (step 3)", "ops": 2,
                            "differing": async_matches_sync(
                                f3a + ".npz", f3, N, rps8),
                            "async_save_ms_host": async_ms})

            nodes_b, apps_b, wb = elastic_cluster(ps, Environment, N)
            clusters.append((nodes_b, apps_b))
            restore_ms = timed(torch, lambda: ckpt.restore_engine(
                wb.engine, f3, sparse_engine=wb.sparse_engine))
            for k in range(EL_STEPS, 2 * EL_STEPS):
                pulls.append(elastic_step(torch, wb, steps[k], outs))
            print(f"elastic restore_engine (v2, 8 ranks): {restore_ms:.1f} "
                  f"ms {tag}")
            results.append({"config": "elastic restore + 3 steps vs live "
                                      "(8 ranks)", "ops": 4 * EL_STEPS,
                            "differing": differing(
                                elastic_state(wb), elastic_state(wa),
                                "restore vs live"),
                            "save_ms": save_ms, "file_mb": mb,
                            "restore_ms": restore_ms})

            # 3. Cross-fleet.
            ckpt.save_engine(wa.engine, f6, sparse_engine=wa.sparse_engine)
            g4 = ps.DeviceGroup(4)
            kv_ms = timed(torch, lambda: wa.reshard(g4))
            nodes_c, apps_c, wc = elastic_cluster(ps, Environment, 4)
            clusters.append((nodes_c, apps_c))
            ckpt.restore_engine(wc.engine, f6, sparse_engine=wc.sparse_engine)
            results.append({"config": "elastic restore on 4 vs reshard 8->4",
                            "ops": 2, "differing": differing(
                                elastic_state(wc), elastic_state(wa),
                                "restore on 4 vs reshard to 4"),
                            "kvworker_reshard_8to4_ms": kv_ms})
            apart = {}
            for label, group in (("8->4", g4), ("4->8", ps.DeviceGroup(N))):
                apart[label] = (
                    timed(torch, lambda: wb.engine.reshard(group)),
                    timed(torch, lambda: wb.sparse_engine.reshard(group)))
                if label == "8->4":
                    differing(elastic_state(wb), elastic_state(wa),
                              "engine.reshard vs KVWorker.reshard")
            for label, (d_ms, s_ms) in apart.items():
                print(f"elastic reshard {label}: dense {d_ms:.1f} ms (40 x 1 "
                      f"MB adam + 40 x 1 MB sum), sparse {s_ms:.1f} ms "
                      f"(table + accumulator) {tag}")
            print(f"elastic KVWorker.reshard 8->4 (barriers, both engines): "
                  f"{kv_ms:.1f} ms {tag}")
            k4 = ring.launches["ring_push_pull[float32]"]
            for k in range(2 * EL_STEPS, 3 * EL_STEPS):
                inputs = elastic_grads(torch, emb, k, 4)
                for w in (wa, wc):
                    pulls.append(elastic_step(torch, w, inputs, outs))
                ref.step(inputs)
            k4 = ring.launches["ring_push_pull[float32]"] - k4
            if k4 != 2 * EL_STEPS:
                raise AssertionError(f"elastic: K4 launched {k4} times for "
                                     f"{2 * EL_STEPS} ring steps at n = 4")
            state_a = elastic_state(wa)
            results.append({"config": "elastic 3 steps after restore on 4 "
                                      "vs after reshard to 4", "ops":
                            8 * EL_STEPS, "differing": differing(
                                elastic_state(wc), state_a, "4-rank steps"),
                            "max_abs_err_vs_f64": ref.check(state_a)})
            del state_a
            if sorted(set(pulls)) != [4, N]:
                raise AssertionError(f"elastic: S3 pulls ran on {pulls} "
                                     f"shards, not on both {N} and 4")
            results.append({"config": f"elastic S3 pulls vs the table's rows "
                                      f"({pulls.count(N)} at {N} shards, "
                                      f"{pulls.count(4)} at 4)",
                            "ops": len(pulls), "differing": 0})

            # 4. Back to 8, then the composite axis.
            grow_ms = timed(torch, lambda: wa.reshard(ps.DeviceGroup(N)))
            print(f"elastic KVWorker.reshard 4->8: {grow_ms:.1f} ms {tag}")
            f9 = os.path.join(tmp, "dense.npz")
            ckpt.save_engine(wa.engine, f9)
            engines = []
            for shape, names in (((2, 4), ("dp", "kv")),
                                 ((2, 4), ("dp", "kv"))):
                e = ps.CollectiveEngine(ps.make_group(shape, names),
                                        worker_axis="dp", impl="ring",
                                        server_handle=EL_HANDLE)
                e.register_dense("grads", EL_KEYS, VAL_LEN)
                e.register_dense("ring", EL_RING_KEYS, VAL_LEN)
                ckpt.restore_engine(e, f9)
                engines.append(e)
            comp, two_d = engines
            comp.reshard(ps.make_group((2, 2, 2), ("dp", "kv1", "kv2")),
                         axis_name=("kv1", "kv2"))
            if comp.num_shards != 4 or comp.axis != ("kv1", "kv2"):
                raise AssertionError("elastic: the composite reshard left "
                                     f"{comp.num_shards} shards on "
                                     f"{comp.axis}")
            k4c = 0
            for k in range(3 * EL_STEPS, 4 * EL_STEPS):
                g2 = elastic_grads(torch, emb, k, 2)[0]
                ref.dense(g2)
                for e in (comp, two_d):
                    before = ring.launches["ring_push_pull_2d[float32]"]
                    e.push_pull("grads", g2)
                    e.push_pull("ring", g2, handle="sum")
                    if e is comp:
                        k4c += (ring.launches["ring_push_pull_2d[float32]"]
                                - before)
            if k4c != EL_STEPS:
                raise AssertionError(f"elastic: K4's sub-rings launched {k4c} "
                                     f"times on the composite axis for "
                                     f"{EL_STEPS} steps")
            state_c = elastic_state(None, comp)
            results.append({"config": "elastic composite (dp 2, kv1 2, kv2 2) "
                                      "vs 2-D (dp 2, kv 4), 3 steps",
                            "ops": 2 * EL_STEPS, "differing": differing(
                                state_c, elastic_state(None, two_d),
                                "composite vs 2-D"), "k4_composite": k4c,
                            "max_abs_err_vs_f64": ref.check(state_c)})
            del state_c
            del comp, two_d, engines

            # 5. Steps with a write pending, against steps without.
            g = steps[0][0]
            ck.save(wa.engine, os.path.join(tmp, "pending"),
                    sparse_engine=wa.sparse_engine)
            pending = timed(torch, lambda: [wa.wait(wa.push_pull(
                EL_KEYS, g, outs)) for _ in range(5)]) / 5
            still = ck._q.unfinished_tasks > 0
            ck.close()
            quiet = timed(torch, lambda: [wa.wait(wa.push_pull(
                EL_KEYS, g, outs)) for _ in range(5)]) / 5
            print(f"elastic push_pull (adam 40 x 1 MB, device grads, result "
                  f"to numpy): {pending:.3f} ms/step with an async write "
                  f"pending (still pending after the 5 steps: {still}), "
                  f"{quiet:.3f} ms/step without {tag}")
            results.append({"config": "elastic push_pull with an async write "
                                      "pending / without", "ops": 10,
                            "pending_ms_per_step": pending,
                            "quiet_ms_per_step": quiet})
        finally:
            for nodes, apps in reversed(clusters):
                msg_finalize(nodes, apps)
    return results


# -- separate processes (BASELINE configs 1-3) --------------------------------

PROC_DEADLINE = 240.0  # seconds for every child of one launch
MB_LEN = VAL_LEN * 4  # 1,024,000 B per key
SIZE_KEY_STRIDE = 100_000  # each size of a phase pushes its own keys


def node_main() -> int:
    """One node process of a process phase (``chip_smoke.py --node``):
    the role from ``DMLC_ROLE`` as a launcher sets it, the workload from
    ``SMOKE_SPEC`` (JSON).  Prints one JSON line, its last."""
    spec = json.loads(os.environ["SMOKE_SPEC"])
    if spec.get("phase") == "failover":
        return node_failover(spec)  # no torch: its supervisor restarts fast
    import torch
    import pslite_tpu_torch as ps
    from pslite_tpu_torch.ops import ring_collective as ring

    if spec.get("phase") == "recovery":
        return node_recovery(spec)
    role = os.environ["DMLC_ROLE"]
    if spec.get("profile_dir") and role == "worker":
        # ENABLE_PROFILING's event log, one file per process.
        os.environ["ENABLE_PROFILING"] = "1"
        os.environ["PROFILE_PATH"] = os.path.join(
            spec["profile_dir"], f"{role}-{os.getpid()}.csv")
    ranks = spec.get("ranks", 0)
    if role == "worker" and ranks:
        # The engine on this card's virtual ranks (the main path's n).
        pos = [ps.Postoffice("worker")]
        pos[0].van.set_mesh(ps.DeviceGroup(ranks))
        pos[0].start()
    else:
        ps.start_ps()
        pos = None
    report = {"role": role, "pid": os.getpid()}
    apps = []
    if role in ("server", "joint"):
        srv = ps.KVServer(0)
        srv.set_request_handle(AssignHandle(ps) if spec.get("handle")
                               == "assign" else ps.KVServerDefaultHandle())
        apps.append(srv)
        report["streams_opened"] = lambda: srv.streams_opened
        if os.environ.get("ENABLE_RECV_BUFFER") == "1":
            # test_benchmark.cc:268-320: each worker's slice lands in a
            # buffer pinned for it.
            po = ps.postoffice("server")
            begin = po.get_server_key_ranges()[po.my_rank()].begin
            for wid in po.get_node_ids(ps.WORKER_GROUP):
                for si, (per_server, nbytes) in enumerate(spec["sizes"]):
                    srv.register_recv_buffer(
                        int(wid), int(begin) + si * SIZE_KEY_STRIDE,
                        np.zeros(per_server * nbytes // 4, np.float32))
        report["delivered_in_place"] = lambda: srv.delivered_in_place
        if spec.get("phase") == "durable-serve":
            report["tier"] = lambda: (
                repr(srv._handle.store) if hasattr(srv._handle.store,
                                                   "tier_of")
                else f"dict of {len(srv._handle.store)} keys")
    if role in ("worker", "joint"):
        po = pos[0] if pos else ps.postoffice("worker")
        kv = ps.KVWorker(0, 0, postoffice=po)
        apps.append(kv)
        if ranks:
            report.update(node_ici(torch, ring, kv, spec))
            if spec.get("trace_steps"):
                print("STEPS_DONE", flush=True)  # the card is idle now
        elif spec.get("phase"):
            report.update(TIER_NODES[spec["phase"]](ps, po, kv, spec))
        else:
            report.update(node_rounds(ps, po, kv, spec))
    # finalize's barrier keeps the servers answering until every worker
    # is done; the apps stop after it.  With the server killed
    # (``deadline``) there is no barrier to meet: the scheduler (the
    # failure detector) and the server (until it is killed) stay up
    # until the parent closes their stdin.
    deadline = spec.get("phase") == "deadline"
    if deadline and role != "worker":
        sys.stdin.read()
    if role == "scheduler" and spec.get("observe") is not None:
        report.update(observe_cluster(ps.postoffice("scheduler"),
                                      spec["observe"]))
    if pos:
        pos[0].finalize()
    else:
        ps.finalize(do_barrier=not deadline)
    if "tier" in report:
        report["tier"] = report["tier"]()  # before stop closes the tier
    for a in apps:
        a.stop()
    for key in ("delivered_in_place", "streams_opened"):
        if key in report:
            report[key] = report[key]()
    path = os.environ.get("PROFILE_PATH")
    if spec.get("profile_dir") and path:
        # The van closed the log at finalize.
        with open(path) as f:
            rows = [ln.split(",") for ln in f.read().split()]
        report["profile_engine"] = [r[:2] + r[3:] for r in rows
                                    if r[1].endswith("_engine")]
        report["profile_events"] = len(rows)
    report["ok"] = True
    print(json.dumps(report), flush=True)
    return 0


def van_native(van) -> bool:
    """Whether a van (every rail of a composite) runs the native core."""
    rails = getattr(van, "_rails", None)
    if rails is not None:
        return all(van_native(r) for r in rails)
    return getattr(van, "_native", None) is not None


def node_rounds(ps, po, kv, spec) -> dict:
    """test_benchmark's rounds at each ``[keys per server, bytes per
    key]`` of ``spec["sizes"]`` (key ranges disjoint per size):
    ``push_pull`` (fused) or ``push`` + worker barrier + ``pull``, with
    integer-valued f32 pushes, so every pulled value is checked
    exactly whatever order the workers' pushes arrive in.  With
    ``spec["codec"]`` the keys are ``register_bucket``-ed under it, the
    pushes are seeded normal f32, and each pull must lie within
    ``CodecBound`` of the float64 sum of every worker's pushes.  Every
    size runs its warm-up rounds first; then ``spec["rounds"]`` timed
    rounds of each size, once, or once per window of
    ``spec["windows"]`` (``node_windows``; one ``WINDOW`` report each)."""
    workers = po.num_workers
    me = po.my_rank()
    codec = spec.get("codec")
    states = []
    for si, (per_server, nbytes) in enumerate(spec["sizes"]):
        ranges = po.get_server_key_ranges()
        keys = np.array([r.begin + si * SIZE_KEY_STRIDE + i for r in ranges
                         for i in range(per_server)], np.uint64)
        vlen = nbytes // 4
        rng = np.random.default_rng(SEED + 7 + si)
        st = {"nbytes": nbytes, "keys": keys, "r": 0, "times": [],
              "wire": [], "worst": 0.0}
        if codec:
            kv.register_bucket(keys, codec=codec)
            st["bases"] = [rng.standard_normal(len(keys) * vlen,
                                               dtype=np.float32)
                           for _ in range(workers)]
            st["bound"] = CodecBound(codec, len(keys) * vlen, 1)
            bases = st["bases"]
        else:
            bases = [rng.integers(-8, 8, size=len(keys) * vlen).astype(
                np.float32) for _ in range(workers)]
        st["base"] = bases[me]
        st["base_sum"] = sum(b.astype(np.float64) for b in bases)
        del bases
        st["buf"] = np.empty_like(st["base"])
        st["dst"] = (kv.alloc_pull_buffer(keys, vlen) if spec.get("zpull")
                     else None)
        if spec.get("zpull") and st["dst"] is None:
            raise AssertionError("alloc_pull_buffer returned None")
        st["outs"] = (st["dst"] if st["dst"] is not None
                      else np.zeros_like(st["base"]))
        states.append(st)

    def run(st, n: int, timed: bool) -> None:
        keys, buf, outs = st["keys"], st["buf"], st["outs"]
        for _ in range(n):
            r = st["r"]
            np.add(st["base"], np.float32(r), out=buf)
            before = (po.van.send_bytes, po.van.recv_bytes)
            t0 = time.perf_counter()
            if spec["mode"] == "push_pull":
                kv.wait(kv.push_pull(keys, buf, outs))
            else:
                kv.wait(kv.push(keys, buf))
                po.barrier(0, ps.WORKER_GROUP)
                kv.wait(kv.pull(keys, outs))
            dt = time.perf_counter() - t0
            if timed:
                st["times"].append(dt)
                st["wire"].append((po.van.send_bytes - before[0],
                                   po.van.recv_bytes - before[1]))
            if codec:
                for b in st["bases"]:
                    st["bound"].pushed(b + np.float32(r))
                st["worst"] = max(st["worst"], st["bound"].check(
                    f"size {st['nbytes']} B round {r}", 0, outs))
            else:
                want = (r + 1) * st["base_sum"] + workers * r * (r + 1) / 2
                if not np.array_equal(outs, want):
                    raise AssertionError(f"size {st['nbytes']} B round "
                                         f"{r}: {int((outs != want).sum())}"
                                         f" values wrong")
            st["r"] += 1
            # The next round's push must not overtake a slower worker's
            # pull of this one.
            if spec["mode"] != "push_pull":
                po.barrier(0, ps.WORKER_GROUP)

    def stats(st, first: int = 0) -> dict:
        timed = st["times"][first:]
        wire = st["wire"][first:]
        elapsed = sum(timed)
        nkeys = len(st["keys"])
        return {"keys": nkeys, "ms_per_round": elapsed / len(timed) * 1e3,
                "gbps": 8 * st["nbytes"] * nkeys * len(timed)
                / (elapsed * 1e9),
                "rounds_ms": [t * 1e3 for t in timed], "checked": st["r"],
                "max_err": st["worst"],
                "sent_per_round": sum(w[0] for w in wire) / len(timed),
                "recv_per_round": sum(w[1] for w in wire) / len(timed)}

    for st in states:
        run(st, spec["warmup"], timed=False)
    if spec.get("windows"):
        for _ in node_windows(spec):
            marks = [len(st["times"]) for st in states]
            for st in states:
                run(st, spec["rounds"], timed=True)
            window_done({"sizes": {str(st["nbytes"]): stats(st, m)
                                   for st, m in zip(states, marks)}})
    else:
        for st in states:
            run(st, spec["rounds"], timed=True)
    out = {str(st["nbytes"]): stats(st) for st in states}
    for st in states:
        if st["dst"] is not None:
            kv.free_pull_buffer(st["keys"])
    del states
    out["zpull_hits"] = kv.zpull_hits
    out["chunks"] = [po.van.chunks_sent, po.van.chunks_recv]
    return {"sizes": out, "native": van_native(po.van),
            "pipe_mode": getattr(po.van, "_pipe_mode", False)}


def node_ici(torch, ring, kv, spec) -> dict:
    """The ``ici_tcp``/``ici_shm`` worker: the 40 x 1 MB bucket through K4
    with grads on the card against float64, and ``MSG_LOOSE_KEYS``
    unregistered 1 MB keys over messages to the server, exactly;
    interleaved for ``spec["steps"]`` steps."""
    ring.reset_launches()
    n = spec["ranks"]
    bucket = np.arange(KEYS, dtype=np.uint64)
    kv.register_dense("grads", bucket, VAL_LEN)
    loose = np.arange(MSG_LOOSE_KEYS, dtype=np.uint64) + 1_000_000
    lbase = np.random.default_rng(SEED + 8).integers(
        -8, 8, size=MSG_LOOSE_KEYS * VAL_LEN).astype(np.float32)
    lbuf, lout = np.empty_like(lbase), np.zeros_like(lbase)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    outs = torch.zeros(P, device="cuda")
    s64 = torch.zeros(P, dtype=torch.float64, device="cuda")
    mag = torch.zeros(P, dtype=torch.float64, device="cuda")
    worst, t_bucket, t_msg = 0.0, [], []
    traced = spec.get("trace_steps", 0)

    def step(k: int) -> None:
        nonlocal worst
        g = torch.randn((n, P), device="cuda", generator=gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kv.wait(kv.push_pull(bucket, g, outs))
        t_bucket.append(time.perf_counter() - t0)
        s64.add_(g.double().sum(0))
        mag.add_(g.double().abs().sum(0))
        err = (outs.double() - s64).abs()
        worst = max(worst, float(err.max()))
        if not bool((err <= 1e-6 + (k + 1) * (n + 1) * 2.0 ** -24
                     * mag).all()):
            raise AssertionError(f"bucket step {k} off float64 by "
                                 f"{float(err.max())}")
        np.add(lbase, np.float32(k), out=lbuf)
        t0 = time.perf_counter()
        kv.wait(kv.push(loose, lbuf))
        kv.wait(kv.pull(loose, lout))
        t_msg.append(time.perf_counter() - t0)
        want = (k + 1) * lbase.astype(np.float64) + k * (k + 1) / 2
        if not np.array_equal(lout, want):
            raise AssertionError(f"message step {k} pulled wrong values")

    steps = spec["steps"]
    for k in range(steps - traced):
        step(k)
    extra = {}
    if traced:
        # The observability phase: torch.profiler (device_trace) around
        # the last steps; the van's event profiler is on.  A profiler
        # window now and then comes back without device events: one
        # more step, traced, then.
        from pslite_tpu_torch.utils.profiling import device_trace

        k, rings, dt = steps - traced, [], None
        for attempt in range(3):
            with device_trace(spec["trace_dir"]) as dt:
                for _ in range(traced if attempt == 0 else 1):
                    step(k)
                    k += 1
                torch.cuda.synchronize()
            rings = [ev for ev in dt.events if "ring_kernel" in ev.key]
            if rings:
                break
        steps = k
        if not rings:
            raise AssertionError("device_trace names no ring_kernel")
        us = sum(getattr(ev, "device_time_total", 0)
                 or getattr(ev, "cuda_time_total", 0) for ev in rings)
        calls = sum(ev.count for ev in rings)
        extra = {"ring_kernel_us": us / calls, "ring_kernel_calls": calls,
                 "ring_kernel_names": sorted({ev.key for ev in rings}),
                 "trace_path": dt.path, "traced_attempts": attempt + 1}
    return {"launches": dict(ring.launches), "max_abs_err_vs_f64": worst,
            **extra,
            "native": van_native(kv.po.van),
            "bucket_ms": sum(t_bucket) / len(t_bucket) * 1e3,
            "msg_ms": sum(t_msg) / len(t_msg) * 1e3, "steps": steps}


# -- message-path tiers: one process per node over tcp ------------------------

TIER_ROUNDS = 2   # interleaved rounds of each phase's two legs
TIER_SECS = 1.0   # pipeline window of each leg and round
SOB_DEPTH = 256
SOB_OP_BYTES = 4096
FANIN_ROWS = 1 << 20  # models/dlrm.py:22-28's DLRMConfig at the 1M rows
FANIN_DIM = 16        # its comment names; 64 MiB of f32
FANIN_OUT = 64        # lookups per request (benchmark.py:495)
FANIN_DEPTH = 8
HOT_ROWS = 1024       # benchmark.py:337-340's dlrm_serve table
HOT_PULLS = 2000      # benchmark.py:2084's full-size storm
HOT_RYW_ROWS = 32     # rows pushed then pulled after the timed storm
MT_BULK_MB = 4
MT_DEPTH = 12
MT_RAMP = 0.5         # seconds the bulk pipeline runs before and after
                      # each serve window (benchmark.py:268-276's warm)
TIER_BATCH = {"PS_BATCH_BYTES": str(256 << 10)}
MT_ENV = {"PS_TENANTS": "serve:8,train:1", "PS_TENANT_QUEUE_LIMIT": "8",
          "PS_CHUNK_BYTES": str(256 << 10),
          "PS_APPLY_TASK_BYTES": str(512 << 10),
          "PS_TCP_SNDBUF": str(256 << 10), "PS_TCP_RCVBUF": str(256 << 10)}


class AssignHandle:
    """Assign on push, echo on pull, on the customer thread (the JAX
    benchmark's ``BenchmarkHandle``): the last push of a key is what a
    pull returns, so a storm's final pull proves order and values."""

    def __init__(self, ps):
        self._kvpairs = ps.KVPairs
        self.store = {}

    def __call__(self, meta, kvs, server):
        if meta.push:
            k = len(kvs.vals) // max(len(kvs.keys), 1)
            block = np.array(kvs.vals)
            for i, key in enumerate(kvs.keys.tolist()):
                self.store[key] = block[i * k:(i + 1) * k]
        if meta.pull:
            server.response(meta, self._kvpairs(keys=kvs.keys, vals=(
                np.concatenate([self.store[k] for k in kvs.keys.tolist()]))))
        else:
            server.response(meta)


def pctl_ms(lats) -> tuple:
    """(p50, p99) of latencies in seconds, in ms (benchmark.py:225)."""
    if not lats:
        return 0.0, 0.0
    s = sorted(lats)
    return (s[len(s) // 2] * 1e3, s[min(len(s) - 1, int(len(s) * 0.99))]
            * 1e3)


def push_table(kv, keys: np.ndarray, tenant=None) -> float:
    """Publish the embedding table (one key per row); seconds taken."""
    from pslite_tpu_torch.models import dlrm

    vals = dlrm.embedding_row(dlrm.DLRMConfig(emb_dim=FANIN_DIM),
                              np.arange(len(keys))).reshape(-1)
    t0 = time.perf_counter()
    kv.wait(kv.push(keys, vals, tenant=tenant))
    return time.perf_counter() - t0


def node_windows(spec):
    """After a node's set-up: print ``READY``, then yield once for each of
    ``spec["windows"]`` windows, each after the parent's go (a line on
    stdin; see ``Cluster``)."""
    print("READY", flush=True)
    for i in range(spec["windows"]):
        if not sys.stdin.readline():
            raise AssertionError("the parent closed the window pipe")
        yield i


def window_done(report: dict) -> None:
    print("WINDOW " + json.dumps(report), flush=True)


def node_small_op(ps, po, kv, spec) -> dict:
    """``benchmark.py:400-468``, once per window: one key, 4,096 B pushes
    of each op's ordinal through a depth-256 pipeline, then sequential
    pushes for the low-load latency, then a pull that must equal the
    last ordinal."""
    from collections import deque

    keys = np.zeros(1, np.uint64)
    pool = [np.empty(SOB_OP_BYTES // 4, np.float32)
            for _ in range(SOB_DEPTH + 64)]
    seq = 0

    def op_vals(v):
        buf = pool[v % len(pool)]
        buf.fill(np.float32(v))
        return buf

    for _ in range(32):  # warm: connections, the capability probe
        seq += 1
        kv.wait(kv.push(keys, op_vals(seq)))
    comb = kv.combiner
    out = np.zeros(SOB_OP_BYTES // 4, np.float32)
    for _w in node_windows(spec):
        f0, o0 = ((comb.flushed_frames, comb.flushed_ops) if comb
                  else (0, 0))
        sent0 = po.van.frames_sent
        pending, n_ops = deque(), 0
        t0 = time.perf_counter()
        t_end = t0 + spec["secs"]
        while time.perf_counter() < t_end:
            seq += 1
            pending.append(kv.push(keys, op_vals(seq)))
            n_ops += 1
            if len(pending) >= SOB_DEPTH:
                kv.wait(pending.popleft())
        while pending:
            kv.wait(pending.popleft())
        wall = time.perf_counter() - t0
        frames = po.van.frames_sent - sent0
        merged = ((comb.flushed_frames - f0, comb.flushed_ops - o0)
                  if comb else (0, 0))
        lats = []
        t_end = time.perf_counter() + min(1.0, spec["secs"] / 2)
        while time.perf_counter() < t_end:
            seq += 1
            v = op_vals(seq)
            t1 = time.perf_counter()
            kv.wait(kv.push(keys, v))
            lats.append(time.perf_counter() - t1)
        kv.wait(kv.pull(keys, out))
        if not np.all(out == np.float32(seq)):
            raise AssertionError(f"small-op storm: the final pull holds "
                                 f"{out[0]}, not the last ordinal {seq}")
        p50, p99 = pctl_ms(lats)
        window_done({"ops": n_ops, "secs": wall, "ops_per_s": n_ops / wall,
                     "frames": frames,
                     "ops_per_frame": (merged[1] / merged[0] if merged[0]
                                       else 1.0),
                     "low_p50_ms": p50, "low_p99_ms": p99, "last": seq})
    return {"store_exact": True}


def node_fanin(ps, po, kv, spec) -> dict:
    """``benchmark.py:470-560``: the table spread over the servers, then,
    once per window, ``multi_get`` requests of 64 Zipf(1.5) single-row
    lookups through a depth-8 pipeline, every 32nd and the last 8
    checked bit for bit."""
    from pslite_tpu_torch.models import dlrm

    from collections import deque

    cfg = dlrm.DLRMConfig(num_rows=spec["rows"], emb_dim=FANIN_DIM)
    row_keys = dlrm.spread_row_keys(cfg)
    push_s = push_table(kv, row_keys)
    outs_pool = [[np.zeros(FANIN_DIM, np.float32) for _ in range(FANIN_OUT)]
                 for _ in range(FANIN_DEPTH)]
    all_rows = dlrm.serving_keys(cfg, 4096 * FANIN_OUT, seed=7)
    for i in range(16):  # warm: connections, the capability probes
        kl = [row_keys[int(r):int(r) + 1] for r in
              all_rows[i * FANIN_OUT:(i + 1) * FANIN_OUT]]
        kv.multi_get(kl, outs=outs_pool[0]).wait()
    for _w in node_windows(spec):
        sent0, recv0 = po.van.frames_sent, po.van.frames_recv
        lats, pending, free = [], deque(), list(range(FANIN_DEPTH))
        n_req = checked = 0

        def retire(check):
            nonlocal checked
            t_iss, handle, rws, slot = pending.popleft()
            handle.wait()
            lats.append(time.perf_counter() - t_iss)
            if check:
                want = dlrm.embedding_row(cfg, rws)
                if not np.array_equal(np.stack(outs_pool[slot]), want):
                    raise AssertionError("serving-fanin: a request's rows "
                                         "came back wrong")
                checked += 1
            free.append(slot)

        t0 = time.perf_counter()
        t_end = t0 + spec["secs"]
        while time.perf_counter() < t_end:
            base = (n_req % 4096) * FANIN_OUT
            rws = all_rows[base:base + FANIN_OUT]
            slot = free.pop()
            t1 = time.perf_counter()
            handle = kv.multi_get([row_keys[int(r):int(r) + 1] for r in rws],
                                  outs=outs_pool[slot])
            pending.append((t1, handle, rws, slot))
            n_req += 1
            if len(pending) >= FANIN_DEPTH:
                retire(n_req % 32 == 0)
        while pending:
            retire(True)
        wall = time.perf_counter() - t0
        p50, p99 = pctl_ms(lats)
        window_done({"reqs": n_req, "secs": wall, "reqs_per_s": n_req / wall,
                     "p50_ms": p50, "p99_ms": p99, "checked": checked,
                     "frames_out_per_req": (po.van.frames_sent - sent0)
                     / n_req,
                     "frames_in_per_req": (po.van.frames_recv - recv0)
                     / n_req})
    return {"push_s": push_s, "rows": cfg.num_rows}


def node_hot_cache(ps, po, kv, spec) -> dict:
    """``benchmark.py:331-360`` as the serve tenant: the table on one
    server, an unmeasured Zipf warm storm, ``seed_hot_cache(k=64)`` when
    the cache is on; then, once per window (the cache cleared first, as
    JAX clears it after seeding), the read-only storm of
    ``models/dlrm.py:226-258``: 2,000 Zipf single-row pulls, timed, each
    then checked exactly against its row (JAX checks every 64th).  After
    the last window, read-your-writes: 32 of the storm's rows are each
    pulled, pushed +1 and pulled again, and the second pull must hold
    the push."""
    from pslite_tpu_torch.models import dlrm

    cfg = dlrm.DLRMConfig(num_rows=spec["rows"], emb_dim=FANIN_DIM)
    keys = np.arange(cfg.num_rows, dtype=np.uint64)
    push_s = push_table(kv, keys, tenant="serve")
    out = np.zeros(FANIN_DIM, np.float32)
    for r in dlrm.serving_keys(cfg, 200, seed=3):
        kv.wait(kv.pull(keys[int(r):int(r) + 1], out, tenant="serve"))
    if kv.hot_cache is not None:
        kv.seed_hot_cache(k=64)
    storm = dlrm.serving_keys(cfg, spec["pulls"], seed=7)
    for _w in node_windows(spec):
        if kv.hot_cache is not None:
            kv.hot_cache.clear()
        lats, hits, wrong = [], 0, 0
        for r in storm.tolist():
            sent = po.van.frames_sent
            t0 = time.perf_counter()
            kv.wait(kv.pull(keys[r:r + 1], out, tenant="serve"))
            lats.append(time.perf_counter() - t0)
            hits += po.van.frames_sent == sent
            wrong += not np.array_equal(out,
                                        dlrm.embedding_row(cfg, r))
        if wrong:
            raise AssertionError(f"hot-cache: {wrong} of {len(lats)} storm "
                                 f"pulls came back wrong")
        p50, p99 = pctl_ms(lats)
        window_done({"pulls": len(lats), "p50_ms": p50, "p99_ms": p99,
                     "hit_rate": hits / len(lats), "hits": hits})
    one = np.ones(FANIN_DIM, np.float32)
    stale = 0
    ryw = list(dict.fromkeys(storm.tolist()))[:HOT_RYW_ROWS]
    for r in ryw:
        kv.wait(kv.pull(keys[r:r + 1], out, tenant="serve"))
        want = dlrm.embedding_row(cfg, r) + one  # the server's f32 +=
        kv.wait(kv.push(keys[r:r + 1], one, tenant="serve"))
        kv.wait(kv.pull(keys[r:r + 1], out, tenant="serve"))
        stale += not np.array_equal(out, want)
    if stale:
        raise AssertionError(f"hot-cache: {stale} of {len(ryw)} pulls after "
                             f"a push missed it")
    return {"stale": stale, "ryw_rows": len(ryw), "push_s": push_s,
            "rows": cfg.num_rows}


def node_multi_tenant(ps, po, kv, spec) -> dict:
    """``benchmark.py:243-300`` with its legs (``:2088-2090``) as windows
    of one cluster: rank 0 is the serve tenant (express single-row pulls
    for each window), rank 1 the train tenant (4 MiB pushes at depth 12,
    counting sheds) or idle, the legs alternating round by round.  A
    worker barrier opens each window; the bulk pipeline runs
    ``MT_RAMP`` before and after it, and after each bulk window its
    store must hold exactly its applied pushes so far."""
    from collections import deque

    from pslite_tpu_torch import OverloadError

    secs = spec["secs"]
    legs = ("idle", "bulk") * spec["rounds"]
    if po.my_rank() == 0:
        keys = np.arange(8, dtype=np.uint64)
        kv.wait(kv.push(keys, np.full(8 * 256, 3.0, np.float32),
                        tenant="serve"))
        one, out = keys[3:4], np.zeros(256, np.float32)
        t_end = time.perf_counter() + 0.5
        while time.perf_counter() < t_end:
            kv.wait(kv.pull(one, out, tenant="serve", priority=1))
        windows = []
        for leg in legs:
            po.barrier(0, ps.WORKER_GROUP)
            time.sleep(MT_RAMP)
            lats = []
            t_end = time.perf_counter() + secs
            while time.perf_counter() < t_end:
                t0 = time.perf_counter()
                kv.wait(kv.pull(one, out, tenant="serve", priority=1))
                lats.append(time.perf_counter() - t0)
                if not np.all(out == 3.0):
                    raise AssertionError("multi-tenant: a serving pull "
                                         "came back wrong")
            p50, p99 = pctl_ms(lats)
            windows.append({"leg": leg, "samples": len(lats),
                            "p50_ms": p50, "p99_ms": p99})
        return {"tenant": "serve", "windows": windows}
    nk = 8
    vlen = MT_BULK_MB * (1 << 20) // 4 // nk
    keys = np.arange(1000, 1000 + nk, dtype=np.uint64)
    vals = np.ones(nk * vlen, np.float32)
    out = np.zeros_like(vals)
    applied = 0
    windows = []
    for leg in legs:
        po.barrier(0, ps.WORKER_GROUP)
        if leg == "idle":
            continue
        done = shed = 0
        pending = deque()

        def settle(ts):
            nonlocal done, shed
            try:
                kv.wait(ts)
                done += 1
            except OverloadError:
                shed += 1

        t0 = time.perf_counter()
        t_end = t0 + secs + 2 * MT_RAMP
        while time.perf_counter() < t_end:
            pending.append(kv.push(keys, vals, tenant="train"))
            if len(pending) >= MT_DEPTH:
                settle(pending.popleft())
        while pending:
            settle(pending.popleft())
        wall = time.perf_counter() - t0
        applied += done
        kv.wait(kv.pull(keys, out, tenant="train"))
        if not np.all(out == np.float32(applied)):
            raise AssertionError(f"multi-tenant: the bulk store is not its "
                                 f"{applied} applied pushes")
        windows.append({"applied": done, "shed": shed,
                        "gbps": 8.0 * done * vals.nbytes / wall / 1e9})
    return {"tenant": "train", "windows": windows, "store_exact": True}


GOODPUT_MB = 64        # benchmark.py:1786-1788: 96 pushes of 64 MiB,
GOODPUT_KEYS = 16      # 16 keys each (:1657), 2 MiB chunks, at most 4
GOODPUT_PUSHES = 96    # in flight, 256 KiB socket buffers (:1677-1685)
GOODPUT_ENV = {"PS_CHUNK_BYTES": str(2 << 20),
               "PS_TCP_SNDBUF": str(256 << 10),
               "PS_TCP_RCVBUF": str(256 << 10),
               "PS_RECV_POOL_MB": "512", "PS_BENCH_PIPELINE": "4"}


def node_goodput(ps, po, kv, spec) -> dict:
    """JAX's ``lane_goodput`` storm (``benchmark.py:142-212``), once per
    window: ``spec["pushes"]`` pushes of ``spec["mb"]`` MiB over
    ``GOODPUT_KEYS`` keys, at most ``PS_BENCH_PIPELINE`` in flight, from
    a thread, while this one times priority-1 pulls of one 1 KiB key.
    The pushes are integer-valued (JAX's are normal floats, which only
    its codec legs need), so after each window the store is pulled and
    checked exactly."""
    n_pushes = spec["pushes"]
    val_len = spec["mb"] * (1 << 20) // GOODPUT_KEYS // 4
    big_keys = np.arange(100, 100 + GOODPUT_KEYS, dtype=np.uint64)
    big = np.random.default_rng(SEED + 11).integers(
        -8, 8, size=GOODPUT_KEYS * val_len).astype(np.float32)
    small_key = np.array([7], dtype=np.uint64)
    small = np.ones(256, np.float32)
    small_out = np.zeros_like(small)
    kv.wait(kv.push(big_keys, big))  # warm the path end to end
    kv.wait(kv.push(small_key, small))
    kv.wait(kv.pull(small_key, small_out, priority=1))
    pushes = 1
    depth = int(os.environ.get("PS_BENCH_PIPELINE", "3"))
    check = np.empty_like(big)
    for _ in node_windows(spec):
        wall, errors = [0.0], []

        def pusher():
            try:
                t0 = time.perf_counter()
                pending = []
                for _ in range(n_pushes):
                    pending.append(kv.push(big_keys, big))
                    if len(pending) >= depth:
                        kv.wait(pending.pop(0))
                for ts in pending:
                    kv.wait(ts)
                wall[0] = time.perf_counter() - t0
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                errors.append(exc)

        t = threading.Thread(target=pusher, daemon=True)
        lats = []
        t.start()
        while t.is_alive():
            t0 = time.perf_counter()
            kv.wait(kv.pull(small_key, small_out, priority=1))
            lats.append((time.perf_counter() - t0) * 1e3)
        t.join()
        if errors:
            raise errors[0]
        pushes += n_pushes
        kv.wait(kv.pull(big_keys, check))
        if not (np.array_equal(check, big * np.float32(pushes))
                and np.array_equal(small_out, small)):
            raise AssertionError(f"goodput: the store is not {pushes} "
                                 f"pushes")
        lats.sort()
        window_done({
            "push_gbps": 8.0 * n_pushes * big.nbytes / wall[0] / 1e9,
            "pull_p50_ms": lats[len(lats) // 2],
            "pull_p99_ms": lats[min(len(lats) - 1, int(len(lats) * 0.99))],
            "samples": len(lats), "native": van_native(po.van)})
    return {"pushes": pushes}


# -- recovery: keepalive restarts, request deadlines, chaos ------------------

RECOVERY_CRASHES = 2  # the ici_tcp worker's crashes; it finishes in life 3
RECOVERY_STEPS = 2    # K4 push_pulls of the bucket per life
RECOVERY_HB = {"PS_HEARTBEAT_INTERVAL": "1", "PS_HEARTBEAT_TIMEOUT": "2"}
DEADLINE_ENV = {"PS_HEARTBEAT_INTERVAL": "0.3", "PS_HEARTBEAT_TIMEOUT": "1.0",
                "PS_REQUEST_TIMEOUT": "0.3", "PS_REQUEST_RETRIES": "2"}
DEADLINE_DEPTH = 8    # pushes of the 40 x 1 MB bucket in flight
CHAOS_SPEC = "seed=11,drop=0.15,delay=0.5:2,reorder=0.1,dup=0.1"
CHAOS_ROUNDS = 3      # timed rounds per leg, after one warm-up round
T_PROC = time.time()  # this process's start (a restarted node's clock)
T_MAIN = 0.0  # main()'s start


def recovery_vals(who: int, life: int) -> np.ndarray:
    """A worker's push to the loose keys in one life: small integers, so
    the store is exact whatever order the pushes land in."""
    rng = np.random.default_rng(SEED + 100 * who + life)
    return rng.integers(-8, 8, size=MSG_LOOSE_KEYS * VAL_LEN).astype(
        np.float32)


def recovery_store(crashes: int) -> np.ndarray:
    want = recovery_vals(0, 0).astype(np.float64)
    for life in range(crashes + 1):
        want += recovery_vals(1, life)
    return want


def node_recovery(spec) -> int:
    """One node of ``recovery-keepalive``, started (and restarted) by the
    port's launcher with keepalive.  The first worker process to claim
    ``crasher.claim`` is the crasher: preferred rank 1, the ``ici_tcp``
    van with the engine on ``N`` ranks of cuda:0; in each life it pushes
    the 40 x 1 MB bucket through K4 from device grads (against float64)
    and its life's values to the 16 x 1 MB loose keys over messages,
    then exits 254 until it has crashed ``spec["crashes"]`` times (its
    claim given back, so its restart claims it again).  The other worker
    (rank 0, tcp) pushes its values once and pulls until the server's
    store holds every push exactly.  Lines ``EVENT <json>`` carry the
    wall-clock times the parent reads."""
    import torch
    import pslite_tpu_torch as ps
    from pslite_tpu_torch.environment import Environment
    from pslite_tpu_torch.ops import ring_collective as ring

    def event(**kv):
        print("EVENT " + json.dumps(kv), flush=True)

    role = os.environ["DMLC_ROLE"]
    env = dict(os.environ)
    crasher = False
    life = 0
    if role == "worker":
        try:
            os.close(os.open(os.path.join(spec["dir"], "crasher.claim"),
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY))
            crasher = True
        except FileExistsError:
            pass
    marker = os.path.join(spec["dir"], "crashes")
    if crasher and os.path.exists(marker):
        with open(marker) as f:
            life = int(f.read().strip() or "0")
    if crasher and life:
        # A restart: let the scheduler's detector see the old id dead.
        time.sleep(float(env["PS_HEARTBEAT_TIMEOUT"]) + 1.5)
    if role == "server" or (role == "worker" and not crasher):
        env["DMLC_RANK"] = "0"
    if crasher:
        env.update(DMLC_RANK="1", PS_VAN_TYPE="ici_tcp")
    t_register = time.time()
    po = ps.Postoffice(role, env=Environment(env))
    if crasher:
        po.van.set_mesh(ps.DeviceGroup(N))
    po.start()
    t_ready = time.time()
    apps = []
    report = {"role": role, "crasher": crasher, "ok": True}
    if role == "server":
        srv = ps.KVServer(0, postoffice=po)
        srv.set_request_handle(ps.KVServerDefaultHandle())
        apps.append(srv)
    loose = np.arange(MSG_LOOSE_KEYS, dtype=np.uint64) + 2_000_000
    if role == "worker":
        kv = ps.KVWorker(0, 0, postoffice=po)
        apps.append(kv)
    if crasher:
        event(kind="life", life=life, id=po.van.my_node.id,
              recovery=po.is_recovery, t_proc=T_PROC,
              t_register=t_register, t_ready=t_ready)
        ring.reset_launches()
        bucket = np.arange(KEYS, dtype=np.uint64)
        kv.register_dense("grads", bucket, VAL_LEN)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 10 + life)
        outs = torch.zeros(P, device="cuda")
        s64 = torch.zeros(P, dtype=torch.float64, device="cuda")
        mag = torch.zeros(P, dtype=torch.float64, device="cuda")
        for k in range(spec["steps"]):
            g = torch.randn((N, P), device="cuda", generator=gen)
            kv.wait(kv.push_pull(bucket, g, outs))
            s64 += g.double().sum(0)
            mag += g.double().abs().sum(0)
            err = (outs.double() - s64).abs()
            if not bool((err <= 1e-6 + (k + 1) * (N + 1) * 2.0 ** -24
                         * mag).all()):
                raise AssertionError(f"life {life} step {k}: the bucket is "
                                     f"off float64 by {float(err.max())}")
            if k == 0:
                kv.wait(kv.push(loose, recovery_vals(1, life)))
                event(kind="round", life=life, t=time.time(),
                      max_abs_err_vs_f64=float(err.max()))
        torch.cuda.synchronize()
        k4 = ring.launches.get("ring_push_pull[float32]", 0)
        if life < spec["crashes"]:
            with open(marker, "w") as f:
                f.write(str(life + 1))
            os.unlink(os.path.join(spec["dir"], "crasher.claim"))
            event(kind="crash", life=life, k4=k4, t=time.time())
            os._exit(254)  # after its pushes, before finalize
        report.update(k4=k4, life=life)
    elif role == "worker":
        kv.wait(kv.push(loose, recovery_vals(0, 0)))
        want = recovery_store(spec["crashes"])
        out = np.zeros(MSG_LOOSE_KEYS * VAL_LEN, np.float32)
        end = time.monotonic() + spec["poll_s"]
        polls = 0
        while True:
            kv.wait(kv.pull(loose, out))
            polls += 1
            if np.array_equal(out, want):
                break
            if time.monotonic() > end:
                raise AssertionError(f"the store never held every push "
                                     f"({int((out != want).sum())} values "
                                     f"short after {polls} pulls)")
            time.sleep(0.2)
        event(kind="poll_ok", t=time.time(), polls=polls)
    po.finalize()
    for a in apps:
        a.stop()
    print(json.dumps(report), flush=True)
    return 0


def node_deadline(ps, po, kv, spec) -> dict:
    """The ``deadline-timeout`` worker: after warm-up rounds, prints
    ``READY`` and on the parent's go keeps ``DEADLINE_DEPTH`` pushes of
    the 40 x 1 MB bucket in flight, each with a callback, until a wait
    raises (the parent kills the server in between); then it waits every
    outstanding push.  Every wait after the first TimeoutError must
    raise it too, no failed push's callback may fire, and the whole
    drain is bounded by a watchdog."""
    import collections

    from pslite_tpu_torch.base import server_rank_to_id

    server = server_rank_to_id(0)
    detected = []
    po.register_node_failure_hook(
        lambda nid, down: detected.append(time.time())
        if down and nid == server else None)
    keys = np.array([po.get_server_key_ranges()[0].begin + i
                     for i in range(KEYS)], np.uint64)
    vals = np.random.default_rng(SEED + 11).integers(
        -8, 8, size=KEYS * VAL_LEN).astype(np.float32)
    for _ in range(2):
        kv.wait(kv.push(keys, vals))
    for _ in node_windows({"windows": 1}):
        pass
    watchdog = threading.Timer(60.0, lambda: (
        print("deadline-timeout: a wait hung", flush=True), os._exit(3)))
    watchdog.start()
    fired, ok, failed = set(), [], []
    outstanding = collections.deque()
    t_last, n = None, 0
    while True:
        while not failed and len(outstanding) < DEADLINE_DEPTH:
            ts = kv.push(keys, vals, callback=lambda i=n: fired.add(i))
            outstanding.append((n, ts))
            n += 1
        if not outstanding:
            break
        i, ts = outstanding.popleft()
        try:
            kv.wait(ts)
        except TimeoutError:
            failed.append(i)
            t_last = time.time()
            continue
        if failed:
            raise AssertionError(f"push {i} completed after push "
                                 f"{failed[0]} timed out")
        ok.append(i)
    watchdog.cancel()
    if fired & set(failed):
        raise AssertionError(f"callbacks of failed pushes fired: "
                             f"{sorted(fired & set(failed))}")
    if not set(ok) <= fired:
        raise AssertionError("a completed push's callback did not fire")
    end = time.monotonic() + 15.0
    while not detected and time.monotonic() < end:
        time.sleep(0.01)  # the waits may all have raised before it
    if not detected:
        raise AssertionError("the failure detector never reported the "
                             "killed server")
    report = {"ok_pushes": len(ok), "failed_pushes": len(failed),
              "t_detected": detected[0], "t_last_raise": t_last,
              "pending_left": len(kv._pending)}
    window_done(report)  # before the parent lets the scheduler go
    return report


TIER_NODES = {"small-op": node_small_op, "fanin": node_fanin,
              "hot-cache": node_hot_cache, "multi-tenant": node_multi_tenant,
              "goodput": node_goodput, "deadline": node_deadline,
              "replica-read": lambda *a: node_replica_read(*a),
              "durable-serve": lambda *a: node_durable_serve(*a)}


class Cluster:
    """One cluster of separate processes, roles from the port's launcher
    (``tracker/local.py``), each child under PROC_DEADLINE; every child
    is killed when one fails or time runs out.  With ``spec["windows"]``
    each worker prints ``READY`` after its set-up, then waits for a line
    on its stdin (``window()``) before each timed window and prints one
    ``WINDOW <json>`` line after it, so the windows of two clusters,
    both started once, can alternate while the other one idles."""

    def __init__(self, van: str, workers: int, servers: int, spec: dict,
                 extra=None, joint: bool = False):
        from pslite_tpu_torch.tracker.local import LocalLauncher, build_env
        from pslite_tpu_torch.utils.network import get_available_port

        self.van = van
        port = get_available_port()
        roles = LocalLauncher(workers, servers, [], van=van, root_port=port,
                              joint=joint).roles()
        logdir = tempfile.mkdtemp(prefix="smoke")
        self.procs = []
        try:
            for i, role in enumerate(roles):
                env = build_env(role, workers, servers, "127.0.0.1", port,
                                van, extra=dict(
                                    extra or {}, DMLC_NODE_HOST="127.0.0.1",
                                    SMOKE_SPEC=json.dumps(spec)))
                path = os.path.join(logdir, f"{i}-{role}.log")
                with open(path, "w") as log:
                    self.procs.append((role, path, subprocess.Popen(
                        [sys.executable, os.path.join(HERE, "chip_smoke.py"),
                         "--node"], env=env, stdout=log,
                        stderr=subprocess.STDOUT, stdin=subprocess.PIPE,
                        cwd=HERE)))
        except BaseException:
            self.kill()
            raise
        self.end = time.monotonic() + PROC_DEADLINE
        self.windows = 0

    def _text(self, path: str) -> str:
        with open(path) as f:
            return f.read()

    def _workers(self):
        return [(path, p) for role, path, p in self.procs
                if role in ("worker", "joint")]

    def _fail(self, failed: str):
        self.kill()
        for role, path, _p in self.procs:
            print(f"  [{role}] " + "\n  ".join(
                self._text(path).splitlines()[-15:]))
        raise AssertionError(f"{self.van} cluster: {failed} failed")

    def _check(self) -> None:
        failed = next((r for r, _l, p in self.procs
                       if p.poll() not in (None, 0)), None)
        if failed is None and time.monotonic() > self.end:
            failed = f"deadline of {PROC_DEADLINE:.0f} s"
        if failed is not None:
            self._fail(failed)

    def _lines(self, prefix: str, n: int) -> list:
        """Wait until every worker has printed ``n`` lines starting with
        ``prefix``; the ``n``-th of each, after the prefix."""
        while True:
            got = [[ln[len(prefix):] for ln in self._text(path).splitlines()
                    if ln.startswith(prefix)] for path, _p in self._workers()]
            if all(len(g) >= n for g in got):
                return [g[n - 1] for g in got]
            self._check()
            time.sleep(0.02)

    def ready(self) -> None:
        self._lines("READY", 1)

    def window(self) -> list:
        """Open every worker's next window; their reports."""
        self.windows += 1
        for _path, p in self._workers():
            p.stdin.write(b"go\n")
            p.stdin.flush()
        return [json.loads(t) for t in self._lines("WINDOW ", self.windows)]

    def finish(self, report_roles=("worker", "joint")) -> list:
        """Wait for every child to exit 0; the last JSON line of each
        child of ``report_roles``."""
        for _role, _path, p in self.procs:
            p.stdin.close()
        while any(p.poll() is None for _r, _l, p in self.procs):
            self._check()
            time.sleep(0.05)
        failed = next((r for r, _l, p in self.procs if p.returncode != 0),
                      None)
        if failed is not None:
            self._fail(failed)
        return [json.loads(self._text(path).strip().splitlines()[-1])
                for role, path, _p in self.procs if role in report_roles]

    def kill(self) -> None:
        for _r, _l, p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def launch(van: str, workers: int, servers: int, spec: dict,
           extra=None, joint: bool = False,
           report_roles=("worker", "joint")):
    """One cluster run to its end (``Cluster``); the JSON reports of the
    children of ``report_roles``."""
    cluster = Cluster(van, workers, servers, spec, extra=extra, joint=joint)
    try:
        return cluster.finish(report_roles)
    finally:
        cluster.kill()


def rounds_summary(reports, nbytes: int) -> dict:
    rows = [r["sizes"][str(nbytes)] for r in reports]
    return {"ms_per_round": sum(x["ms_per_round"] for x in rows) / len(rows),
            "gbps_per_worker": sum(x["gbps"] for x in rows) / len(rows),
            "rounds_ms": rows[0]["rounds_ms"], "checked": rows[0]["checked"],
            "keys": rows[0]["keys"],
            "max_err": max(x["max_err"] for x in rows),
            "sent": sum(x["sent_per_round"] for x in rows) / len(rows),
            "recv": sum(x["recv_per_round"] for x in rows) / len(rows)}


def _print_rounds(label, topo, reports, sizes, smi, loopback, codec=None):
    out = []
    for _n, nbytes in sizes:
        s = rounds_summary(reports, nbytes)
        check = (f"every pull within the {codec} bound of the float64 sum, "
                 f"max |err| {s['max_err']:.4g}" if codec else
                 "checked exactly")
        print(f"{label} ({topo}, {s['keys']} keys x {nbytes} B per worker "
              f"and round): {s['ms_per_round']:.3f} ms/round, "
              f"{s['gbps_per_worker']:.4f} Gbit/s per worker by "
              f"test_benchmark's 8*len*total_key_num*iters/elapsed_ns "
              f"(rounds {', '.join(f'{t:.1f}' for t in s['rounds_ms'])} ms; "
              f"{s['checked']} rounds {check}); wire bytes per worker and "
              f"round: sent {s['sent']:.0f}, received {s['recv']:.0f}; "
              f"loopback msg-config2 of this run {loopback} [{smi}] [host "
              f"CPU {cpu_model()}]")
        out.append({"config": f"{label} {nbytes} B", "ops": s["checked"],
                    "max_abs_err_vs_f64": s["max_err"],
                    "ms_per_round": s["ms_per_round"],
                    "gbps_per_worker": s["gbps_per_worker"],
                    "wire_sent_per_round": s["sent"],
                    "wire_recv_per_round": s["recv"]})
    return out


_loopback_cell = ["not run"]

# The two planes of a process phase: the native core (the default) and
# the Python one.
PLANES = (("native", {}), ("python", {"PS_NATIVE": "0"}))
PLANE_ROUNDS = 2  # timed rounds per window; TIER_ROUNDS windows per leg


def leg_env(extra, plane: str, env: dict) -> dict:
    """A plane leg's environment: ``extra`` with the plane's knobs.  A
    shared-memory namespace (``PS_SHM_NS``) takes the plane's name, so
    the legs' clusters, up at once with the same node ids and keys,
    never name one /dev/shm segment alike (one namespace for both legs
    let one cluster's pushes and pulls land in the other's)."""
    out = dict(extra or {}, **env)
    if "PS_SHM_NS" in out:
        out["PS_SHM_NS"] = f"{out['PS_SHM_NS']}{plane}"
    return out


def plane_legs(label: str, topo: str, van: str, workers: int, servers: int,
               spec: dict, sizes, smi: str, extra=None, joint=False,
               planes=PLANES, windows: int = TIER_ROUNDS):
    """One round phase on each plane: a cluster per plane, all up at
    once (each its own ``leg_env``), ``windows`` windows of
    ``PLANE_ROUNDS`` rounds alternating (``interleaved``); every pull
    checked.  Prints each plane's ms/round and Gbit/s per worker (median
    of its windows, the windows' values, and over all its rounds) and, by
    window, each other plane's ms over the ``native`` plane's.  Every
    plane but ``python`` runs the core.  Returns ``(rows, {plane: final
    worker reports})``."""
    spec = dict(spec, sizes=sizes, warmup=MSG_WARMUP, rounds=PLANE_ROUNDS,
                windows=windows)
    legs, finals = interleaved(
        [(plane, leg_env(extra, plane, env)) for plane, env in planes],
        lambda env: Cluster(van, workers, servers, spec, extra=env,
                            joint=joint),
        every_worker=True, windows=windows)
    for plane, reps in finals.items():
        if [r["native"] for r in reps] != [plane != "python"] * len(reps):
            raise AssertionError(f"{label}: a worker of the {plane} leg ran "
                                 f"the other plane")
    rows = []
    for _n, nbytes in sizes:
        key = str(nbytes)
        ms = {plane: [sum(w["sizes"][key]["ms_per_round"] for w in win)
                      / len(win) for win in wins]
              for plane, wins in legs.items()}
        for plane, reps in finals.items():
            s = rounds_summary(reps, nbytes)
            gbps = [sum(w["sizes"][key]["gbps"] for w in win) / len(win)
                    for win in legs[plane]]
            print(f"{label} [{plane}] ({topo}, {s['keys']} keys x {nbytes} "
                  f"B per worker and round; {windows} windows of "
                  f"{PLANE_ROUNDS} rounds alternating with the other "
                  f"plane's): ms/round {spread(ms[plane])}, "
                  f"{s['ms_per_round']:.3f} over all {len(s['rounds_ms'])} "
                  f"timed rounds; Gbit/s per worker {spread(gbps)}; "
                  f"{s['checked']} rounds checked exactly; wire bytes per "
                  f"worker and round: sent {s['sent']:.0f}, received "
                  f"{s['recv']:.0f} [{smi}] [host CPU {cpu_model()}]")
            rows.append({"config": f"{label} {nbytes} B {plane}",
                         "ops": s["checked"],
                         "max_abs_err_vs_f64": s["max_err"],
                         "ms_per_round": float(np.median(ms[plane])),
                         "ms_per_round_all": s["ms_per_round"],
                         "gbps_per_worker": float(np.median(gbps))})
        for plane in ms:
            if plane == "native":
                continue
            name = f"{plane}_over_native_ms"
            ratio_row(rows[-1], name, ms[plane], ms["native"])
            print(f"{label} {nbytes} B {plane} / native ms per round by "
                  f"window: median {rows[-1][name]:.3f}, least "
                  f"{rows[-1][name + '_min']:.3f}, most "
                  f"{rows[-1][name + '_max']:.3f}")
    return rows, finals


def drive_tcp_config1(smi: str):
    """BASELINE config 1: 1 scheduler + 1 server + 1 worker processes
    over tcp, test_benchmark's PUSH_PULL (fused push_pull) of 40 keys x
    1,024,000 B, on each plane (``plane_legs``)."""
    return plane_legs("tcp-config1", "1 + 1 + 1 processes, tcp, push_pull",
                      "tcp", 1, 1, {"mode": "push_pull"}, [[KEYS, MB_LEN]],
                      smi)[0]


def drive_native_goodput(smi: str):
    """JAX's ``native_goodput_bench`` (``benchmark.py:1738-1830``): 1
    worker + 1 server processes over tcp, the ``lane_goodput`` storm
    (``node_goodput``) with the native core and with ``PS_NATIVE=0``,
    each leg one cluster, 2 windows alternating; push Gbit/s and the
    small pull's p99 per leg (medians, the windows' values) and their
    ratios by window.  JAX's >= 2x goodput bar was set on a CPU host: a
    yardstick only."""
    legs, _final = interleaved(
        [("native-goodput", {}),
         ("native-goodput-python", {"PS_NATIVE": "0"})],
        lambda env: Cluster("tcp", 1, 1, {
            "phase": "goodput", "windows": TIER_ROUNDS, "mb": GOODPUT_MB,
            "pushes": GOODPUT_PUSHES}, extra=dict(GOODPUT_ENV, **env)))
    rows = []
    for (label, reps), want in zip(legs.items(), (True, False)):
        if any(r["native"] != want for r in reps):
            raise AssertionError(f"{label} ran the other plane")
        print(f"{label} (1 worker + 1 server, tcp, one process per node; "
              f"{GOODPUT_PUSHES} pushes of {GOODPUT_MB} MiB over "
              f"{GOODPUT_KEYS} keys, 2 MiB chunks, at most 4 in flight, "
              f"256 KiB socket buffers; {tier_topo()}): push Gbit/s "
              f"{spread(r['push_gbps'] for r in reps)}; priority pull p50 "
              f"ms {spread(r['pull_p50_ms'] for r in reps)}, p99 ms "
              f"{spread(r['pull_p99_ms'] for r in reps)} over "
              f"{sum(r['samples'] for r in reps)} pulls; the store exact "
              f"after every window [{smi}] [host CPU {cpu_model()}]")
        rows.append(leg_row(label, reps, "samples", (
            "push_gbps", "pull_p50_ms", "pull_p99_ms")))
    gb = [[r["push_gbps"] for r in reps] for reps in legs.values()]
    p99 = [[r["pull_p99_ms"] for r in reps] for reps in legs.values()]
    ratio_row(rows[0], "goodput_ratio", *gb)
    ratio_row(rows[0], "p99_ratio", *p99)
    print(f"native-goodput native / python by window: push Gbit/s median "
          f"{rows[0]['goodput_ratio']:.3f} (least "
          f"{rows[0]['goodput_ratio_min']:.3f}, most "
          f"{rows[0]['goodput_ratio_max']:.3f}); priority pull p99 median "
          f"{rows[0]['p99_ratio']:.3f} (least {rows[0]['p99_ratio_min']:.3f}"
          f", most {rows[0]['p99_ratio_max']:.3f})")
    return rows


TCP2_SIZES = [[MSG_KEYS_PER_SERVER, 1024], [MSG_KEYS_PER_SERVER, MB_LEN],
              [1, 64 << 20]]  # 64 MiB: 1 key per server, not 40


def drive_tcp_config2(smi: str):
    """BASELINE config 2: 1 scheduler + 2 servers + 2 workers processes
    over tcp, msg-config2's rounds (push, worker barrier, pull) at 40
    keys per server of 1,024 and 1,024,000 B and 1 key per server of
    64 MiB, on each plane and on the core with ``PS_NATIVE_REASSEMBLY=1``
    (``plane_legs``); then the 1 MB round on the core (2 rails) with
    ``DMLC_LOCAL=1`` (unix sockets, no file left after), and over
    ``multi`` (2 tcp rails, each a core of its own) on each plane."""
    import tempfile

    spec = {"mode": "push_barrier_pull", "warmup": MSG_WARMUP,
            "rounds": MSG_ROUNDS}
    topo = "1 + 2 + 2 processes"
    # Two windows per plane, not TIER_ROUNDS: the script's clock (the
    # observability phase came after it).
    out = plane_legs("tcp-config2", f"{topo}, tcp", "tcp", 2, 2,
                     {"mode": "push_barrier_pull"}, TCP2_SIZES, smi,
                     planes=PLANES + (("reassembly",
                                       {"PS_NATIVE_REASSEMBLY": "1"}),),
                     windows=2)[0]
    mb = [[MSG_KEYS_PER_SERVER, MB_LEN]]
    sockdir = tempfile.mkdtemp(prefix="psl")
    if len(os.path.join(sockdir, "pslite_ipc_65535.sock")) > 100:
        sockdir = tempfile.mkdtemp(prefix="psl", dir=HERE)
    out += _print_rounds("tcp-config2-local", f"{topo}, tcp DMLC_LOCAL=1",
                         launch("tcp", 2, 2, dict(spec, sizes=mb),
                                extra={"DMLC_LOCAL": "1",
                                       "TMPDIR": sockdir}),
                         mb, smi, _loopback_cell[0])
    left = [f for f in os.listdir(sockdir) if f.endswith(".sock")]
    if left:
        raise AssertionError(f"DMLC_LOCAL left socket files {left}")
    out += plane_legs("tcp-config2-multi", f"{topo}, multi (2 tcp rails)",
                      "multi", 2, 2, {"mode": "push_barrier_pull"}, mb, smi,
                      extra={"DMLC_NUM_PORTS": "2"})[0]
    return out


def drive_tcp_config2_tiers(smi: str):
    """tcp-config2's 1,024,000 B point twice more: with the apply-shard
    pool turned off (``PS_APPLY_SHARDS=0``; the other tcp rows run it at
    its default, the 1 MiB chunks of each push streamed into it) and
    under the int8 codec (``register_bucket`` on both workers, the pool
    at its default).  The servers report the chunked pushes they
    streamed."""
    spec = {"mode": "push_barrier_pull", "warmup": MSG_WARMUP,
            "rounds": MSG_ROUNDS, "sizes": [[MSG_KEYS_PER_SERVER, MB_LEN]]}
    topo = "1 + 2 + 2 processes, tcp"
    out = []
    for label, extra, codec in (
            ("tcp-config2-pool", {}, None),
            ("tcp-config2-serial", {"PS_APPLY_SHARDS": "0"}, None),
            ("tcp-config2-int8", {}, "int8")):
        reports = launch("tcp", 2, 2, dict(spec, codec=codec), extra=extra,
                         report_roles=("worker", "server"))
        streams = sum(r.get("streams_opened", 0) for r in reports)
        workers = [r for r in reports if r["role"] == "worker"]
        want_streams = 0 if extra or codec else 1
        if (streams > 0) != bool(want_streams):
            raise AssertionError(f"{label}: servers streamed {streams} "
                                 f"chunked pushes")
        out += _print_rounds(label, f"{topo}, {extra or 'pool default'}, "
                             f"streamed pushes {streams}", workers,
                             spec["sizes"], smi, _loopback_cell[0],
                             codec=codec)
    return out


def shm_leftovers(ns: str):
    """Segments and pipes of namespace ``ns`` left in /dev/shm.  The
    pipes' ``.lock`` files stay by design (unlinking one while a node
    lives would hand the next locker another inode): once every process
    of the phase is gone they are removed here."""
    ours = [f for f in os.listdir("/dev/shm") if ns in f]
    for f in ours:
        if f.endswith(".lock"):
            os.unlink(os.path.join("/dev/shm", f))
    return [f for f in ours if not f.endswith(".lock")]


def drive_shm_config3(smi: str):
    """BASELINE config 3 on one host: 2 joint (worker + server) processes
    and the scheduler over ``shm``, 40 keys per server x 1,024,000 B,
    msg-config2's rounds; pushes land in registered receive buffers
    (ENABLE_RECV_BUFFER) and pulls in ``alloc_pull_buffer`` segments
    the servers write in place.  On each plane (``plane_legs``): the
    native core with ``PS_SHM_RING=1`` (every frame between the
    processes through shared-memory pipes, copies of 1 MiB and more in
    the copy pool) and ``PS_NATIVE=0`` (the Python sockets).  No
    segment or pipe may be left afterwards."""
    ns = f"smoke{os.getpid()}c3"
    sizes = [[MSG_KEYS_PER_SERVER, MB_LEN]]
    planes = (("native", {"PS_SHM_RING": "1"}),
              ("python", {"PS_NATIVE": "0"}))
    rows, finals = plane_legs(
        "shm-config3", "scheduler + 2 joint processes, shm, registered "
        "buffers", "shm", 2, 2, {"mode": "push_barrier_pull",
                                 "zpull": True}, sizes, smi,
        extra={"PS_SHM_NS": ns, "ENABLE_RECV_BUFFER": "1"}, joint=True,
        planes=planes)
    for plane, env in planes:
        leg_ns = leg_env({"PS_SHM_NS": ns}, plane, env)["PS_SHM_NS"]
        if shm_leftovers(leg_ns):
            raise AssertionError(f"shm-config3 [{plane}] left "
                                 f"{shm_leftovers(leg_ns)}")
    for plane, reports in finals.items():
        hits = [r["sizes"]["zpull_hits"] for r in reports]
        placed = [r["delivered_in_place"] for r in reports]
        pipes = [r["pipe_mode"] for r in reports]
        if (min(hits) < MSG_WARMUP + TIER_ROUNDS * PLANE_ROUNDS
                or not min(placed) or pipes != [plane == "native"] * 2):
            raise AssertionError(f"shm-config3 [{plane}]: zero-copy pulls "
                                 f"{hits}, pushes placed in registered "
                                 f"buffers {placed}, pipes {pipes}")
        print(f"shm-config3 [{plane}]: zero-copy pull hits per worker "
              f"{hits}, pushes placed by the van in registered buffers per "
              f"server {placed}, shared-memory pipes {pipes}; no /dev/shm "
              f"segment or pipe left")
    return rows


def drive_ici_proc(van: str, smi: str):
    """The ici van between processes: scheduler and server processes and
    one worker process with ``PS_VAN_TYPE=ici_tcp`` (or ``ici_shm``) on
    cuda:0 (8 virtual ranks), 5 steps of ``node_ici``.  K4's launches
    are counted in the worker process and returned."""
    extra = {"PS_ICI_IMPL": "pallas",
             "PS_SHM_NS": f"smoke{os.getpid()}{van}"}
    rep = launch(van, 1, 1, {"ranks": N, "steps": 5}, extra=extra)[0]
    if van == "ici_shm" and shm_leftovers(extra["PS_SHM_NS"]):
        raise AssertionError(f"{van} left /dev/shm segments")
    k4 = rep["launches"]["ring_push_pull[float32]"]
    if k4 < rep["steps"]:
        raise AssertionError(f"ici-{van}: K4 launched {k4} times in the "
                             f"worker process for {rep['steps']} push_pulls")
    if not rep["native"]:
        raise AssertionError(f"ici-{van}: the worker's van is not native")
    print(f"ici-tcp-mixed [{van}] (scheduler, server and worker processes, "
          f"the worker's engine on {N} ranks of cuda:0 beside its van's "
          f"native core): {rep['steps']} "
          f"steps; K4 ring_push_pull[float32] launches in the worker "
          f"process {k4}; host ms per step: bucket push_pull "
          f"{rep['bucket_ms']:.3f} (device grads), message push + pull "
          f"{rep['msg_ms']:.3f} ({MSG_LOOSE_KEYS} x {MB_LEN} B, checked "
          f"exactly); bucket max |err| vs float64 "
          f"{rep['max_abs_err_vs_f64']:.3g} [{smi}] [host CPU {cpu_model()}]")
    return ([{"config": f"ici-tcp-mixed {van}", "ops": 3 * rep["steps"],
              "max_abs_err_vs_f64": rep["max_abs_err_vs_f64"],
              "k4_launches": k4, "bucket_ms": rep["bucket_ms"],
              "msg_ms": rep["msg_ms"]}], rep["launches"])


def interleaved(legs, start, every_worker: bool = False,
                report_roles=("worker", "joint"), windows: int = TIER_ROUNDS):
    """Each ``(label, arg)`` of ``legs`` as one ``Cluster``
    (``start(arg)`` with ``spec["windows"] = windows``), all started
    at once and set up before the first window; then ``windows``
    rounds whose windows alternate between the legs (a, b, a, b, ...),
    as JAX's benches alternate theirs (``benchmark.py:2088-2090,
    2297-2301``), so host drift lands on both while the other leg's
    cluster idles.  ``({label: [window report]}, {label: final
    report})``: the first worker's, or with ``every_worker`` the list
    of every worker's; ``report_roles`` picks whose final reports."""
    pick = (lambda reps: reps) if every_worker else (lambda reps: reps[0])
    clusters = {}
    try:
        for label, arg in legs:
            clusters[label] = start(arg)
        for c in clusters.values():
            c.ready()
        out = {label: [] for label in clusters}
        for _ in range(windows):
            for label, c in clusters.items():
                out[label].append(pick(c.window()))
        return out, {label: pick(c.finish(report_roles))
                     for label, c in clusters.items()}
    finally:
        for c in clusters.values():
            c.kill()


def spread(vals) -> str:
    """Median and the rounds' values, for a printed row."""
    vals = list(vals)
    return (f"median {float(np.median(vals)):.4g} (rounds "
            + ", ".join(f"{v:.4g}" for v in vals) + ")")


def ratio_row(row: dict, name: str, nums, dens) -> None:
    """Round by round ratios of two legs: median, least and most."""
    r = [a / b for a, b in zip(nums, dens)]
    row.update({name: float(np.median(r)), f"{name}_min": min(r),
                f"{name}_max": max(r)})


def leg_row(label: str, reps, ops: str, keys) -> dict:
    """A main-path row: the legs' ops summed, ``keys`` as medians."""
    return {"config": label, "ops": sum(r[ops] for r in reps),
            **{k: float(np.median([r[k] for r in reps])) for k in keys}}


def tier_topo() -> str:
    return (f"{TIER_ROUNDS} windows per leg alternating with the other "
            f"leg's, both clusters up throughout")


def drive_small_op_storm(smi: str):
    """``small-op-storm`` and ``-unbatched`` (``benchmark.py:2134-2163``'s
    legs), interleaved."""
    envs = (("small-op-storm", dict(TIER_BATCH, PS_BATCH_MIN_OPS="256",
                                    PS_BATCH_HOLD_US="12000")),
            ("small-op-storm-unbatched", {"PS_BATCH_BYTES": "0"}))
    legs, _final = interleaved(envs, lambda env: Cluster(
        "tcp", 1, 1, {"phase": "small-op", "handle": "assign",
                      "secs": TIER_SECS, "windows": TIER_ROUNDS},
        extra=env))
    rows = []
    for label, reps in legs.items():
        print(f"{label} (1 worker + 1 server, tcp, one process per node; "
              f"1-key {SOB_OP_BYTES} B pushes at depth {SOB_DEPTH} for "
              f"{TIER_SECS} s, {tier_topo()}): ops/s "
              f"{spread(r['ops_per_s'] for r in reps)}; ops "
              f"{sum(r['ops'] for r in reps)}, frames sent "
              f"{sum(r['frames'] for r in reps)}, ops per batch frame "
              f"{spread(r['ops_per_frame'] for r in reps)}; low-load push "
              f"p50 ms {spread(r['low_p50_ms'] for r in reps)}, p99 ms "
              f"{spread(r['low_p99_ms'] for r in reps)}; every final pull "
              f"= its last ordinal [{smi}; host {cpu_model()}]")
        rows.append(leg_row(label, reps, "ops", (
            "ops_per_s", "ops_per_frame", "low_p50_ms", "low_p99_ms")))
    ratio_row(rows[0], "ops_per_s_ratio",
              *[[r["ops_per_s"] for r in reps] for reps in legs.values()])
    print(f"small-op-storm ops/s batched / unbatched by round: median "
          f"{rows[0]['ops_per_s_ratio']:.3f}, least "
          f"{rows[0]['ops_per_s_ratio_min']:.3f}, most "
          f"{rows[0]['ops_per_s_ratio_max']:.3f}")
    return rows


def drive_serving_fanin(smi: str):
    """``serving-fanin`` and ``-unbatched`` (``benchmark.py:2227-2262``'s
    legs), interleaved: 1 worker + 2 servers, hot cache cold."""
    envs = (("serving-fanin", TIER_BATCH),
            ("serving-fanin-unbatched", {"PS_BATCH_BYTES": "0"}))
    legs, final = interleaved(envs, lambda env: Cluster(
        "tcp", 1, 2, {"phase": "fanin", "rows": FANIN_ROWS,
                      "secs": TIER_SECS, "windows": TIER_ROUNDS},
        extra=dict(env, PS_HOT_CACHE="0")))
    rows = []
    for label, reps in legs.items():
        print(f"{label} (1 worker + 2 servers, tcp; "
              f"{final[label]['rows']} x {FANIN_DIM} f32 table pushed in "
              f"{final[label]['push_s']:.2f} s as both legs' clusters set "
              f"up; multi_get of {FANIN_OUT} Zipf(1.5) rows at depth "
              f"{FANIN_DEPTH} for {TIER_SECS} s, {tier_topo()}): "
              f"requests/s {spread(r['reqs_per_s'] for r in reps)}; p50 ms "
              f"{spread(r['p50_ms'] for r in reps)}, p99 ms "
              f"{spread(r['p99_ms'] for r in reps)}; frames per request "
              f"out {spread(r['frames_out_per_req'] for r in reps)}, in "
              f"{spread(r['frames_in_per_req'] for r in reps)}; "
              f"{sum(r['checked'] for r in reps)} of "
              f"{sum(r['reqs'] for r in reps)} requests checked bit for "
              f"bit [{smi}; host {cpu_model()}]")
        rows.append(leg_row(label, reps, "reqs", (
            "reqs_per_s", "p50_ms", "p99_ms", "frames_out_per_req",
            "frames_in_per_req")))
        rows[-1]["push_s"] = final[label]["push_s"]
    ratio_row(rows[0], "reqs_per_s_ratio",
              *[[r["reqs_per_s"] for r in reps] for reps in legs.values()])
    print(f"serving-fanin requests/s batched / unbatched by round: median "
          f"{rows[0]['reqs_per_s_ratio']:.3f}, least "
          f"{rows[0]['reqs_per_s_ratio_min']:.3f}, most "
          f"{rows[0]['reqs_per_s_ratio_max']:.3f}")
    return rows


def drive_hot_cache(smi: str):
    """``hot-cache`` and ``-off`` (``benchmark.py:1972-1994``'s legs of
    ``dlrm_serve`` at its 1,024-row table, the storm read-only as
    ``models/dlrm.py:226-258``'s): 1 + 1, interleaved.  (On the fan-in's
    1,048,576-row table, pushed in 1 MiB streamed parts, each part
    charges its first key with its key count in ``kv.hot_keys``, in
    both packages: the top 64 are then the parts' first keys, and the
    seeded cache admits row 0 alone.)"""
    envs = (("hot-cache", {"PS_HOT_CACHE": "1", "PS_HOT_CACHE_MB": "64",
                           "PS_HOT_CACHE_TTL_S": "1"}),
            ("hot-cache-off", {"PS_HOT_CACHE": "0"}))
    legs, final = interleaved(envs, lambda env: Cluster(
        "tcp", 1, 1, {"phase": "hot-cache", "rows": HOT_ROWS,
                      "pulls": HOT_PULLS, "windows": TIER_ROUNDS},
        extra=dict(env, PS_TENANTS=MT_ENV["PS_TENANTS"])))
    rows = []
    for label, reps in legs.items():
        print(f"{label} (1 worker + 1 server, tcp, the serve tenant of "
              f"PS_TENANTS={MT_ENV['PS_TENANTS']}; {final[label]['rows']} "
              f"x {FANIN_DIM} f32 table; {tier_topo()}): {HOT_PULLS} "
              f"Zipf(1.5) single-row pulls a window, read-only, each "
              f"checked exactly; p50 ms {spread(r['p50_ms'] for r in reps)}"
              f", p99 ms {spread(r['p99_ms'] for r in reps)}, hit rate "
              f"{spread(r['hit_rate'] for r in reps)} (answered without a "
              f"frame); then read-your-writes on "
              f"{final[label]['ryw_rows']} rows, stale reads "
              f"{final[label]['stale']} [{smi}; host {cpu_model()}]")
        rows.append(leg_row(label, reps, "pulls",
                            ("p50_ms", "p99_ms", "hit_rate")))
        rows[-1]["stale"] = final[label]["stale"]
    ratio_row(rows[0], "p50_ratio",
              *[[r["p50_ms"] for r in reps] for reps in reversed(
                  list(legs.values()))])
    print(f"hot-cache p50 off / on by round: median "
          f"{rows[0]['p50_ratio']:.3f}, least {rows[0]['p50_ratio_min']:.3f}"
          f", most {rows[0]['p50_ratio_max']:.3f}")
    return rows


def admission_probe(ps, Environment, n_pushes: int = 64, limit: int = 4):
    """``benchmark.py:2012-2062``: a loopback cluster in this process,
    ``PS_TENANT_QUEUE_LIMIT=4``, the train tenant offering 64 monolithic
    32 KiB pushes without waiting; every wait ends, applied or
    ``OverloadError``, and the store holds exactly the applied count."""
    nodes = msg_cluster(ps, Environment, 1, 1, env={
        "PS_TENANTS": MT_ENV["PS_TENANTS"],
        "PS_TENANT_QUEUE_LIMIT": str(limit)})
    srv = ps.KVServer(0, postoffice=nodes[1])
    srv.set_request_handle(ps.KVServerDefaultHandle())
    w = ps.KVWorker(0, 0, postoffice=nodes[2])
    try:
        keys = np.arange(8, dtype=np.uint64)
        vals = np.ones(8 * 1024, np.float32)
        t0 = time.perf_counter()
        tss = [w.push(keys, vals, tenant="train") for _ in range(n_pushes)]
        applied = shed = 0
        for ts in tss:
            try:
                w.wait(ts)
                applied += 1
            except ps.OverloadError:
                shed += 1
        wall = time.perf_counter() - t0
        out = np.zeros_like(vals)
        w.wait(w.pull(keys, out, tenant="train"))
    finally:
        msg_finalize(nodes, [w, srv])
    if not np.all(out == np.float32(applied)):
        raise AssertionError(f"admission probe: the store is not its "
                             f"{applied} applied pushes")
    return {"offered": n_pushes, "applied": applied, "shed": shed,
            "wall_ms": wall * 1e3}


def drive_multi_tenant(ps, Environment, smi: str):
    """``multi-tenant`` and ``-idle`` (``benchmark.py:1920-1935``'s legs,
    interleaved as ``:2088-2090`` runs them): 2 workers + 1 server, the
    legs alternating windows of one cluster; then JAX's admission
    probe."""
    reps = launch("tcp", 2, 1, {"phase": "multi-tenant",
                                "rounds": TIER_ROUNDS, "secs": TIER_SECS},
                  extra=MT_ENV)
    serve = next(r for r in reps if r["tenant"] == "serve")["windows"]
    train = next(r for r in reps if r["tenant"] == "train")["windows"]
    rows = []
    for label, leg in (("multi-tenant", "bulk"), ("multi-tenant-idle",
                                                  "idle")):
        ws = [w for w in serve if w["leg"] == leg]
        bulk = (f"bulk applied {', '.join(str(t['applied']) for t in train)}"
                f", shed {', '.join(str(t['shed']) for t in train)}, "
                f"Gbit/s {spread(t['gbps'] for t in train)}, store exact at "
                f"its applied count after every window" if leg == "bulk"
                else "bulk idle")
        print(f"{label} (2 workers + 1 server, tcp, PS_TENANTS=serve:8,"
              f"train:1, PS_TENANT_QUEUE_LIMIT=8; {TIER_ROUNDS} windows of "
              f"{TIER_SECS} s alternating with the other leg in one "
              f"cluster): serve p50 ms {spread(w['p50_ms'] for w in ws)}, "
              f"p99 ms {spread(w['p99_ms'] for w in ws)} "
              f"({sum(w['samples'] for w in ws)} express pulls); {bulk} "
              f"[{smi}; host {cpu_model()}]")
        rows.append({"config": label, "ops": sum(w["samples"] for w in ws),
                     "serve_p50_ms": float(np.median([w["p50_ms"]
                                                      for w in ws])),
                     "serve_p99_ms": float(np.median([w["p99_ms"]
                                                      for w in ws])),
                     "bulk_applied": (sum(t["applied"] for t in train)
                                      if leg == "bulk" else 0),
                     "bulk_shed": (sum(t["shed"] for t in train)
                                   if leg == "bulk" else 0)})
    ratio_row(rows[0], "serve_p99_ratio",
              *[[w["p99_ms"] for w in serve if w["leg"] == leg]
                for leg in ("bulk", "idle")])
    print(f"multi-tenant serve p99 bulk / idle by round: median "
          f"{rows[0]['serve_p99_ratio']:.3f}, least "
          f"{rows[0]['serve_p99_ratio_min']:.3f}, most "
          f"{rows[0]['serve_p99_ratio_max']:.3f}")
    probe = admission_probe(ps, Environment)
    print(f"admission probe (loopback 1 + 1 in this process, "
          f"PS_TENANT_QUEUE_LIMIT=4, {probe['offered']} monolithic 32 KiB "
          f"train pushes offered without waiting): applied "
          f"{probe['applied']}, shed {probe['shed']} (OverloadError), every "
          f"wait ended in {probe['wall_ms']:.3f} ms, store exact at the "
          f"applied count [{smi}; host {cpu_model()}]")
    rows.append({"config": "admission-probe", "ops": probe["offered"],
                 "applied": probe["applied"], "shed": probe["shed"]})
    return rows


def drive_recovery_keepalive(smi: str):
    """``recovery-keepalive`` (JAX's ``test_elastic.py::
    test_worker_crash_recovery_end_to_end`` at full width): the port's
    launcher (``python3 -m pslite_tpu_torch.tracker.local -n 2 -s 1``,
    keepalive on) runs 1 scheduler, 1 server and 2 workers over tcp on
    the native core, heartbeats 1 s / 2 s (``node_recovery``).  The
    ``ici_tcp`` worker crashes ``RECOVERY_CRASHES`` times and finishes
    in its next life; each life must take the dead id back, launch K4,
    and the other worker must see the store exact.  K4's launches in
    the crasher's lives are returned as the path's."""
    from pslite_tpu_torch.utils.network import get_available_port

    work = tempfile.mkdtemp(prefix="smoke-recovery")
    spec = {"phase": "recovery", "dir": work, "crashes": RECOVERY_CRASHES,
            "steps": RECOVERY_STEPS, "poll_s": 120.0}
    env = dict(os.environ, **RECOVERY_HB, PS_ICI_IMPL="pallas",
               DMLC_PS_ROOT_URI="127.0.0.1", DMLC_NODE_HOST="127.0.0.1",
               SMOKE_SPEC=json.dumps(spec))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pslite_tpu_torch.tracker.local", "-n", "2",
         "-s", "1", "--van", "tcp", "--root-port",
         str(get_available_port()), "--", sys.executable,
         os.path.join(HERE, "chip_smoke.py"),
         "--node"], env=env, cwd=HERE, capture_output=True, text=True,
        timeout=PROC_DEADLINE)
    wall = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        print("\n".join(out.splitlines()[-40:]))
        raise AssertionError(f"recovery-keepalive: the launcher exited "
                             f"{proc.returncode}")
    events = [json.loads(ln[len("EVENT "):]) for ln in out.splitlines()
              if ln.startswith("EVENT ")]
    lives = sorted((e for e in events if e["kind"] == "life"),
                   key=lambda e: e["life"])
    crashes = sorted((e for e in events if e["kind"] == "crash"),
                     key=lambda e: e["life"])
    rounds = {e["life"]: e for e in events if e["kind"] == "round"}
    finals = [json.loads(ln) for ln in out.splitlines()
              if ln.startswith("{") and '"crasher": true' in ln]
    restarts = out.count("restarting worker (exit 254)")
    if (len(lives) != RECOVERY_CRASHES + 1 or len(crashes) != RECOVERY_CRASHES
            or restarts != RECOVERY_CRASHES or len(finals) != 1
            or not any(e["kind"] == "poll_ok" for e in events)):
        print("\n".join(out.splitlines()[-40:]))
        raise AssertionError(f"recovery-keepalive: {len(lives)} lives, "
                             f"{len(crashes)} crashes, {restarts} restarts")
    ids = {e["id"] for e in lives}
    if len(ids) != 1 or [e["recovery"] for e in lives] != (
            [False] + [True] * RECOVERY_CRASHES):
        raise AssertionError(f"recovery-keepalive: the lives' ids {ids}, "
                             f"recovery marks "
                             f"{[e['recovery'] for e in lives]}")
    k4 = [c["k4"] for c in crashes] + [finals[0]["k4"]]
    if min(k4) <= 0:
        raise AssertionError(f"recovery-keepalive: K4 launches per life "
                             f"{k4}")
    rows = []
    for c, nxt in zip(crashes, lives[1:]):
        rows.append({
            "exit_to_restart_s": nxt["t_proc"] - c["t"],
            "restart_to_roster_s": nxt["t_ready"] - nxt["t_proc"],
            "register_to_roster_s": nxt["t_ready"] - nxt["t_register"],
            "restart_to_exact_round_s": (rounds[nxt["life"]]["t"]
                                         - nxt["t_proc"])})
    worst = max(e["max_abs_err_vs_f64"] for e in rounds.values())
    print(f"recovery-keepalive (the port's launcher with keepalive: 1 "
          f"scheduler, 1 server and 2 worker processes over tcp, native "
          f"core, heartbeats 1 s / 2 s; the ici_tcp worker on {N} ranks of "
          f"cuda:0 crashed {RECOVERY_CRASHES} times, exit 254, and took "
          f"node id {ids.pop()} back each life): per restart, exit -> "
          f"restart (process start) "
          f"{spread(r['exit_to_restart_s'] for r in rows)} s, restart -> "
          f"roster with is_recovery "
          f"{spread(r['restart_to_roster_s'] for r in rows)} s (of which "
          f"the child's wait for the detector "
          f"{float(RECOVERY_HB['PS_HEARTBEAT_TIMEOUT']) + 1.5:.1f} s; "
          f"registration -> roster "
          f"{spread(r['register_to_roster_s'] for r in rows)} s), restart "
          f"-> first exact round "
          f"{spread(r['restart_to_exact_round_s'] for r in rows)} s; K4 "
          f"ring_push_pull[float32] launches per life {k4}; the other "
          f"worker saw the store exact ({MSG_LOOSE_KEYS} x {MB_LEN} B "
          f"keys, {RECOVERY_CRASHES + 2} pushes); bucket max |err| vs "
          f"float64 {worst:.3g}; {wall:.1f} s in all [{smi}] "
          f"[host CPU {cpu_model()}]")
    row = {"config": "recovery-keepalive", "ops": len(lives)
           * (RECOVERY_STEPS + 1) + 2, "max_abs_err_vs_f64": worst,
           **{f"k4_launches_life{i + 1}": n for i, n in enumerate(k4)}}
    for key in rows[0]:
        row[key] = float(np.median([r[key] for r in rows]))
    return [row], {"ring_push_pull[float32]": sum(k4)}


def drive_deadline_timeout(smi: str):
    """``deadline-timeout`` (JAX's ``test_fault_tolerance.py::
    test_wait_raises_timeout_against_killed_server`` at full width): 1 +
    1 + 1 processes over tcp, heartbeats 0.3 s / 1.0 s,
    ``PS_REQUEST_TIMEOUT=0.3``, ``PS_REQUEST_RETRIES=2``; the worker
    keeps ``DEADLINE_DEPTH`` pushes of the 40 x 1 MB bucket in flight and
    the server process is killed (SIGKILL) under them
    (``node_deadline``)."""
    import signal

    cluster = Cluster("tcp", 1, 1, {"phase": "deadline"}, extra=DEADLINE_ENV)
    try:
        cluster.ready()
        (_wpath, wproc), = cluster._workers()
        wproc.stdin.write(b"go\n")
        wproc.stdin.flush()
        time.sleep(0.5)
        server = next(p for role, _l, p in cluster.procs if role == "server")
        t_kill = time.time()
        os.kill(server.pid, signal.SIGKILL)
        server.wait()
        cluster.procs = [x for x in cluster.procs if x[0] != "server"]
        rep = json.loads(cluster._lines("WINDOW ", 1)[0])
        cluster.finish(("worker",))
    finally:
        cluster.kill()
    if rep["failed_pushes"] < 1 or rep["pending_left"]:
        raise AssertionError(f"deadline-timeout: {rep}")
    detect = rep["t_detected"] - t_kill
    last = rep["t_last_raise"] - t_kill
    print(f"deadline-timeout (1 scheduler, 1 server, 1 worker process over "
          f"tcp, native core; heartbeats 0.3 s / 1.0 s, "
          f"PS_REQUEST_TIMEOUT=0.3, PS_REQUEST_RETRIES=2; "
          f"{DEADLINE_DEPTH} pushes of {KEYS} x {MB_LEN} B in flight when "
          f"the server process was killed): kill -> detection (the "
          f"worker's NODE_FAILURE hook) {detect:.3f} s, kill -> the last "
          f"outstanding wait raising TimeoutError {last:.3f} s; "
          f"{rep['ok_pushes']} pushes completed before, "
          f"{rep['failed_pushes']} raised TimeoutError, none hung, no "
          f"failed push's callback fired [{smi}] [host CPU {cpu_model()}]")
    return [{"config": "deadline-timeout",
             "ops": rep["ok_pushes"] + rep["failed_pushes"],
             "kill_to_detect_s": detect, "kill_to_last_raise_s": last,
             "failed_pushes": rep["failed_pushes"]}]


def drive_chaos_matrix(ps, Environment, smi: str):
    """``chaos-matrix`` (JAX's ``test_chaos.py::
    test_chaos_matrix_healed_by_resender`` at test_benchmark's 1 MB
    keys): 1 worker + 2 servers in this process over ``chaos+tcp`` with
    ``PS_CHAOS`` drop 0.15, delay 0.5-2 ms, reorder 0.1, dup 0.1 and
    ``PS_RESEND=1`` (60 ms), beside a plain tcp leg; each round pushes
    40 keys of 1,024,000 B per server and pulls them, every pull checked
    exactly.  The legs alternate round by round."""
    from pslite_tpu_torch.utils.network import get_available_port

    legs = {}
    for label, van, extra in (
            ("chaos+tcp", "chaos+tcp", {"PS_CHAOS": CHAOS_SPEC,
                                        "PS_RESEND": "1",
                                        "PS_RESEND_TIMEOUT": "60"}),
            ("tcp", "tcp", {})):
        env = dict(extra, DMLC_PS_ROOT_URI="127.0.0.1",
                   DMLC_NODE_HOST="127.0.0.1",
                   DMLC_PS_ROOT_PORT=str(get_available_port()))
        nodes = msg_cluster(ps, Environment, 1, 2, van=van, env=env)
        servers = []
        for po in nodes[1:3]:
            srv = ps.KVServer(0, postoffice=po)
            srv.set_request_handle(ps.KVServerDefaultHandle())
            servers.append(srv)
        w = ps.KVWorker(0, 0, postoffice=nodes[3])
        legs[label] = {"nodes": nodes, "apps": servers + [w], "w": w,
                       "times": [], "s64": None}
    try:
        wpo = legs["tcp"]["nodes"][3]
        keys = np.array([r.begin + i for r in wpo.get_server_key_ranges()
                         for i in range(MSG_KEYS_PER_SERVER)], np.uint64)
        base = np.random.default_rng(SEED + 12).integers(
            -8, 8, size=len(keys) * VAL_LEN).astype(np.float32)
        buf, out = np.empty_like(base), np.zeros_like(base)
        for r in range(1 + CHAOS_ROUNDS):
            for label, leg in legs.items():
                np.add(base, np.float32(r), out=buf)
                t0 = time.perf_counter()
                leg["w"].wait(leg["w"].push(keys, buf))
                leg["w"].wait(leg["w"].pull(keys, out))
                if r:
                    leg["times"].append(time.perf_counter() - t0)
                want = (r + 1) * base.astype(np.float64) + r * (r + 1) / 2
                if not np.array_equal(out, want):
                    raise AssertionError(
                        f"chaos-matrix [{label}] round {r}: "
                        f"{int((out != want).sum())} values wrong")
        stats = {}
        for po in legs["chaos+tcp"]["nodes"]:
            for k, v in po.van.chaos_stats.items():
                stats[k] = stats.get(k, 0) + v
        if not stats:
            raise AssertionError("chaos-matrix: chaos injected nothing")
    finally:
        for leg in legs.values():
            msg_finalize(leg["nodes"], leg["apps"])
    ms = {label: sum(leg["times"]) / len(leg["times"]) * 1e3
          for label, leg in legs.items()}
    print(f"chaos-matrix (1 worker + 2 servers in this process, "
          f"{len(keys)} keys x {MB_LEN} B, push + pull per round, "
          f"{CHAOS_ROUNDS} timed rounds per leg alternating, every pull "
          f"exact): chaos+tcp ({CHAOS_SPEC}, PS_RESEND=1, 60 ms) "
          f"{ms['chaos+tcp']:.1f} ms/round "
          f"({', '.join(f'{t * 1e3:.1f}' for t in legs['chaos+tcp']['times'])}"
          f"), plain tcp {ms['tcp']:.1f} ms/round "
          f"({', '.join(f'{t * 1e3:.1f}' for t in legs['tcp']['times'])}); "
          f"chaos counters over every node "
          + ", ".join(f"{k} {v}" for k, v in sorted(stats.items()))
          + f" [{smi}] [host CPU {cpu_model()}]")
    return [{"config": "chaos-matrix", "ops": 4 * (1 + CHAOS_ROUNDS),
             "ms_per_round_chaos": ms["chaos+tcp"],
             "ms_per_round_tcp": ms["tcp"], **{f"chaos_{k}": v
                                               for k, v in stats.items()}}]


# -- durability: replication, replica reads, the durable store ----------------

FAILOVER_ENV = {"PS_KV_REPLICATION": "2", "PS_HEARTBEAT_INTERVAL": "0.3",
                "PS_HEARTBEAT_TIMEOUT": "1.0", "PS_REQUEST_TIMEOUT": "0.5",
                "PS_REQUEST_RETRIES": "5"}
FAILOVER_WARM = 2       # rounds each worker runs before the parent kills
FAILOVER_MIN_ROUNDS = 8  # rounds each worker runs at least
FAILOVER_AFTER = 2      # exact rounds after the restored server is heard
FAILOVER_CAP_S = 150.0  # the storm's own bound
RR_SECS = 2.0           # benchmark.py:2516: 3 s quick, 6 s full; cut
                        # to keep the script inside its time limit
RR_ROWS, RR_DIM, RR_BATCH, RR_DEPTH = 2048, 16, 16, 8  # benchmark.py:592-596
RR_ENV = {"PS_REPLICA_READS": "1", "PS_HOT_CACHE": "0",
          "PS_REQUEST_TIMEOUT": "5.0", "PS_REQUEST_RETRIES": "6"}
NS_ROWS, NS_DIM = 512, 16  # benchmark.py:2397's namespace-flip storm
DUR_ROWS, DUR_DIM = 1024, 1024  # benchmark.py:2666-2667, quick=False
DUR_PULLS = 1500
DUR_WARM_PULLS = 300


def say(line: str) -> None:
    """One output line in one write: a launcher's children share its
    pipe, and ``print`` may write the text and the newline apart."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def failover_keys(po, who: int, per_server: int) -> np.ndarray:
    """A worker's own keys in each server's range (disjoint per worker,
    so each worker knows its keys' sums exactly)."""
    return np.array([r.begin + 10_000 * (1 + who) + i
                     for r in po.get_server_key_ranges()
                     for i in range(per_server)], np.uint64)


def node_failover(spec) -> int:
    """One node of ``replication-failover``'s kill leg, launched by the
    port's launcher with keepalive.  A server runs its node in a child
    process (``SMOKE_INNER``) and exits 254 when that child was killed
    (SIGKILL), so the keepalive restarts it; the restart first waits for
    the failure detector to declare the dead id.  Workers push their 80
    keys x 1,024,000 B each round and pull rank 0's 40 back, checked
    exactly, until ``FAILOVER_AFTER`` rounds ran after the restored
    server was heard.  Lines ``EVENT <json>`` carry the times."""
    role = os.environ["DMLC_ROLE"]
    if role == "server" and "SMOKE_INNER" not in os.environ:
        marker = os.path.join(spec["dir"], "server-killed")
        restart = os.path.exists(marker)
        say("EVENT " + json.dumps({"kind": "supervisor", "t_proc": T_PROC,
                                   "restart": restart}))
        if restart:
            time.sleep(float(FAILOVER_ENV["PS_HEARTBEAT_TIMEOUT"]) + 1.5)
        rc = subprocess.call(
            [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--node"],
            env=dict(os.environ, SMOKE_INNER="1"))
        if rc == -9:
            with open(marker, "w") as f:
                f.write("1")
            return 254  # the crash: the launcher's keepalive restarts it
        return rc
    # Not before: the supervisor restarts without importing torch.
    import pslite_tpu_torch as ps
    from pslite_tpu_torch.base import server_rank_to_id

    ps.start_ps()
    po = ps.postoffice(role)
    if role == "scheduler":
        ps.finalize()
        return 0
    if role == "server":
        srv = ps.KVServer(0)
        handle = ps.KVServerDefaultHandle()
        t_handle = time.time()
        srv.set_request_handle(handle)  # a recovered life restores here
        t_restored = time.time()
        say("EVENT " + json.dumps({
            "kind": "server", "rank": po.my_rank(), "pid": os.getpid(),
            "recovery": po.is_recovery, "t_proc": T_PROC,
            "t_handle": t_handle, "t_restored": t_restored,
            "keys": len(handle.store),
            "bytes": int(sum(v.nbytes for v in handle.store.values()))}))
        ps.finalize()
        say("EVENT " + json.dumps({
            "kind": "store", "rank": po.my_rank(),
            "crc": {str(k): zlib.crc32(v.tobytes())
                    for k, v in handle.store.items()}}))
        srv.stop()
        return 0
    kv = ps.KVWorker(0, 0)
    me = po.my_rank()
    victim = server_rank_to_id(0)
    events = []
    po.register_node_failure_hook(
        lambda nid, down: events.append((time.time(), down))
        if nid == victim else None)
    keys = failover_keys(po, me, spec["keys"])
    k0 = keys[:spec["keys"]]
    base = np.random.default_rng(SEED + 20 + me).integers(
        -8, 8, size=len(keys) * spec["val_len"]).astype(np.float32)
    base64 = base.astype(np.float64)
    buf = np.empty_like(base)
    out = np.zeros(len(k0) * spec["val_len"], np.float32)
    watchdog = threading.Timer(FAILOVER_CAP_S, lambda: (
        say("replication-failover: the storm hung"), os._exit(3)))
    watchdog.start()
    rounds, r = [], 0
    while True:
        np.add(base, np.float32(r), out=buf)
        t0 = time.time()
        kv.wait(kv.push(keys, buf))
        t1 = time.time()
        kv.wait(kv.pull(k0, out))
        t2 = time.time()
        want = (r + 1) * base64[:len(out)] + r * (r + 1) / 2
        if not np.array_equal(out, want):
            raise AssertionError(f"worker {me} round {r}: "
                                 f"{int((out != want).sum())} of rank 0's "
                                 f"values wrong")
        rounds.append((t0, t1, t2))
        r += 1
        if r == FAILOVER_WARM:
            say("EVENT " + json.dumps({"kind": "warm", "rank": me}))
        ups = [t for t, down in events if not down]
        after = sum(1 for t0_, _t1, _t2 in rounds if ups and t0_ > ups[0])
        if r >= FAILOVER_MIN_ROUNDS and after >= FAILOVER_AFTER:
            break
    # The whole store, both ranges, against the fault-free sums.
    full = np.zeros_like(base)
    kv.wait(kv.pull(keys, full))
    want = r * base64 + (r - 1) * r / 2
    exact = bool(np.array_equal(full, want))
    watchdog.cancel()
    kv.stop()
    ps.finalize()
    say(json.dumps({"kind": "worker", "rank": me, "rounds": rounds,
                    "events": events, "exact": exact,
                    "failovers": kv.stats["failovers"]}))
    return 0 if exact else 1


def node_replica_read(ps, po, kv, spec) -> dict:
    """JAX's ``--mode replica_read`` (``benchmark.py:580-700``) once per
    window: every worker aims a Zipf(1.3) storm of 16-row pulls at depth
    8 at server rank 0's range for ``spec["secs"]``; every 64th request
    is a read-your-writes probe (push +1 to this worker's own block,
    pull it straight back: a miss is a violation); every 32nd pull is
    checked against the table."""
    from collections import deque

    secs, batch, depth = spec["secs"], spec["batch"], spec["depth"]
    rows, dim = spec["rows"], spec["dim"]
    n_w = po.num_workers
    wrank = po.my_rank()
    keys = np.arange(rows, dtype=np.uint64)  # rank 0's range
    table = np.stack([np.full(dim, 1.0 + r, np.float32)
                      for r in range(rows)])
    kv.wait(kv.push(keys, table.reshape(-1)))
    po.barrier(0, ps.WORKER_GROUP)
    expected = table * n_w
    warm = np.zeros(batch * dim, np.float32)
    end = time.monotonic() + 10.0
    while True:
        warm[:] = 0
        kv.wait(kv.pull(keys[:batch], warm))
        if np.array_equal(warm.reshape(batch, dim), expected[:batch]):
            break
        if time.monotonic() > end:
            raise AssertionError("the base table never settled on the chain")
        time.sleep(0.05)
    po.barrier(0, ps.WORKER_GROUP)
    zipf = np.minimum(np.random.RandomState(7 + wrank).zipf(
        1.3, size=65536) - 1, rows - 8 * batch - 1).astype(np.int64)
    pool = [np.zeros(batch * dim, np.float32) for _ in range(depth)]
    p0 = rows - (wrank + 1) * batch
    probe_keys = keys[p0:p0 + batch]
    probe_expected = np.ascontiguousarray(expected[p0:p0 + batch])
    probe_delta = np.ones(batch * dim, np.float32)
    probe_out = np.zeros(batch * dim, np.float32)
    zi = 0
    for _w in node_windows(spec):
        spread0 = kv.stats["replica_read.spread"]
        fall0 = kv.stats["replica_read.fallbacks"]
        pending, free, lats = deque(), list(range(depth)), []
        n_req = violations = checked = 0

        def retire(check: bool) -> None:
            nonlocal checked
            t_iss, ts, start, slot = pending.popleft()
            kv.wait(ts)
            lats.append(time.perf_counter() - t_iss)
            if check:
                got = pool[slot].reshape(batch, dim)
                if not np.array_equal(got, expected[start:start + batch]):
                    raise AssertionError(f"storm pull of rows [{start}, "
                                         f"{start + batch}) wrong")
                checked += 1
            free.append(slot)

        t0 = time.perf_counter()
        t_end = t0 + secs
        while time.perf_counter() < t_end:
            n_req += 1
            if n_req % 64 == 0:
                probe_expected += 1.0
                kv.wait(kv.push(probe_keys, probe_delta))
                probe_out[:] = 0
                kv.wait(kv.pull(probe_keys, probe_out))
                if not np.array_equal(probe_out.reshape(batch, dim),
                                      probe_expected):
                    violations += 1
                continue
            start = int(zipf[zi % len(zipf)])
            zi += 1
            slot = free.pop()
            pending.append((time.perf_counter(),
                            kv.pull(keys[start:start + batch], pool[slot]),
                            start, slot))
            if len(pending) >= depth:
                retire(check=n_req % 32 == 0)
        while pending:
            retire(check=False)
        wall = time.perf_counter() - t0
        p50, p99 = pctl_ms(lats)
        window_done({"reqs": n_req, "reqs_per_s": n_req / wall,
                     "ryw_violations": violations, "checked": checked,
                     "spread": kv.stats["replica_read.spread"] - spread0,
                     "fallbacks": kv.stats["replica_read.fallbacks"] - fall0,
                     "p50_ms": p50, "p99_ms": p99})
    return {"members": sorted(kv._read_share)}


def node_durable_serve(ps, po, kv, spec) -> dict:
    """JAX's ``--mode durable_serve`` (``benchmark.py:369-394``): the
    table (``spec["rows"]`` x ``spec["dim"]`` f32, ``models/dlrm.py``'s
    rows), an unmeasured Zipf(1.5) warm storm of 300 single-row pulls
    (the server's hot keys learn the head, the tier settles), then once
    per window ``spec["pulls"]`` Zipf single-row pulls, timed, every
    64th checked exactly."""
    from pslite_tpu_torch.models import dlrm

    rows, dim = spec["rows"], spec["dim"]
    cfg = dlrm.DLRMConfig(num_rows=rows, emb_dim=dim)
    keys = np.arange(rows, dtype=np.uint64)
    table = dlrm.embedding_row(cfg, np.arange(rows))
    kv.wait(kv.push(keys, table.reshape(-1)))
    out = np.zeros(dim, np.float32)
    for r in dlrm.serving_keys(cfg, spec["warm"], seed=3):
        kv.wait(kv.pull(keys[int(r):int(r) + 1], out))
    checked = 0
    for w in node_windows(spec):
        lats = []
        for i, r in enumerate(dlrm.serving_keys(cfg, spec["pulls"],
                                           seed=7 + w)):
            t0 = time.perf_counter()
            kv.wait(kv.pull(keys[int(r):int(r) + 1], out))
            lats.append(time.perf_counter() - t0)
            if i % 64 == 0:
                if not np.array_equal(out, table[int(r)]):
                    raise AssertionError(f"durable-serve: row {r} wrong")
                checked += 1
        p50, p99 = pctl_ms(lats)
        window_done({"pulls": len(lats), "p50_ms": p50, "p99_ms": p99,
                     "checked": checked})
    return {"checked": checked}


def drive_replication_failover(smi: str):
    """``replication-failover``: 2 workers + 2 servers over tcp on the
    native core, BASELINE config 2's pushes (80 keys x 1,024,000 B per
    worker and round).  (1) The replication tax: push, worker barrier,
    pull of the 80 keys at ``PS_KV_REPLICATION=2`` against 1, one
    cluster each, 2 windows of 2 rounds alternating.  (2) The kill: the
    port's launcher with keepalive (``node_failover``), deadlines 0.5 s
    x 5 retries, heartbeats 0.3 s / 1.0 s; mid storm the parent SIGKILLs
    server rank 0; its range fails over to the replica, the keepalive
    restarts it, it takes rank 0 back and restores from the replica
    before serving.  Every wait ends, every round's pull of rank 0's
    keys and the final pull of both ranges are exact, and the restored
    store equals the replica's."""
    import signal

    from pslite_tpu_torch.utils.network import get_available_port

    spec = {"mode": "push_barrier_pull", "sizes": [[MSG_KEYS_PER_SERVER,
                                                    MB_LEN]],
            "warmup": MSG_WARMUP, "rounds": PLANE_ROUNDS,
            "windows": TIER_ROUNDS}
    legs, _f = interleaved(
        [("k1", {}), ("k2", {"PS_KV_REPLICATION": "2"})],
        lambda env: Cluster("tcp", 2, 2, spec, extra=env),
        every_worker=True)
    key = str(MB_LEN)
    ms = {leg: [sum(w["sizes"][key]["ms_per_round"] for w in win) / len(win)
                for win in wins] for leg, wins in legs.items()}
    row = {"config": "replication-tax", "ops": 2 * TIER_ROUNDS * PLANE_ROUNDS
           * 2, "ms_per_round_k1": float(np.median(ms["k1"])),
           "ms_per_round_k2": float(np.median(ms["k2"]))}
    ratio_row(row, "tax_k2_over_k1", ms["k2"], ms["k1"])
    print(f"replication-tax (1 scheduler + 2 servers + 2 workers, tcp, "
          f"native core; {2 * MSG_KEYS_PER_SERVER} keys x {MB_LEN} B per "
          f"worker and round, push + worker barrier + pull, every pull "
          f"exact; {tier_topo()}): ms/round k=1 {spread(ms['k1'])}, k=2 "
          f"{spread(ms['k2'])}; k=2 / k=1 by window median "
          f"{row['tax_k2_over_k1']:.3f} (least "
          f"{row['tax_k2_over_k1_min']:.3f}, most "
          f"{row['tax_k2_over_k1_max']:.3f}) [{smi}] [host CPU "
          f"{cpu_model()}]")

    work = tempfile.mkdtemp(prefix="smoke-failover")
    env = dict(os.environ, **FAILOVER_ENV, DMLC_PS_ROOT_URI="127.0.0.1",
               DMLC_NODE_HOST="127.0.0.1",
               SMOKE_SPEC=json.dumps({"phase": "failover", "dir": work,
                                      "keys": MSG_KEYS_PER_SERVER,
                                      "val_len": VAL_LEN}))
    lines: list = []
    proc = subprocess.Popen(
        [sys.executable, "-m", "pslite_tpu_torch.tracker.local", "-n", "2",
         "-s", "2", "--van", "tcp", "--root-port", str(get_available_port()),
         "--", sys.executable, os.path.join(HERE, "chip_smoke.py"),
         "--node"], env=env, cwd=HERE, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout),
                              daemon=True)
    reader.start()

    def events(kind):
        return [json.loads(ln[len("EVENT "):]) for ln in list(lines)
                if ln.startswith("EVENT ") and f'"kind": "{kind}"' in ln]

    t_kill = None
    try:
        end = time.monotonic() + PROC_DEADLINE
        while (len(events("warm")) < 2 or len(events("server")) < 2):
            if proc.poll() is not None or time.monotonic() > end:
                raise AssertionError("replication-failover: the cluster "
                                     "did not start its storm")
            time.sleep(0.02)
        time.sleep(1.0)  # mid storm
        victim = next(e for e in events("server") if e["rank"] == 0)
        t_kill = time.time()
        os.kill(victim["pid"], signal.SIGKILL)
        rc = proc.wait(timeout=PROC_DEADLINE)
        reader.join(timeout=10)
    finally:
        # The launcher's whole session: a server's child outlives its
        # supervisor when the launcher terminates the run on a failure.
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    out = "".join(lines)
    if rc != 0:
        print("\n".join(out.splitlines()[-60:]))
        raise AssertionError(f"replication-failover: the launcher exited "
                             f"{rc}")
    workers = [json.loads(ln) for ln in out.splitlines()
               if ln.startswith('{"kind": "worker"')]
    lives = events("server")
    restored = [e for e in lives if e["recovery"]]
    sup = [e for e in events("supervisor") if e["restart"]]
    stores = {}
    for e in events("store"):
        stores[e["rank"]] = e["crc"]
    if (len(workers) != 2 or not all(w["exact"] for w in workers)
            or len(restored) != 1 or len(sup) != 1
            or out.count("restarting server (exit 254)") != 1
            or sorted(stores) != [0, 1]):
        print("\n".join(out.splitlines()[-60:]))
        raise AssertionError(f"replication-failover: {len(workers)} worker "
                             f"reports, {len(restored)} restored lives, "
                             f"{len(sup)} restarts, stores of "
                             f"{sorted(stores)}")
    if stores[0] != stores[1]:
        diff = [k for k in stores[0] if stores[1].get(k) != stores[0][k]]
        raise AssertionError(f"replication-failover: the restored store "
                             f"differs from the replica's on {len(diff)} "
                             f"of {len(stores[0])} keys")
    rs = restored[0]
    t_detect = min(t for w in workers for t, down in w["events"] if down)
    t_heard = min(t for w in workers for t, down in w["events"] if not down)
    waits = [(a, b) for w in workers for t0, t1, t2 in w["rounds"]
             for a, b in ((t0, t1), (t1, t2))]
    last_end = max(b for a, b in waits if a < t_kill)
    first_fo = min(t2 for w in workers for _t0, _t1, t2 in w["rounds"]
                   if t2 > t_detect)
    first_exact = min(t2 for w in workers for t0, _t1, t2 in w["rounds"]
                      if t0 > t_heard)
    restore_s = rs["t_restored"] - rs["t_handle"]
    kill_row = {
        "config": "replication-failover",
        "ops": sum(len(w["rounds"]) for w in workers) * 2,
        "kill_to_detect_s": t_detect - t_kill,
        "kill_to_first_failover_pull_s": first_fo - t_kill,
        "kill_to_last_wait_end_s": last_end - t_kill,
        "restart_to_restored_s": rs["t_restored"] - sup[0]["t_proc"],
        "inner_start_to_restored_s": rs["t_restored"] - rs["t_proc"],
        "restore_s": restore_s, "restored_mb": rs["bytes"] / 1e6,
        "restore_mb_per_s": rs["bytes"] / 1e6 / max(restore_s, 1e-9),
        "restart_to_first_exact_round_s": first_exact - sup[0]["t_proc"],
        "max_wait_s": max(b - a for a, b in waits),
        "failovers": sum(w["failovers"] for w in workers)}
    print(f"replication-failover (the port's launcher with keepalive: 1 "
          f"scheduler, 2 servers, 2 workers over tcp, native core, "
          f"PS_KV_REPLICATION=2, heartbeats 0.3 s / 1.0 s, "
          f"PS_REQUEST_TIMEOUT=0.5, PS_REQUEST_RETRIES=5; each worker "
          f"pushes {2 * MSG_KEYS_PER_SERVER} keys x {MB_LEN} B per round and "
          f"pulls rank 0's {MSG_KEYS_PER_SERVER} back; server rank 0 "
          f"SIGKILLed mid storm): kill -> detection "
          f"{kill_row['kill_to_detect_s']:.3f} s, kill -> first failover "
          f"pull {kill_row['kill_to_first_failover_pull_s']:.3f} s, kill "
          f"-> the last outstanding wait's end "
          f"{kill_row['kill_to_last_wait_end_s']:.3f} s (longest wait "
          f"{kill_row['max_wait_s']:.3f} s, none hung); restart "
          f"(keepalive, exit 254; the restart waits "
          f"{float(FAILOVER_ENV['PS_HEARTBEAT_TIMEOUT']) + 1.5:.1f} s for "
          f"the detector) -> restored "
          f"{kill_row['restart_to_restored_s']:.3f} s (its process start "
          f"-> restored {kill_row['inner_start_to_restored_s']:.3f} s; the "
          f"restore {restore_s:.3f} s for {rs['keys']} keys, "
          f"{kill_row['restored_mb']:.1f} MB, "
          f"{kill_row['restore_mb_per_s']:.1f} MB/s), restart -> first "
          f"exact round {kill_row['restart_to_first_exact_round_s']:.3f} "
          f"s; {sum(len(w['rounds']) for w in workers)} rounds, every "
          f"pull exact, both ranges exact at the end, the restored store "
          f"equal to the replica's ({len(stores[0])} keys, crc32 each); "
          f"{kill_row['failovers']} failover routings [{smi}] [host CPU "
          f"{cpu_model()}]")
    return [row, kill_row]


def drive_replica_read(ps, Environment, smi: str):
    """``replica-read``: JAX's ``replica_read_bench(quick=True)``
    (``benchmark.py:2494-2548``) over tcp processes: 3 workers + 3
    servers, k = 3 against k = 1, one cluster each, 2 windows of
    ``RR_SECS`` alternating; then JAX's namespace-flip leg
    (``benchmark.py:2397-2491``): 1 worker + 3 servers in this process
    over tcp at k = 3 with replica reads, a pull storm while the
    scheduler snapshots v1, pushes v2, publishes v1, flips and rolls
    back; 0 failed requests, every answer exactly v1 or v2."""
    import shutil

    from pslite_tpu_torch.utils.network import get_available_port

    spec = {"phase": "replica-read", "windows": TIER_ROUNDS,
            "secs": RR_SECS, "rows": RR_ROWS, "dim": RR_DIM,
            "batch": RR_BATCH, "depth": RR_DEPTH}
    legs, finals = interleaved(
        [("k3", dict(RR_ENV, PS_KV_REPLICATION="3")),
         ("k1", dict(RR_ENV, PS_KV_REPLICATION="1"))],
        lambda env: Cluster("tcp", 3, 3, spec, extra=env),
        every_worker=True)
    rate = {leg: [sum(w["reqs_per_s"] for w in win) for win in wins]
            for leg, wins in legs.items()}
    viol = sum(w["ryw_violations"] for wins in legs.values() for win in wins
               for w in win)
    if viol:
        raise AssertionError(f"replica-read: {viol} read-your-writes "
                             f"violations")
    members = sorted({m for f in finals["k3"] for m in f["members"]})
    if len(members) < 3:
        raise AssertionError(f"replica-read: the k=3 workers read from "
                             f"nodes {members} only")
    row = {"config": "replica-read",
           "ops": sum(w["reqs"] for wins in legs.values() for win in wins
                      for w in win),
           "reads_per_s_k3": float(np.median(rate["k3"])),
           "reads_per_s_k1": float(np.median(rate["k1"])),
           "ryw_violations": viol}
    ratio_row(row, "k3_over_k1_reads", rate["k3"], rate["k1"])
    p50 = {leg: [float(np.median([w["p50_ms"] for w in win]))
                 for win in wins] for leg, wins in legs.items()}
    spreads = sum(w["spread"] for win in legs["k3"] for w in win)
    falls = sum(w["fallbacks"] for win in legs["k3"] for w in win)
    checked = sum(w["checked"] for wins in legs.values() for win in wins
                  for w in win)
    print(f"replica-read (JAX's replica_read_bench: 3 workers + 3 servers "
          f"over tcp, native core, each worker a Zipf(1.3) storm of "
          f"{RR_BATCH}-row pulls at depth {RR_DEPTH} on rank 0's "
          f"{RR_ROWS} x {RR_DIM} rows for {RR_SECS:g} s, a read-your-writes "
          f"probe every 64th request; {tier_topo()}): reads/s k=3 "
          f"{spread(rate['k3'])}, k=1 {spread(rate['k1'])}; k=3 / k=1 by "
          f"window median {row['k3_over_k1_reads']:.3f} (least "
          f"{row['k3_over_k1_reads_min']:.3f}, most "
          f"{row['k3_over_k1_reads_max']:.3f}); p50 ms k=3 "
          f"{spread(p50['k3'])}, k=1 {spread(p50['k1'])}; read-your-writes "
          f"violations {viol}; k=3 spread reads {spreads}, stale-answer "
          f"fallbacks {falls}; {checked} storm pulls checked exactly "
          f"[{smi}] [host CPU {cpu_model()}]")

    snapdir = tempfile.mkdtemp(prefix="smoke-nsflip")
    nodes = msg_cluster(ps, Environment, 1, 3, van="tcp", env={
        "PS_KV_REPLICATION": "3", "PS_REPLICA_READS": "1",
        "PS_REQUEST_TIMEOUT": "2.0", "PS_REQUEST_RETRIES": "6",
        "PS_SNAPSHOT_DIR": snapdir, "DMLC_PS_ROOT_URI": "127.0.0.1",
        "DMLC_NODE_HOST": "127.0.0.1",
        "DMLC_PS_ROOT_PORT": str(get_available_port())})
    sched, worker_po = nodes[0], nodes[4]
    servers = []
    for po in nodes[1:4]:
        srv = ps.KVServer(0, postoffice=po)
        srv.set_request_handle(ps.KVServerDefaultHandle())
        servers.append(srv)
    w = ps.KVWorker(0, 0, postoffice=worker_po)
    try:
        keys = np.arange(NS_ROWS, dtype=np.uint64)
        v1 = np.stack([np.full(NS_DIM, 1.0 + r, np.float32)
                       for r in range(NS_ROWS)])
        v2 = 2 * v1
        w.wait(w.push(keys, v1.reshape(-1)))
        time.sleep(0.3)  # the forwards land on the whole chain
        t0 = time.perf_counter()
        sched.snapshot()
        snap_s = time.perf_counter() - t0
        w.wait(w.push(keys, v1.reshape(-1)))  # the live store is v2
        batch, stop, errors, pulls = 16, threading.Event(), [], [0]

        def storm():
            out = np.zeros(batch * NS_DIM, np.float32)
            i = 0
            while not stop.is_set():
                start = (i * 7) % (NS_ROWS - batch)
                i += 1
                out[:] = 0
                try:
                    w.wait(w.pull(keys[start:start + batch], out))
                except Exception as exc:  # noqa: BLE001 - counted
                    errors.append(repr(exc))
                    continue
                got = out.reshape(batch, NS_DIM)
                if not (np.array_equal(got, v1[start:start + batch])
                        or np.array_equal(got, v2[start:start + batch])):
                    errors.append(f"mixed read at row {start}")
                pulls[0] += 1

        t = threading.Thread(target=storm, daemon=True)
        t.start()
        time.sleep(0.5)
        t0 = time.perf_counter()
        pub = sched.publish_model(namespace="bench", version="v1")
        flip_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(0.5)
        t0 = time.perf_counter()
        rb = sched.rollback_model()
        rollback_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(0.5)
        stop.set()
        t.join(timeout=10)
        out = np.zeros(NS_ROWS * NS_DIM, np.float32)
        w.wait(w.pull(keys, out))
        if (errors or pub["servers"] != 3 or rb["servers"] != 3
                or not np.array_equal(out.reshape(NS_ROWS, NS_DIM), v2)):
            raise AssertionError(f"namespace-flip: {errors[:3]}, {pub}, "
                                 f"{rb}")
    finally:
        msg_finalize(nodes, servers + [w])
        shutil.rmtree(snapdir, ignore_errors=True)
    print(f"replica-read namespace-flip (1 worker + 3 servers in this "
          f"process over tcp, k=3, replica reads; {NS_ROWS} x {NS_DIM} "
          f"rows): snapshot {snap_s * 1e3:.1f} ms, publish (stage + flip) "
          f"{flip_ms:.1f} ms, rollback {rollback_ms:.1f} ms under "
          f"{pulls[0]} storm pulls, 0 failed, each exactly v1 or v2; the "
          f"live v2 store served after the rollback [{smi}] [host CPU "
          f"{cpu_model()}]")
    row.update(ns_flip_ms=flip_ms, ns_rollback_ms=rollback_ms,
               ns_pulls=pulls[0], ns_failed=0)
    return [row]


def drive_durable_store(ps, Environment, smi: str):
    """``durable-store``.  (1) JAX's ``durable_store_bench(quick=False)``
    serving legs (``benchmark.py:2649-2720``): 1 worker + 1 server
    processes over tcp, a 1,024 x 1,024 f32 table, the server's store
    tiered under ``PS_STORE_RAM_MB`` = a quarter of the table against
    all in RAM, one cluster each, 2 windows of 1,500 Zipf single-row
    pulls alternating (``node_durable_serve``); the tiered/all-RAM hot
    p99 ratio (JAX's <= 2x bar is a yardstick).  (2) A coordinated
    snapshot of BASELINE config 2's store (80 keys x 1,024,000 B over 2
    servers, in this process over tcp), the whole cluster finalized, a
    fresh one booted with ``PS_SNAPSHOT_RESTORE=1``: snapshot s,
    restore s (each server's ``set_request_handle``), pulls bit-exact."""
    import shutil

    from pslite_tpu_torch.utils.network import get_available_port

    table_mb = DUR_ROWS * DUR_DIM * 4 / 2 ** 20
    ram_mb = table_mb / 4.0
    spec = {"phase": "durable-serve", "windows": TIER_ROUNDS,
            "rows": DUR_ROWS, "dim": DUR_DIM, "pulls": DUR_PULLS,
            "warm": DUR_WARM_PULLS}
    legs, finals = interleaved(
        [("tiered", {"PS_STORE_RAM_MB": str(ram_mb)}), ("all-ram", {})],
        lambda env: Cluster("tcp", 1, 1, spec, extra=env),
        report_roles=("server",))
    p99 = {leg: [w["p99_ms"] for w in wins] for leg, wins in legs.items()}
    p50 = {leg: [w["p50_ms"] for w in wins] for leg, wins in legs.items()}
    row = {"config": "durable-store",
           "ops": sum(w["pulls"] for wins in legs.values() for w in wins),
           "hot_p99_tiered_ms": float(np.median(p99["tiered"])),
           "hot_p99_allram_ms": float(np.median(p99["all-ram"])),
           "hot_p50_tiered_ms": float(np.median(p50["tiered"])),
           "hot_p50_allram_ms": float(np.median(p50["all-ram"]))}
    ratio_row(row, "hot_p99_ratio", p99["tiered"], p99["all-ram"])
    print(f"durable-store serving (JAX's durable_store_bench, quick=False: "
          f"1 worker + 1 server over tcp, {DUR_ROWS} x {DUR_DIM} f32 "
          f"table ({table_mb:.1f} MiB), PS_STORE_RAM_MB={ram_mb:g} against "
          f"all-RAM, {DUR_WARM_PULLS} warm pulls, {DUR_PULLS} Zipf(1.5) "
          f"single-row pulls per window, every 64th exact; {tier_topo()}): "
          f"p99 ms tiered {spread(p99['tiered'])}, all-RAM "
          f"{spread(p99['all-ram'])}; p50 ms tiered {spread(p50['tiered'])}"
          f", all-RAM {spread(p50['all-ram'])}; tiered / all-RAM p99 by "
          f"window median {row['hot_p99_ratio']:.3f} (least "
          f"{row['hot_p99_ratio_min']:.3f}, most "
          f"{row['hot_p99_ratio_max']:.3f}; JAX's bar 2.0, a yardstick) "
          f"[{smi}] [host CPU {cpu_model()}]")
    if "TieredStore" not in finals["tiered"]["tier"]:
        raise AssertionError(f"durable-store: the tiered leg's store is "
                             f"{finals['tiered']['tier']}")
    print(f"    the servers' stores at the end: tiered "
          f"{finals['tiered']['tier']}; all-RAM {finals['all-ram']['tier']}")

    snapdir = tempfile.mkdtemp(prefix="smoke-snapshot")

    def boot(extra):
        env = dict(extra, PS_SNAPSHOT_DIR=snapdir,
                   DMLC_PS_ROOT_URI="127.0.0.1", DMLC_NODE_HOST="127.0.0.1",
                   DMLC_PS_ROOT_PORT=str(get_available_port()))
        nodes = msg_cluster(ps, Environment, 1, 2, van="tcp", env=env)
        servers = [ps.KVServer(0, postoffice=po) for po in nodes[1:3]]
        took = {}

        def install(i, srv):
            t0 = time.perf_counter()
            srv.set_request_handle(ps.KVServerDefaultHandle())
            took[i] = time.perf_counter() - t0

        run_threads([lambda i=i, s=s: install(i, s)
                     for i, s in enumerate(servers)], "handles")
        return nodes, servers, ps.KVWorker(0, 0, postoffice=nodes[3]), took

    try:
        nodes, servers, w, _t = boot({})
        keys = np.array([r.begin + i
                         for r in nodes[3].get_server_key_ranges()
                         for i in range(MSG_KEYS_PER_SERVER)], np.uint64)
        vals = np.random.default_rng(SEED + 30).integers(
            -8, 8, size=len(keys) * VAL_LEN).astype(np.float32)
        try:
            w.wait(w.push(keys, vals))
            t0 = time.perf_counter()
            res = nodes[0].snapshot()
            snap_s = time.perf_counter() - t0
        finally:
            msg_finalize(nodes, servers + [w])
        nodes, servers, w, took = boot({"PS_SNAPSHOT_RESTORE": "1"})
        try:
            got = np.zeros_like(vals)
            w.wait(w.pull(keys, got))
            if not np.array_equal(got, vals):
                raise AssertionError(f"durable-store: the restored pull has "
                                     f"{int((got != vals).sum())} values "
                                     f"wrong")
        finally:
            msg_finalize(nodes, servers + [w])
    finally:
        shutil.rmtree(snapdir, ignore_errors=True)
    mb = sum(e["nbytes"] for e in res["ranges"]) / 1e6
    restore_s = max(took.values())
    print(f"durable-store snapshot (BASELINE config 2's store, "
          f"{len(keys)} keys x {MB_LEN} B over 2 servers in this process "
          f"over tcp): snapshot {snap_s:.3f} s ({len(res['ranges'])} "
          f"segments, {mb:.1f} MB, {mb / snap_s:.1f} MB/s), whole cluster "
          f"finalized, restore on boot {restore_s:.3f} s (the slower "
          f"server's set_request_handle; {mb / restore_s:.1f} MB/s), every "
          f"pulled value exact [{smi}] [host CPU {cpu_model()}]")
    row.update(snapshot_s=snap_s, restore_s=restore_s, snapshot_mb=mb)
    return [row]


SCALE_KEYS = 32  # the storm's keys, spread over the key space
SCALE_VAL_LEN = 8192  # 32 KiB of f32 per key: 1 MiB per push
SCALE_WINDOW_S = 4.0  # the base window; the migration window is 2x + 2 s


def drive_elastic_scale(ps, ring, Environment, smi: str):
    """``elastic-scale``: JAX's ``elastic_scale_bench(quick=False)``
    (``benchmark.py:1393-1508``) with the card's kernel on the worker.
    1 scheduler + 2 servers (tcp, the native core at its default) + 1
    worker (``ici_tcp``, ``DeviceGroup(8)`` on cuda:0) in this process,
    ``PS_ELASTIC=1``, ``PS_REQUEST_TIMEOUT=3``, ``PS_REQUEST_RETRIES=8``.
    A storm of 1 MiB pushes (32 keys spread over the key space, 8,192
    f32 each) runs throughout; priority 1-key pulls are sampled every
    2 ms over a 4 s base window, then over the migration window, in
    which two servers join (2 -> 4), 2 s pass, and both decommission
    (4 -> 2).  The registered 40 x 1 MB bucket goes through K4 from
    device grads at epoch 0, after both joins and after both departures,
    each time against the float64 sum: membership changes never touch
    the data plane.  Fails unless the final store is exact against
    completed pushes x payload, no storm op failed, the cluster ends at
    epoch 6 with ranks [0, 1] and the joiners' stores are empty."""
    import torch

    from pslite_tpu_torch.utils.network import get_available_port

    base = {"DMLC_NUM_WORKER": "1", "DMLC_NUM_SERVER": "2",
            "DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_NODE_HOST": "127.0.0.1",
            "DMLC_PS_ROOT_PORT": str(get_available_port()),
            "PS_VAN_TYPE": "tcp", "PS_ICI_IMPL": "pallas",
            "PS_ELASTIC": "1", "PS_REQUEST_TIMEOUT": "3.0",
            "PS_REQUEST_RETRIES": "8", **IN_PROCESS}
    nodes = [ps.Postoffice("scheduler", env=Environment(base))]
    nodes += [ps.Postoffice("server", env=Environment(base))
              for _ in range(2)]
    wpo = ps.Postoffice("worker", env=Environment(
        dict(base, PS_VAN_TYPE="ici_tcp")))
    wpo.van.set_mesh(ps.DeviceGroup(N))
    nodes.append(wpo)
    run_threads([po.start for po in nodes], "elastic-scale start")
    apps, joiners = [], []
    stop = threading.Event()
    storm_t = None
    try:
        for po in nodes[1:3]:
            srv = ps.KVServer(0, postoffice=po)
            srv.set_request_handle(ps.KVServerDefaultHandle())
            apps.append(srv)
        w = ps.KVWorker(0, 0, postoffice=wpo)
        apps.append(w)
        bucket = np.arange(KEYS, dtype=np.uint64) + 7  # apart from the storm
        w.register_dense("grads", bucket, VAL_LEN)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
        s64 = np.zeros(P)
        mag = np.zeros(P)
        bucket_out = np.zeros(P, np.float32)
        worst = [0.0]

        def through_k4(k: int, when: str) -> None:
            g = torch.randn((N, P), device="cuda", generator=gen)
            w.wait(w.push_pull(bucket, g, bucket_out))
            gh = g.double().cpu().numpy()
            s64[:] += gh.sum(0)
            mag[:] += np.abs(gh).sum(0)
            err = np.abs(bucket_out - s64)
            worst[0] = max(worst[0], float(err.max()))
            if not np.all(err <= 1e-6 + (k + 1) * (N + 1) * 2.0 ** -24 * mag):
                raise AssertionError(f"elastic-scale: the bucket {when} off "
                                     f"float64 by {float(err.max())}")

        through_k4(0, "at epoch 0")
        span = (1 << 64) // SCALE_KEYS
        keys = (np.arange(SCALE_KEYS, dtype=np.uint64) * np.uint64(span)
                + np.uint64(3))
        vals = (np.arange(SCALE_KEYS * SCALE_VAL_LEN, dtype=np.float32) % 97
                + 1.0)
        hot_key, hot_out = keys[:1], np.zeros(SCALE_VAL_LEN, np.float32)
        pushes, errors = [0], []

        def storm():
            while not stop.is_set():
                try:
                    w.wait(w.push(keys, vals))
                    pushes[0] += 1
                except Exception as exc:  # noqa: BLE001 - checked below
                    errors.append(repr(exc))
                    return

        def sample(lats, dur_s):
            end = time.perf_counter() + dur_s
            while time.perf_counter() < end:
                t0 = time.perf_counter()
                w.wait(w.pull(hot_key, hot_out, priority=1))
                lats.append(time.perf_counter() - t0)
                time.sleep(0.002)

        w.wait(w.push(keys, vals))
        pushes[0] += 1
        storm_t = threading.Thread(target=storm, name="elastic-storm",
                                   daemon=True)
        storm_t.start()
        base_lats, mig_lats = [], []
        sample(base_lats, SCALE_WINDOW_S)
        sampler = threading.Thread(
            target=sample, name="elastic-sampler",
            args=(mig_lats, SCALE_WINDOW_S * 2 + 2.0), daemon=True)
        t_mig = time.perf_counter()
        sampler.start()
        moved = {}
        for j in range(2):
            po = ps.Postoffice("server", env=Environment(base))
            po.start(0)
            t_admit = time.perf_counter()
            srv = ps.KVServer(0, postoffice=po)
            srv.set_request_handle(ps.KVServerDefaultHandle())
            joiners.append((po, srv))
            if j == 0:
                # The first join's handoff: admission to the import.
                end = time.monotonic() + 60
                while (srv.stats["migrated_keys_in"] == 0
                       and time.monotonic() < end):
                    time.sleep(0.001)
                moved = {"s": time.perf_counter() - t_admit,
                         "mb": srv.stats["migrated_keys_in"] * SCALE_VAL_LEN
                         * 4 / 1e6}
        wait_epoch(wpo, 2)
        through_k4(1, "after both joins")
        time.sleep(SCALE_WINDOW_S / 2)
        for _po, srv in joiners:
            srv.decommission(timeout_s=60)
        rt = wait_epoch(wpo, 6)
        change_s = time.perf_counter() - t_mig
        through_k4(2, "after both departures")
        sampler.join(SCALE_WINDOW_S * 4 + 20)
        mig_wall = time.perf_counter() - t_mig
        stop.set()
        storm_t.join(30)
        if storm_t.is_alive() or sampler.is_alive():
            raise AssertionError("elastic-scale: the storm or the sampler "
                                 "wedged")
        n = pushes[0]
        out = np.zeros_like(vals)
        w.wait(w.pull(keys, out))
        k4 = ring.launches["ring_push_pull[float32]"]
        problems = []
        if errors:
            problems.append(f"storm errors {errors[:3]}")
        if not np.array_equal(out, vals * n):
            problems.append(f"store off completed pushes x payload in "
                            f"{int((out != vals * n).sum())} values")
        if rt.epoch != 6 or sorted(rt.active) != [0, 1]:
            problems.append(f"epoch {rt.epoch}, active {list(rt.active)}")
        if any(len(srv._handle.store) for _po, srv in joiners):
            problems.append("a joiner's store is not empty")
        if k4 != 3:
            problems.append(f"K4 launched {k4} times for 3 push_pulls")
        if problems:
            raise AssertionError("elastic-scale: " + "; ".join(problems))
        b50, b99 = pctl_ms(base_lats)
        m50, m99 = pctl_ms(mig_lats)
        ratio = m99 / b99 if b99 > 0 else float("nan")
        bounces = w.stats["wrong_owner_bounces"]
        print(f"elastic-scale (1 scheduler + 2 tcp servers + 1 ici_tcp "
              f"worker on {N} ranks of cuda:0 in this process; 2 -> 4 -> 2 "
              f"servers mid storm): base p50 {b50:.3f} / p99 {b99:.3f} ms "
              f"({len(base_lats)} priority pulls), migration p50 "
              f"{m50:.3f} / p99 {m99:.3f} ms ({len(mig_lats)} pulls), p99 "
              f"ratio {ratio:.2f} (JAX's bar <= 3, a yardstick); 2 -> 4 -> "
              f"2 {change_s:.3f} s (first join to epoch 6 at the worker), "
              f"migration window wall {mig_wall:.3f} s (JAX's "
              f"scale_2_4_2_wall_s); first join handed "
              f"{moved['mb']:.3f} MB over in {moved['s'] * 1e3:.2f} ms "
              f"(admission to import: at this size a round trip plus "
              f"admission, not a transfer rate); {n} pushes of {vals.nbytes / 2 ** 20:.0f} MiB, "
              f"store exact; {bounces} wrong-owner bounces; epoch "
              f"{rt.epoch}, active {list(rt.active)}; K4 "
              f"ring_push_pull[float32] launches {k4} (epochs 0, 2, 6), "
              f"bucket max |err| vs float64 {worst[0]:.3g} [{smi}] "
              f"[host CPU {cpu_model()}]")
        return [{"config": "elastic-scale", "ops": n + len(base_lats)
                 + len(mig_lats) + 3, "max_abs_err_vs_f64": worst[0],
                 "base_p99_ms": b99, "migration_p99_ms": m99,
                 "p99_ratio": ratio, "change_s": change_s,
                 "wall_s": mig_wall,
                 "first_join_handoff_ms": moved["s"] * 1e3}]
    finally:
        stop.set()
        if storm_t is not None:
            storm_t.join(30)
        for a in apps + [srv for _po, srv in joiners]:
            try:
                a.stop()
            except Exception as exc:  # noqa: BLE001 - stop the rest
                print(f"elastic-scale: stop failed: {exc!r}",
                      file=sys.stderr)
        for po in nodes + [po for po, _srv in joiners]:
            try:
                po.van.stop()
            except Exception as exc:  # noqa: BLE001 - stop the rest
                print(f"elastic-scale: van stop failed: {exc!r}",
                      file=sys.stderr)


MIGRATE_KEYS = 2 * MSG_KEYS_PER_SERVER  # config 2's store: 80 x 1,024,000 B


def drive_elastic_migrate(ps, Environment, smi: str):
    """``elastic-scale``'s second leg: a range migration at a realistic
    size, where ``elastic-scale``'s first join moves 0.26 MB.  BASELINE
    config 2's store (80 keys x 1,024,000 B = 81.92 MB, spread over the
    key space) on 1 server, 1 scheduler + 1 worker, all over tcp (native
    core at its default) in this process, ``PS_ELASTIC=1``, no traffic
    during the moves.  A second server joins: the range splits at
    ``MAX_KEY // 2`` and the donor streams the keys above the cut (39
    keys, 39.94 MB: key 40 lies 4 below it) to the joiner, timed from
    admission to the import; then the joiner decommissions, timed over
    ``decommission()``, and the keys stream back.  MB/s = the bytes each
    move carried over its time.  Fails unless every pull after each
    move is bit-exact, each move carried every key of the joiner's
    range, and the cluster ends at epoch 3 with rank [0] alone."""
    from pslite_tpu_torch.range import find_range
    from pslite_tpu_torch.utils.network import get_available_port

    base = {"DMLC_NUM_WORKER": "1", "DMLC_NUM_SERVER": "1",
            "DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_NODE_HOST": "127.0.0.1",
            "DMLC_PS_ROOT_PORT": str(get_available_port()),
            "PS_VAN_TYPE": "tcp", "PS_ELASTIC": "1", **IN_PROCESS}
    nodes = [ps.Postoffice(role, env=Environment(base))
             for role in ("scheduler", "server", "worker")]
    run_threads([po.start for po in nodes], "elastic-migrate start")
    apps, joiner = [], None
    try:
        srv0 = ps.KVServer(0, postoffice=nodes[1])
        srv0.set_request_handle(ps.KVServerDefaultHandle())
        apps.append(srv0)
        w = ps.KVWorker(0, 0, postoffice=nodes[2])
        apps.append(w)
        span = (1 << 64) // MIGRATE_KEYS
        keys = (np.arange(MIGRATE_KEYS, dtype=np.uint64) * np.uint64(span)
                + np.uint64(3))
        vals = np.random.default_rng(SEED + 31).integers(
            -8, 8, size=MIGRATE_KEYS * VAL_LEN).astype(np.float32)
        store_mb = vals.nbytes / 1e6
        w.wait(w.push(keys, vals))
        problems = []

        def check(when: str) -> None:
            got = np.zeros_like(vals)
            w.wait(w.pull(keys, got))
            if not np.array_equal(got, vals):
                problems.append(f"{int((got != vals).sum())} values off "
                                f"{when}")

        check("before the join")
        po = ps.Postoffice("server", env=Environment(base))
        po.start(0)
        t_admit = time.perf_counter()
        srv = ps.KVServer(0, postoffice=po)
        srv.set_request_handle(ps.KVServerDefaultHandle())
        joiner = (po, srv)
        end = time.monotonic() + 60
        while (srv.stats["migrated_keys_in"] == 0
               and time.monotonic() < end):
            time.sleep(0.0005)
        join_s = time.perf_counter() - t_admit
        n_in = srv.stats["migrated_keys_in"]
        rt1 = wait_epoch(nodes[2], 1)
        want = sum(find_range(keys, e.begin, e.end).size()
                   for e in rt1.entries if e.owner == 1)
        check("after the join")
        t_leave = time.perf_counter()
        srv.decommission(timeout_s=60)
        leave_s = time.perf_counter() - t_leave
        n_out = srv.stats["migrated_keys_out"]
        rt = wait_epoch(nodes[2], 3)
        check("after the decommission")
        if not 0 < want == n_in == n_out:
            problems.append(f"moved {n_in} keys in, {n_out} back; want "
                            f"{want} each")
        if rt.epoch != 3 or list(rt.active) != [0]:
            problems.append(f"epoch {rt.epoch}, active {list(rt.active)}")
        if len(srv._handle.store):
            problems.append("the joiner's store is not empty")
        if problems:
            raise AssertionError("elastic-migrate: " + "; ".join(problems))
        join_mb = n_in * MB_LEN / 1e6
        leave_mb = n_out * MB_LEN / 1e6
        print(f"elastic-migrate (BASELINE config 2's store, {MIGRATE_KEYS} "
              f"keys x {MB_LEN} B = {store_mb:.2f} MB on 1 tcp server, "
              f"1 + 1 -> 2 -> 1 servers in this process, no traffic "
              f"during the moves): the join moved {join_mb:.2f} MB in "
              f"{join_s:.4f} s ({join_mb / join_s:.1f} MB/s, admission to "
              f"import), the decommission {leave_mb:.2f} MB back in "
              f"{leave_s:.4f} s ({leave_mb / leave_s:.1f} MB/s, the whole "
              f"call); every pull exact; epoch {rt.epoch}, active "
              f"{list(rt.active)} [{smi}] [host CPU {cpu_model()}]")
        return [{"config": "elastic-migrate", "ops": 4 + 2,
                 "join_mb": join_mb, "join_s": join_s,
                 "join_mb_s": join_mb / join_s, "leave_mb": leave_mb,
                 "leave_s": leave_s, "leave_mb_s": leave_mb / leave_s}]
    finally:
        for a in apps + ([joiner[1]] if joiner else []):
            try:
                a.stop()
            except Exception as exc:  # noqa: BLE001 - stop the rest
                print(f"elastic-migrate: stop failed: {exc!r}",
                      file=sys.stderr)
        for po in nodes + ([joiner[0]] if joiner else []):
            try:
                po.van.stop()
            except Exception as exc:  # noqa: BLE001 - stop the rest
                print(f"elastic-migrate: van stop failed: {exc!r}",
                      file=sys.stderr)


# -- observability: telemetry's cost, traced rounds, the profiled kernel
#    path, the autopilot ------------------------------------------------------

OBS_LEGS = (("off", {"PS_TELEMETRY": "0"}),
            ("metrics", {"PS_METRICS_INTERVAL": "1"}),
            ("tail", {"PS_TRACE_TAIL": "slow:p95,errors,floor:0.001"}))
OBS_ROUNDS = 2      # timed rounds per window; TIER_ROUNDS windows per leg
OBS_PULL_S = 0.5    # the tail leg's scheduler pulls traces this often
OBS_TAIL_EXTRA = 2  # untimed windows the tail leg runs after the others
AP_KEYS, AP_VAL_LEN, AP_STORM_S = 32, 4096, 14.0  # autopilot_bench(False)
AP_ENV = {"PS_ELASTIC": "1", "PS_AUTOPILOT": "1",
          "PS_METRICS_INTERVAL": "0.25", "PS_AUTOPILOT_SUSTAIN": "2",
          "PS_AUTOPILOT_SKEW_RATIO": "1.5",
          "PS_AUTOPILOT_SKEW_COOLDOWN_S": "1.0",
          "PS_AUTOPILOT_MIN_RATE": "5.0", "PS_AUTOPILOT_MAX_ACTIONS": "8",
          "PS_AUTOPILOT_TRACE_EVERY": "0", "PS_REQUEST_TIMEOUT": "3.0",
          "PS_REQUEST_RETRIES": "8"}  # benchmark.py:1549-1565
JOIN_KEYS = 512     # the hinted join's Zipf load: distinct keys pushed


def wire_digest(m: dict) -> dict:
    """A node's wire families from one snapshot, both planes summed
    (``ClusterHistory.wire_summary``'s formulas over the cumulative
    counters)."""
    c = m.get("counters", {})

    def g(name):
        return c.get(name, 0)

    def both(suffix):
        return g("wire." + suffix) + g("wire.native." + suffix)

    ops = both("tx.ops") + g("wire.rx.ops")
    syscalls = (both("tx.syscalls") + both("rx.syscalls"))
    frames = both("tx.frames") + g("wire.rx.frames") + g(
        "wire.native.rx.frames")
    zc = both("tx.bytes_zc") + g("wire.rx.bytes_zc") + g(
        "wire.native.rx.bytes_zc")
    copy = (g("wire.tx.bytes_copy") + g("wire.rx.bytes_copy")
            + g("wire.native.rx.bytes_copy"))
    res = m.get("histograms", {}).get("wire.lane_residency_s") or {}
    return {"ops": ops, "native_tx_ops": g("wire.native.tx.ops"),
            "syscalls_per_op": syscalls / ops if ops else None,
            "frames_per_op": frames / ops if ops else None,
            "zc_share": zc / (zc + copy) if zc + copy else None,
            "residency_p99_s": res.get("p99") if res.get("count") else None,
            "residency_count": res.get("count", 0)}


def observe_cluster(po, spec: dict) -> dict:
    """The scheduler of an observed process cluster: with
    ``spec["traces"]``, a sample of its ClusterHistory (a METRICS_PULL)
    and a TRACE_PULL (with the history's tail hints) every OBS_PULL_S
    while the workers run; at the end (the parent closed stdin; the
    other nodes wait in finalize's barrier, their pumps up) one last
    METRICS_PULL, which must reach every node, and TRACE_PULL.  Returns
    each node's role and wire digest and the kept traces' critical-path
    breakdowns."""
    stop = threading.Event()
    errors = []

    def loop():
        po.start_history()
        while not stop.wait(OBS_PULL_S):
            try:
                po.history.sample_once(timeout_s=5.0)
                po.collect_cluster_traces(timeout_s=5.0)
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append(repr(exc))

    t = None
    if spec.get("traces"):
        t = threading.Thread(target=loop, name="observe", daemon=True)
        t.start()
    sys.stdin.read()
    stop.set()
    if t is not None:
        t.join(30)
    if errors:
        raise AssertionError(f"observer pulls failed: {errors[:3]}")
    t0 = time.perf_counter()
    snaps = po.collect_cluster_metrics(timeout_s=10.0)
    pull_ms = (time.perf_counter() - t0) * 1e3
    want = 1 + po.num_worker_instances + po.num_server_instances
    if len(snaps) != want or any("error" in s for s in snaps.values()):
        raise AssertionError(f"METRICS_PULL reached {sorted(snaps)} of "
                             f"{want} nodes")
    out = {"pull_ms": pull_ms, "nodes": {
        str(nid): {"role": s["role"], "counters": len(
            s["metrics"].get("counters", {})),
            "wire": wire_digest(s["metrics"])}
        for nid, s in snaps.items()}}
    if spec.get("traces"):
        coll = po.collect_cluster_traces(timeout_s=10.0)
        out["breakdowns"] = coll.breakdowns()
        out["lost_spans"] = coll.lost_spans
    return out


def _obs_cost(smi: str, before_windows=None):
    """(a) and (b): BASELINE config 2 over tcp (1 + 2 + 2 processes,
    native core) under each of OBS_LEGS, all three clusters up at once,
    TIER_ROUNDS windows of OBS_ROUNDS rounds alternating; every pull
    checked exactly.  Each scheduler observes (``observe_cluster``)."""
    sizes = [[MSG_KEYS_PER_SERVER, MB_LEN]]
    spec = {"mode": "push_barrier_pull", "sizes": sizes,
            "warmup": MSG_WARMUP, "rounds": OBS_ROUNDS,
            "windows": TIER_ROUNDS}
    clusters = {}
    try:
        for label, env in OBS_LEGS:
            tail = label == "tail"
            clusters[label] = Cluster("tcp", 2, 2, dict(
                spec, observe={"traces": tail},
                windows=TIER_ROUNDS + (OBS_TAIL_EXTRA if tail else 0)),
                extra=env)
        for c in clusters.values():
            c.ready()
        if before_windows is not None:
            before_windows()
        # The tail leg's slow threshold comes from its scheduler's hints
        # (windowed quantiles of the warm-up's latencies, fresh 30 s):
        # let a pull deliver them before the first window.
        time.sleep(3 * OBS_PULL_S)
        wins = {label: [] for label in clusters}
        for _ in range(TIER_ROUNDS):
            for label, c in clusters.items():
                wins[label].append(c.window())
        # More rounds of the tail leg alone, untimed, for the traces: a
        # request is kept when slower than the hinted p95, so few of the
        # timed windows' are.
        for _ in range(OBS_TAIL_EXTRA):
            clusters["tail"].window()
        # The tail leg's observer pulls the last windows' traces.
        time.sleep(OBS_PULL_S + 0.5)
        finals = {label: c.finish(("worker", "scheduler"))
                  for label, c in clusters.items()}
    finally:
        for c in clusters.values():
            c.kill()
    key = str(MB_LEN)
    ms = {label: [sum(w["sizes"][key]["ms_per_round"] for w in win)
                  / len(win) for win in wl] for label, wl in wins.items()}
    rows = []
    sched = {label: next(r for r in reps if r["role"] == "scheduler")
             for label, reps in finals.items()}
    for label, reps in finals.items():
        workers = [r for r in reps if r["role"] == "worker"]
        if [r["native"] for r in workers] != [True, True]:
            raise AssertionError(f"observability {label}: a worker ran the "
                                 f"Python plane")
        s = rounds_summary(workers, MB_LEN)
        row = {"config": f"observability {label}", "ops": s["checked"],
               "max_abs_err_vs_f64": s["max_err"],
               "ms_per_round": float(np.median(ms[label]))}
        ratio_row(row, "over_off_ms", ms[label], ms["off"])
        rows.append(row)
        print(f"observability [{label}: "
              f"{dict(OBS_LEGS)[label]}] (1 + 2 + 2 processes, tcp, "
              f"native; {s['keys']} keys x {MB_LEN} B per worker and round; "
              f"{TIER_ROUNDS} windows of {OBS_ROUNDS} rounds alternating "
              f"with the other legs'): ms/round {spread(ms[label])}; over "
              f"the telemetry-off leg by window: median "
              f"{row['over_off_ms']:.3f}, least {row['over_off_ms_min']:.3f},"
              f" most {row['over_off_ms_max']:.3f}; {s['checked']} rounds "
              f"checked exactly; the scheduler's last METRICS_PULL reached "
              f"{len(sched[label]['nodes'])} nodes in "
              f"{sched[label]['pull_ms']:.1f} ms [{smi}] [host CPU "
              f"{cpu_model()}]")
    off = sched["off"]["nodes"]
    if any(n["counters"] for n in off.values()):
        raise AssertionError("PS_TELEMETRY=0 exported counters")
    for label in ("metrics", "tail"):
        for nid, n in sorted(sched[label]["nodes"].items(), key=lambda kv:
                             int(kv[0])):
            if n["role"] == "scheduler":
                continue
            w = n["wire"]
            if not w["ops"] or not w["native_tx_ops"]:
                raise AssertionError(f"observability {label}: node {nid} "
                                     f"exported no wire.native ops")
            res = (f"{w['residency_p99_s'] * 1e6:.1f} us over "
                   f"{w['residency_count']} lane dispatches"
                   if w["residency_p99_s"] is not None else
                   "no Python-lane dispatch (every data frame rode the "
                   "native lanes)")
            print(f"observability [{label}] wire, {n['role']} {nid} (one "
                  f"METRICS_PULL, wire.native.* synced): "
                  f"{w['ops']} ops, syscalls/op {w['syscalls_per_op']:.3f},"
                  f" frames/op {w['frames_per_op']:.3f}, zero-copy share "
                  f"{w['zc_share']:.4f}, lane residency p99 {res}")
    bds = sched["tail"]["breakdowns"]
    s_keys = 2 * MSG_KEYS_PER_SERVER
    if not bds:
        raise AssertionError("observability tail: no trace was kept")
    from pslite_tpu_torch.telemetry.critical_path import STAGES

    for path in ("push", "pull"):
        sel = [b for b in bds if bool(b["pull"]) == (path == "pull")]
        if not sel:
            continue
        med = {st: float(np.median([b["stages"][st] for b in sel]))
               for st in STAGES}
        wall = float(np.median([b["wall_us"] for b in sel]))
        rows.append({"config": f"observability 1 MB {path} stages",
                     "ops": len(sel), "wall_us": wall,
                     **{f"{st}_us": v for st, v in med.items()}})
        keeps = sorted({str(b["keep"]) for b in sel})
        print(f"observability [tail] where a 1 MB round's {path} goes "
              f"({s_keys} keys x {MB_LEN} B per worker over tcp; median "
              f"over {len(sel)} tail-kept requests of its "
              f"{TIER_ROUNDS + OBS_TAIL_EXTRA} windows, keep "
              f"{', '.join(keeps)}; critical path, us): wall {wall:.0f}; "
              + ", ".join(f"{st} {v:.0f}" for st, v in med.items())
              + f" [{smi}]")
    return rows


def _obs_kernel_start() -> Cluster:
    """(c): the ``ici_tcp`` worker (8 ranks on cuda:0) under
    ``ENABLE_PROFILING=1`` pushes the 40 x 1 MB bucket through K4 for 5
    steps, the last 2 inside ``device_trace``; its scheduler observes.
    Started here, read by ``_obs_kernel``."""
    tmp = tempfile.mkdtemp(prefix="smoke-obs")
    spec = {"ranks": N, "steps": 5, "trace_steps": 2,
            "trace_dir": os.path.join(tmp, "trace"), "profile_dir": tmp,
            "observe": {}}
    return Cluster("ici_tcp", 1, 1, spec, extra={"PS_ICI_IMPL": "pallas"})


def _obs_kernel(cluster: Cluster, kernel_rows, smi: str):
    """(c)'s checks: the worker's profile log holds one ``push_pull``
    engine event of 2 x 40.96 MB per K4 launch, its trace names
    ``ring_kernel``, and the scheduler's METRICS_PULL returned the
    worker's snapshot."""
    try:
        reps = cluster.finish(("worker", "scheduler"))
    finally:
        cluster.kill()
    rep = next(r for r in reps if r["role"] == "worker")
    sched = next(r for r in reps if r["role"] == "scheduler")
    k4 = rep["launches"]["ring_push_pull[float32]"]
    pp = [r for r in rep["profile_engine"] if r[1] == "push_pull_engine"]
    want_bytes = str(2 * P * 4)
    if (k4 != rep["steps"] or len(pp) != k4
            or any(r[0] != "grads" or r[2] != want_bytes for r in pp)):
        raise AssertionError(f"observability kernel path: K4 launched {k4} "
                             f"times, the profile holds {pp}")
    roles = sorted(n["role"] for n in sched["nodes"].values())
    if roles != ["scheduler", "server", "worker"]:
        raise AssertionError(f"METRICS_PULL returned {roles}")
    k4_row = next(r for r in kernel_rows
                  if r["name"] == "ring_push_pull[float32]")
    print(f"observability [kernel path] (ici_tcp worker, {N} ranks on "
          f"cuda:0, ENABLE_PROFILING=1): K4 launches {k4}, profile "
          f"push_pull engine events {len(pp)} of {want_bytes} B each "
          f"(dispatch us {', '.join(r[3] for r in pp)}); device_trace of "
          f"the last 2 steps: {rep['ring_kernel_calls']} calls of "
          f"{', '.join(rep['ring_kernel_names'])}, "
          f"{rep['ring_kernel_us'] / 1e3:.4f} ms each (the kernels phase: "
          f"{k4_row['ms']:.4f} ms host-free); the scheduler's METRICS_PULL "
          f"returned {', '.join(roles)} [{smi}]")
    return ([{"config": "observability kernel path", "ops": k4,
              "k4_launches": k4, "profile_events": len(pp),
              "ring_kernel_ms_traced": rep["ring_kernel_us"] / 1e3,
              "ring_kernel_ms_kernels_phase": k4_row["ms"]}],
            rep["launches"])


def _obs_autopilot(ps, Environment, smi: str):
    """(d): JAX's ``autopilot_bench(quick=False)`` (benchmark.py:1530):
    1 scheduler + 2 elastic servers + 1 worker over tcp in this process,
    32 keys of 4,096 f32, a 14 s storm whose hot set (a quarter of the
    keys, all on server 0) drifts at half time; the autopilot (act mode)
    must rebalance with no operator action and every store stay exact.
    Then one elastic join under a Zipf load with the scheduler's hint:
    the cut must be the key ``with_join`` computes from that hint."""
    from pslite_tpu_torch.cluster.autopilot import _server_rates
    from pslite_tpu_torch.utils.network import get_available_port

    def cluster(env, servers=2):
        base = {"DMLC_NUM_WORKER": "1", "DMLC_NUM_SERVER": str(servers),
                "DMLC_PS_ROOT_URI": "127.0.0.1",
                "DMLC_NODE_HOST": "127.0.0.1",
                "DMLC_PS_ROOT_PORT": str(get_available_port()),
                "PS_VAN_TYPE": "tcp", **IN_PROCESS, **env}
        nodes = [ps.Postoffice(r, env=Environment(base)) for r in
                 ["scheduler"] + ["server"] * servers + ["worker"]]
        run_threads([po.start for po in nodes], "observability start")
        apps = []
        for po in nodes[1:-1]:
            srv = ps.KVServer(0, postoffice=po)
            srv.set_request_handle(ps.KVServerDefaultHandle())
            apps.append(srv)
        w = ps.KVWorker(0, 0, postoffice=nodes[-1])
        apps.append(w)
        return nodes, apps, w, base

    def close(nodes, apps):
        for a in apps:
            a.stop()
        for po in nodes:
            po.van.stop()

    def skew(rates):
        if len(rates) < 2:
            return None
        return max(rates.values()) / max(sum(rates.values()) / len(rates),
                                         1e-9)

    nodes, apps, w, _base = cluster(AP_ENV)
    try:
        sched = nodes[0]
        span = (1 << 64) // AP_KEYS
        keys = (np.arange(AP_KEYS, dtype=np.uint64) * np.uint64(span)
                + np.uint64(3))
        vals = np.arange(AP_KEYS * AP_VAL_LEN, dtype=np.float32) % 97 + 1.0
        hot_a, hot_b = keys[:AP_KEYS // 4], keys[AP_KEYS // 4:AP_KEYS // 2]
        hot_out = np.zeros(AP_VAL_LEN * len(hot_a), np.float32)
        pushes, stop, errors, first = [0], [False], [], []
        epoch_at = []

        def storm():
            t0 = time.perf_counter()
            while not stop[0]:
                try:
                    w.wait(w.push(keys, vals))
                    pushes[0] += 1
                    hot = (hot_a if time.perf_counter() - t0
                           < AP_STORM_S / 2 else hot_b)
                    for _ in range(8):
                        w.wait(w.pull(hot, hot_out))
                except Exception as exc:  # noqa: BLE001 - reported below
                    errors.append(repr(exc))
                    return

        w.wait(w.push(keys, vals))
        pushes[0] += 1
        t = threading.Thread(target=storm, daemon=True)
        t_storm = time.perf_counter()
        t.start()
        while time.perf_counter() - t_storm < AP_STORM_S:
            if not first:
                s = skew(_server_rates(sched.history))
                if s is not None:
                    first.append(s)
            rt = sched.current_routing()
            if not epoch_at and rt is not None and rt.epoch > 0:
                epoch_at.append(time.perf_counter() - t_storm)
            time.sleep(0.05)
        stop[0] = True
        t.join(timeout=60)
        last = skew(_server_rates(sched.history))
        out = np.zeros_like(vals)
        w.wait(w.pull(keys, out))
        exact = bool(np.array_equal(out, vals * pushes[0])) and not errors
        counts = sched.history.autopilot.counts()
        rt = sched.current_routing()
        acted = [d for d in sched.history.autopilot.decision_log
                 if d.outcome == "acted"]
    finally:
        close(nodes, apps)
    if not exact or not epoch_at or not acted:
        raise AssertionError(f"observability autopilot: exact {exact}, "
                             f"errors {errors[:3]}, epochs {epoch_at}, "
                             f"decisions {counts}")
    print(f"observability [autopilot] (autopilot_bench(quick=False): 1 + 2 "
          f"elastic tcp servers + 1 worker in this process, {AP_KEYS} keys "
          f"x {AP_VAL_LEN} f32, {AP_STORM_S:.0f} s drifting hot-set "
          f"storm): load_skew_ratio first window {first[0]:.2f}, last "
          f"window {last:.2f}; operator_actions 0; first rebalance epoch "
          f"{epoch_at[0]:.2f} s after the storm began; decisions "
          f"{counts}; final epoch {rt.epoch}; {pushes[0]} pushes, every "
          f"store exact [{smi}] [host CPU {cpu_model()}]")
    rows = [{"config": "observability autopilot", "ops": pushes[0],
             "load_skew_first": first[0], "load_skew_last": last,
             "operator_actions": 0, "rebalance_s": epoch_at[0],
             "decisions_acted": counts.get("acted", 0)}]

    nodes, apps, w, base = cluster({"PS_ELASTIC": "1"})
    joiner = None
    try:
        sched = nodes[0]
        rng = np.random.default_rng(SEED + 41)
        hot = np.unique((rng.zipf(1.2, 20 * JOIN_KEYS) * 104729)
                        % (1 << 62)).astype(np.uint64)[:JOIN_KEYS]
        for _ in range(3):
            w.wait(w.push(hot, np.ones(len(hot) * 8, np.float32)))
        for k in range(4):
            sub = hot[: 16 << k]
            w.wait(w.push(sub, np.ones(len(sub) * 8, np.float32)))
        sched.collect_cluster_metrics(timeout_s=10.0)
        hint = sched.hot_key_hint()
        want = sched.routing_table().with_join(2, hot=hint)
        po = ps.Postoffice("server", env=Environment(base))
        po.start(0)
        srv = ps.KVServer(0, postoffice=po)
        srv.set_request_handle(ps.KVServerDefaultHandle())
        joiner = (po, srv)
        got = wait_epoch(sched, want.epoch)
        cut = next(e.begin for e in got.entries if e.owner == 2)
        want_cut = next(e.begin for e in want.entries if e.owner == 2)
        check = np.zeros(len(hot) * 8, np.float32)
        w.wait(w.pull(hot, check))
        wsum = np.ones(len(hot) * 8, np.float32) * 3
        for k in range(4):
            wsum[: (16 << k) * 8] += 1
        if cut != want_cut or got.to_json() != want.to_json() \
                or not np.array_equal(check, wsum):
            raise AssertionError(f"observability join: cut {cut}, "
                                 f"with_join {want_cut}")
    finally:
        close(nodes + ([joiner[0]] if joiner else []),
              apps + ([joiner[1]] if joiner else []))
    print(f"observability [join with the hint] (1 + 2 -> 3 elastic tcp "
          f"servers in this process, {len(hot)} Zipf(1.2) keys; the hint: "
          f"{len(hint)} hot keys from one METRICS_PULL): cut key {cut}, "
          f"with_join(hot=hint) {want_cut}; every pull exact [{smi}]")
    rows.append({"config": "observability join cut", "ops": 8,
                 "cut_key": float(cut), "hint_keys": len(hint)})
    return rows


def drive_observability(ps, Environment, kernel_rows, smi: str):
    """The observability phase: (c)'s processes start with (a)'s
    clusters, and its worker's steps end before (a)'s first timed window
    (``STEPS_DONE``); (a)-(b) ``_obs_cost``; (d) ``_obs_autopilot``
    alone in this process; then (c)'s checks, ``_obs_kernel`` (its K4
    launches counted in the worker process and returned)."""
    t = time.perf_counter()
    kernel = _obs_kernel_start()
    try:
        rows = _obs_cost(smi, before_windows=lambda: kernel._lines(
            "STEPS_DONE", 1))
        t_cost = time.perf_counter() - t
        rows += _obs_autopilot(ps, Environment, smi)
        t_ap = time.perf_counter() - t - t_cost
    except BaseException:
        kernel.kill()
        raise
    krows, child = _obs_kernel(kernel, kernel_rows, smi)
    print(f"observability seconds: the cost legs with the kernel path "
          f"beside their start {t_cost:.1f}, the autopilot and the join "
          f"{t_ap:.1f}, the kernel path's checks "
          f"{time.perf_counter() - t - t_cost - t_ap:.1f}")
    return rows + krows, child


# -- the models phase: the model zoo trains through the PS ---------------------

MODEL_STEPS = 20   # examples/train_flagship.py's and train_pipeline.py's
DLRM_STEPS = 15    # tests/test_model_zoo.py's DLRM runs
KV_STEPS = 30      # the kv_train_loop leg, per codec
KV_LR = 0.1        # tests/test_model_train.py's guard: at the loop's
                   # default 0.5 the loss swings step to step, and the
                   # codecs' runs part by more than any codec error
KV_GAP = 0.02      # the guard's bar: fp8_e4m3 + EF within 2 % of raw
PROFILED_STEPS = 5


def psformer_flops(cfg, tokens: int, seq: int) -> float:
    """Model FLOPs of one training step of a dense PSFormer config over
    ``tokens`` tokens of ``seq``-long sequences: forward 2 per
    multiply-add of every matmul (qkv, proj, the MLP pair, the unembed,
    and attention's scores and values over the whole sequence, as the
    ring computes every block), backward twice that."""
    D, L, V = cfg.dim, cfg.layers, cfg.vocab
    per_token = (L * 2 * (3 * D * D + D * D + 2 * cfg.mlp_ratio * D * D
                          + 2 * seq * D) + 2 * D * V)
    return 3.0 * per_token * tokens


# The kernel wrappers on the models' and the harness's paths: each one's
# counter, its plain version, the arguments it writes in place (none: it
# returns its result; its result is compared too where it returns a fresh
# tensor) and its bar against the plain version (None: bit-exact, as its
# kernel row holds it).  K4's ``sgd:`` handle may round ``(lr / n) *
# agg`` once (an FMA) on the card where the plain version rounds twice.
HELD_KERNELS = {
    "ring_push": ("ring_push[float32]", "ring_push_reference", (1,), None),
    "ring_push_pull": ("ring_push_pull[float32]", "ring_push_pull_reference",
                       (1,), None),
    "scatter_add": ("sparse_scatter_add", "scatter_add_reference", (0,),
                    None),
    "row_adagrad": ("sparse_row_adagrad", "row_adagrad_reference", (0, 1),
                    (1e-5, 1e-6)),
    "gather_rows": ("sparse_gather_rows", "gather_rows_reference", (),
                    None),
    "reduce_apply": ("reduce_push_pull[float32]", "reduce_apply_reference",
                     (1, 3), None),
}
SGD_BAR = (1e-6, 1e-6)
MODEL_HELD = ("ring_push", "scatter_add", "row_adagrad", "gather_rows")


def _clones(torch, values):
    return [v.clone() if torch.is_tensor(v) else v for v in values]


def _held_module(name: str, ring, sr):
    """The module of a ``HELD_KERNELS`` wrapper."""
    if name.startswith("reduce_"):
        from pslite_tpu_torch.ops import reduce_update
        return reduce_update
    return ring if name.startswith("ring_") else sr


@contextlib.contextmanager
def hold_first_launches(torch, ring, sr, names=MODEL_HELD):
    """While open, record the first call of each wrapper in ``names``
    (of ``HELD_KERNELS``) that the main path makes: its arguments cloned
    before the call, and after it its arguments and its result.  Yields
    the record, ``{wrapper: (before, kwargs, after, result)}``."""
    held, real = {}, {}
    for name in names:
        mod = _held_module(name, ring, sr)
        real[name] = (mod, getattr(mod, name))

        def wrapper(*args, _name=name, **kw):
            fn = real[_name][1]
            if _name in held:
                return fn(*args, **kw)
            before = _clones(torch, args)
            out = fn(*args, **kw)
            held[_name] = (before, kw, _clones(torch, args),
                           out.clone() if torch.is_tensor(out) else None)
            return out

        setattr(mod, name, wrapper)
    try:
        yield held
    finally:
        for name, (mod, fn) in real.items():
            setattr(mod, name, fn)


def check_held(torch, ring, sr, held, label: str) -> dict:
    """Each recorded launch against its plain version on clones of the
    same inputs, on the card; fails on a mismatch.  Returns ``{counter:
    max abs error}``."""
    errs = {}
    for name, (before, kw, after, out) in held.items():
        counter, plain, writes, bar = HELD_KERNELS[name]
        mod = _held_module(name, ring, sr)
        args = _clones(torch, before)
        want = getattr(mod, plain)(*args, **kw)
        pairs = ([(after[i], args[i]) for i in writes
                  if i < len(after) and torch.is_tensor(after[i])]
                 if writes else [(out, want)])
        if name == "ring_push_pull":
            pairs.append((out, want))
        if name.startswith("ring_"):
            handle = before[2] if len(before) > 2 else kw.get("handle", "sum")
            bar = SGD_BAR if str(handle).startswith("sgd") else None
        if bar is None:
            for got, exp in pairs:
                mismatches(got, exp)
        elif not within(pairs, *bar):
            raise AssertionError(
                f"{label}: {counter} is off its plain version by "
                f"{max_err(pairs):.3g} (rtol {bar[0]}, atol {bar[1]})")
        errs[counter] = max_err(pairs)
    return errs


def drive_models(torch, ps, ring, sr, Environment, smi: str):
    """The model zoo through the port's PS on cuda:0, 8 virtual ranks,
    each leg at the repo's own full width; every leg's loss must fall and
    its K4/S1/S2/S3 launches match its steps."""
    from pslite_tpu_torch.models import cnn, dlrm, train, transformer

    # Float32 matmuls and convs in full float32, as XLA runs them (the
    # models' large products are bfloat16 anyway).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    t_phase = time.perf_counter()
    counters = (ring.launches, sr.launches)
    watched = ("ring_push[float32]", "sparse_scatter_add",
               "sparse_row_adagrad", "sparse_gather_rows")
    results = []

    def counts():
        return {k: c[k] for c in counters for k in watched if k in c}

    def check_launches(label, before, want):
        made = {k: v - before[k] for k, v in counts().items()}
        want = {k: want.get(k, 0) for k in watched}
        if made != want:
            raise AssertionError(f"{label}: launches {made}, expected {want}")
        return made

    def leg(label, step, steps, units, unit, expect, after=None):
        """``steps`` calls of ``step() -> loss``: the first untimed (first
        use), its launch of each kernel held against the kernel's plain
        version; the rest timed by CUDA events and the wall; then
        ``after() -> (extra row fields, its launches)``; the launches
        made, against ``expect`` per step plus ``after``'s."""
        before = counts()
        with hold_first_launches(torch, ring, sr) as held:
            losses = [step()]
        errs = check_held(torch, ring, sr, held, label)
        if sorted(errs) != sorted(k for k, v in expect.items() if v):
            raise AssertionError(f"{label}: held {sorted(errs)}, expected "
                                 f"{sorted(expect)}")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        losses += [step() for _ in range(steps - 1)]
        end.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / (steps - 1)
        event = start.elapsed_time(end) / (steps - 1)
        losses = [float(x) for x in losses]
        extra, more = after() if after else ({}, {})
        made = check_launches(label, before, {
            k: expect.get(k, 0) * steps + more.get(k, 0) for k in watched})
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"{label}: the loss did not fall: {losses}")
        row = {"config": label, "ops": steps, "first_loss": losses[0],
               "last_loss": losses[-1], "event_ms_per_step": event,
               "wall_ms_per_step": wall,
               f"{unit}_per_s_wall": units / wall * 1e3,
               **{f"launches_{k}": v for k, v in made.items() if v},
               **{f"max_abs_err_{k}": v for k, v in errs.items()},
               **extra}
        print(f"models {label}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"over {steps} steps; {event:.3f} ms/step (CUDA events), "
              f"{wall:.3f} ms/step wall, {units / wall * 1e3:,.0f} "
              f"{unit}/s wall; launches "
              + (", ".join(f"{k} {v}" for k, v in made.items() if v)
                 or "none") + f" [{smi}]")
        if errs:
            print("    step 1 against the plain versions: "
                  + ", ".join(f"{k} max |err| {v:.3g}"
                              for k, v in errs.items()))
        results.append(row)
        return row

    # PSFormer over dp 4 x sp 2: examples/train_flagship.py's defaults.
    cfg = transformer.ModelConfig()
    batch, seq = 8, 64
    inputs, targets = (torch.as_tensor(a, device=dev)
                       for a in train.toy_batch(cfg, batch, seq))
    group = ps.make_group((4, 2), ("dp", "sp"), device=dev)
    for label, mcfg, strategy in (
            ("psformer-dp4xsp2-ring", cfg, "ring"),
            ("psformer-dp4xsp2-ulysses", cfg, "ulysses"),
            ("psformer-moe-dp4xsp2", transformer.ModelConfig(moe_experts=8),
             "ring")):
        step, store = train.make_ps_train_step(mcfg, group, lr=0.3,
                                               sp_strategy=strategy)

        def profiled(step=step, store=store, mcfg=mcfg):
            """The profiler over PROFILED_STEPS more steps (and the steps
            it runs besides: its warm-up, and any window it retraces)."""
            calls = [0]

            def counted():
                calls[0] += 1
                return step(inputs, targets)

            busy, kernels = device_breakdown(torch, counted,
                                             iters=PROFILED_STEPS)
            return ({"busy_ms_per_step": busy, "kernels": kernels,
                     "params": store.n_params,
                     "model_tflop_per_step": psformer_flops(
                         mcfg, batch * seq, seq) / 1e12},
                    {"ring_push[float32]": calls[0]})

        row = leg(label, lambda: step(inputs, targets), MODEL_STEPS,
                  batch * seq, "tokens", {"ring_push[float32]": 1},
                  profiled if label.endswith("-ring") else None)
        if "busy_ms_per_step" in row:
            kernels = row.pop("kernels")
            row["busy_share"] = row["busy_ms_per_step"] / row[
                "wall_ms_per_step"]
            row["model_tflops_wall"] = (row["model_tflop_per_step"]
                                        / row["wall_ms_per_step"] * 1e3)
            print(f"    {row['params']:,} params; model "
                  f"{row['model_tflop_per_step'] * 1e3:.2f} GFLOP/step, "
                  f"{row['model_tflops_wall']:.3f} TFLOP/s wall; "
                  f"profiler: device busy {row['busy_ms_per_step']:.3f} "
                  f"ms/step, busy share {row['busy_share']:.3f}")
            for kname, ms in kernels[:8]:
                print(f"    {ms:.4f} ms/step  {kname}")

    # GPipe over dp 2 x pp 4: examples/train_pipeline.py's defaults.
    pcfg = transformer.ModelConfig(dim=64, layers=4)
    M, mb, pseq = 2, 2, 32
    pstep, state = train.make_pp_train_step(
        pcfg, ps.make_group((2, 4), ("dp", "pp"), device=dev), lr=0.2,
        num_micro=M)
    rng = np.random.default_rng(0)
    pin = rng.integers(0, pcfg.vocab, size=(2, M, mb, pseq)).astype(np.int32)
    pin, ptgt = (torch.as_tensor(a, device=dev)
                 for a in (pin, (pin + 1) % pcfg.vocab))
    pp_state = [state]

    def pp_step():
        pp_state[0], loss = pstep(pp_state[0], pin, ptgt)
        return loss

    leg("psformer-pp-dp2xpp4", pp_step, MODEL_STEPS, 2 * M * mb * pseq,
        "tokens", {})

    # The CNN, data parallel over 8 ranks.
    ccfg = cnn.CNNConfig()
    cstep, _ = cnn.make_ps_train_step(
        ccfg, ps.DeviceGroup(N, device=dev, axis_name="dp"), lr=0.1)
    images, labels = (torch.as_tensor(a, device=dev)
                      for a in cnn.toy_batch(ccfg, batch=64))
    leg("cnn-dp8", lambda: cstep(images, labels), MODEL_STEPS, 64,
        "examples", {"ring_push[float32]": 1})

    # DLRM at the benchmark's table size, config 5's lookups per worker.
    dcfg = dlrm.DLRMConfig(num_rows=1 << 20)
    batch_w = 1024  # x num_cat 4 = 4,096 lookups per worker
    data = [torch.as_tensor(a, device=dev)
            for a in dlrm.toy_batch(dcfg, workers=N, batch=batch_w, seed=1)]
    for opt, kernel in ((None, "sparse_scatter_add"),
                        ("row_adagrad", "sparse_row_adagrad")):
        group = ps.DeviceGroup(N, device=dev)
        dstep = dlrm.make_train_step(
            dcfg, ps.CollectiveEngine(group, impl="ring"),
            ps.SparseEngine(group), lr=0.1, emb_optimizer=opt)
        leg(f"dlrm-1m-{opt or 'sgd'}", lambda: dstep(*data), DLRM_STEPS,
            N * batch_w, "examples",
            {"ring_push[float32]": 1, kernel: 1, "sparse_gather_rows": 1})

    # The toy LM over a loopback message-path PS, raw and fp8 + EF.
    finals = {}
    for codec in (None, "fp8_e4m3"):
        nodes = msg_cluster(ps, Environment, 1, 1)
        srv = ps.KVServer(0, postoffice=nodes[1])
        srv.set_request_handle(ps.KVServerDefaultHandle())
        kv = ps.KVWorker(0, 0, postoffice=nodes[2])
        label = f"kv-train-{codec or 'raw'}"
        before = counts()
        try:
            t0 = time.perf_counter()
            losses = train.kv_train_loop(kv, cfg, steps=KV_STEPS, lr=KV_LR,
                                         codec=codec, device=dev)
            wall = (time.perf_counter() - t0) * 1e3 / KV_STEPS
        finally:
            msg_finalize(nodes, [kv, srv])
        # The message path's pushes run no kernel of the watched four.
        check_launches(label, before, {})
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"kv_train_loop {codec}: {losses}")
        finals[codec] = float(np.mean(losses[-5:]))
        results.append({"config": label, "ops": KV_STEPS,
                        "first_loss": losses[0], "last_loss": losses[-1],
                        "wall_ms_per_step": wall})
        print(f"models {label}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"over {KV_STEPS} steps; {wall:.2f} ms/step wall (pull, grad "
              f"on the card, push; host CPU {cpu_model()})")
    gap = abs(finals["fp8_e4m3"] - finals[None]) / finals[None]
    print(f"models kv-train: fp8_e4m3 + error feedback ends "
          f"{gap * 100:.2f} % from raw (mean of the last 5 losses; "
          f"bar {KV_GAP * 100:g} %)")
    if not gap <= KV_GAP:
        raise AssertionError(f"kv-train: fp8_e4m3 + error feedback ends "
                             f"{gap * 100:.2f} % from raw, over "
                             f"{KV_GAP * 100:g} %")
    print(f"models phase: {time.perf_counter() - t_phase:.1f} s")
    return results


def multiproc_phase():
    """``tools/multiproc_phase.py``: the ``multiprocess`` phase's body (one
    group across worker processes on the card, and the DCN tier)."""
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import multiproc_phase as mp

    return mp


def harness_phase():
    """``tools/harness_phase.py``: the ``harness`` phase's body (stress,
    the benchmark CLI, psmon/pstrace and the examples on the card)."""
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import harness_phase as hp

    return hp


def wait_epoch(po, epoch: int, timeout: float = 60.0):
    """The routing table once ``po`` holds ``epoch`` or a later one."""
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        rt = po.current_routing()
        if rt is not None and rt.epoch >= epoch:
            return rt
        time.sleep(0.01)
    raise AssertionError(f"routing epoch {epoch} not reached in {timeout} s")


# Phases of child processes only (see ``main``), over tcp: shm-config3
# stays in the first lane (run beside the other lane's clusters once, its
# first 1 MB round read 18,061,460 wrong values).
SECOND_LANE = ("tcp-config1", "native-goodput", "tcp-config2",
               "tcp-config2-tiers", "small-op-storm", "serving-fanin",
               "hot-cache", "recovery-keepalive", "deadline-timeout",
               "replication-failover")


def main() -> int:
    global T_MAIN
    T_MAIN = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import pslite_tpu_torch as ps
    except ImportError as exc:
        print(f"chip_smoke: pslite_tpu_torch not importable: {exc}",
              file=sys.stderr)
        return 2
    from pslite_tpu_torch.environment import Environment
    from pslite_tpu_torch.ops import _native
    from pslite_tpu_torch.ops import fused_update as fu
    from pslite_tpu_torch.ops import quantize as qz
    from pslite_tpu_torch.ops import reduce_update as ru
    from pslite_tpu_torch.ops import ring_collective as ring
    from pslite_tpu_torch.ops import sparse_rows as sr
    from pslite_tpu_torch.models import embedding as emb
    from pslite_tpu_torch.models import resnet_trace as rt
    from pslite_tpu_torch.vans import native as host_native

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{name} count {count}")

    # The host core (g++) builds beside the kernels (nvcc).
    host_build = {}

    def build_host_core():
        t = time.perf_counter()
        try:
            host_native.build(force=True)
            host_build["lib"] = host_native.load()
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            host_build["error"] = exc
        host_build["s"] = time.perf_counter() - t

    host_thread = threading.Thread(target=build_host_core)
    host_thread.start()
    t0 = time.perf_counter()
    _native.build(force=True)
    _native.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{_native.build_info['path']}")
    host_thread.join()
    if "error" in host_build:
        raise host_build["error"]
    stamp = host_build["lib"].psl_abi_version()
    if stamp != host_native.ABI_VERSION:
        raise AssertionError(f"native core ABI stamp {stamp}")
    print(f"native core build ({host_native.build_info['compiler']}, "
          f"{' '.join(host_native.CXX_FLAGS)}): {host_build['s']:.1f} s "
          f"-> {host_native.build_info['path']}; ABI stamp {stamp} "
          f"(vans/native.py ABI_VERSION {host_native.ABI_VERSION}) "
          f"[host CPU {cpu_model()}]")
    for line in _native.build_info["log"].splitlines():
        if "ptxas info" in line or "spill" in line:
            print(f"  {line.strip()}")

    for label, n, kv, pads in (
            ("1-D n=8", N, None, P), ("2-D dp4xkv2", 4, 2, P),
            ("1-D n=2", 2, None, P),
            ("grouped trace 1-D n=8", N, None, trace_pads(rt, N)),
            ("grouped trace 2-D dp4xkv2", 4, 2, trace_pads(rt, 2))):
        shape = ring.int8_launch_shape(n, pads, kv_shards=kv)
        size = P if isinstance(pads, int) else f"{len(pads)} buckets"
        print(f"int8 ring launch shape {label} P={size}: cluster "
              f"{shape['cluster']} CTAs x {shape['groups']} clusters per "
              f"region x {shape['nregions']} regions, "
              f"{shape['smem_floats'] * 4} B shared memory per CTA (slice "
              f"{shape['slice']} values), co-resident clusters "
              f"{shape['max_active_clusters']}, waves {shape['waves']}, "
              f"scratch {shape['scratch']} values; launcher cost (bytes "
              f"per CTA) by cluster x groups {shape['cost']}")

    rows = kernel_phase(torch, ring, fu, qz, rt, torch.device("cuda:0"))
    rows += sparse_rows_rows(torch, sr, emb, torch.device("cuda:0"),
                             _native)
    rows += sparse_group_rows(torch, sr, emb, torch.device("cuda:0"))
    for r in rows:
        note = r["library_note"]
        lib = (f"{r['library_ms']:.4f} ms (host-inclusive "
               f"{r['library_ms_host']:.4f}{'; ' + note if note else ''})"
               if r.get("library_ms") is not None else f"none ({note})")
        print(f"kernel {r['name']}: {r['ms']:.4f} ms host-free, "
              f"{r['ms_host']:.4f} ms host-inclusive (plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms'] * 1e3:.1f} us, "
              f"{r['bound_ms'] / r['ms']:.2f} of bound, library {lib}), "
              f"max_abs_err {r['max_abs_err']:.3g}")
        if "singles_ms" in r:
            print(f"    {r['buckets']} buckets, {r['values']} values; the "
                  f"{r['buckets']} single launches: {r['singles_ms']:.4f} ms "
                  f"host-free, {r['singles_ms_host']:.4f} ms host-inclusive")
        if "ms_by_shape" in r:
            print(f"    int8 launch: {r['nregions']} regions, cluster "
                  f"{r['cluster']} CTAs x {r['groups']} clusters per region, "
                  f"{r['waves']} waves; host-free ms by forced cluster x "
                  f"groups (each 0 elements off the plain version): "
                  + ", ".join(f"{k}: {v:.4f}"
                              for k, v in r["ms_by_shape"].items()))
        if "ms_by_cluster" in r:
            print(f"    one launch of {r['nregions']} regions at cluster "
                  f"{r['cluster']} ({r['waves']} waves); host-free ms by "
                  f"forced cluster size: " + ", ".join(
                      f"{c}: {ms:.4f}" for c, ms in r["ms_by_cluster"].items()))
        if "ms_cold" in r:
            chain = (f", chain floor {r['chain_floor_ms'] * 1e3:.1f} us "
                     f"(longest run {r['max_run']} updates)"
                     if "chain_floor_ms" in r else "")
            print(f"    config 5: {r['distinct_rows']} distinct rows; "
                  f"{r['ms_cold']:.4f} ms host-free with the L2 flushed "
                  f"before each launch{chain}")
        if "hot_run_cycles_per_add" in r:
            print(f"    the longest run ({r['hot_run']} updates) walks at "
                  f"{r['hot_run_cycles_per_add']:.2f} SM cycles per add "
                  f"(clock probe)")
        if "earlier_note" in r:
            chain = (f"; chain floor {r['chain_floor_ms'] * 1e3:.1f} us "
                     f"(longest run {r['max_run']} updates)"
                     if "chain_floor_ms" in r else "")
            print(f"    {r['tables']} tables, {r['distinct_rows']} distinct "
                  f"rows; {r['earlier_note']}: {r['earlier_ms']:.4f} ms "
                  f"host-free, {r['earlier_ms_host']:.4f} ms "
                  f"host-inclusive{chain}")
        elif "earlier_ms" in r:
            print(f"    the engine's path before it (plain reduction, then "
                  f"the handle or K1-K3, then the copy): "
                  f"{r['earlier_ms']:.4f} ms; elements off the plain "
                  f"version {r['elements_off_plain']}")
        if "steps" in r:
            print(f"    per step of {r['steps']}: {r['ms_per_step']:.4f} ms "
                  f"host-free, {r['ms_host_per_step']:.4f} ms "
                  f"host-inclusive, bound "
                  f"{r['bound_ms_per_step'] * 1e3:.1f} us")

    rng = np.random.default_rng(SEED)
    grads_steps = [rng.standard_normal((N, P), dtype=np.float32)
                   for _ in range(6)]
    host = trace_grads(rt, SEED + 1)
    dev_steps = torch.randn(
        (REPLAY_STEPS, N, P), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(SEED + 2))

    # Each path of the main path runs with every count set to 0 just
    # before it, and its counts are read just after.
    paths = [
        ("dense push_pull", lambda: (
            drive(torch, ps, Environment, grads_steps)
            + [drive_int8(torch, ps, ring, Environment, grads_steps)]
            + drive_2d(torch, ps, ring, grads_steps)
            + [drive_quantize(torch, ps, qz, grads_steps)]
            + drive_fused_ops(torch, ps, fu, grads_steps)
            + drive_default_impl(torch, ps, ru, fu, Environment,
                                 grads_steps))),
        ("int8 n=2", lambda: [drive_int8_spill(torch, ps, ring,
                                               grads_steps)]),
        ("resnet50 trace", lambda: drive_resnet(torch, ps, Environment, rt,
                                                host)),
        ("groups", lambda: drive_groups(torch, ps, rt, host)),
        ("replay", lambda: drive_replay(torch, ps, Environment, dev_steps)),
        ("zero-copy", lambda: drive_zero_copy(torch, ps, Environment,
                                              grads_steps)),
        ("sparse", lambda: drive_sparse(torch, ps, Environment, emb, sr)),
        ("sparse-groups", lambda: drive_sparse_groups(torch, ps, Environment,
                                                      emb, sr)),
        ("elastic", lambda: drive_elastic(torch, ps, ring, emb, Environment,
                                          smi)),
        ("msg-config2", lambda: drive_msg_config2(ps, Environment, smi)),
        ("msg-config2-serial", lambda: drive_msg_config2(
            ps, Environment, smi, label="msg-config2-serial",
            env={"PS_APPLY_SHARDS": "0"})),
        ("msg-pool-vs-serial", lambda: drive_msg_pool_vs_serial(
            ps, Environment)),
        ("msg-config2-codecs", lambda: drive_msg_codecs(ps, Environment,
                                                        smi)),
        ("codec-throughput", lambda: drive_codec_throughput(smi)),
        ("msg-ici-mixed", lambda: drive_msg_ici_mixed(
            ps, ring, Environment, grads_steps, smi)),
        ("msg-optimizer", lambda: drive_msg_optimizer(ps, Environment)),
        ("tcp-config1", lambda: drive_tcp_config1(smi)),
        ("native-goodput", lambda: drive_native_goodput(smi)),
        ("tcp-config2", lambda: drive_tcp_config2(smi)),
        ("tcp-config2-tiers", lambda: drive_tcp_config2_tiers(smi)),
        ("shm-config3", lambda: drive_shm_config3(smi)),
        ("ici-tcp-mixed", lambda: drive_ici_proc("ici_tcp", smi)),
        ("ici-shm-mixed", lambda: drive_ici_proc("ici_shm", smi)),
        ("multiprocess", lambda: multiproc_phase().drive_multiprocess(
            smi, rows)),
        ("harness", lambda: harness_phase().drive_harness(smi)),
        ("small-op-storm", lambda: drive_small_op_storm(smi)),
        ("serving-fanin", lambda: drive_serving_fanin(smi)),
        ("hot-cache", lambda: drive_hot_cache(smi)),
        ("multi-tenant", lambda: drive_multi_tenant(ps, Environment,
                                                    smi)),
        ("recovery-keepalive", lambda: drive_recovery_keepalive(smi)),
        ("deadline-timeout", lambda: drive_deadline_timeout(smi)),
        ("chaos-matrix", lambda: drive_chaos_matrix(ps, Environment, smi)),
        ("replication-failover", lambda: drive_replication_failover(smi)),
        ("replica-read", lambda: drive_replica_read(ps, Environment, smi)),
        ("durable-store", lambda: drive_durable_store(ps, Environment, smi)),
        ("elastic-scale", lambda: (
            drive_elastic_scale(ps, ring, Environment, smi)
            + drive_elastic_migrate(ps, Environment, smi))),
        ("observability", lambda: drive_observability(
            ps, Environment, rows, smi)),
        ("models", lambda: drive_models(torch, ps, ring, sr, Environment,
                                        smi)),
    ]
    # The phases whose every node is a child process that this process
    # neither hands the card to nor changes the environment of run in a
    # second lane beside the others, from codec-throughput on (the last
    # phase that sets a variable children inherit), so that the script
    # keeps inside its time limit on a slower host: they spend most of
    # their time starting processes.  Their launches are their children's.
    second = [(p, r) for p, r in paths if p in SECOND_LANE]
    paths = [(p, r) for p, r in paths if p not in SECOND_LANE]
    lane = {"out": [], "error": None}

    def run_lane():
        try:
            for path, run in second:
                t_path = time.perf_counter()
                out = run()
                lane["out"].append((path, out,
                                    time.perf_counter() - t_path))
        except BaseException as exc:  # raised again on the main thread
            lane["error"] = exc

    lane_thread = threading.Thread(target=run_lane, name="second-lane")
    results, path_counts = [], {}

    def record_path(path, out, t_path, counts):
        # A process phase also returns the launches its worker process
        # counted.
        child = {}
        if isinstance(out, tuple):
            out, child = out
        path_counts[path] = dict(counts)
        for k, v in child.items():
            path_counts[path][k] = path_counts[path].get(k, 0) + v
        print(f"main path launches [{path}] ({t_path:.1f} s): "
              + ", ".join(f"{k} {v}" for k, v in path_counts[path].items()
                          if v))
        return out

    for path, run in paths:
        fu.reset_launches()
        ring.reset_launches()
        qz.reset_launches()
        sr.reset_launches()
        ru.reset_launches()
        t_path = time.perf_counter()
        out = run()
        t_path = time.perf_counter() - t_path
        out = record_path(path, out, t_path, {
            **ring.launches, **fu.launches, **qz.launches, **sr.launches,
            **ru.launches})
        results += out
        if path == "msg-config2":
            _loopback_cell[0] = (f"{out[0]['ms_per_round']:.3f} ms/round, "
                                 f"{out[0]['gbps_per_worker']:.4f} Gbit/s "
                                 f"per worker")
        if path == "codec-throughput":
            lane_thread.start()
    lane_thread.join()
    if lane["error"] is not None:
        raise lane["error"]
    none = {k: 0 for k in {**ring.launches, **fu.launches, **qz.launches,
                           **sr.launches, **ru.launches}}
    for path, out, t_path in lane["out"]:
        results += record_path(path, out, t_path, none)
    for r in results:
        extra = "".join(f", {k} {v:.4g}" for k, v in r.items()
                        if k not in ("config", "ops", "max_abs_err_vs_f64"))
        err = (f"max |err| vs float64 {r['max_abs_err_vs_f64']:.3g}"
               if "max_abs_err_vs_f64" in r else "held against sequential "
                                                 "ops")
        print(f"main path {r['config']}: {r['ops']} ops, {err}{extra}")
    # The sparse path launches once per table and op: 3 pushes and 3
    # pulls of each handle, single ops on two twin tables (per handle),
    # and the replay's 3 pushes and pulls; its push_group of 2 tables is
    # one chain of 3 launches per handle, its pull_group one launch.
    want = {"sparse_scatter_add": 3 + 2 + 3, "sparse_row_adagrad": 3 + 2,
            "sparse_gather_rows": 6 + 2 + 3,
            "sparse_scatter_add_group": 3, "sparse_row_adagrad_group": 3,
            "sparse_gather_rows_group": 1}
    got = {k: path_counts["sparse"][k] for k in want}
    if got != want:
        raise AssertionError(f"sparse path launches {got}, expected {want}")
    # The sparse-groups path: GROUP_STEPS steps of each handle over the
    # three groups, each a push_group (3 launches per dtype: 3, 3 and 6)
    # and a pull_group (1), whatever the number of tables (26, 2, 2); the
    # twins one launch per table and op.
    tables = sum(len(v) for v in group_specs().values())
    want = {"sparse_scatter_add_group": GROUP_STEPS * (3 + 3 + 6),
            "sparse_row_adagrad_group": GROUP_STEPS * (3 + 3 + 6),
            "sparse_gather_rows_group": 2 * GROUP_STEPS * 3,
            "sparse_scatter_add": GROUP_STEPS * tables,
            "sparse_row_adagrad": GROUP_STEPS * tables,
            "sparse_gather_rows": 2 * GROUP_STEPS * tables}
    got = {k: path_counts["sparse-groups"][k] for k in want}
    if got != want:
        raise AssertionError(f"sparse-groups path launches {got}, "
                             f"expected {want}")
    # The elastic path: run A 9 steps, B and C 3 each (D2 adam, the 1-D
    # ring, S2, S3 once per step), the composite and 2-D engines 3 adam
    # and 3 ring steps each, and 10 timed adam steps.
    want = {"reduce_adam[float32]": 15 + 6 + 10,
            "ring_push_pull[float32]": 15,
            "ring_push_pull_2d[float32]": 6, "sparse_row_adagrad": 15,
            "sparse_gather_rows": 15}
    got = {k: path_counts["elastic"][k] for k in want}
    if got != want:
        raise AssertionError(f"elastic path launches {got}, expected {want}")
    for r in rows:
        r["launches"] = (
            path_counts["int8 n=2"]["ring_push_pull_int8[float32]"]
            if r["name"] == SPILL_ROW else
            sum(c[r.get("counter", r["name"])] for p, c in path_counts.items()
                if p != "int8 n=2"))
        r["bound_us"] = r["bound_ms"] * 1e3
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        if r["launches"] == 0:
            raise AssertionError(f"{r['name']} never launched on the main "
                                 f"path")
    # The groups path runs 2 int8 push_pull_groups of 36 buckets: one
    # launch each.
    grouped8 = path_counts["groups"]["ring_push_pull_group_int8[float32]"]
    if grouped8 != 2:
        raise AssertionError(f"the grouped int8 ring launched {grouped8} "
                             f"times for 2 groups")
    del grads_steps, host, dev_steps

    steady = steady_state(torch, ps)
    for r in steady:
        if r["cell"] in ("xla/sum", "pallas/adam:1e-3"):
            check_reduce_breakdown(r)
    for r in steady:
        print(f"steady push_pull {r['cell']} 40x1MB: "
              f"{r['event_ms_per_step']:.4f} ms/step (CUDA events), "
              f"{r['wall_ms_per_step']:.4f} ms/step wall, "
              f"{r['goodput_gbps_event']:.1f} GB/s events, "
              f"{r['goodput_gbps_wall']:.1f} GB/s wall; profiler: device "
              f"busy {r['busy_ms_per_step']:.4f} ms/step, busy share "
              f"{r['busy_share']:.3f} [{smi}]")
        for kname, ms in r["kernels"][:6]:
            print(f"    {ms:.4f} ms/step  {kname}")

    for r in steady_state_trace(torch, ps, rt, Environment):
        h2d = (f", host-to-device {r['h2d_gbps_wall']:.2f} GB/s wall"
               if "h2d_gbps_wall" in r else "")
        if "error_bound" in r:
            h2d += (f", max |err| vs float64 {r['max_abs_err_vs_f64']:.3g} "
                    f"(int8 bound {r['error_bound']:.3g})")
        print(f"steady {r['cell']}: {r['wall_ms_per_step']:.4f} ms/step "
              f"wall, {r['event_ms_per_step']:.4f} ms/step (CUDA events), "
              f"{r['goodput_gbps_wall']:.1f} GB/s wall{h2d}; profiler: "
              f"device busy {r['busy_ms_per_step']:.4f} ms/step (copies "
              f"{r['copy_ms_per_step']:.4f}), busy share "
              f"{r['busy_share']:.3f} [{smi}]")
        for kname, ms in r["kernels"][:6]:
            print(f"    {ms:.4f} ms/step  {kname}")

    for r in steady_state_sparse(torch, ps, Environment, emb):
        print(f"steady {r['cell']} (1,048,576 x 64, 8 x 4,096 Zipf): "
              f"{r['wall_ms_per_step']:.4f} ms/step wall, "
              f"{r['event_ms_per_step']:.4f} ms/step (CUDA events), "
              f"{r['goodput_gbps_wall']:.2f} GB/s wall; profiler: device "
              f"busy {r['busy_ms_per_step']:.4f} ms/step (copies "
              f"{r['copy_ms_per_step']:.4f}), busy share "
              f"{r['busy_share']:.3f} [{smi}]")
        for kname, ms in r["kernels"][:8]:
            print(f"    {ms:.4f} ms/step  {kname}")

    for r in steady_state_groups(torch, ps, Environment, emb):
        print(f"steady {r['cell']} ({r['tables']} tables): push_group + "
              f"pull_group {r['group_wall_ms']:.4f} ms/step wall, the "
              f"per-table loop {r['loop_wall_ms']:.4f} ms/step wall "
              f"(windows {spread(r['group_walls'])} / "
              f"{spread(r['loop_walls'])}) [{smi}]")

    push_pieces(torch, sr, emb, rows)
    for r in rows:
        if "pieces_ms" in r:
            print(f"kernel {r['name']} pieces (profiler, ms per call): "
                  + ", ".join(f"{k} {v:.4f}"
                              for k, v in r["pieces_ms"].items()))
    print(f"chip_smoke: {time.perf_counter() - T_MAIN:.1f} s in all")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--node"]:
        # A flushed print leaves in one write, so the lines of node
        # processes that share a pipe never run together (unbuffered
        # output, as PYTHONUNBUFFERED gives, writes a print's text and
        # its newline apart).
        sys.stdout.reconfigure(write_through=False)
        sys.path.insert(0, HERE)
        sys.exit(node_main())
    sys.exit(main())
