#!/usr/bin/env python3
"""Drive pslite_tpu_torch on one NVIDIA GPU and check it end to end.

Run from the root of a checkout, on a host with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and only a full pass prints the last
line):

1. The card: ``nvidia-smi`` name and power limit, torch's device name
   and count.
2. Build every CUDA kernel of the dense data plane from ``csrc/`` with
   nvcc; print the build time and the ``-Xptxas -v`` register/spill
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
   long runs' walk, the short runs beside it).
   K1-K3 also on bf16 stores (0 differing elements: kernel and plain
   version round after every operation).
   ``ms`` is the mean of ITERS calls captured in one CUDA graph and
   replayed, timed with CUDA events (the host is out of the timing);
   ``ms_host`` is the mean of ITERS back-to-back Python calls (the host
   included).  Beside them: the plain version's time, the card's least
   time for the same work, and the time of one PyTorch call that
   computes the same function where there is one.
4. Main path: ``Postoffice("worker")`` + ``DeviceGroup(8)`` +
   ``KVWorker.push_pull``/``push``/``pull`` on the reference benchmark's
   40 x 1,024,000 B bucket under the ring (``PS_ICI_IMPL=pallas``,
   handle ``sum``, f32 and bf16, and f32 with ``PS_ICI_COMPRESS=int8``)
   and the fused optimizer handles (``adam``, ``sgd_momentum``,
   ``adagrad``, on f32 and bf16 buckets); ``CollectiveEngine`` on a ``make_group((4, 2), ("dp",
   "kv"))`` group with ``worker_axis="dp"`` for ``sum``, int8 and
   ``adam``; and an int8 quantize -> dequantize round trip of the
   bucket.  Each is checked against a float64 numpy reference, and the
   ring and quantize results also against their plain versions on the
   card.  Kernel launch counts are zeroed just before and read just
   after; every kernel must have launched.  Then, with the counts zeroed
   again, the int8 ring at n = 2 (``CollectiveEngine`` on a 2-rank
   group, the spilling shape).  Then, each path with the counts zeroed
   before it: the ResNet-50 trace (BASELINE config 4: 36 buckets of 1,024
   to 1,048,576 f32 values, 8 ranks) through Postoffice/KVWorker per
   bucket, as one ``push_pull_group``, through the coalescer (36 tickets
   from 4 threads) and from host numpy grads (serial copies, and
   ``push_pull_multi_stream``'s pinned staging); the grouped bf16, 2-D
   and int8 rings over the trace; ``KVWorker.replay`` (ring keep all and
   last, torch, adam) against 8 sequential push_pulls; zero-copy and
   registered pulls (a stale handle must raise); the sparse tables (config
   5 through ``KVWorker.push_sparse``/``pull_sparse``, 3 steps with the sum
   handle and 3 with ``row_adagrad:0.01,1e-8``, against float64 numpy and
   each push against the plain version on the card; a
   ``push_group``/``pull_group`` of two tables against single ops; and
   ``models.embedding.replay``); engine state that moves (``elastic``:
   the 40 x 1 MB adam bucket, a 40 x 1 MB sum bucket and config 5's
   table under row_adagrad through ``KVWorker`` on the ici van, 8 ranks:
   a ``save_engine`` restored by a fresh cluster and an
   ``AsyncEngineCheckpointer`` file against the live run and the sync
   file, a 4-rank restore against ``KVWorker.reshard`` 8 -> 4 and 3 more
   steps of both, within float64's bounds, then back to 8 and onto the
   composite ``(dp 2, kv1 2, kv2 2)`` axis against ``(dp 2, kv 4)``: 0
   differing elements everywhere; K3, K4 at n = 4 and on the composite
   sub-rings, S2 and S3 launched on the recut state; save/restore/async
   and reshard times printed with the host CPU).  The grouped int8 ring
   must count one launch per ``push_pull_group``, and the sparse kernels
   one launch per table and op.  Then the steady-state
   ``engine.push_pull`` time with device-resident grads, and the steady
   state of the trace's five paths (``resnet50-grouped-int8``: one
   ``push_pull_group`` per step under ``PS_ICI_COMPRESS=int8``) and of
   an 8-step replay (wall and event ms/step, the profiler's device time,
   host-to-device GB/s), and of config 5 through KVWorker: one push and
   one pull per step with grads on the card (``embedding-1m``), under
   ``row_adagrad`` (``embedding-1m-adagrad``) and from numpy grads
   (``embedding-1m-host``).
   The message control plane, each phase with the counts zeroed before
   it, clusters started in this process with their own deadlines:
   ``msg-config2`` (BASELINE config 2's topology over the loopback van:
   1 scheduler + 2 servers + 2 workers, test_benchmark's 40 keys per
   server of 1,024,000 B, 2 warm-up and 10 timed rounds of push, worker
   barrier, pull, every pull checked exactly; ms/round and
   test_benchmark's Gbit/s, beside the card's name and power limit and
   the host CPU), ``msg-ici-mixed`` (one ``KVWorker`` on an ``ici``
   cluster: the 40 x 1 MB bucket through K4 and 16 unregistered 1 MB
   keys over messages to the server, 5 interleaved steps against
   float64, K4's launches and the server's keys checked) and
   ``msg-optimizer`` (``KVServerOptimizerHandle`` adam against float64).
   Then separate processes, one per node (``python3 chip_smoke.py
   --node``, roles and environment from the port's ``tracker/local.py``),
   every child under ``PROC_DEADLINE``, all killed when one fails, one
   JSON line back from each: ``tcp-config1`` (BASELINE config 1, fused
   push_pull of 40 x 1,024,000 B), ``tcp-config2`` (config 2, msg-config2's
   rounds at 80 x 1,024 B, 80 x 1,024,000 B and 2 x 64 MiB per worker;
   the 1 MB round also with ``DMLC_LOCAL=1``, no socket file left, and
   over ``multi``, 2 tcp rails), ``shm-config3`` (config 3 on one host:
   the scheduler + 2 ``--joint`` processes over shm, registered push
   buffers and zero-copy pulls, no /dev/shm segment left) and
   ``ici-tcp-mixed`` (scheduler, server and an ``ici_tcp`` worker
   process, then ``ici_shm``: the bucket through K4 from device grads
   against float64 and 16 x 1 MB keys over messages; K4 counted in the
   worker process and added to the path's launches).  Every pull is
   checked exactly; each cell's ms/round and Gbit/s are printed beside
   the loopback ``msg-config2`` of the same run.
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
    stream, which is the capture stream inside ``torch.cuda.graph``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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
            library_note="no single PyTorch call computes it",
        ))
        del grads, store, sk, sp, outk, outp
    return rows


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
        env = Environment({"PS_ICI_IMPL": "pallas",
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
            "PS_ICI_IMPL": "pallas", "PS_ICI_SERVER_HANDLE": handle}))
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
    env = Environment({"PS_ICI_IMPL": "pallas",
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
    configurations: bf16 (8 ranks), the 2-D sub-rings (dp = 4 x kv = 2)
    and int8 (8 ranks), two steps each, against float64 (int8: within the
    summed error bound, relative error < 0.05)."""
    names = [name for name, _ in rt.make_buckets()]
    results = []
    for label, group, waxis, dtype, compress in (
            ("bf16", ps.DeviceGroup(N), None, torch.bfloat16, None),
            ("2-D dp4xkv2", ps.make_group((4, 2), ("dp", "kv")), "dp",
             torch.float32, None),
            ("int8", ps.DeviceGroup(N), None, torch.float32, "int8")):
        eng = ps.CollectiveEngine(group, impl="pallas", worker_axis=waxis,
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
                "PS_ICI_IMPL": impl, "PS_ICI_SERVER_HANDLE": handle}))
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
        "PS_ICI_IMPL": "pallas", "PS_ICI_SERVER_HANDLE": "sum"}))
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


def device_breakdown(torch, step, iters: int = 5, attempts: int = 3):
    """torch.profiler over ``iters`` steps: (device-busy ms per step,
    [(kernel, ms per step)] by time).  The kernels run on one stream, so
    their times add.  (The profiler slows the host, so the busy share is
    taken against an unprofiled step's wall time, not this window's.)
    The profiler now and then reports a window without its device events
    (seen on an H100 for windows of a few kernels): such a window is
    profiled again, up to ``attempts`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                step()
            torch.cuda.synchronize()
        kernels = []
        for ev in prof.key_averages():
            # Kernel events only: an aten op's self device time repeats
            # the time of the kernels it launched.
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
                kernels.append((ev.key[:60],
                                ev.self_device_time_total / iters / 1e3))
        kernels.sort(key=lambda kv: -kv[1])
        busy_ms = sum(ms for _, ms in kernels)
        if busy_ms > 0:
            return busy_ms, kernels
    raise AssertionError(f"the profiler saw no device time in {attempts} "
                         f"windows")


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
        "PS_ICI_IMPL": "pallas", "PS_ICI_SERVER_HANDLE": "sum"}))
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


# -- sparse tables: BASELINE config 5 ------------------------------------------

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
    po = ps.Postoffice("worker", env=Environment({}))
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


# -- the message control plane in one process ---------------------------------

MSG_ROUNDS, MSG_WARMUP = 10, 2
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
            "PS_ICI_IMPL": "pallas", **(env or {})}
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


def drive_msg_config2(ps, Environment, smi: str):
    """BASELINE config 2's topology in one process over the loopback van:
    test_benchmark's PUSH_PULL workload (40 keys per server of 1,024,000
    B), each round both workers push on their own threads, meet at a
    worker barrier, then pull.  Integer-valued f32 pushes, so every
    pulled value is checked exactly, whatever order the two workers'
    pushes arrive in."""
    nodes = msg_cluster(ps, Environment, 2, 2)
    srv_pos, wk_pos = nodes[1:3], nodes[3:]
    apps = []
    try:
        handles = []
        for po in srv_pos:
            srv = ps.KVServer(0, postoffice=po)
            handles.append(ps.KVServerDefaultHandle())
            srv.set_request_handle(handles[-1])
            apps.append(srv)
        workers = [ps.KVWorker(0, 0, postoffice=po) for po in wk_pos]
        apps += workers
        keys = np.array([r.begin + i for r in wk_pos[0].get_server_key_ranges()
                         for i in range(MSG_KEYS_PER_SERVER)], np.uint64)
        rng = np.random.default_rng(SEED + 3)
        base = [rng.integers(-8, 8, size=len(keys) * VAL_LEN).astype(
            np.float32) for _ in range(2)]
        bufs = [np.empty_like(b) for b in base]
        outs = [np.zeros_like(b) for b in base]
        base_sum = base[0].astype(np.float64) + base[1]

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

        times = []
        for r in range(MSG_WARMUP + MSG_ROUNDS):
            for i in range(2):
                np.add(base[i], np.float32(r), out=bufs[i])
            t0 = time.perf_counter()
            run_threads([lambda i=i: work(i) for i in range(2)],
                        f"msg-config2 round {r}")
            times.append(time.perf_counter() - t0)
            want = (r + 1) * base_sum + r * (r + 1)
            for i in range(2):
                if not np.array_equal(outs[i], want):
                    bad = int((outs[i] != want).sum())
                    raise AssertionError(f"msg-config2 round {r}: worker {i} "
                                         f"pulled {bad} wrong values")
        if [len(h.store) for h in handles] != [MSG_KEYS_PER_SERVER] * 2:
            raise AssertionError("msg-config2: servers hold the wrong keys")
        elapsed = sum(times[MSG_WARMUP:])
        nbytes = VAL_LEN * 4
        gbps = 8 * nbytes * len(keys) * MSG_ROUNDS / (elapsed * 1e9)
        ms = elapsed / MSG_ROUNDS * 1e3
        print(f"msg-config2 (1 scheduler + 2 servers + 2 workers, loopback "
              f"van, {len(keys)} keys x {nbytes} B per worker and round): "
              f"{ms:.3f} ms/round (push, worker barrier, pull; host path, "
              f"no device work; rounds {', '.join(f'{t * 1e3:.1f}' for t in times[MSG_WARMUP:])} ms), "
              f"{gbps:.4f} Gbit/s per worker by test_benchmark's "
              f"8*len*total_key_num*iters/elapsed_ns, {2 * gbps:.4f} both "
              f"workers; {MSG_WARMUP + MSG_ROUNDS} rounds checked exactly; "
              f"per worker and round: " + ", ".join(
                  f"{k} {sum(v) / len(v) * 1e3:.1f} ms"
                  for k, v in phases.items()) +
              f" [{smi}] [host CPU {cpu_model()}]")
        return [{"config": "msg-config2", "ops": 4 * (MSG_WARMUP + MSG_ROUNDS),
                 "max_abs_err_vs_f64": 0.0, "ms_per_round": ms,
                 "gbps_per_worker": gbps}]
    finally:
        msg_finalize(nodes, apps)


def drive_msg_ici_mixed(ps, ring, Environment, grads_steps, smi: str):
    """The JAX IciVan's contract on the card: one KVWorker on an ``ici``
    cluster push_pulls the registered 40 x 1 MB bucket through K4 and
    pushes/pulls 16 unregistered 1 MB keys over messages to the server,
    interleaved for 5 steps, each against float64 numpy."""
    nodes = msg_cluster(ps, Environment, 1, 1, van="ici")
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
            want = (k + 1) * lbase.astype(np.float64) + k * (k + 1) / 2
            if not np.array_equal(lout, want):
                raise AssertionError(f"msg-ici-mixed: message step {k} "
                                     f"pulled wrong values")
        if sorted(handle.store) != loose.tolist():
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
              f"exactly the {MSG_LOOSE_KEYS} unregistered keys; host ms per "
              f"op: bucket push_pull {ms['bucket']:.3f} (numpy grads, "
              f"host-to-device copy and result copy included), message push "
              f"{ms['push']:.3f}, message pull {ms['pull']:.3f} "
              f"({MSG_LOOSE_KEYS} x {VAL_LEN * 4} B); bucket max |err| vs "
              f"float64 {worst:.3g} [{smi}]")
        return [{"config": "msg-ici-mixed", "ops": 3 * steps,
                 "max_abs_err_vs_f64": worst, "k4_launches": k4,
                 "bucket_ms": ms["bucket"], "msg_push_ms": ms["push"],
                 "msg_pull_ms": ms["pull"]}]
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


# -- engine state that moves: checkpoints and reshard ---------------------------

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
    import torch
    import pslite_tpu_torch as ps
    from pslite_tpu_torch.ops import ring_collective as ring

    spec = json.loads(os.environ["SMOKE_SPEC"])
    role = os.environ["DMLC_ROLE"]
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
        srv.set_request_handle(ps.KVServerDefaultHandle())
        apps.append(srv)
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
    if role in ("worker", "joint"):
        po = pos[0] if pos else ps.postoffice("worker")
        kv = ps.KVWorker(0, 0, postoffice=po)
        apps.append(kv)
        if ranks:
            report.update(node_ici(torch, ring, kv, spec))
        else:
            report.update(node_rounds(ps, po, kv, spec))
    # finalize's barrier keeps the servers answering until every worker
    # is done; the apps stop after it.
    if pos:
        pos[0].finalize()
    else:
        ps.finalize()
    for a in apps:
        a.stop()
    if "delivered_in_place" in report:
        report["delivered_in_place"] = report["delivered_in_place"]()
    report["ok"] = True
    print(json.dumps(report), flush=True)
    return 0


def node_rounds(ps, po, kv, spec) -> dict:
    """test_benchmark's rounds at each ``[keys per server, bytes per
    key]`` of ``spec["sizes"]`` (key ranges disjoint per size):
    ``push_pull`` (fused) or ``push`` + worker barrier + ``pull``, with
    integer-valued f32 pushes, so every pulled value is checked
    exactly whatever order the workers' pushes arrive in."""
    workers = po.num_workers
    me = po.my_rank()
    out = {}
    for si, (per_server, nbytes) in enumerate(spec["sizes"]):
        ranges = po.get_server_key_ranges()
        keys = np.array([r.begin + si * SIZE_KEY_STRIDE + i for r in ranges
                         for i in range(per_server)], np.uint64)
        vlen = nbytes // 4
        rng = np.random.default_rng(SEED + 7 + si)
        bases = [rng.integers(-8, 8, size=len(keys) * vlen).astype(
            np.float32) for _ in range(workers)]
        base, base_sum = bases[me], sum(b.astype(np.float64) for b in bases)
        del bases
        buf = np.empty_like(base)
        dst = (kv.alloc_pull_buffer(keys, vlen) if spec.get("zpull")
               else None)
        if spec.get("zpull") and dst is None:
            raise AssertionError("alloc_pull_buffer returned None")
        outs = dst if dst is not None else np.zeros_like(base)
        times = []
        rounds = spec["warmup"] + spec["rounds"]
        for r in range(rounds):
            np.add(base, np.float32(r), out=buf)
            t0 = time.perf_counter()
            if spec["mode"] == "push_pull":
                kv.wait(kv.push_pull(keys, buf, outs))
            else:
                kv.wait(kv.push(keys, buf))
                po.barrier(0, ps.WORKER_GROUP)
                kv.wait(kv.pull(keys, outs))
            times.append(time.perf_counter() - t0)
            want = (r + 1) * base_sum + workers * r * (r + 1) / 2
            if not np.array_equal(outs, want):
                raise AssertionError(f"size {nbytes} B round {r}: "
                                     f"{int((outs != want).sum())} values "
                                     f"wrong")
            # The next round's push must not overtake a slower worker's
            # pull of this one.
            if spec["mode"] != "push_pull":
                po.barrier(0, ps.WORKER_GROUP)
        if dst is not None:
            kv.free_pull_buffer(keys)
        del outs, dst
        timed = times[spec["warmup"]:]
        elapsed = sum(timed)
        out[str(nbytes)] = {
            "keys": len(keys), "ms_per_round": elapsed / len(timed) * 1e3,
            "gbps": 8 * nbytes * len(keys) * len(timed) / (elapsed * 1e9),
            "rounds_ms": [t * 1e3 for t in timed], "checked": rounds}
    out["zpull_hits"] = kv.zpull_hits
    out["chunks"] = [po.van.chunks_sent, po.van.chunks_recv]
    return {"sizes": out}


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
    for k in range(spec["steps"]):
        g = torch.randn((n, P), device="cuda", generator=gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kv.wait(kv.push_pull(bucket, g, outs))
        t_bucket.append(time.perf_counter() - t0)
        s64 += g.double().sum(0)
        mag += g.double().abs().sum(0)
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
    return {"launches": dict(ring.launches), "max_abs_err_vs_f64": worst,
            "bucket_ms": sum(t_bucket) / len(t_bucket) * 1e3,
            "msg_ms": sum(t_msg) / len(t_msg) * 1e3, "steps": spec["steps"]}


def launch(van: str, workers: int, servers: int, spec: dict,
           extra=None, joint: bool = False):
    """One cluster of separate processes, roles from the port's
    launcher (``tracker/local.py``), each child under PROC_DEADLINE;
    every child is killed when one fails or time runs out.  Returns the
    children's JSON reports (workers and joint nodes only)."""
    import tempfile

    from pslite_tpu_torch.tracker.local import LocalLauncher, build_env
    from pslite_tpu_torch.utils.network import get_available_port

    port = get_available_port()
    roles = LocalLauncher(workers, servers, [], van=van, root_port=port,
                          joint=joint).roles()
    logdir = tempfile.mkdtemp(prefix="smoke")
    procs = []
    try:
        for i, role in enumerate(roles):
            env = build_env(role, workers, servers, "127.0.0.1", port, van,
                            extra=dict(extra or {}, DMLC_NODE_HOST="127.0.0.1",
                                       SMOKE_SPEC=json.dumps(spec)))
            log = open(os.path.join(logdir, f"{i}-{role}.log"), "w+")
            procs.append((role, log, subprocess.Popen(
                [sys.executable, os.path.join(HERE, "chip_smoke.py"),
                 "--node"], env=env, stdout=log, stderr=subprocess.STDOUT,
                cwd=HERE)))
        end = time.monotonic() + PROC_DEADLINE
        failed = None
        while failed is None and any(p.poll() is None
                                     for _r, _l, p in procs):
            failed = next((r for r, _l, p in procs
                           if p.poll() not in (None, 0)), None)
            if time.monotonic() > end:
                failed = f"deadline of {PROC_DEADLINE:.0f} s"
            time.sleep(0.05)
        if failed is None:
            failed = next((r for r, _l, p in procs if p.returncode != 0),
                          None)
    finally:
        for _r, _l, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for role, log, p in procs:
        log.seek(0)
        outs.append((role, log.read()))
        log.close()
    if failed is not None:
        for role, text in outs:
            print(f"  [{role}] " + "\n  ".join(text.splitlines()[-15:]))
        raise AssertionError(f"{van} cluster: {failed} failed")
    return [json.loads(text.strip().splitlines()[-1]) for role, text in outs
            if role in ("worker", "joint")]


def rounds_summary(reports, nbytes: int) -> dict:
    rows = [r["sizes"][str(nbytes)] for r in reports]
    return {"ms_per_round": sum(x["ms_per_round"] for x in rows) / len(rows),
            "gbps_per_worker": sum(x["gbps"] for x in rows) / len(rows),
            "rounds_ms": rows[0]["rounds_ms"], "checked": rows[0]["checked"],
            "keys": rows[0]["keys"]}


def _print_rounds(label, topo, reports, sizes, smi, loopback):
    out = []
    for _n, nbytes in sizes:
        s = rounds_summary(reports, nbytes)
        print(f"{label} ({topo}, {s['keys']} keys x {nbytes} B per worker "
              f"and round): {s['ms_per_round']:.3f} ms/round, "
              f"{s['gbps_per_worker']:.4f} Gbit/s per worker by "
              f"test_benchmark's 8*len*total_key_num*iters/elapsed_ns "
              f"(rounds {', '.join(f'{t:.1f}' for t in s['rounds_ms'])} ms; "
              f"{s['checked']} rounds checked exactly); loopback msg-config2 "
              f"of this run {loopback} [{smi}] [host CPU {cpu_model()}]")
        out.append({"config": f"{label} {nbytes} B", "ops": s["checked"],
                    "max_abs_err_vs_f64": 0.0,
                    "ms_per_round": s["ms_per_round"],
                    "gbps_per_worker": s["gbps_per_worker"]})
    return out


_loopback_cell = ["not run"]


def drive_tcp_config1(smi: str):
    """BASELINE config 1: 1 scheduler + 1 server + 1 worker processes
    over tcp, test_benchmark's PUSH_PULL (fused push_pull) of 40 keys x
    1,024,000 B, 2 warm-up and 10 timed rounds."""
    sizes = [[KEYS, MB_LEN]]
    reports = launch("tcp", 1, 1, {"sizes": sizes, "mode": "push_pull",
                                   "warmup": MSG_WARMUP,
                                   "rounds": MSG_ROUNDS})
    return _print_rounds("tcp-config1", "1 + 1 + 1 processes, tcp, "
                         "push_pull", reports, sizes, smi, _loopback_cell[0])


TCP2_SIZES = [[MSG_KEYS_PER_SERVER, 1024], [MSG_KEYS_PER_SERVER, MB_LEN],
              [1, 64 << 20]]  # 64 MiB: 1 key per server, not 40


def drive_tcp_config2(smi: str):
    """BASELINE config 2: 1 scheduler + 2 servers + 2 workers processes
    over tcp, msg-config2's rounds (push, worker barrier, pull) at 40
    keys per server of 1,024 and 1,024,000 B and 1 key per server of
    64 MiB; then the 1 MB round with ``DMLC_LOCAL=1`` (unix sockets, no
    file left after) and over ``multi`` (2 tcp rails)."""
    import tempfile

    spec = {"mode": "push_barrier_pull", "warmup": MSG_WARMUP,
            "rounds": MSG_ROUNDS}
    topo = "1 + 2 + 2 processes"
    out = _print_rounds("tcp-config2", f"{topo}, tcp", launch(
        "tcp", 2, 2, dict(spec, sizes=TCP2_SIZES)), TCP2_SIZES, smi,
        _loopback_cell[0])
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
    out += _print_rounds("tcp-config2-multi", f"{topo}, multi (2 tcp "
                         "rails)", launch("multi", 2, 2, dict(spec, sizes=mb),
                                          extra={"DMLC_NUM_PORTS": "2"}),
                         mb, smi, _loopback_cell[0])
    return out


def shm_leftovers(ns: str):
    return [f for f in os.listdir("/dev/shm") if ns in f]


def drive_shm_config3(smi: str):
    """BASELINE config 3 on one host: 2 joint (worker + server) processes
    and the scheduler over ``shm``, 40 keys per server x 1,024,000 B,
    msg-config2's rounds; pushes land in registered receive buffers
    (ENABLE_RECV_BUFFER) and pulls in ``alloc_pull_buffer`` segments
    the servers write in place.  No segment may be left afterwards."""
    ns = f"smoke{os.getpid()}c3"
    sizes = [[MSG_KEYS_PER_SERVER, MB_LEN]]
    reports = launch("shm", 2, 2, {
        "sizes": sizes, "mode": "push_barrier_pull", "warmup": MSG_WARMUP,
        "rounds": MSG_ROUNDS, "zpull": True},
        extra={"PS_SHM_NS": ns, "ENABLE_RECV_BUFFER": "1"}, joint=True)
    if shm_leftovers(ns):
        raise AssertionError(f"shm-config3 left {shm_leftovers(ns)}")
    hits = [r["sizes"]["zpull_hits"] for r in reports]
    placed = [r["delivered_in_place"] for r in reports]
    if min(hits) < MSG_WARMUP + MSG_ROUNDS or not min(placed):
        raise AssertionError(f"shm-config3: zero-copy pulls {hits}, pushes "
                             f"placed in registered buffers {placed}")
    print(f"shm-config3: zero-copy pull hits per worker {hits}, pushes "
          f"placed by the van in registered buffers per server {placed}; "
          f"no /dev/shm segment left")
    return _print_rounds("shm-config3", "scheduler + 2 joint processes, "
                         "shm, registered buffers", reports, sizes, smi,
                         _loopback_cell[0])


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
    print(f"ici-tcp-mixed [{van}] (scheduler, server and worker processes, "
          f"the worker's engine on {N} ranks of cuda:0): {rep['steps']} "
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


def main() -> int:
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
    from pslite_tpu_torch.ops import ring_collective as ring
    from pslite_tpu_torch.ops import sparse_rows as sr
    from pslite_tpu_torch.models import embedding as emb
    from pslite_tpu_torch.models import resnet_trace as rt

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{name} count {count}")

    t0 = time.perf_counter()
    _native.build(force=True)
    _native.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{_native.build_info['path']}")
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
              f"{shape['cluster']} CTAs x {shape['nregions']} regions, "
              f"{shape['smem_floats'] * 4} B shared memory per CTA (slice "
              f"{shape['slice']} values), co-resident clusters "
              f"{shape['max_active_clusters']}, waves {shape['waves']}, "
              f"scratch {shape['scratch']} values; launcher cost (bytes "
              f"per CTA) {shape['cost']}")

    rows = kernel_phase(torch, ring, fu, qz, rt, torch.device("cuda:0"))
    rows += sparse_rows_rows(torch, sr, emb, torch.device("cuda:0"),
                             _native)
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
            + [drive_quantize(torch, ps, qz, grads_steps)])),
        ("int8 n=2", lambda: [drive_int8_spill(torch, ps, ring,
                                               grads_steps)]),
        ("resnet50 trace", lambda: drive_resnet(torch, ps, Environment, rt,
                                                host)),
        ("groups", lambda: drive_groups(torch, ps, rt, host)),
        ("replay", lambda: drive_replay(torch, ps, Environment, dev_steps)),
        ("zero-copy", lambda: drive_zero_copy(torch, ps, Environment,
                                              grads_steps)),
        ("sparse", lambda: drive_sparse(torch, ps, Environment, emb, sr)),
        ("elastic", lambda: drive_elastic(torch, ps, ring, emb, Environment,
                                          smi)),
        ("msg-config2", lambda: drive_msg_config2(ps, Environment, smi)),
        ("msg-ici-mixed", lambda: drive_msg_ici_mixed(
            ps, ring, Environment, grads_steps, smi)),
        ("msg-optimizer", lambda: drive_msg_optimizer(ps, Environment)),
        ("tcp-config1", lambda: drive_tcp_config1(smi)),
        ("tcp-config2", lambda: drive_tcp_config2(smi)),
        ("shm-config3", lambda: drive_shm_config3(smi)),
        ("ici-tcp-mixed", lambda: drive_ici_proc("ici_tcp", smi)),
        ("ici-shm-mixed", lambda: drive_ici_proc("ici_shm", smi)),
    ]
    results, path_counts = [], {}
    for path, run in paths:
        fu.reset_launches()
        ring.reset_launches()
        qz.reset_launches()
        sr.reset_launches()
        out = run()
        # A process phase also returns the launches its worker process
        # counted.
        child = {}
        if isinstance(out, tuple):
            out, child = out
        results += out
        if path == "msg-config2":
            _loopback_cell[0] = (f"{out[0]['ms_per_round']:.3f} ms/round, "
                                 f"{out[0]['gbps_per_worker']:.4f} Gbit/s "
                                 f"per worker")
        path_counts[path] = {**ring.launches, **fu.launches, **qz.launches,
                             **sr.launches}
        for k, v in child.items():
            path_counts[path][k] = path_counts[path].get(k, 0) + v
        print(f"main path launches [{path}]: " + ", ".join(
            f"{k} {v}" for k, v in path_counts[path].items() if v))
    for r in results:
        extra = "".join(f", {k} {v:.4g}" for k, v in r.items()
                        if k not in ("config", "ops", "max_abs_err_vs_f64"))
        err = (f"max |err| vs float64 {r['max_abs_err_vs_f64']:.3g}"
               if "max_abs_err_vs_f64" in r else "held against sequential "
                                                 "ops")
        print(f"main path {r['config']}: {r['ops']} ops, {err}{extra}")
    # The sparse path launches once per table and op: 3 pushes and 3
    # pulls of each handle, a push_group and a pull_group of 2 tables
    # beside single ops on their twins (per handle), and the replay's 3
    # pushes and pulls.
    want = {"sparse_scatter_add": 3 + 2 + 2 + 3,
            "sparse_row_adagrad": 3 + 2 + 2,
            "sparse_gather_rows": 6 + 2 + 2 + 3}
    got = {k: path_counts["sparse"][k] for k in want}
    if got != want:
        raise AssertionError(f"sparse path launches {got}, expected {want}")
    # The elastic path: run A 9 steps, B and C 3 each (K3, the 1-D ring,
    # S2, S3 once per step), the composite and 2-D engines 3 adam and 3
    # ring steps each, and 10 timed adam steps.
    want = {"adam_update": 15 + 6 + 10, "ring_push_pull[float32]": 15,
            "ring_push_pull_2d[float32]": 6, "sparse_row_adagrad": 15,
            "sparse_gather_rows": 15}
    got = {k: path_counts["elastic"][k] for k in want}
    if got != want:
        raise AssertionError(f"elastic path launches {got}, expected {want}")
    for r in rows:
        r["launches"] = (
            path_counts["int8 n=2"]["ring_push_pull_int8[float32]"]
            if r["name"] == SPILL_ROW else
            sum(c[r["name"]] for p, c in path_counts.items()
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

    for r in steady_state(torch, ps):
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

    push_pieces(torch, sr, emb, rows)
    for r in rows:
        if "pieces_ms" in r:
            print(f"kernel {r['name']} pieces (profiler, ms per call): "
                  + ", ".join(f"{k} {v:.4f}"
                              for k, v in r["pieces_ms"].items()))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--node"]:
        sys.path.insert(0, HERE)
        sys.exit(node_main())
    sys.exit(main())
