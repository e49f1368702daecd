"""Stress traffic generator — gather / scatter / datascatter / dense.

Counterpart of ``pslite_tpu/stress.py`` (:1-147), with the same patterns,
arguments and defaults.  Parity with ``tests/test_benchmark_stress.cc``
(:249-431), which documents four traffic patterns over BytePS sessions
("exactly MoE-style all-to-all building blocks", SURVEY §2.9).  Here each
pattern is one engine op over the ranks of a device group, optionally
driven by several host threads (``BENCHMARK_NTHREAD``) to stress the
dispatch path:

- ``dense``        reduce: ``CollectiveEngine.push_pull`` (K4
                   ``ring_push_pull`` under ``PS_ICI_IMPL=pallas``, the
                   rank-order adds under the default ``torch`` impl)
- ``gather``       every rank materializes all ranks' blocks
                   (``CollectiveEngine.pull``: no kernel, as JAX's
                   all_gather is no Pallas kernel)
- ``scatter``      cross-worker reduction to owner shards
                   (``CollectiveEngine.push``: K4 ``ring_push``)
- ``datascatter``  sparse rows routed to owner shards
                   (``SparseEngine.push``: S1)

The gradients are built once on the group's device (JAX's
``device_put`` of ones; its datascatter pushes host arrays each
iteration, which the port's engine would copy in every call).

Usage (single process drives the whole group; one rank per card, or
``--ranks N`` virtual ranks on ``--device``)::

    python -m pslite_tpu_torch.stress --len 30720000 --repeat 5 --threads 2
    python -m pslite_tpu_torch.stress --ranks 8 --device cuda:0
    python -m pslite_tpu_torch.stress --ranks 8 --device cpu --len 65536
"""

from __future__ import annotations

import argparse
import os
import threading

import numpy as np

PATTERNS = ("dense", "gather", "scatter", "datascatter")


def run_pattern(engine, sparse_engine, pattern: str, size_bytes: int,
                iters: int, measure=None) -> float:
    """Returns application goodput in Gbps for the pattern.

    ``measure(loop) -> seconds | None`` swaps the clock (e.g. the
    device-busy seconds of a ``torch.profiler`` trace read by
    ``utils/xplane.py``); returns 0.0 when that basis is unavailable."""
    import torch

    from .utils.profiling import clocked

    W = engine.num_shards
    n = max(size_bytes // 4, W)
    name = f"stress_{pattern}_{size_bytes}"

    def timed(loop):
        # None (basis unavailable) maps to goodput 0.0 at the return
        # sites — never to a fake elapsed time, which would turn into
        # an astronomically large published goodput.
        return clocked(loop, measure)

    if pattern == "datascatter":
        dim = 128
        rows = max(n // dim, W)
        table = f"{name}_tbl"
        if table not in sparse_engine._tables:
            sparse_engine.register_sparse(table, rows, dim)
        batch = max(rows // W, 1)
        idx = torch.as_tensor(np.random.default_rng(0).integers(
            0, rows, size=(W, batch)
        ).astype(np.int32), device=sparse_engine.device)
        grads = torch.ones((W, batch, dim), dtype=torch.float32,
                           device=sparse_engine.device)
        sparse_engine.push(table, idx, grads)  # warm
        sparse_engine.block(table)

        def loop():
            for _ in range(iters):
                sparse_engine.push(table, idx, grads)
            sparse_engine.block(table)

        elapsed = timed(loop)
        if not elapsed:
            return 0.0
        moved = 4 * W * batch * dim * iters
        return 8.0 * moved / (elapsed * 1e9)

    if name not in engine._buckets:
        engine.register_dense(name, np.arange(1, dtype=np.uint64), n)
    bucket = engine.bucket(name)
    grads = torch.ones((W, bucket.padded_len), dtype=torch.float32,
                       device=engine.device)

    ops = {
        "dense": lambda: engine.push_pull(name, grads),
        "gather": lambda: engine.pull(name),
        "scatter": lambda: engine.push(name, grads),
    }
    op = ops[pattern]
    op()  # warm / first use
    engine.block(name)

    def loop():
        for _ in range(iters):
            op()
        engine.block(name)

    elapsed = timed(loop)
    if not elapsed:
        return 0.0
    per_iter = n * 4 * (2 if pattern == "dense" else 1)
    return 8.0 * per_iter * iters / (elapsed * 1e9)


def make_group(ranks=None, device=None):
    """The stress group: ``default_group()`` (one rank per card, as JAX's
    default mesh has one device per chip) unless ``ranks`` or ``device``
    is given, then ``ranks`` virtual ranks (default: one per card, or 1
    on the CPU) on ``device`` (default ``cuda:0``).  Raises without a
    card unless the CPU is asked for."""
    import torch

    from .parallel.mesh import DeviceGroup, default_group, resolve_device

    if ranks is None and device is None:
        return default_group()
    dev = resolve_device(device or "cuda:0")
    if ranks is None:
        ranks = torch.cuda.device_count() if dev.type == "cuda" else 1
    return DeviceGroup(int(ranks), device=dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--len", type=int, default=30_720_000,
                    help="bytes per tensor (stress default 30720000)")
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("--threads", type=int,
                    default=int(os.environ.get("BENCHMARK_NTHREAD", "1")))
    ap.add_argument("--patterns", nargs="*", default=list(PATTERNS))
    ap.add_argument("--ranks", type=int, default=None,
                    help="virtual ranks on --device (default: one per "
                         "card)")
    ap.add_argument("--device", default=None,
                    help="torch device of every rank (default: the card; "
                         "'cpu' runs the plain PyTorch versions)")
    args = ap.parse_args(argv)

    from .parallel.engine import CollectiveEngine
    from .parallel.sparse import SparseEngine

    engine = CollectiveEngine(make_group(args.ranks, args.device))
    sparse = SparseEngine(engine.group, engine.axis)

    results = {}

    def drive(pattern):
        results[pattern] = run_pattern(
            engine, sparse, pattern, args.len, args.repeat
        )

    for pattern in args.patterns:
        if args.threads > 1 and pattern != "datascatter":
            # Concurrent host threads sharing one engine stress the
            # dispatch path (BENCHMARK_NTHREAD, test_benchmark.cc:535-549).
            threads = [
                threading.Thread(target=drive, args=(pattern,))
                for _ in range(args.threads)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        else:
            drive(pattern)
        print(f"{pattern}: {results[pattern]:.3f} Gbps", flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
