"""Sparse embedding workload (BASELINE config 5): 1M keys, skewed access.

Counterpart of ``pslite_tpu/models/embedding.py``: Zipf-distributed row
access over a sharded embedding table, replayed as sparse push
(scatter-add aggregation) + pull through a :class:`SparseEngine`.
:func:`skewed_indices` is a numpy copy and gives the JAX package's
indices for the same seed.
"""

from __future__ import annotations

import time

import numpy as np


def skewed_indices(num_rows: int, workers: int, batch: int, seed: int = 0,
                   a: float = 1.2) -> np.ndarray:
    """[workers, batch] Zipf(a)-skewed row ids (hot-key heavy)."""
    rng = np.random.default_rng(seed)
    idx = rng.zipf(a, size=(workers, batch)).astype(np.int64)
    return ((idx - 1) % num_rows).astype(np.int32)


def replay(sparse_engine, num_rows: int = 1 << 20, dim: int = 64,
           batch: int = 4096, steps: int = 1, seed: int = 0,
           measure=None):
    """Push + pull of one Zipf batch per step, with host numpy grads of
    ones (copied to the device in each push), as the JAX package's
    replay.  ``measure(loop) -> seconds | None`` replaces the host clock
    (for example with CUDA events); None means that clock has no reading
    and is passed on.  Returns (bytes moved per step, seconds per
    step)."""
    name = f"emb_{num_rows}_{dim}"
    if name not in sparse_engine._tables:
        sparse_engine.register_sparse(name, num_rows, dim)
    W = sparse_engine.num_shards
    idx = skewed_indices(num_rows, W, batch, seed=seed)
    grads = np.ones((W, batch, dim), dtype=np.float32)

    sparse_engine.push(name, idx, grads)  # first touch: the kernel library
    sparse_engine.pull(name, idx)
    sparse_engine.block(name)

    def loop():
        for _ in range(steps):
            sparse_engine.push(name, idx, grads)
            sparse_engine.pull(name, idx)
        sparse_engine.block(name)

    if measure is not None:
        elapsed = measure(loop)
    else:
        t0 = time.perf_counter()
        loop()
        elapsed = time.perf_counter() - t0
    dt = elapsed / max(steps, 1) if elapsed is not None else None
    step_bytes = 2 * 4 * W * batch * dim  # push + pull payload
    return step_bytes, dt
