"""DLRM-style recommender: a sparse embedding and a dense MLP through
the PS, on PyTorch.

Counterpart of ``pslite_tpu/models/dlrm.py``.  Categorical features look
up rows of an embedding table sharded over the ranks (``SparseEngine``),
dense features feed an MLP whose parameters live in a dense bucket of a
``CollectiveEngine``.  One training step runs both PS cycles:

- the MLP: ``engine.pull``, then the mean gradient pushed as a broadcast
  ``[total]`` with handle ``sum`` (on a ``impl="ring"`` engine: K4's
  push-only ring, ``csrc/ring_push_pull.cu``);
- the rows: ``sparse_engine.pull`` (S3, ``gather_rows``), then their
  gradients scatter-added (S1, ``scatter_add``) or applied by the fused
  row-wise Adagrad handle (S2, ``row_adagrad:<lr>``)
  (``csrc/sparse_rows.cu``).

The serving helpers (``embedding_row`` ... ``serve_fanout_storm``) drive
the same table over the message-path PS, as JAX's do.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..utils import logging as log
from .ps_step import ravel_pytree
from .transformer import normal_init


@dataclass(frozen=True)
class DLRMConfig:
    num_rows: int = 1024  # embedding table rows (1M in the benchmark)
    emb_dim: int = 16
    num_cat: int = 4  # categorical features per example
    num_dense: int = 8  # dense features per example
    hidden: int = 64
    dtype: str = "float32"


def init_mlp(gen: torch.Generator, cfg: DLRMConfig, device="cpu"):
    """JAX's shapes and scales (``N(0, 1) * fan_in**-0.5``, biases zeros),
    drawn from ``gen``."""
    dt = getattr(torch, cfg.dtype)
    d_in = cfg.num_dense + cfg.num_cat * cfg.emb_dim

    return {
        "w1": normal_init(gen, (d_in, cfg.hidden), d_in ** -0.5, dt, device),
        "b1": torch.zeros((cfg.hidden,), dtype=dt, device=device),
        "w2": normal_init(gen, (cfg.hidden, 1), cfg.hidden ** -0.5, dt,
                          device),
        "b2": torch.zeros((1,), dtype=dt, device=device),
    }


def predict(mlp, emb_rows, dense_feats, cfg: DLRMConfig):
    """emb_rows [B, num_cat, emb_dim]; dense [B, num_dense] -> logits [B].
    The MLP runs in the params' dtype (no bfloat16 cast), as in JAX."""
    B = dense_feats.shape[0]
    x = torch.cat([dense_feats, emb_rows.reshape(B, -1)], dim=-1)
    h = torch.relu(x @ mlp["w1"] + mlp["b1"])
    return (h @ mlp["w2"] + mlp["b2"])[:, 0]


def make_train_step(cfg: DLRMConfig, engine, sparse_engine, lr: float = 0.1,
                    seed: int = 0, emb_optimizer: str = None):
    """Returns ``step(idx, dense, labels) -> loss`` driving both PS
    planes.  ``idx`` ``[W, B, num_cat]`` rows per worker, ``dense`` ``[W,
    B, num_dense]``, ``labels`` ``[W, B]`` in {0, 1} (numpy or tensors).
    ``emb_optimizer="row_adagrad"`` trains the table with the fused
    row-wise Adagrad handle instead of SGD scatter-add.  The MLP's
    initial params come from ``init_mlp`` of a generator seeded with
    ``seed``."""
    log.check(emb_optimizer in (None, "row_adagrad"),
              f"unknown emb_optimizer {emb_optimizer!r}")
    W = engine.num_shards
    dev = engine.device
    mlp0 = init_mlp(torch.Generator().manual_seed(seed), cfg, device=dev)
    flat0, unravel = ravel_pytree(mlp0)
    engine.register_dense("dlrm_mlp", np.arange(1, dtype=np.uint64),
                          int(flat0.numel()), dtype=flat0.dtype, init=flat0)
    sparse_engine.register_sparse("dlrm_emb", cfg.num_rows, cfg.emb_dim)

    def _grads(flat_mlp, emb_rows, dense, labels):
        flat = flat_mlp.detach().requires_grad_()
        rows = emb_rows.detach().requires_grad_()
        logits = predict(unravel(flat), rows,
                         dense.reshape(-1, cfg.num_dense), cfg)
        lbl = labels.reshape(-1).to(logits.dtype)
        # Sigmoid cross-entropy (CTR-style binary objective).
        loss = torch.mean(torch.clamp_min(logits, 0) - logits * lbl
                          + torch.log1p(torch.exp(-torch.abs(logits))))
        g_flat, g_rows = torch.autograd.grad(loss, (flat, rows))
        return loss.detach(), g_flat, g_rows

    def step(idx, dense, labels):
        idx = torch.as_tensor(idx, device=dev)
        B = idx.shape[1]
        # -- sparse pull: rows for every worker's batch --------------------
        flat_idx = idx.reshape(W, B * cfg.num_cat)
        rows = sparse_engine.pull("dlrm_emb", flat_idx)
        rows = rows.reshape(W * B, cfg.num_cat, cfg.emb_dim)
        # -- dense pull ------------------------------------------------------
        flat_mlp = engine.pull("dlrm_mlp")
        loss, g_flat, g_rows = _grads(
            flat_mlp, rows, torch.as_tensor(dense, device=dev),
            torch.as_tensor(labels, device=dev))
        # -- dense push: the broadcast push sums W copies, so pre-divide;
        # the handle is pinned whatever the engine's default.
        engine.push("dlrm_mlp", -lr * g_flat / W, handle="sum")
        # -- sparse push -----------------------------------------------------
        g_rows = g_rows.reshape(W, B * cfg.num_cat, cfg.emb_dim)
        if emb_optimizer == "row_adagrad":
            # Raw gradient: the handle applies -lr*G/(sqrt(acc)+eps).
            sparse_engine.push("dlrm_emb", flat_idx, g_rows,
                               handle=f"row_adagrad:{lr}")
        else:
            sparse_engine.push("dlrm_emb", flat_idx, -lr * g_rows)
        return loss

    return step


def embedding_row(cfg: DLRMConfig, row):
    """Deterministic embedding-row values (bit-exact serving checks):
    ``arange(emb_dim) * 1e-3 + float32(row) + 0.5`` in float32, ``[emb_dim]``
    for one row or ``[n, emb_dim]`` for an array of ``n`` rows."""
    base = np.arange(cfg.emb_dim, dtype=np.float32) * 1e-3
    rows = np.asarray(row).astype(np.float32)
    return (base + rows[..., None]) + np.float32(0.5)


def spread_row_keys(cfg: DLRMConfig):
    """Row -> PS key mapping that spreads the table uniformly over the
    u64 key space, and so over every server's key range (plain
    ``arange`` keys all land on server 0)."""
    stride = (1 << 64) // cfg.num_rows
    return np.arange(cfg.num_rows, dtype=np.uint64) * np.uint64(stride)


def push_embedding_table(worker, cfg: DLRMConfig, tenant=None,
                         spread: bool = False) -> None:
    """Publish the full deterministic table into the message-path PS
    store, one key per row of ``emb_dim`` floats (``spread=True``: on
    :func:`spread_row_keys`)."""
    keys = (spread_row_keys(cfg) if spread
            else np.arange(cfg.num_rows, dtype=np.uint64))
    vals = embedding_row(cfg, np.arange(cfg.num_rows)).reshape(-1)
    worker.wait(worker.push(keys, vals, tenant=tenant))


def serve_fanout_storm(worker, cfg: DLRMConfig, n_reqs: int,
                       fanout: int = 64, seed: int = 0, tenant=None,
                       check_every: int = 32):
    """The serving fan-out path: each request is ``fanout`` single-row
    Zipf lookups through ``KVWorker.multi_get`` over the spread key
    layout.  Returns per-request wall latencies (seconds); every
    ``check_every``-th request is checked bit for bit against
    :func:`embedding_row`."""
    row_keys = spread_row_keys(cfg)
    all_rows = serving_keys(cfg, n_reqs * fanout, seed)
    outs = [np.zeros(cfg.emb_dim, np.float32) for _ in range(fanout)]
    lats = []
    for i in range(n_reqs):
        rows = all_rows[i * fanout:(i + 1) * fanout]
        key_lists = [row_keys[int(r):int(r) + 1] for r in rows]
        t0 = time.perf_counter()
        handle = worker.multi_get(key_lists, outs=outs, tenant=tenant)
        handle.wait()
        lats.append(time.perf_counter() - t0)
        if check_every and i % check_every == 0:
            for j, r in enumerate(rows):
                log.check(
                    np.array_equal(outs[j], embedding_row(cfg, int(r))),
                    f"fan-out pull of row {r} returned wrong values")
    return lats


def serving_keys(cfg: DLRMConfig, n: int, seed: int = 0):
    """Zipf(1.5)-distributed row ids: the inference request stream."""
    rng = np.random.default_rng(seed)
    idx = rng.zipf(1.5, size=n).astype(np.int64)
    return ((idx - 1) % cfg.num_rows).astype(np.uint64)


def serve_embedding_storm(worker, cfg: DLRMConfig, n_pulls: int,
                          seed: int = 0, tenant=None, priority: int = 0,
                          check_every: int = 64):
    """``n_pulls`` single-row Zipf pulls over the message-path PS; returns
    per-pull wall latencies (seconds).  Every ``check_every``-th pull is
    checked bit for bit against :func:`embedding_row`, so a cache serving
    stale rows fails loudly."""
    keys = serving_keys(cfg, n_pulls, seed)
    out = np.zeros(cfg.emb_dim, np.float32)
    lats = []
    for i, row in enumerate(keys):
        kk = np.array([row], dtype=np.uint64)
        t0 = time.perf_counter()
        worker.wait(worker.pull(kk, out, priority=priority, tenant=tenant))
        lats.append(time.perf_counter() - t0)
        if check_every and i % check_every == 0:
            log.check(np.array_equal(out, embedding_row(cfg, int(row))),
                      f"serving pull of row {row} returned wrong values")
    return lats


def toy_batch(cfg: DLRMConfig, workers: int, batch: int, seed: int = 0):
    """Learnable toy CTR data: the label correlates with one row's use."""
    rng = np.random.default_rng(seed)
    idx = rng.zipf(1.5, size=(workers, batch, cfg.num_cat)).astype(np.int64)
    idx = (idx - 1) % cfg.num_rows
    dense = rng.normal(size=(workers, batch, cfg.num_dense)).astype(
        np.float32)
    labels = ((idx[..., 0] % 2) ^ (dense[..., 0] > 0)).astype(np.int32)
    return idx.astype(np.int32), dense, labels
