"""pslite_tpu_torch's SparseEngine against the JAX SparseEngine.

The port runs on ``DeviceGroup(8, device="cpu")`` (the plain PyTorch
versions of its row kernels); the JAX engine on the 8-device virtual CPU
mesh.  The same numpy indices and rows go through both, and the port's
table layout is the JAX package's logical layout, so ``store_array`` and
``acc_array`` compare directly.

Tolerances: the sum push and the pull are bit-exact (``np.array_equal``),
f32 and bf16: XLA's CPU scatter adds a row's updates one after another in
list order, rounding to the table's dtype after each add, and so does the
port.  Row-wise Adagrad sums G*G over the row in another order than
XLA's reduction, so store and accumulator are held to rtol 1e-5 / atol
1e-6 (the dense optimizers' bar); groups equal singles exactly.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pslite_tpu import KVWorker as JaxKVWorker
from pslite_tpu import checkpoint as jckpt
from pslite_tpu.models.embedding import skewed_indices as jax_skewed
from pslite_tpu.parallel.engine import CollectiveEngine as JaxEngine
from pslite_tpu.parallel.mesh import default_mesh
from pslite_tpu.parallel.sparse import SparseEngine as JaxSparse
from pslite_tpu_torch import (CollectiveEngine, DeviceGroup, KVWorker,
                              Postoffice, SparseEngine)
from pslite_tpu_torch.convert import load_engine_npz
from pslite_tpu_torch.environment import Environment
from pslite_tpu_torch.models import embedding
from pslite_tpu_torch.ops import sparse_rows
from pslite_tpu_torch.parallel import sparse as tsparse

from helpers import LoopbackCluster

W = 8
ROWS = 37  # not a multiple of the 8 shards
# dim -> the JAX lane-packing factor that sets rows_per_shard
PACKS = {2: 64, 4: 32, 8: 16, 64: 2, 256: 1}


def _engines():
    return JaxSparse(default_mesh()), SparseEngine(DeviceGroup(W, device="cpu"))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _batch(rng, rows, n, dim, hot=3):
    """[W, n] indices with duplicates within and across workers and one
    row pushed by every worker twice, and [W, n, dim] rows."""
    idx = rng.integers(0, rows, size=(W, n)).astype(np.int32)
    idx[:, 0] = hot
    idx[:, n // 2] = hot
    g = (rng.normal(size=(W, n, dim)) * 3).astype(np.float32)
    return idx, g


@pytest.mark.parametrize("dim", sorted(PACKS))
def test_sparse_push_pull_bit_exact(dim):
    """Mirror of test_engine.py::test_sparse_push_pull: store and pulls
    equal JAX bit for bit, at every lane-packing factor."""
    jeng, teng = _engines()
    rng = np.random.default_rng(dim)
    init = rng.normal(size=(ROWS, dim)).astype(np.float32)
    jt = jeng.register_sparse("emb", ROWS, dim, init=init)
    tt = teng.register_sparse("emb", ROWS, dim, init=init)
    assert (tt.pack, tt.rows_per_shard) == (jt.pack, jt.rows_per_shard)
    assert tt.pack == PACKS[dim]
    for step in range(2):
        idx, g = _batch(rng, ROWS, 6, dim)
        jeng.push("emb", idx, g)
        tok = teng.push("emb", idx, g)
        assert tok.shape == (1, 1)
        np.testing.assert_array_equal(_np(teng.store_array("emb")),
                                      _np(jeng.store_array("emb")))
        np.testing.assert_array_equal(_np(teng.pull("emb", idx)),
                                      _np(jeng.pull("emb", idx)))
    # The unpacked store is the JAX package's packed store, reshaped.
    t = teng.table("emb")
    packed = tsparse._pack_host(teng.store_array("emb").numpy(),
                                t.rows_per_shard, W, t.pack, dim)
    assert packed.shape == (t.phys_rows * W, t.pack * dim)
    np.testing.assert_array_equal(
        tsparse._unpack_host(packed, t.rows_per_shard, W, t.pack, dim),
        _np(jeng.store_array("emb")))


def test_sparse_push_pull_bf16():
    """A bf16 table rounds to bf16 after each add, as XLA's CPU scatter
    does: bit-exact."""
    jeng, teng = _engines()
    rng = np.random.default_rng(5)
    init = rng.normal(size=(ROWS, 8)).astype(np.float32)
    jeng.register_sparse("b", ROWS, 8, dtype=jnp.bfloat16, init=init)
    teng.register_sparse("b", ROWS, 8, dtype=torch.bfloat16, init=init)
    idx, g = _batch(rng, ROWS, 10, 8)
    gb = g.astype(ml_dtypes.bfloat16)
    jeng.push("b", idx, gb)
    teng.push("b", idx, gb)
    assert teng.store_array("b").dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(teng.store_array("b")),
                                  _np(jeng.store_array("b")))
    np.testing.assert_array_equal(_np(teng.pull("b", idx)),
                                  _np(jeng.pull("b", idx)))


def test_sparse_pull_zero_init():
    _, teng = _engines()
    teng.register_sparse("z", 16, 2)
    out = teng.pull("z", np.zeros((W, 3), np.int32))
    assert tuple(out.shape) == (W, 3, 2)
    assert not out.any()


def _f64_adagrad(ref, acc, idx, g, lr, eps):
    G = np.zeros(ref.shape, np.float64)
    np.add.at(G, idx.reshape(-1), g.reshape(-1, ref.shape[1]))
    acc += np.mean(G ** 2, axis=1)
    denom = np.sqrt(acc)[:, None] + eps
    ref -= np.where(denom > eps, lr * G / denom, 0.0)


@pytest.mark.parametrize("dim", [4, 64])
def test_sparse_row_adagrad(dim):
    """Mirror of test_engine.py::test_sparse_row_adagrad: 3 steps with a
    hot row, against JAX (rtol 1e-5 / atol 1e-6) and against the float64
    host recurrence (the JAX test's bar, 1e-4)."""
    jeng, teng = _engines()
    rng = np.random.default_rng(11)
    rows, lr, eps = 23, 0.1, 1e-8
    init = rng.normal(size=(rows, dim)).astype(np.float32)
    jeng.register_sparse("emb", rows, dim, init=init)
    teng.register_sparse("emb", rows, dim, init=init)
    ref, acc = init.astype(np.float64), np.zeros(rows, np.float64)
    handle = f"row_adagrad:{lr},{eps}"
    for _ in range(3):
        idx, g = _batch(rng, rows, 5, dim, hot=7)
        jeng.push("emb", idx, g, handle=handle)
        teng.push("emb", idx, g, handle=handle)
        _f64_adagrad(ref, acc, idx, g, lr, eps)
        np.testing.assert_allclose(_np(teng.store_array("emb")),
                                   _np(jeng.store_array("emb")),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_np(teng.acc_array("emb")),
                                   _np(jeng.acc_array("emb")),
                                   rtol=1e-5, atol=1e-6)
    all_idx = np.tile(np.arange(rows, dtype=np.int32), (W, 1))
    np.testing.assert_allclose(_np(teng.pull("emb", all_idx))[0], ref,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(teng.acc_global_device("emb")), acc,
                               rtol=1e-4, atol=1e-4)
    snap = teng.acc_array("emb")
    teng.set_acc_array("emb", snap.numpy())
    assert torch.equal(teng.acc_array("emb"), snap)
    assert tuple(snap.shape) == (teng.table("emb").rows_per_shard * W,)


def test_sparse_adagrad_segment_sum_matches_dense_reference():
    """Mirror of test_engine.py::test_sparse_adagrad_segment_sum_matches_
    dense_reference: heavy collisions against the dense float64
    recurrence over global rows."""
    _, teng = _engines()
    rows, dim, lr, eps = 37, 4, 0.1, 1e-8
    rng = np.random.default_rng(101)
    teng.register_sparse("sa", rows, dim)
    assert teng.table("sa").pack == 32
    ref, acc = np.zeros((rows, dim)), np.zeros(rows)
    for _ in range(3):
        idx = rng.integers(0, rows, size=(W, 6)).astype(np.int32)
        idx[:, 0] = 5
        g = rng.normal(size=(W, 6, dim)).astype(np.float32)
        teng.push("sa", idx, g, handle=f"row_adagrad:{lr},{eps}")
        _f64_adagrad(ref, acc, idx, g, lr, eps)
    got = _np(teng.pull("sa", np.tile(np.arange(rows, dtype=np.int32),
                                      (W, 1))))[0]
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(teng.acc_global_device("sa")), acc,
                               rtol=1e-4, atol=1e-5)


def test_sparse_group_ops_match_single():
    """Mirror of test_engine.py::test_sparse_group_ops_match_single:
    push_group/pull_group over tables of different rows, dims and batches
    equal per-table push/pull with 0 differing elements, for the sum and
    row_adagrad handles; the JAX group agrees."""
    specs = {"a": (17, 4, 3), "b": (33, 8, 5), "c": (9, 2, 2)}
    rng = np.random.default_rng(21)
    grp = SparseEngine(DeviceGroup(W, device="cpu"))
    one = SparseEngine(DeviceGroup(W, device="cpu"))
    jgrp = JaxSparse(default_mesh())
    data = {}
    for n, (rows, dim, nb) in specs.items():
        init = rng.normal(size=(rows, dim)).astype(np.float32)
        for eng in (grp, one, jgrp):
            eng.register_sparse(n, rows, dim, init=init)
        data[n] = _batch(rng, rows, nb, dim, hot=1)
    names = list(specs)
    idxs = [data[n][0] for n in names]
    for handle in (None, "row_adagrad:0.1"):
        grp.push_group(names, idxs, [data[n][1] for n in names],
                       handle=handle)
        jgrp.push_group(names, idxs, [data[n][1] for n in names],
                        handle=handle)
        for n in names:
            one.push(n, *data[n], handle=handle)
        outs = grp.pull_group(names, idxs)
        jouts = jgrp.pull_group(names, idxs)
        for n, out, jout in zip(names, outs, jouts):
            assert torch.equal(out, one.pull(n, data[n][0])), n
            assert torch.equal(grp.store_array(n), one.store_array(n)), n
            if handle is None:
                np.testing.assert_array_equal(_np(out), _np(jout))
            else:
                assert torch.equal(grp.acc_array(n), one.acc_array(n)), n
                np.testing.assert_allclose(_np(out), _np(jout), rtol=1e-5,
                                           atol=1e-6)


def test_sparse_table_via_worker():
    """Mirror of test_ici_van.py::test_sparse_table_via_worker: through
    Postoffice + IciVan + KVWorker, with ``out=`` (numpy and tensor),
    callbacks and get_pulled; equal to the JAX worker's pulls."""
    idx = np.random.default_rng(3).integers(0, 64, size=(W, 5)).astype(
        np.int32)
    grads = np.random.default_rng(4).normal(size=(W, 5, 8)).astype(
        np.float32)
    c = LoopbackCluster(num_workers=1, num_servers=1, van_type="ici")
    c.start()
    try:
        jw = JaxKVWorker(0, 0, postoffice=c.workers[0])
        c.workers[0].van.sparse_engine.register_sparse("emb", 64, 8)
        jw.wait(jw.push_sparse("emb", idx, grads))
        want = np.zeros((W, 5, 8), np.float32)
        jw.wait(jw.pull_sparse("emb", idx, out=want))
    finally:
        c.finalize()

    po = Postoffice("worker", env=Environment({}))
    po.van.set_mesh(DeviceGroup(W, device="cpu"))
    po.start()
    worker = KVWorker(0, 0, postoffice=po)
    try:
        eng = po.van.sparse_engine
        assert isinstance(eng, SparseEngine) and eng is worker.sparse_engine
        assert eng.group is po.van.engine.group
        eng.register_sparse("emb", num_rows=64, dim=8)
        fired = []
        worker.wait(worker.push_sparse("emb", idx, grads,
                                       callback=lambda: fired.append(1)))
        out = np.zeros((W, 5, 8), np.float32)
        ts = worker.pull_sparse("emb", idx, out=out)
        worker.wait(ts)
        assert fired == [1]
        np.testing.assert_array_equal(out, want)
        assert torch.equal(worker.get_pulled(ts), torch.from_numpy(want))
        dst = torch.zeros(W, 5, 8)
        worker.wait(worker.pull_sparse("emb", idx, out=dst))
        assert torch.equal(dst, torch.from_numpy(want))
        # row_adagrad through the worker: the engine's own push, once more.
        ref = SparseEngine(DeviceGroup(W, device="cpu"))
        ref.register_sparse("emb", 64, 8)
        ref.push("emb", idx, grads)
        ref.push("emb", idx, grads, handle="row_adagrad:0.05")
        worker.wait(worker.push_sparse("emb", idx, grads,
                                       handle="row_adagrad:0.05"))
        assert torch.equal(eng.store_array("emb"), ref.store_array("emb"))
        assert eng.push_bytes == 2 * W * 5 * 8 * 4
        assert eng.pull_bytes == 2 * W * 5 * 8 * 4
    finally:
        worker.stop()
        po.finalize()


def test_embedding_skew_and_replay():
    """Mirror of test_workloads.py::test_embedding_skew_and_replay: the
    port's skewed_indices equals the JAX package's for the same seed."""
    for args in ((1000, 8, 256, 1), (1 << 20, 8, 4096, 0)):
        idx = embedding.skewed_indices(*args)
        np.testing.assert_array_equal(idx, jax_skewed(*args))
        assert idx.dtype == np.int32
    idx = embedding.skewed_indices(1000, 8, 256, seed=1)
    assert idx.min() >= 0 and idx.max() < 1000
    _, counts = np.unique(idx, return_counts=True)
    assert counts.max() > 10 * np.median(counts)

    eng = SparseEngine(DeviceGroup(W, device="cpu"))
    step_bytes, dt = embedding.replay(eng, num_rows=512, dim=8, batch=64,
                                      steps=2)
    assert step_bytes == 2 * 4 * 8 * 64 * 8
    assert dt > 0
    # 1 warm-up push + 2 steps of ones: each row holds 3x its hit count.
    idx = embedding.skewed_indices(512, W, 64)
    counts = np.bincount(idx.reshape(-1), minlength=512).astype(np.float32)
    got = eng.store_global_device("emb_512_8").numpy()
    np.testing.assert_array_equal(got, np.repeat(3 * counts[:, None], 8, 1))


def test_config5_widths_at_a_small_scale():
    """BASELINE config 5's widths (dim 64, Zipf(1.2) rows, 8 workers)
    with 4,096 rows and batches of 256: sum push and pull bit-exact with
    JAX, row_adagrad within its bar."""
    rows, dim, batch = 4096, 64, 256
    idx = embedding.skewed_indices(rows, W, batch, seed=0)
    _, counts = np.unique(idx, return_counts=True)
    assert counts.max() > 100  # a hot row with a long run
    g = np.random.default_rng(9).normal(size=(W, batch, dim)).astype(
        np.float32)
    for handle in (None, "row_adagrad:0.01,1e-8"):
        jeng, teng = _engines()
        jeng.register_sparse("e", rows, dim)
        teng.register_sparse("e", rows, dim)
        for _ in range(2):
            jeng.push("e", idx, g, handle=handle)
            teng.push("e", idx, g, handle=handle)
        got, want = _np(teng.store_array("e")), _np(jeng.store_array("e"))
        if handle is None:
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(_np(teng.pull("e", idx)),
                                          _np(jeng.pull("e", idx)))
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(_np(teng.acc_array("e")),
                                       _np(jeng.acc_array("e")),
                                       rtol=1e-5, atol=1e-6)


def test_out_of_range_indices_follow_the_port_rule():
    """An index is taken iff 0 <= i and i // S < rows_per_shard: with
    dim 256, 37 rows and 8 shards, rps = 5, so 39 lands in a padded row
    (flat row 7*5 + 4), while 40 (local row 5 — flat offset 5 would be
    shard 1's row 0) and -1 are dropped and pull zeros."""
    _, teng = _engines()
    t = teng.register_sparse("o", 37, 256)
    assert t.rows_per_shard == 5
    idx = np.zeros((W, 3), np.int32)
    idx[:, 0], idx[:, 1], idx[:, 2] = 39, 40, -1
    g = np.ones((W, 3, 256), np.float32)
    teng.push("o", idx, g)
    store = teng.store_array("o")
    assert torch.equal(store[7 * 5 + 4], torch.full((256,), float(W)))
    assert int((store != 0).any(1).sum()) == 1
    pulled = teng.pull("o", idx)
    assert torch.equal(pulled[:, 0], torch.full((W, 256), float(W)))
    assert not pulled[:, 1:].any()
    teng.push("o", idx, g, handle="row_adagrad:0.1")
    assert int((teng.acc_array("o") != 0).sum()) == 1
    assert not torch.equal(teng.store_array("o")[7 * 5 + 4], store[7 * 5 + 4])


def test_load_engine_npz_restores_sparse_tables(tmp_path):
    """A JAX save_engine npz with a sparse table and its accumulator
    (global row order, has_acc) restores through load_engine_npz into a
    port engine with another shard count; one more step each agrees."""
    jeng, jse = JaxEngine(default_mesh()), JaxSparse(default_mesh())
    rng = np.random.default_rng(31)
    jeng.register_dense("d", np.arange(4, dtype=np.uint64), 8)
    jse.register_sparse("s", ROWS, 4)
    jse.register_sparse("t", 20, 64)
    for _ in range(2):
        jse.push("s", *_batch(rng, ROWS, 4, 4), handle="row_adagrad:0.1")
    jse.push("t", *_batch(rng, 20, 4, 64))
    path = str(tmp_path / "ckpt.npz")
    jckpt.save_engine(jeng, path, sparse_engine=jse)

    group = DeviceGroup(4, device="cpu")
    teng, tse = CollectiveEngine(group), SparseEngine(group)
    teng.register_dense("d", np.arange(4, dtype=np.uint64), 8)
    tse.register_sparse("s", ROWS, 4)
    tse.register_sparse("t", 20, 64)
    load_engine_npz(teng, path, sparse_engine=tse)
    for name in ("s", "t"):
        np.testing.assert_array_equal(_np(tse.store_global_device(name)),
                                      _np(jse.store_global_device(name)))
    np.testing.assert_array_equal(_np(tse.acc_global_device("s")),
                                  _np(jse.acc_global_device("s")))
    with pytest.raises(AssertionError, match="no accumulator"):
        tse.acc_array("t")
    # One more row_adagrad step on each (JAX 8 workers, port 4: the same
    # 32 updates) agrees within the Adagrad bar.
    idx, g = _batch(rng, ROWS, 4, 4)
    jse.push("s", idx, g, handle="row_adagrad:0.1")
    tse.push("s", idx.reshape(4, 8), g.reshape(4, 8, 4),
             handle="row_adagrad:0.1")
    np.testing.assert_allclose(_np(tse.store_global_device("s")),
                               _np(jse.store_global_device("s")),
                               rtol=1e-5, atol=1e-6)
    # Without a sparse engine the sparse entries are not read.
    tse.set_store_array("t", torch.zeros(20, 64), global_rows=True)
    load_engine_npz(teng, path)
    assert not tse.store_array("t").any()


def test_store_and_acc_restore_layouts():
    """set_store_array / set_acc_array take the interleaved layout of
    store_array / acc_array, or global rows; JAX agrees on both."""
    jeng, teng = _engines()
    rng = np.random.default_rng(41)
    glob = rng.normal(size=(ROWS, 8)).astype(np.float32)
    acc = rng.random(ROWS).astype(np.float32)
    for eng in (jeng, teng):
        eng.register_sparse("r", ROWS, 8)
        eng.set_store_array("r", glob, global_rows=True)
        eng.ensure_acc("r")
        eng.set_acc_array("r", acc, global_rows=True)
    np.testing.assert_array_equal(_np(teng.store_array("r")),
                                  _np(jeng.store_array("r")))
    np.testing.assert_array_equal(_np(teng.acc_array("r")),
                                  _np(jeng.acc_array("r")))
    inter = teng.store_array("r")
    teng.set_store_array("r", torch.zeros_like(inter))
    teng.set_store_array("r", inter.numpy())
    assert torch.equal(teng.store_array("r"), inter)
    np.testing.assert_array_equal(teng.store_global_device("r").numpy(),
                                  glob)
    # The numpy layout helpers agree with the device layout.
    rps = teng.table("r").rows_per_shard
    np.testing.assert_array_equal(
        tsparse._interleave_rows(glob, ROWS, rps, W, np.float32),
        inter.numpy())
    np.testing.assert_array_equal(
        tsparse._deinterleave_rows(teng.acc_array("r").numpy(), ROWS, rps, W),
        acc)
    with pytest.raises(AssertionError, match="bad restore shape"):
        teng.set_store_array("r", glob)
    with pytest.raises(AssertionError, match="bad global-rows"):
        teng.set_acc_array("r", acc[:5], global_rows=True)


def test_not_ported_surfaces_raise():
    _, teng = _engines()
    teng.register_sparse("x", 8, 4)
    for call, item in ((lambda: teng.reshard(None), "item 7"),
                       (lambda: teng.reshard_staged(None), "item 7"),
                       (lambda: teng.store_raw("x"), "orbax"),
                       (lambda: teng.store_spec("x"), "orbax")):
        with pytest.raises(NotImplementedError, match=item):
            call()
    with pytest.raises(AssertionError, match="unknown sparse handle"):
        teng.push("x", np.zeros((W, 1), np.int32), np.zeros((W, 1, 4)),
                  handle="adam")
    with pytest.raises(AssertionError, match="bad worker dim"):
        teng.pull("x", np.zeros((3, 1), np.int32))
    with pytest.raises(AssertionError, match="float32 or bfloat16"):
        teng.register_sparse("h", 8, 4, dtype=torch.float16)


def test_wrappers_run_the_plain_versions_on_the_cpu():
    """On CPU tensors the wrappers run their plain versions and count no
    launch; the sum push equals a serial numpy loop."""
    sparse_rows.reset_launches()
    rng = np.random.default_rng(51)
    S, rps, dim = 4, 3, 5
    store = torch.from_numpy(rng.normal(size=(S * rps, dim)).astype(
        np.float32))
    idx = torch.from_numpy(rng.integers(-2, 14, size=(4, 7)).astype(np.int32))
    rows = torch.from_numpy(rng.normal(size=(4, 7, dim)).astype(np.float32))
    want = store.numpy().copy()
    for i, r in zip(idx.reshape(-1).tolist(), rows.reshape(-1, dim).numpy()):
        if i >= 0 and i // S < rps:
            want[(i % S) * rps + i // S] += r
    sparse_rows.scatter_add(store, idx, rows, S, rps)
    np.testing.assert_array_equal(store.numpy(), want)
    out = sparse_rows.gather_rows(store, idx, S, rps)
    flat = sparse_rows.target_rows(idx, S, rps)
    assert torch.equal(out[flat >= 0], store[flat[flat >= 0]])
    assert not out[flat < 0].any()
    acc = torch.zeros(S * rps)
    sparse_rows.row_adagrad(store, acc, idx, rows, S, rps, 0.1, 1e-8)
    assert int((acc != 0).sum()) == len(set(flat[flat >= 0].tolist()))
    assert all(v == 0 for v in sparse_rows.launches.values())
    with pytest.raises(AssertionError, match="int32"):
        sparse_rows.gather_rows(store, idx.long(), S, rps)
    with pytest.raises(AssertionError, match="num_shards"):
        sparse_rows.gather_rows(store, idx, S, rps + 1)
