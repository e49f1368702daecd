"""The port's elastic tier and composite kv axes against the JAX engine.

Each test runs the same recut in both packages on the same numpy grads:
the JAX engines on the 8-device CPU mesh of tests/conftest.py (the ring
in interpret mode), the port's on CPU device groups.  Sums are held bit
for bit (the rank-order adds of the torch path, the TPU ring's order of
addition on the ring); the optimizers within rtol 1e-5 / atol 1e-6, as
XLA's CPU backend contracts their multiply-adds into FMAs and eager
PyTorch does not.  A recut moves data and nothing else, so the port's
state after a reshard is also held bit for bit against its own state
before it.

The composite kv axis ``("kv1", "kv2")`` with a worker axis is the 2-D
layout with B = kv1 x kv2 shards: the port's composite results equal its
``(dp, kv = kv1 x kv2)`` results bit for bit, and JAX's interpret-mode
ring on the (2, 2, 2) torus at tests/test_engine.py:966-992's shapes.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from pslite_tpu.parallel.engine import CollectiveEngine as JaxEngine
from pslite_tpu.parallel.mesh import make_mesh
from pslite_tpu.parallel.sparse import SparseEngine as JaxSparse
from pslite_tpu.utils.logging import CheckError as JaxCheckError
from pslite_tpu_torch import CollectiveEngine, DeviceGroup, SparseEngine
from pslite_tpu_torch import make_group as _make_group
from pslite_tpu_torch.utils.logging import CheckError

TOL = dict(rtol=1e-5, atol=1e-6)


def _jmesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("kv",))


def _group(n):
    return DeviceGroup(n, device="cpu")


def make_group(shape, names):
    return _make_group(shape, names, device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _equal(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


def _pair(n, **kw):
    return JaxEngine(_jmesh(n), **kw), CollectiveEngine(_group(n), **kw)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_dense_shrink_then_grow(impl):
    jeng, teng = _pair(8, impl=impl)
    keys = np.arange(6, dtype=np.uint64)
    for eng in (jeng, teng):
        eng.register_dense("b", keys, 99)  # total 594: 600 on 8, 596 on 4
    rng = np.random.RandomState(0)
    g8 = rng.randn(8, 594).astype(np.float32)
    first = teng.push_pull("b", g8)
    _equal(first, jeng.push_pull("b", g8))
    np.testing.assert_allclose(_np(first), g8.sum(0), rtol=1e-5)

    for eng in (jeng, teng):
        eng.reshard(_jmesh(4) if eng is jeng else _group(4))
    assert teng.num_shards == teng.num_workers == 4
    assert teng.bucket("b").padded_len == 596
    _equal(teng.pull("b"), first)  # the recut moved data only
    _equal(teng.pull("b"), jeng.pull("b"))
    g4 = rng.randn(4, 594).astype(np.float32)
    _equal(teng.push_pull("b", g4), jeng.push_pull("b", g4))

    for eng in (jeng, teng):
        eng.reshard(_jmesh(8) if eng is jeng else _group(8))
    assert teng.bucket("b").padded_len == 600
    _equal(teng.pull("b"), jeng.pull("b"))
    _equal(teng.push_pull("b", g8), jeng.push_pull("b", g8))


def test_dense_opt_state_survives():
    jeng, teng = _pair(8, server_handle="sgd_momentum:0.1,0.9")
    keys = np.arange(4, dtype=np.uint64)
    for eng in (jeng, teng):
        eng.register_dense("m", keys, 64)
    g = np.ones((8, 256), np.float32)
    np.testing.assert_allclose(_np(teng.push_pull("m", g)),
                               _np(jeng.push_pull("m", g)), **TOL)
    mom = teng.opt_state("m")[1][0]
    for eng in (jeng, teng):
        eng.reshard(_jmesh(4) if eng is jeng else _group(4))
    _equal(teng.opt_state("m")[1][0], mom)
    g4 = np.ones((4, 256), np.float32)
    np.testing.assert_allclose(_np(teng.push_pull("m", g4)),
                               _np(jeng.push_pull("m", g4)), **TOL)
    kind, state = teng.opt_state("m")
    jkind, jstate = jeng.opt_state("m")
    assert kind == jkind == "sgd_momentum"
    assert tuple(state[0].shape) == tuple(jstate[0].shape) == (256,)
    np.testing.assert_allclose(_np(state[0]), _np(jstate[0]), **TOL)


def test_dense_adam_step_counter_survives():
    jeng, teng = _pair(4, server_handle="adam")
    keys = np.arange(2, dtype=np.uint64)
    for eng in (jeng, teng):
        eng.register_dense("a", keys, 64)
        eng.push_pull("a", np.ones((4, 128), np.float32))
    for eng in (jeng, teng):
        eng.reshard(make_mesh((2,), ("kv",)) if eng is jeng else _group(2))
        kind, state = eng.opt_state("a")
        assert kind == "adam" and tuple(state[2].shape) == (2,)
        np.testing.assert_array_equal(_np(state[2]), 1.0)
        eng.push_pull("a", np.ones((2, 128), np.float32))
        np.testing.assert_array_equal(_np(eng.opt_state("a")[1][2]), 2.0)
    for x, y in zip(teng.opt_state("a")[1], jeng.opt_state("a")[1]):
        np.testing.assert_allclose(_np(x), _np(y), **TOL)
    np.testing.assert_allclose(_np(teng.pull("a")), _np(jeng.pull("a")),
                               **TOL)


def test_sparse_reshard_preserves_rows():
    jse, tse = JaxSparse(_jmesh(8)), SparseEngine(_group(8))
    rows, dim = 37, 8  # divisible by neither shard count
    init = np.arange(rows * dim, dtype=np.float32).reshape(rows, dim)
    idx = np.array([0, 5, 17, 36], dtype=np.int32)
    for se in (jse, tse):
        se.register_sparse("t", rows, dim, init=init)
    _equal(tse.pull("t", np.broadcast_to(idx, (8, 4)))[0], init[idx])
    for se in (jse, tse):
        se.reshard(_jmesh(4) if se is jse else _group(4))
    assert tse.num_shards == 4
    assert tse.table("t").rows_per_shard == jse.table("t").rows_per_shard
    _equal(tse.store_array("t"), jse.store_array("t"))
    _equal(tse.pull("t", np.broadcast_to(idx, (4, 4)))[0], init[idx])
    grads = np.ones((4, 4, dim), np.float32)
    for se in (jse, tse):
        se.push("t", np.broadcast_to(idx, (4, 4)), grads)
    got = tse.pull("t", np.broadcast_to(idx, (4, 4)))
    _equal(got, jse.pull("t", np.broadcast_to(idx, (4, 4))))
    _equal(got[0], init[idx] + 4.0)


def test_reshard_rejects_2d_layout():
    jeng = JaxEngine(make_mesh((2, 4), ("dp", "kv")), worker_axis="dp")
    teng = CollectiveEngine(make_group((2, 4), ("dp", "kv")),
                            worker_axis="dp")
    teng.register_dense("b", np.arange(2, dtype=np.uint64), 8)
    with pytest.raises(JaxCheckError):
        jeng.reshard(_jmesh(4))
    with pytest.raises(CheckError, match="stays 2-D"):
        teng.reshard(_group(4))
    assert teng.num_shards == 4 and teng.bucket("b").padded_len == 16


def test_sparse_reshard_carries_adagrad_state():
    """Recutting a table mid-training recuts its accumulator: continued
    training on the new group matches a run that stayed there, and the
    JAX engine doing the same recut."""
    rng = np.random.default_rng(5)
    rows, dim = 19, 4
    init = rng.normal(size=(rows, dim)).astype(np.float32)
    idx8 = rng.integers(0, rows, size=(8, 3)).astype(np.int32)
    g8 = rng.normal(size=(8, 3, dim)).astype(np.float32)
    idx4, g4 = idx8[:4], g8[:4]
    all_idx = np.broadcast_to(np.arange(rows, dtype=np.int32), (4, rows))
    ref = SparseEngine(_group(4))
    ref.register_sparse("t", rows, dim, init=init)
    for _ in range(2):
        ref.push("t", idx4, g4, handle="row_adagrad:0.1")
    want = _np(ref.pull("t", all_idx))[0]

    jse, tse = JaxSparse(_jmesh(8)), SparseEngine(_group(8))
    z8 = np.concatenate([g4, np.zeros_like(g4)], axis=0)
    for se in (jse, tse):
        se.register_sparse("t", rows, dim, init=init)
        se.push("t", np.concatenate([idx4, idx4], axis=0), z8,
                handle="row_adagrad:0.1")
    acc = tse.acc_global_device("t")
    for se in (jse, tse):
        se.reshard(_jmesh(4) if se is jse else _group(4))
    _equal(tse.acc_global_device("t"), acc)
    np.testing.assert_allclose(_np(tse.acc_array("t")),
                               _np(jse.acc_array("t")), **TOL)
    for se in (jse, tse):
        se.push("t", idx4, g4, handle="row_adagrad:0.1")
    got = _np(tse.pull("t", all_idx))[0]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, _np(jse.pull("t", all_idx))[0], **TOL)


def test_dense_reshard_carries_adagrad_state():
    jeng, teng = _pair(8)
    keys = np.arange(2, dtype=np.uint64)
    init = np.linspace(0, 1, 2 * 64).astype(np.float32)
    for eng in (jeng, teng):
        eng.register_dense("p", keys, 64, init=init)
        eng.push_pull("p", np.ones((8, 128), np.float32), handle="adagrad:0.1")
    before = teng.opt_state("p")[1][0]
    for eng in (jeng, teng):
        eng.reshard(_jmesh(4) if eng is jeng else _group(4))
    kind, arrs = teng.opt_state("p")
    assert kind == "adagrad" and len(arrs) == 1
    _equal(arrs[0], before)
    g4 = np.ones((4, 128), np.float32)
    out = teng.push_pull("p", g4, handle="adagrad:0.1")
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(
        _np(out), _np(jeng.push_pull("p", g4, handle="adagrad:0.1")), **TOL)


def test_dense_2d_reshard_preserves_state():
    """A 2-D engine reshards onto another 2-D group: worker fan-in and
    shard count both recut, values kept, as in the JAX engine."""
    jeng = JaxEngine(make_mesh((2, 4), ("dp", "kv")), worker_axis="dp")
    teng = CollectiveEngine(make_group((2, 4), ("dp", "kv")),
                            worker_axis="dp")
    keys = np.arange(3, dtype=np.uint64)
    grads = np.tile(np.arange(120, dtype=np.float32), (2, 1))
    for eng in (jeng, teng):
        eng.register_dense("b2d", keys, 40)
    _equal(teng.push_pull("b2d", grads), jeng.push_pull("b2d", grads))
    jeng.reshard(make_mesh((4, 2), ("dp", "kv")))
    teng.reshard(make_group((4, 2), ("dp", "kv")))
    assert teng.num_workers == 4 and teng.num_shards == 2
    _equal(teng.pull("b2d"), 2 * np.arange(120))
    grads4 = np.tile(np.arange(120, dtype=np.float32), (4, 1))
    out = teng.push_pull("b2d", grads4)
    _equal(out, jeng.push_pull("b2d", grads4))
    _equal(out, 6 * np.arange(120))


# -- composite kv axes ---------------------------------------------------------

def _three(impl, **kw):
    """(JAX, port composite, port 2-D (dp 2, kv 4)) engines."""
    return (JaxEngine(make_mesh((2, 2, 2), ("dp", "kv1", "kv2")),
                      axis_name=("kv1", "kv2"), worker_axis="dp", impl=impl,
                      **kw),
            CollectiveEngine(make_group((2, 2, 2), ("dp", "kv1", "kv2")),
                             axis_name=("kv1", "kv2"), worker_axis="dp",
                             impl=impl, **kw),
            CollectiveEngine(make_group((2, 4), ("dp", "kv")),
                             worker_axis="dp", impl=impl, **kw))


def test_three_axis_torus_parity():
    """(dp, kv1, kv2): the ring's dp sub-rings over the 4 kv shards equal
    JAX's interpret-mode ring and the port's 2-D ring at B = 4, bit for
    bit, on the padding path (val_len 101, total 303)."""
    keys = np.arange(3, dtype=np.uint64)
    rng = np.random.default_rng(91)
    g = rng.normal(size=(2, 303)).astype(np.float32)
    for impl in ("xla", "pallas"):
        jeng, t3, t2 = _three(impl)
        assert t3.num_shards == 4 and t3.num_workers == 2
        assert t3._effective_impl(torch.float32, "sum") == (
            "ring" if impl == "pallas" else "torch")
        for eng in (jeng, t3, t2):
            eng.register_dense("t3", keys, 101)
        assert t3.bucket("t3").padded_len == 304
        out = t3.push_pull("t3", g)
        _equal(out, jeng.push_pull("t3", g))
        _equal(out, t2.push_pull("t3", g))
        _equal(t3.store_array("t3"), t2.store_array("t3"))
        np.testing.assert_allclose(_np(out), g.sum(0), rtol=1e-5, atol=1e-5)


def test_three_axis_torus_stateful_and_replay():
    """adam replay on the torus: JAX within the optimizers' bar, the
    port's 2-D engine bit for bit, and a 1-D port engine of 8 workers
    whose rows sum the same within rtol 2e-5 (the JAX test's bar)."""
    keys = np.arange(2, dtype=np.uint64)
    rng = np.random.default_rng(93)
    T = 3
    base = rng.normal(size=(T, 128)).astype(np.float32)
    seq3 = np.stack([np.stack([4 * b, 4 * b]) for b in base])
    seq1 = np.stack([np.stack([b] * 8) for b in base])
    jeng, t3, t2 = _three("xla", server_handle="adam:0.01")
    for eng in (jeng, t3, t2):
        eng.register_dense("r3", keys, 64)
    got = t3.replay("r3", seq3, keep="last")
    np.testing.assert_allclose(_np(got),
                               _np(jeng.replay("r3", seq3, keep="last")),
                               **TOL)
    _equal(got, t2.replay("r3", seq3, keep="last"))
    ref = CollectiveEngine(_group(8), server_handle="adam:0.01")
    ref.register_dense("r1", keys, 64)
    np.testing.assert_allclose(_np(got),
                               _np(ref.replay("r1", seq1, keep="last")),
                               rtol=2e-5, atol=2e-5)
    # Stateful single ops too.
    g = seq3[0]
    out = t3.push_pull("r3", g)
    np.testing.assert_allclose(_np(out), _np(jeng.push_pull("r3", g)), **TOL)
    _equal(out, t2.push_pull("r3", g))
    for x, y in zip(t3.opt_state("r3")[1], t2.opt_state("r3")[1]):
        _equal(x, y)


def test_composite_ring_ops_equal_2d():
    """Grouped ops, ring replay and the int8 ring (JAX's gate lets int8
    run wherever the 2-D sub-rings run) on the composite axis: bit for
    bit the port's 2-D results."""
    rng = np.random.default_rng(94)
    keys = np.arange(3, dtype=np.uint64)
    _, t3, t2 = _three("pallas")
    _, c3, c2 = _three("pallas", wire_compress="int8")
    for eng in (t3, t2, c3, c2):
        eng.register_dense("x", keys, 101)
        eng.register_dense("y", keys[:2], 64)
    gx = rng.normal(size=(2, 303)).astype(np.float32)
    gy = rng.normal(size=(2, 128)).astype(np.float32)
    for a, b in zip(t3.push_pull_group(["x", "y"], [gx, gy]),
                    t2.push_pull_group(["x", "y"], [gx, gy])):
        _equal(a, b)
    seq = rng.normal(size=(3, 2, 303)).astype(np.float32)
    _equal(t3.replay("x", seq), t2.replay("x", seq))
    assert c3._ring_compress(torch.float32)
    _equal(c3.push_pull("x", gx), c2.push_pull("x", gx))
    _equal(c3.store_array("x"), c2.store_array("x"))


def test_tuple_axis_without_worker_axis_colocated():
    """A composite kv axis without a worker axis: workers = shards = the
    product, and the ring gives way to the torch path."""
    jeng = JaxEngine(make_mesh((2, 4), ("kv1", "kv2")),
                     axis_name=("kv1", "kv2"), impl="pallas")
    teng = CollectiveEngine(make_group((2, 4), ("kv1", "kv2")),
                            axis_name=("kv1", "kv2"), impl="pallas")
    assert teng.num_shards == teng.num_workers == 8
    assert teng._effective_impl(torch.float32, "sum") == "torch"
    assert jeng._effective_impl(np.float32, "sum") == "xla"
    keys = np.arange(2, dtype=np.uint64)
    g = np.random.default_rng(95).normal(size=(8, 128)).astype(np.float32)
    for eng in (jeng, teng):
        eng.register_dense("c2", keys, 64)
    out = teng.push_pull("c2", g)
    _equal(out, jeng.push_pull("c2", g))
    np.testing.assert_allclose(_np(out), g.sum(0), rtol=1e-5)
    with pytest.raises(CheckError, match="explicit device group"):
        CollectiveEngine(axis_name=("kv1", "kv2"))


def test_three_axis_torus_reshard():
    """A (2, 2, 2)-torus engine reshards onto a (dp, kv) group and back
    without losing state, as the JAX engine does."""
    jeng, teng, _ = _three("xla")
    keys = np.arange(2, dtype=np.uint64)
    ones = np.ones((2, 128), np.float32)
    for eng in (jeng, teng):
        eng.register_dense("rs3", keys, 64)
        eng.push_pull("rs3", ones)
    jeng.reshard(make_mesh((2, 4), ("dp", "kv")), axis_name="kv")
    teng.reshard(make_group((2, 4), ("dp", "kv")), axis_name="kv")
    assert teng.num_shards == 4 and teng.axis == "kv"
    _equal(teng.pull("rs3"), jeng.pull("rs3"))
    _equal(teng.pull("rs3"), 2 * np.ones(128))
    jeng.reshard(make_mesh((2, 2, 2), ("dp", "kv1", "kv2")),
                 axis_name=("kv1", "kv2"))
    teng.reshard(make_group((2, 2, 2), ("dp", "kv1", "kv2")),
                 axis_name=["kv1", "kv2"])
    assert teng.num_shards == 4 and teng.axis == ("kv1", "kv2")
    out = teng.push_pull("rs3", ones)
    _equal(out, jeng.push_pull("rs3", ones))
    _equal(out, 4 * np.ones(128))


def test_one_dim_reshard_onto_a_composite_axis():
    """An 8-rank 1-D engine onto (dp, kv1, kv2) with the composite axis
    and no worker axis: 4 shards and 4 workers, as in the JAX engine."""
    jeng, teng = _pair(8, server_handle="adam:0.01")
    keys = np.arange(3, dtype=np.uint64)
    rng = np.random.default_rng(96)
    for eng in (jeng, teng):
        eng.register_dense("c", keys, 101)
    g8 = rng.normal(size=(8, 303)).astype(np.float32)
    np.testing.assert_allclose(_np(teng.push_pull("c", g8)),
                               _np(jeng.push_pull("c", g8)), **TOL)
    jeng.reshard(make_mesh((2, 2, 2), ("dp", "kv1", "kv2")),
                 axis_name=("kv1", "kv2"))
    teng.reshard(make_group((2, 2, 2), ("dp", "kv1", "kv2")),
                 axis_name=("kv1", "kv2"))
    assert (teng.num_shards, teng.num_workers) == (4, 4)
    assert (jeng.num_shards, jeng.num_workers) == (4, 4)
    g4 = rng.normal(size=(4, 303)).astype(np.float32)
    np.testing.assert_allclose(_np(teng.push_pull("c", g4)),
                               _np(jeng.push_pull("c", g4)), **TOL)


# -- handles, pull buffers, other devices ----------------------------------------

def test_zero_copy_handles_are_stale_after_reshard():
    """A zero-copy result and a registered pull buffer's handle taken
    before a reshard are stale after it (a use raises); the pull buffer
    is rebuilt at the new padded length."""
    teng = CollectiveEngine(_group(1))
    teng.register_dense("z", np.arange(3, dtype=np.uint64), 5)
    teng.register_dense("p", np.arange(2, dtype=np.uint64), 7)
    zc = teng.push_pull("z", np.ones(15, np.float32), zero_copy=True)
    assert not zc.is_deleted()
    teng.register_pull_buffer("p")
    teng.push("p", np.full(14, 2.0, np.float32))
    held = teng.pull("p")
    assert held.shape == (14,)
    teng.reshard(_group(4))
    assert zc.is_deleted() and held.is_deleted()
    with pytest.raises(RuntimeError, match="stale"):
        zc.sum()
    with pytest.raises(RuntimeError, match="stale"):
        held.numpy()
    fresh = teng.pull("p")
    assert fresh.shape == (16,) and teng.pinned_pull_buffer("p") is fresh
    _equal(fresh[:14], np.full(14, 2.0))
    _equal(teng.pull("z"), np.ones(15))


def test_reshard_staged_commits_nothing_until_commit():
    teng = CollectiveEngine(_group(8), server_handle="adam:0.01")
    teng.register_dense("a", np.arange(2, dtype=np.uint64), 64)
    teng.push_pull("a", np.ones((8, 128), np.float32))
    before = teng.store_array("a")
    with teng.reshard_staged(_group(2)) as commit:
        assert teng.num_shards == 8 and torch.equal(teng._stores["a"],
                                                    before)
        assert not teng._bucket_mu["a"].acquire(blocking=False)
    assert teng.num_shards == 8  # left without committing
    with teng.reshard_staged(_group(2)) as commit:
        commit()
    assert teng.num_shards == 2 and teng.opt_state("a")[1][2].shape == (2,)
    _equal(teng.pull("a"), before[:128])
