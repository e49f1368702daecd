"""The int8 wire-compressed ring and the 2-D (dp, kv) data plane of
pslite_tpu_torch against the JAX package.

The port runs its plain PyTorch versions on CPU device groups; the JAX
ring kernels run in interpret mode on the 8-device virtual CPU mesh, as
tests/test_ring_collective.py and tests/test_engine.py run them.  The
same numpy inputs go through both.

Tolerances: bit-exact everywhere, except the 2-D ``sgd_momentum`` engine
(rtol 2e-5, the JAX test's own tolerance: XLA contracts the optimizer's
multiply-adds into FMAs and eager PyTorch does not).  The compressed ring
is bit-exact because the port re-quantizes with the same per-half-chunk
absmax scale (``amax * f32(1/127)``), emulates XLA's fused ``q*scale + g``
exactly, and splits chunks where the int8 tile puts the split.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from pslite_tpu import checkpoint as jckpt
from pslite_tpu.ops import ring_collective as jring
from pslite_tpu.parallel.engine import CollectiveEngine as JaxEngine
from pslite_tpu.parallel.mesh import make_mesh
from pslite_tpu.parallel.mesh import shard_map_compat as shard_map
from pslite_tpu_torch import (CollectiveEngine, DeviceGroup, KVWorker,
                              Postoffice, make_group)
from pslite_tpu_torch.convert import load_engine_npz
from pslite_tpu_torch.environment import Environment
from pslite_tpu_torch.ops import ring_collective as tring
from pslite_tpu_torch.utils.logging import CheckError


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# -- the compressed ring, op level ------------------------------------------------

def _jax_compressed_ring(n, bidir, with_ag, grads, store):
    chunk = grads.shape[1] // n
    fn = jring.ring_push_pull if with_ag else jring.ring_push

    def body(s, g):
        return fn(g[0].reshape(n, chunk), s, lambda s, a: s + a, "kv", n,
                  bidir=bidir, compress=True)

    f = jax.jit(shard_map(
        body, mesh=Mesh(np.array(jax.devices()[:n]), ("kv",)),
        in_specs=(P("kv"), P("kv", None)),
        out_specs=(P("kv"), P(None)) if with_ag else P("kv"),
    ))
    outs = f(jnp.asarray(store), jnp.asarray(grads))
    return [np.asarray(o) for o in (outs if with_ag else (outs,))]


# The cases of tests/test_ring_collective.py::test_ring_compressed (n = 8
# stalls the JAX interpreter), with and without the all-gather.
@pytest.mark.parametrize("n,bidir", [(2, False), (4, True)])
@pytest.mark.parametrize("with_ag", [True, False])
def test_compressed_ring_matches_jax(n, bidir, with_ag):
    chunk = jring.ring_chunk_len(n * 1024, n, bidir=bidir, compress=True)
    rng = np.random.RandomState(5)
    grads = rng.randn(n, n * chunk).astype(np.float32)
    store = rng.randn(n * chunk).astype(np.float32)
    want = _jax_compressed_ring(n, bidir, with_ag, grads, store)
    s = torch.from_numpy(store.copy())
    fn = tring.ring_push_pull if with_ag else tring.ring_push
    out = fn(torch.from_numpy(grads), s, "sum", bidir=bidir, compress=True)
    np.testing.assert_array_equal(s.numpy(), want[0])
    if with_ag:
        np.testing.assert_array_equal(out.numpy(), want[1])
        # The error bound of tests/test_ring_collective.py:172-177.
        exact = store + grads.sum(0)
        amax = np.abs(grads).max() * n + np.abs(store).max()
        assert np.abs(out.numpy() - exact).max() < 2 * n * amax / 127


def test_compressed_split_uses_the_int8_tile():
    """At the main path's shapes (8 ranks, 40 x 256,000 values) the
    compressed ring splits each chunk at 643,072, not at half of the f32
    tile-padded chunk (640,000)."""
    P_ = 40 * 256_000
    geo = tring.ring_geometry(8, P_, torch.float32, compress=True)
    assert (geo.sub, geo.split, geo.padded_sub) == (1_280_000, 643_072,
                                                    1_286_144)
    assert tring.ring_geometry(8, P_, torch.float32).split == 640_000
    # 2-D (dp=4, kv=2): kv shards of 5,120,000, sub-chunks of 1,280,000.
    geo = tring.ring_geometry(4, P_, torch.float32, kv_shards=2)
    assert (geo.period, geo.sub, geo.split) == (5_120_000, 1_280_000,
                                                640_000)


def test_compressed_ring_rejects_non_f32():
    g = torch.zeros(2, 2048, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        tring.ring_push_pull(g, torch.zeros(2048, dtype=torch.bfloat16),
                             compress=True)


def test_fma_emulation_rounds_once():
    """The plain version's fmaf differs from multiply-then-add exactly
    where one rounding differs from two."""
    a = torch.tensor([1 + 2.0 ** -12], dtype=torch.float32)
    c = torch.tensor([-(1 + 2.0 ** -11)], dtype=torch.float32)
    got = tring._fma_f32(a, a, c)
    assert float(got) == 2.0 ** -24  # (1+2^-12)^2 - (1+2^-11), exactly
    assert float(a * a + c) == 0.0
    x = torch.from_numpy(np.random.RandomState(0).randn(3, 1000)
                         .astype(np.float32))
    want = (x[0].double() * x[1].double() + x[2].double()).float()
    torch.testing.assert_close(tring._fma_f32(x[0], x[1], x[2]), want,
                               rtol=0, atol=0)


# -- the compressed 1-D engine -----------------------------------------------------

def test_compressed_engine_matches_jax():
    """n = 4, 2 keys x 500 (the kernel pads each chunk to the int8
    tile): push_pull, push and pull bit-exact; the store keeps full
    precision, so a pull differs from the last pulled values."""
    n = 4
    jeng = JaxEngine(mesh=Mesh(np.array(jax.devices()[:n]), ("kv",)),
                     impl="pallas", wire_compress="int8")
    teng = CollectiveEngine(DeviceGroup(n, device="cpu"), impl="pallas",
                            wire_compress="int8")
    keys = np.arange(2, dtype=np.uint64)
    for eng in (jeng, teng):
        eng.register_dense("c", keys, 500)
    rng = np.random.RandomState(6)
    g1 = rng.randn(n, 1000).astype(np.float32)
    g2 = rng.randn(n, 1000).astype(np.float32)
    p1 = teng.push_pull("c", g1)
    np.testing.assert_array_equal(_np(p1), _np(jeng.push_pull("c", g1)))
    np.testing.assert_array_equal(_np(teng.pull("c")), _np(jeng.pull("c")))
    assert not np.array_equal(_np(teng.pull("c")), _np(p1))
    jeng.push("c", g2)
    teng.push("c", g2)
    np.testing.assert_array_equal(_np(teng.pull("c")), _np(jeng.pull("c")))


def test_compression_applies_to_f32_ring_only(monkeypatch):
    monkeypatch.setenv("PS_ICI_COMPRESS", "int8")
    teng = CollectiveEngine(DeviceGroup(4, device="cpu"), impl="pallas")
    assert teng.wire_compress == "int8"
    assert teng._ring_compress(torch.float32)
    assert not teng._ring_compress(torch.bfloat16)
    # bf16 buckets and the torch impl run the uncompressed paths.
    keys = np.arange(2, dtype=np.uint64)
    g = np.random.RandomState(1).randn(4, 4096).astype(np.float32)
    plain = CollectiveEngine(DeviceGroup(4, device="cpu"), impl="pallas",
                             wire_compress="")
    assert plain.wire_compress is None
    for eng in (teng, plain):
        eng.register_dense("h", keys, 2048, dtype=torch.bfloat16)
    np.testing.assert_array_equal(_np(teng.push_pull("h", g)),
                                  _np(plain.push_pull("h", g)))
    xla = CollectiveEngine(DeviceGroup(4, device="cpu"), impl="xla")
    xla.register_dense("f", keys, 2048)
    np.testing.assert_array_equal(_np(xla.push_pull("f", g)), g.sum(0))
    with pytest.raises(CheckError, match="wire_compress"):
        CollectiveEngine(DeviceGroup(4, device="cpu"), wire_compress="fp4")


# -- the 2-D (dp, kv) engine ---------------------------------------------------------

def _engines_2d(shape, impl, handle="sum", compress=None):
    jeng = JaxEngine(mesh=make_mesh(shape, ("dp", "kv")), worker_axis="dp",
                     impl=impl, server_handle=handle,
                     wire_compress=compress)
    teng = CollectiveEngine(make_group(shape, ("dp", "kv"), device="cpu"),
                            worker_axis="dp", impl=impl,
                            server_handle=handle, wire_compress=compress)
    return jeng, teng


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_2d_engine_matches_jax(shape, impl):
    """tests/test_engine.py::test_two_axis_ring_kernel_matches_xla's
    inputs (val_len 700: padded, non-tile-aligned sub-chunks), bit-exact:
    push_pull, push, then pull."""
    jeng, teng = _engines_2d(shape, impl)
    assert (teng.num_workers, teng.num_shards) == shape
    keys = np.arange(3, dtype=np.uint64)
    for eng in (jeng, teng):
        eng.register_dense("b", keys, 700)
    assert jeng.bucket("b").padded_len == teng.bucket("b").padded_len
    rng = np.random.default_rng(41)
    g1 = rng.normal(size=(shape[0], 2100)).astype(np.float32)
    g2 = rng.normal(size=(shape[0], 2100)).astype(np.float32)
    np.testing.assert_array_equal(_np(teng.push_pull("b", g1)),
                                  _np(jeng.push_pull("b", g1)))
    jeng.push("b", g2)
    teng.push("b", g2)
    np.testing.assert_array_equal(_np(teng.pull("b")), _np(jeng.pull("b")))


def test_2d_ring_order_is_not_rank_order():
    """The sub-rings' order of addition differs from a rank-order sum."""
    g = torch.from_numpy(np.random.default_rng(41).normal(
        size=(4, 2100)).astype(np.float32))
    s = torch.zeros(2100)
    ring = tring.ring_push_pull(g, s, "sum", kv_shards=2)
    plain = g[0] + g[1] + g[2] + g[3]
    assert not torch.equal(ring, plain)
    torch.testing.assert_close(ring, plain, rtol=1e-5, atol=1e-5)


def test_2d_int8_engine_matches_jax():
    """tests/test_engine.py::test_two_axis_ring_kernel_int8_compress's
    inputs, bit-exact; on 2-D the store takes the pulled values."""
    jeng, teng = _engines_2d((2, 4), "pallas", compress="int8")
    keys = np.arange(2, dtype=np.uint64)
    for eng in (jeng, teng):
        eng.register_dense("c2", keys, 4096)
    grads = np.random.default_rng(43).normal(size=(2, 8192)).astype(
        np.float32)
    pulled = teng.push_pull("c2", grads)
    np.testing.assert_array_equal(_np(pulled),
                                  _np(jeng.push_pull("c2", grads)))
    np.testing.assert_array_equal(_np(teng.pull("c2")), _np(pulled))
    np.testing.assert_array_equal(_np(teng.pull("c2")),
                                  _np(jeng.pull("c2")))
    tol = 3 * np.abs(grads).max() / 127
    np.testing.assert_allclose(_np(pulled), grads.sum(0), atol=tol)


def test_2d_int8_push_leaves_the_push_pull_store():
    """A compressed 2-D push leaves the store a push_pull would."""
    teng = CollectiveEngine(make_group((2, 4), ("dp", "kv"), device="cpu"),
                            worker_axis="dp", impl="pallas",
                            wire_compress="int8")
    keys = np.arange(2, dtype=np.uint64)
    teng.register_dense("a", keys, 4096)
    teng.register_dense("b", keys, 4096)
    g = np.random.default_rng(44).normal(size=(2, 8192)).astype(np.float32)
    teng.push("a", g)
    pulled = teng.push_pull("b", g)
    np.testing.assert_array_equal(_np(teng.pull("a")), _np(pulled))


def test_2d_sgd_momentum_matches_jax():
    """tests/test_engine.py::test_two_axis_stateful_fused_handles on the
    pallas impl: rank-order sum over dp, then the fused optimizer."""
    handle = "sgd_momentum:0.1,0.9"
    jeng, teng = _engines_2d((2, 4), "pallas", handle=handle)
    keys = np.arange(3, dtype=np.uint64)
    init = np.linspace(1, 2, 300).astype(np.float32)
    for eng in (jeng, teng):
        eng.register_dense("st", keys, 100, init=init)
    rng = np.random.default_rng(47)
    for _ in range(3):
        g = rng.normal(size=(2, 300)).astype(np.float32)
        np.testing.assert_allclose(_np(teng.push_pull("st", g)),
                                   _np(jeng.push_pull("st", g)),
                                   rtol=2e-5, atol=2e-5)


def test_2d_group_validation():
    grp = make_group((2, 4), ("dp", "kv"), device="cpu")
    assert grp.shape == {"dp": 2, "kv": 4} and grp.num_ranks == 8
    with pytest.raises(CheckError, match="not in the device group"):
        CollectiveEngine(grp, worker_axis="wk")
    with pytest.raises(CheckError, match="must differ"):
        CollectiveEngine(grp, worker_axis="kv")
    with pytest.raises(ValueError, match="do not match"):
        make_group((2, 4), ("dp",), device="cpu")
    eng = CollectiveEngine(grp, worker_axis="dp")
    eng.register_dense("w", np.arange(2, dtype=np.uint64), 8)
    with pytest.raises(CheckError, match="bad worker dim"):
        eng.push_pull("w", np.ones((4, 16), np.float32))
    # One dp rank: no ring to run, the torch path serves it.
    one = CollectiveEngine(make_group((1, 4), ("dp", "kv"), device="cpu"),
                           worker_axis="dp", impl="pallas")
    assert one._effective_impl(torch.float32, "sum") == "torch"


def test_2d_engine_loads_a_jax_checkpoint(tmp_path):
    """load_engine_npz fills a 2-D engine from a 1-D JAX checkpoint;
    one more step each then agrees bit for bit."""
    src = JaxEngine(mesh=Mesh(np.array(jax.devices()[:8]), ("kv",)))
    keys = np.arange(3, dtype=np.uint64)
    src.register_dense("s", keys, 700)
    src.push_pull("s", np.random.default_rng(50).normal(
        size=(8, 2100)).astype(np.float32))
    path = str(tmp_path / "ckpt.npz")
    jckpt.save_engine(src, path)
    jeng, teng = _engines_2d((4, 2), "pallas")
    for eng in (jeng, teng):
        eng.register_dense("s", keys, 700)
    jckpt.restore_engine(jeng, path)
    load_engine_npz(teng, path)
    np.testing.assert_array_equal(_np(teng.pull("s")), _np(src.pull("s")))
    g = np.random.default_rng(51).normal(size=(4, 2100)).astype(np.float32)
    np.testing.assert_array_equal(_np(teng.push_pull("s", g)),
                                  _np(jeng.push_pull("s", g)))


# -- the worker API under PS_ICI_COMPRESS ------------------------------------------

def test_kvworker_compressed_matches_jax_engine(monkeypatch):
    """KVWorker with PS_ICI_IMPL=pallas and PS_ICI_COMPRESS=int8 (read
    from the process environment, as the JAX engine reads it)."""
    monkeypatch.setenv("PS_ICI_COMPRESS", "int8")
    n = 4
    jeng = JaxEngine(mesh=Mesh(np.array(jax.devices()[:n]), ("kv",)),
                     impl="pallas")
    assert jeng.wire_compress == "int8"
    po = Postoffice("worker", env=Environment({"PS_ICI_IMPL": "pallas"}))
    po.van.set_mesh(DeviceGroup(n, device="cpu"))
    po.start()
    worker = KVWorker(0, 0, postoffice=po)
    try:
        assert worker.engine.wire_compress == "int8"
        keys = np.arange(4, dtype=np.uint64)
        worker.register_dense("g", keys, 1024)
        jeng.register_dense("g", keys, 1024)
        g = np.random.RandomState(8).randn(n, 4096).astype(np.float32)
        outs = np.zeros(4096, np.float32)
        worker.wait(worker.push_pull(keys, g, outs))
        np.testing.assert_array_equal(outs, _np(jeng.push_pull("g", g)))
        worker.wait(worker.push(keys, g))
        jeng.push("g", g)
        worker.wait(worker.pull(keys, outs))
        np.testing.assert_array_equal(outs, _np(jeng.pull("g")))
    finally:
        worker.stop()
        po.finalize()
