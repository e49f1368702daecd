"""pslite_tpu_torch's replay, zero-copy and registered pulls, host-origin
streams, the ResNet-50 trace and their KVWorker surfaces, against the JAX
package.

The port runs on CPU device groups (its plain versions); the JAX engine
on the virtual CPU mesh (ring kernels in interpret mode, on 4 devices
where the ring is scanned, to keep them cheap).  The same numpy inputs go
through both.

Tolerances: ``sum`` is bit-exact, on the ring (the TPU ring's order) and
on the torch path (rank-order sums); the optimizer handles agree within
rtol 1e-5 / atol 1e-6 (XLA contracts a*b + c into one FMA, eager PyTorch
does not).  A replay equals its sequential push_pulls bit for bit.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pslite_tpu.models import resnet_trace as jrt
from pslite_tpu.parallel.engine import CollectiveEngine as JaxEngine
from pslite_tpu.parallel.mesh import default_mesh, make_mesh
from pslite_tpu_torch import CollectiveEngine, DeviceGroup, KVWorker, \
    Postoffice
from pslite_tpu_torch.environment import Environment
from pslite_tpu_torch.models import resnet_trace as trt

W = 8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(n=W, handle="sum", impl="xla", **kw):
    """(JAX engine on an n-device mesh, port engine on n CPU ranks)."""
    mesh = default_mesh() if n == W else make_mesh((n,), ("kv",))
    return (JaxEngine(mesh, server_handle=handle, impl=impl, **kw),
            CollectiveEngine(DeviceGroup(n, device="cpu"),
                             server_handle=handle, impl=impl, **kw))


def _register(engines, name, keys, val_len, init=None):
    for eng in engines:
        eng.register_dense(name, np.arange(keys, dtype=np.uint64), val_len,
                           init=init)


# -- replay ---------------------------------------------------------------------

@pytest.mark.parametrize("keep", ["all", "last"])
def test_replay_matches_jax_torch_path(keep):
    """T = 4 steps of [T, W, total] grads (padded bucket), and the
    broadcast [T, total] form: equal to the JAX replay, and to the port's
    own sequential push_pulls."""
    jeng, teng = _pair()
    single = CollectiveEngine(DeviceGroup(W, device="cpu"))
    _register((jeng, teng, single), "rp", 3, 100)
    seq = np.random.default_rng(31).normal(size=(4, W, 300)).astype(
        np.float32)
    got = teng.replay("rp", seq, keep=keep)
    np.testing.assert_array_equal(_np(got),
                                  _np(jeng.replay("rp", seq, keep=keep)))
    steps = torch.stack([single.push_pull("rp", g) for g in seq])
    assert torch.equal(got, steps if keep == "all" else steps[-1])
    bseq = np.ones((5, 300), np.float32)
    np.testing.assert_array_equal(_np(teng.replay("rp", bseq, keep=keep)),
                                  _np(jeng.replay("rp", bseq, keep=keep)))
    assert (teng.push_bytes, teng.pull_bytes) == (jeng.push_bytes,
                                                  jeng.pull_bytes)


@pytest.mark.parametrize("keep", ["all", "last"])
def test_replay_ring_matches_jax(keep):
    """The scanned ring (keep="last": push-only steps, one pull at the
    end) on 4 ranks, T = 2, chunks shorter than the tile."""
    jeng, teng = _pair(4, impl="pallas")
    _register((jeng, teng), "rr", 2, 300)
    seq = np.random.default_rng(57).normal(size=(2, 4, 600)).astype(
        np.float32)
    np.testing.assert_array_equal(_np(teng.replay("rr", seq, keep=keep)),
                                  _np(jeng.replay("rr", seq, keep=keep)))
    np.testing.assert_array_equal(_np(teng.pull("rr")), _np(jeng.pull("rr")))


def test_replay_adam_matches_jax_and_sequential():
    init = np.linspace(0, 1, 128).astype(np.float32)
    jeng, teng = _pair(handle="adam:0.01")
    single = CollectiveEngine(DeviceGroup(W, device="cpu"),
                              server_handle="adam:0.01")
    _register((jeng, teng, single), "ra", 2, 64, init=init)
    seq = np.random.default_rng(33).normal(size=(3, W, 128)).astype(
        np.float32)
    got = teng.replay("ra", seq)
    np.testing.assert_allclose(_np(got), _np(jeng.replay("ra", seq)),
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(got, torch.stack([single.push_pull("ra", g)
                                         for g in seq]))
    kind, state = teng.opt_state("ra")
    assert kind == "adam" and float(state[2][0]) == 3.0


def test_replay_int8_configuration_runs_the_torch_path():
    """An int8-compressed configuration replays with exact rank-order
    sums, as the JAX engine does (its single ops keep the int8 ring)."""
    jeng, teng = _pair(impl="pallas", wire_compress="int8")
    _register((jeng, teng), "rc", 2, 4096)
    seq = np.random.default_rng(61).normal(size=(2, W, 8192)).astype(
        np.float32)
    assert not teng._replay_use_ring(torch.float32, "sum")
    np.testing.assert_array_equal(_np(teng.replay("rc", seq)),
                                  _np(jeng.replay("rc", seq)))


def test_replay_zero_copy_keep_last():
    mesh1 = make_mesh((1,), ("kv",))
    jeng = JaxEngine(mesh1)
    teng = CollectiveEngine(DeviceGroup(1, device="cpu"))
    _register((jeng, teng), "zl", 2, 64)
    seq = np.random.default_rng(77).normal(size=(4, 1, 128)).astype(
        np.float32)
    want = jeng.replay("zl", seq, keep="last", zero_copy=True)
    out = teng.replay("zl", seq, keep="last", zero_copy=True)
    assert out is teng._stores["zl"]
    np.testing.assert_array_equal(_np(out), _np(want))
    # Elsewhere the zero-copy request returns a fresh copy.
    _, t8 = _pair()
    _register((t8,), "zf", 2, 64)
    out8 = t8.replay("zf", np.ones((2, 128), np.float32), keep="last",
                     zero_copy=True)
    assert out8.data_ptr() != t8._stores["zf"].data_ptr()


def test_replay_rejects_bad_arguments():
    _, teng = _pair()
    _register((teng,), "rb", 2, 8)
    with pytest.raises(AssertionError, match="bad keep"):
        teng.replay("rb", np.ones((2, 16), np.float32), keep="first")
    with pytest.raises(AssertionError, match="bad worker dim"):
        teng.replay("rb", np.ones((2, 3, 16), np.float32))


# -- zero-copy and registered pulls -------------------------------------------

def test_push_pull_zero_copy_single_rank_aliases_the_store():
    mesh1 = make_mesh((1,), ("kv",))
    jeng = JaxEngine(mesh1)
    teng = CollectiveEngine(DeviceGroup(1, device="cpu"))
    _register((jeng, teng), "zc", 3, 100)
    rng = np.random.default_rng(71)
    g1, g2 = (rng.normal(size=(1, 300)).astype(np.float32) for _ in range(2))
    out1 = teng.push_pull("zc", g1, zero_copy=True)
    assert out1 is teng._stores["zc"]
    np.testing.assert_array_equal(_np(out1),
                                  _np(jeng.push_pull("zc", g1,
                                                     zero_copy=True)))
    out2 = teng.push_pull("zc", g2, zero_copy=True)
    np.testing.assert_array_equal(_np(out2),
                                  _np(jeng.push_pull("zc", g2,
                                                     zero_copy=True)))
    # The contract that differs from JAX: the stale holder is not deleted,
    # it shows the next op's values.
    assert out1 is out2 and torch.equal(out1, out2)
    assert teng.flat_zc_eligible() and not teng.flat_ring_eligible(
        torch.float32)


def test_push_pull_zero_copy_falls_back_on_several_ranks():
    jeng, teng = _pair()
    _register((jeng, teng), "zf", 2, 64)
    ones = np.ones((W, 128), np.float32)
    out1 = teng.push_pull("zf", ones, zero_copy=True)
    out2 = teng.push_pull("zf", ones, zero_copy=True)
    assert out1.data_ptr() != teng._stores["zf"].data_ptr()
    np.testing.assert_array_equal(_np(out1), 8 * np.ones(128))
    np.testing.assert_array_equal(_np(out2), 16 * np.ones(128))
    assert not teng._zc_pull_eligible(torch.float32, "sum")


def test_push_pull_zero_copy_stateful():
    mesh1 = make_mesh((1,), ("kv",))
    init = np.linspace(0, 1, 128).astype(np.float32)
    jeng = JaxEngine(mesh1, server_handle="adam:0.01")
    teng = CollectiveEngine(DeviceGroup(1, device="cpu"),
                            server_handle="adam:0.01")
    _register((jeng, teng), "sz", 2, 64, init=init)
    seq = np.random.default_rng(73).normal(size=(3, 1, 128)).astype(
        np.float32)
    for g in seq:
        got = teng.push_pull("sz", g, zero_copy=True)
        assert got is teng._stores["sz"]
        np.testing.assert_allclose(_np(got), _np(jeng.push_pull(
            "sz", g, zero_copy=True)), rtol=1e-5, atol=1e-6)


def test_pinned_pull_buffer_address_identity():
    jeng, teng = _pair()
    _register((jeng, teng), "pin0", 4, 64)
    buf = teng.register_pull_buffer("pin0")
    jeng.register_pull_buffer("pin0")
    ones = np.ones(256, np.float32)
    for _ in range(2):
        jeng.push("pin0", ones)
        teng.push("pin0", ones)
        p = teng.pull("pin0")
        assert p.data_ptr() == buf.data_ptr()
        assert teng.pinned_pull_buffer("pin0") is buf
        np.testing.assert_array_equal(_np(p), _np(jeng.pull("pin0")))
    assert teng.pull("pin0").data_ptr() == buf.data_ptr()
    teng.unregister_pull_buffer("pin0")
    fresh = teng.pull("pin0")
    assert fresh.data_ptr() != buf.data_ptr() and fresh.shape == (256,)
    np.testing.assert_array_equal(_np(fresh), 16 * ones)


def test_pinned_pull_padded_bucket():
    _, teng = _pair()
    _register((teng,), "pin1", 3, 33)  # total 99 -> padded 104
    teng.register_pull_buffer("pin1")
    base = np.arange(99, dtype=np.float32)
    teng.push("pin1", np.stack([base] * W))
    pulled = teng.pull("pin1")
    assert pulled.shape == (104,)
    np.testing.assert_array_equal(_np(pulled)[:99], 8 * base)


# -- host-origin streams -----------------------------------------------------------

def test_push_pull_stream_matches_sequential_and_jax():
    jeng, teng = _pair()
    _register((jeng, teng), "ps", 2, 100)
    seq = [np.random.default_rng(53 + t).normal(size=(W, 200)).astype(
        np.float32) for t in range(5)]
    want = [_np(o) for o in jeng.push_pull_stream("ps", iter(seq), depth=2)]
    got = [_np(o) for o in teng.push_pull_stream("ps", iter(seq), depth=2)]
    assert len(got) == 5
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # Closing early releases the stager: close() joins its thread.
    def stagers():
        return {t for t in threading.enumerate()
                if t.name == "engine-stager" and t.is_alive()}

    before = stagers()
    gen = teng.push_pull_stream("ps", iter(seq), depth=1)
    next(gen)
    assert stagers() - before
    gen.close()
    assert stagers() <= before


def test_push_pull_multi_stream_reraises_stager_errors():
    _, teng = _pair()
    _register((teng,), "a", 2, 8)

    def pairs():
        yield "a", np.ones((W, 16), np.float32)
        raise ValueError("bad source")

    gen = teng.push_pull_multi_stream(pairs(), depth=2)
    assert float(next(gen)[0]) == 8.0
    with pytest.raises(ValueError, match="bad source"):
        next(gen)
    with pytest.raises(KeyError):
        list(teng.push_pull_multi_stream(iter([("nope", np.ones(3))])))


def test_push_pull_stream_overlaps_staging():
    """The stager asks the source for item i+1 while the caller still
    holds item i (event order, not wall-time margins)."""
    _, teng = _pair()
    _register((teng,), "ov", 1, 1024)
    g = np.ones(1024, np.float32)
    pulled_at, done_at = [], []

    def source():
        for _ in range(4):
            pulled_at.append(time.perf_counter())
            yield g

    for out in teng.push_pull_stream("ov", source(), depth=2):
        _np(out)
        time.sleep(0.15)
        done_at.append(time.perf_counter())
    assert len(pulled_at) == len(done_at) == 4
    for i in range(3):
        assert pulled_at[i + 1] < done_at[i], f"no pipelining at step {i}"


# -- the ResNet-50 trace --------------------------------------------------------

def test_resnet_trace_sizes_match_jax():
    assert trt.resnet50_param_sizes() == jrt.resnet50_param_sizes()
    assert trt.total_params() == jrt.total_params() == 25_557_032
    for nbytes in (1 << 20, 4 << 20, 16 << 20):
        assert trt.make_buckets(nbytes) == jrt.make_buckets(nbytes)
    sizes = [n for _, n in trt.make_buckets()]
    assert (len(sizes), min(sizes), max(sizes)) == (36, 1024, 1 << 20)


def test_resnet_trace_replay_paths_run():
    """Grouped device grads and host-origin grads (serial and streamed)
    over 2 CPU ranks: every path moves the trace's bytes, and each
    bucket's store holds steps x 2 ranks x ones."""
    eng = CollectiveEngine(DeviceGroup(2, device="cpu"), impl="ring")
    for kw in (dict(grouped=True), dict(host_origin=True, overlap=False),
               dict(host_origin=True, overlap=True)):
        nbytes, dt = trt.replay(eng, steps=1, bucket_bytes=16 << 20, **kw)
        assert nbytes == 2 * 4 * 25_557_032 and dt > 0
        name, n = trt.make_buckets(16 << 20)[-1]
        np.testing.assert_array_equal(_np(eng.pull(name)),
                                      np.full(n, 4.0, np.float32))
    _, none = trt.replay(eng, steps=1, bucket_bytes=16 << 20,
                         measure=lambda loop: None)
    assert none is None


# -- KVWorker surfaces --------------------------------------------------------------

@pytest.fixture()
def worker():
    po = Postoffice("worker", env=Environment({"PS_ICI_IMPL": "xla"}))
    po.van.set_mesh(DeviceGroup(W, device="cpu"))
    po.start()
    w = KVWorker(0, 0, postoffice=po)
    yield w
    w.stop()
    po.finalize()


def test_worker_registered_pull_buffer(worker):
    keys = np.arange(3, dtype=np.uint64)
    worker.register_dense("b", keys, 5)
    buf = worker.register_pull_buffer("b")
    outs = np.zeros(15, np.float32)
    for k in range(1, 3):
        worker.wait(worker.push(keys, np.ones(15, np.float32)))
        ts = worker.pull(keys, outs)
        worker.wait(ts)
        np.testing.assert_array_equal(outs, np.full(15, 8.0 * k))
        assert worker.get_pulled(ts) is None  # not kept: overwritten next
        assert worker.engine.pinned_pull_buffer("b").data_ptr() == \
            buf.data_ptr()
    # Back-to-back pulls: each waits for the previous one to complete.
    tss = [worker.pull(keys, outs) for _ in range(3)]
    for ts in tss:
        worker.wait(ts)
    np.testing.assert_array_equal(outs, np.full(15, 16.0))


def test_worker_replay_stream_and_coalescer(worker):
    keys = np.arange(2, dtype=np.uint64)
    worker.register_dense("r", keys, 8)
    seq = np.ones((3, 16), np.float32)
    np.testing.assert_array_equal(_np(worker.replay("r", seq)),
                                  np.outer([8, 16, 24], np.ones(16)))
    outs = [_np(o) for o in worker.push_pull_stream("r", iter(seq))]
    np.testing.assert_array_equal(outs[-1], np.full(16, 48.0))
    worker.register_dense("s", keys + 10, 8)
    with worker.coalescer(window_us=100_000) as disp:
        ta = disp.push_pull("r", seq[0])
        tb = disp.push_pull("s", seq[0])
        np.testing.assert_array_equal(_np(ta.result()), np.full(16, 56.0))
        np.testing.assert_array_equal(_np(tb.result()), np.full(16, 8.0))
