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
    Postoffice, make_group
from pslite_tpu_torch.environment import Environment
from pslite_tpu_torch.models import resnet_trace as trt
from pslite_tpu_torch.parallel.zero_copy import ZeroCopyHandle

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
    assert isinstance(out, ZeroCopyHandle)
    assert out.data_ptr() == teng._stores["zl"].data_ptr()
    np.testing.assert_array_equal(_np(out), _np(want))
    # The next op donates the store in JAX; here the handle goes stale.
    jeng.push("zl", seq[0])
    teng.push("zl", seq[0])
    assert want.is_deleted() and out.is_deleted()
    with pytest.raises(RuntimeError, match="'zl' is stale"):
        out.sum()
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
    assert out1.data_ptr() == teng._stores["zc"].data_ptr()
    want1 = jeng.push_pull("zc", g1, zero_copy=True)
    np.testing.assert_array_equal(_np(out1), _np(want1))
    out2 = teng.push_pull("zc", g2, zero_copy=True)
    want2 = jeng.push_pull("zc", g2, zero_copy=True)
    np.testing.assert_array_equal(_np(out2), _np(want2))
    # The JAX contract: the first result was donated into the second
    # step, so the stale holder is deleted and raises on use; the new one
    # aliases the store.
    assert want1.is_deleted() and out1.is_deleted()
    assert not out2.is_deleted()
    assert out2.data_ptr() == teng._stores["zc"].data_ptr()
    for use in (lambda t: t.numpy(), lambda t: t.tolist(),
                lambda t: t.cpu(), lambda t: t[0].item(), lambda t: t + 1,
                lambda t: torch.equal(t, out2), lambda t: t.data_ptr()):
        with pytest.raises(RuntimeError, match="'zc' is stale"):
            use(out1)
    assert teng.flat_zc_eligible() and not teng.flat_ring_eligible(
        torch.float32)


def test_push_pull_zero_copy_falls_back_on_several_ranks():
    jeng, teng = _pair()
    _register((jeng, teng), "zf", 2, 64)
    ones = np.ones((W, 128), np.float32)
    out1 = teng.push_pull("zf", ones, zero_copy=True)
    out2 = teng.push_pull("zf", ones, zero_copy=True)
    assert out1.data_ptr() != teng._stores["zf"].data_ptr()
    assert type(out1) is torch.Tensor and type(out2) is torch.Tensor
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
        assert got.data_ptr() == teng._stores["sz"].data_ptr()
        np.testing.assert_allclose(_np(got), _np(jeng.push_pull(
            "sz", g, zero_copy=True)), rtol=1e-5, atol=1e-6)


def test_pinned_pull_buffer_address_identity():
    jeng, teng = _pair()
    _register((jeng, teng), "pin0", 4, 64)
    buf = teng.register_pull_buffer("pin0")
    jbuf = jeng.register_pull_buffer("pin0")
    addr = buf.data_ptr()
    ones = np.ones(256, np.float32)
    for _ in range(2):
        jeng.push("pin0", ones)
        teng.push("pin0", ones)
        p = teng.pull("pin0")
        assert p.data_ptr() == addr
        assert teng.pinned_pull_buffer("pin0") is p
        np.testing.assert_array_equal(_np(p), _np(jeng.pull("pin0")))
    # The first pull donated the registered array, in both engines.
    assert jbuf.is_deleted() and buf.is_deleted()
    assert teng.pull("pin0").data_ptr() == addr
    teng.unregister_pull_buffer("pin0")
    fresh = teng.pull("pin0")
    assert fresh.data_ptr() != addr and fresh.shape == (256,)
    np.testing.assert_array_equal(_np(fresh), 16 * ones)


def test_pinned_pull_buffer_across_two_pulls():
    """Each pull returns a fresh handle on the registered memory; the
    previous one is stale (JAX: the next pull donates it)."""
    jeng, teng = _pair()
    _register((jeng, teng), "pin2", 2, 64)
    teng.register_pull_buffer("pin2")
    jeng.register_pull_buffer("pin2")
    g = np.random.default_rng(79).normal(size=(W, 128)).astype(np.float32)
    firsts = []
    for eng in (jeng, teng):
        eng.push("pin2", g)
        firsts.append(eng.pull("pin2"))
    np.testing.assert_array_equal(_np(firsts[1]), _np(firsts[0]))
    seconds = []
    for eng in (jeng, teng):
        eng.push("pin2", g)
        seconds.append(eng.pull("pin2"))
    np.testing.assert_array_equal(_np(seconds[1]), _np(seconds[0]))
    assert firsts[0].is_deleted() and firsts[1].is_deleted()
    assert not seconds[1].is_deleted()
    assert seconds[1].data_ptr() == teng._pinned_pulls["pin2"][0].data_ptr()
    with pytest.raises(RuntimeError, match="'pin2' is stale"):
        _np(firsts[1])
    # A push does not touch the registered buffer: its handle stays live.
    teng.push("pin2", g)
    assert not seconds[1].is_deleted()


@pytest.mark.parametrize("op", ["push", "push_pull", "replay", "group",
                                "set_store_array", "pull"])
def test_zero_copy_handle_goes_stale_on_mutating_ops(op):
    """Every op that replaces a bucket's store makes its zero-copy handle
    stale (the JAX engine deletes the array for push, push_pull, replay
    and the group, which donate the store; ``set_store_array`` does not
    donate there, but here the handle's memory is no longer the store);
    a pull leaves it live."""
    mesh1 = make_mesh((1,), ("kv",))
    jeng = JaxEngine(mesh1)
    teng = CollectiveEngine(DeviceGroup(1, device="cpu"))
    _register((jeng, teng), "m", 2, 64)
    _register((jeng, teng), "other", 1, 64)
    g = np.ones((1, 128), np.float32)
    outs = [eng.push_pull("m", g, zero_copy=True) for eng in (jeng, teng)]
    for eng in (jeng, teng):
        if op == "push":
            eng.push("m", g)
        elif op == "push_pull":
            eng.push_pull("m", g)
        elif op == "replay":
            eng.replay("m", np.ones((2, 1, 128), np.float32))
        elif op == "group":
            eng.push_pull_group(["other", "m"], [g[:, :64], g])
        elif op == "set_store_array":
            eng.set_store_array("m", np.zeros(128, np.float32))
        else:
            eng.pull("m")
    stale = op != "pull"
    assert outs[1].is_deleted() == stale
    if op != "set_store_array":
        assert outs[0].is_deleted() == stale
    if stale:
        with pytest.raises(RuntimeError, match="'m' is stale"):
            outs[1].numpy()
    else:
        np.testing.assert_array_equal(_np(outs[1]), np.ones(128))


def test_live_zero_copy_handle_is_a_copy_source():
    """A live handle feeds copies, views and KVWorker's completion copy
    into ``outs`` (numpy and tensor) like any tensor; what comes out is a
    plain tensor or array, valid after the handle goes stale."""
    teng = CollectiveEngine(DeviceGroup(1, device="cpu"))
    _register((teng,), "cs", 3, 10)
    g = np.arange(30, dtype=np.float32)[None]
    h = teng.push_pull("cs", g, zero_copy=True)
    dst = torch.empty(30).copy_(h)
    view = h.reshape(3, 10)
    outs_np = np.zeros(30, np.float32)
    outs_t = torch.zeros(30)
    KVWorker._engine_complete(h, None, outs_np, None)
    KVWorker._engine_complete(h, None, outs_t, None)
    assert type(dst) is torch.Tensor and type(view) is torch.Tensor
    teng.push_pull("cs", g, zero_copy=True)
    assert h.is_deleted()
    np.testing.assert_array_equal(dst.numpy(), g[0])
    np.testing.assert_array_equal(outs_np, g[0])
    np.testing.assert_array_equal(outs_t.numpy(), g[0])
    # The view shares the store's memory, which the next op updated.
    np.testing.assert_array_equal(view.reshape(-1).numpy(), 2 * g[0])
    # Handing the handle back as grads is fine while it is live.
    h2 = teng.push_pull("cs", np.zeros((1, 30), np.float32), zero_copy=True)
    h3 = teng.push_pull("cs", h2, zero_copy=True)
    np.testing.assert_array_equal(_np(h3), 4 * g[0])


@pytest.mark.parametrize("group,impl,handle", [
    ((8,), "xla", "sum"), ((8,), "pallas", "sum"),
    ((4, 2), "xla", "sum"), ((4, 2), "pallas", "adam:1e-3")])
def test_zero_copy_not_eligible_returns_a_copy(group, impl, handle):
    """Several kv shards (1-D, or the 2-D kv axis): zero_copy returns a
    fresh plain tensor, which the next op leaves as it was."""
    if len(group) == 1:
        teng = CollectiveEngine(DeviceGroup(group[0], device="cpu"),
                                impl=impl, server_handle=handle)
    else:
        teng = CollectiveEngine(make_group(group, ("dp", "kv"),
                                           device="cpu"),
                                worker_axis="dp", impl=impl,
                                server_handle=handle)
    _register((teng,), "nc", 2, 64)
    g = np.ones((teng.num_workers, 128), np.float32)
    out = teng.push_pull("nc", g, zero_copy=True)
    kept = out.clone()
    assert type(out) is torch.Tensor
    assert out.data_ptr() != teng._stores["nc"].data_ptr()
    teng.push_pull("nc", g, zero_copy=True)
    assert torch.equal(out, kept)
    last = teng.replay("nc", np.ones((2, 128), np.float32), keep="last",
                       zero_copy=True)
    assert type(last) is torch.Tensor


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
    addr = worker.register_pull_buffer("b").data_ptr()
    outs = np.zeros(15, np.float32)
    for k in range(1, 3):
        worker.wait(worker.push(keys, np.ones(15, np.float32)))
        ts = worker.pull(keys, outs)
        worker.wait(ts)
        np.testing.assert_array_equal(outs, np.full(15, 8.0 * k))
        assert worker.get_pulled(ts) is None  # not kept: overwritten next
        assert worker.engine.pinned_pull_buffer("b").data_ptr() == addr
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
