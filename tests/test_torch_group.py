"""pslite_tpu_torch's grouped push_pull and coalescing dispatcher against
the JAX package.

The port runs on ``DeviceGroup(..., device="cpu")`` (the grouped ring's
plain version: each bucket's plain ring in turn); the JAX engine on the
8-device virtual CPU mesh, its ring kernels in interpret mode.  The same
numpy grads go through both.

Tolerances: ``sum`` is bit-exact on the ring (the TPU ring's order of
addition, per bucket) and on the torch path (rank-order sums), 1-D and
2-D.  The coalescer's tests mirror ``tests/test_coalesce.py``.
"""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pslite_tpu.parallel.engine import CollectiveEngine as JaxEngine
from pslite_tpu.parallel.mesh import default_mesh, make_mesh
from pslite_tpu_torch import CollectiveEngine, DeviceGroup, make_group
from pslite_tpu_torch.ops import ring_collective as ring
from pslite_tpu_torch.utils.logging import CheckError

W = 8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _register(engines, specs):
    for eng in engines:
        for name, keys, val_len in specs:
            eng.register_dense(name, np.arange(keys, dtype=np.uint64),
                               val_len)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_group_matches_jax_and_singles_1d(impl):
    """Odd bucket lengths (padded to the 8 ranks; on the ring, chunks
    shorter than the tile) against the JAX group, and against the port's
    own single push_pulls."""
    specs = [("g0", 3, 37), ("g1", 2, 300)]
    jeng = JaxEngine(default_mesh(), impl=impl)
    teng = CollectiveEngine(DeviceGroup(W, device="cpu"), impl=impl)
    single = CollectiveEngine(DeviceGroup(W, device="cpu"), impl=impl)
    _register((jeng, teng, single), specs)
    names = [n for n, _, _ in specs]
    rng = np.random.RandomState(17)
    # The interpret-mode JAX ring costs ~13 s per bucket and step.
    for _ in range(1 if impl == "pallas" else 2):
        grads = [rng.randn(W, k * v).astype(np.float32) for _, k, v in specs]
        want = jeng.push_pull_group(names, grads)
        got = teng.push_pull_group(names, grads)
        for n, g, a, b in zip(names, grads, got, want):
            assert a.shape == (teng.bucket(n).total_len,)
            np.testing.assert_array_equal(_np(a), _np(b))
            np.testing.assert_array_equal(_np(a),
                                          _np(single.push_pull(n, g)))
    assert (teng.push_bytes, teng.pull_bytes) == (jeng.push_bytes,
                                                  jeng.pull_bytes)


def test_group_int8_matches_jax_1d():
    """The int8 ring group of two small buckets on a 4-rank mesh, one
    step, against the JAX engine's group (interpret mode): bit-exact."""
    specs = [("i0", 2, 300), ("i1", 3, 37)]
    mesh = make_mesh((4,), ("kv",))
    jeng = JaxEngine(mesh, impl="pallas", wire_compress="int8")
    teng = CollectiveEngine(DeviceGroup(4, device="cpu"), impl="pallas",
                            wire_compress="int8")
    _register((jeng, teng), specs)
    names = [n for n, _, _ in specs]
    rng = np.random.default_rng(23)
    grads = [rng.normal(size=(4, k * v)).astype(np.float32)
             for _, k, v in specs]
    got = teng.push_pull_group(names, grads)
    want = jeng.push_pull_group(names, grads)
    for n, a, b in zip(names, got, want):
        assert a.shape == (teng.bucket(n).total_len,)
        np.testing.assert_array_equal(_np(a), _np(b))
        np.testing.assert_array_equal(_np(teng.pull(n)), _np(jeng.pull(n)))


def test_group_matches_jax_2d_torch_path():
    """A 2-D (dp=2, kv=4) group on the torch path, as
    test_engine.py::test_two_axis_push_pull_group builds it."""
    mesh = make_mesh((2, 4), ("dp", "kv"))
    jeng = JaxEngine(mesh=mesh, worker_axis="dp", impl="xla")
    teng = CollectiveEngine(make_group((2, 4), ("dp", "kv"), device="cpu"),
                            worker_axis="dp", impl="xla")
    specs = [(f"gb{i}", 2, v) for i, v in enumerate((40, 700, 256))]
    _register((jeng, teng), specs)
    rng = np.random.default_rng(51)
    grads = [rng.normal(size=(2, 2 * v)).astype(np.float32)
             for _, _, v in specs]
    names = [n for n, _, _ in specs]
    for a, b in zip(teng.push_pull_group(names, grads),
                    jeng.push_pull_group(names, grads)):
        np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("compress", [None, "int8"])
def test_group_2d_ring_equals_singles(compress):
    """2-D sub-rings (and their int8 form) in a group: the same bits as
    single push_pulls (the JAX 2-D ring parity is in
    test_torch_engine2d.py)."""
    engines = [CollectiveEngine(make_group((4, 2), ("dp", "kv"),
                                           device="cpu"),
                                worker_axis="dp", impl="ring",
                                wire_compress=compress) for _ in range(2)]
    specs = [("a", 3, 700), ("b", 1, 4096), ("c", 5, 9)]
    _register(engines, specs)
    rng = np.random.RandomState(3)
    grads = [rng.randn(4, k * v).astype(np.float32) for _, k, v in specs]
    names = [n for n, _, _ in specs]
    grouped = engines[0].push_pull_group(names, grads)
    for n, g, out in zip(names, grads, grouped):
        assert torch.equal(out, engines[1].push_pull(n, g))


def test_group_rejects_duplicates_and_stateful_handles():
    teng = CollectiveEngine(DeviceGroup(W, device="cpu"))
    _register((teng,), [("d", 2, 8)])
    g = np.ones((W, 16), np.float32)
    with pytest.raises(CheckError, match="duplicate"):
        teng.push_pull_group(["d", "d"], [g, g])
    with pytest.raises(CheckError, match="stateless"):
        teng.push_pull_group(["d"], [g], handle="adam:1e-3")
    with pytest.raises(CheckError, match="mismatch"):
        teng.push_pull_group(["d"], [g, g])


@pytest.mark.parametrize("compress", [False, True])
def test_group_plain_version_is_single_rings(compress):
    """On CPU tensors the grouped wrapper runs the plain ring per bucket
    (an empty bucket included) and launches nothing."""
    ring.reset_launches()
    gen = torch.Generator().manual_seed(4)
    sizes = (7, 0, 300, 1024)
    grads = [torch.randn(4, 4 * n, generator=gen) for n in sizes]
    stores = [torch.randn(4 * n, generator=gen) for n in sizes]
    s1 = [s.clone() for s in stores]
    outs = ring.ring_push_pull_group(grads, stores, "sum", compress=compress)
    for g, s, o, t in zip(grads, stores, outs, s1):
        assert torch.equal(o, ring.ring_push_pull_reference(
            g, t, "sum", compress=compress))
        assert torch.equal(s, t)
    assert sum(ring.launches.values()) == 0
    assert ring.ring_push_pull_group([], [], "sum") == []


# -- coalescer (tests/test_coalesce.py) -----------------------------------------

def _cengine(n_buckets=0, prefix="c", impl="ring"):
    eng = CollectiveEngine(DeviceGroup(W, device="cpu"), impl=impl)
    names = [f"{prefix}{i}" for i in range(n_buckets)]
    _register((eng,), [(n, 2, 64) for n in names])
    return eng, names


def _counting(eng):
    calls = []
    orig = eng.push_pull_group

    def counting(ns, gs, handle=None):
        calls.append(list(ns))
        return orig(ns, gs, handle=handle)

    eng.push_pull_group = counting
    return calls


def test_coalesced_matches_jax_per_op():
    """Concurrent tickets equal the JAX engine's single push_pulls (both
    on the rank-order path)."""
    eng, names = _cengine(6, impl="xla")
    jeng = JaxEngine(default_mesh(), impl="xla")
    _register((jeng,), [(n, 2, 64) for n in names])
    rng = np.random.default_rng(81)
    grads = {n: rng.normal(size=(8, 128)).astype(np.float32)
             for n in names}
    want = {n: _np(jeng.push_pull(n, grads[n])) for n in names}
    calls = _counting(eng)
    with eng.coalescer(window_us=200_000) as disp:
        tickets = {n: disp.push_pull(n, grads[n]) for n in names}
        for n in names:
            np.testing.assert_array_equal(_np(tickets[n].result()), want[n])
    assert calls == [names]


def test_coalescer_same_bucket_keeps_issue_order():
    eng, _ = _cengine()
    _register((eng,), [("dup", 2, 64)])
    ones = np.ones((8, 128), np.float32)
    with eng.coalescer(window_us=200_000) as disp:
        t1 = disp.push_pull("dup", ones)
        t2 = disp.push_pull("dup", 2 * ones)
        np.testing.assert_array_equal(_np(t1.result()), 8 * np.ones(128))
        np.testing.assert_array_equal(_np(t2.result()), 24 * np.ones(128))


def test_coalescer_concurrent_issuers():
    eng, names = _cengine(8, "t")
    results, errs = {}, []
    with eng.coalescer(window_us=1_000) as disp:
        def issue(n, scale):
            try:
                t = disp.push_pull(n, scale * np.ones((8, 128), np.float32))
                results[n] = _np(t.result())
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=issue, args=(n, i + 1))
                   for i, n in enumerate(names)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    assert not errs
    for i, n in enumerate(names):
        np.testing.assert_array_equal(results[n], 8 * (i + 1) * np.ones(128))


def test_coalescer_unknown_bucket_fails_only_its_ticket():
    eng, _ = _cengine()
    _register((eng,), [("good", 2, 64)])
    ones = np.ones((8, 128), np.float32)
    with eng.coalescer(window_us=200_000) as disp:
        t_bad = disp.push_pull("missing", ones)
        t_good = disp.push_pull("good", ones)
        np.testing.assert_array_equal(_np(t_good.result()), 8 * np.ones(128))
        with pytest.raises(KeyError):
            t_bad.result()


def test_coalescer_flush_close_and_window_of_one():
    """A window of one op runs as a single push_pull (no group); a lone
    op waits out a fixed window until result() flushes it; a closed
    dispatcher takes no ops; a stateful handle is refused."""
    eng, _ = _cengine()
    _register((eng,), [("solo", 2, 64)])
    calls = _counting(eng)
    with eng.coalescer(window_us=3_000_000, idle_us=0) as disp:
        t = disp.push_pull("solo", np.ones((8, 128), np.float32))
        assert not t.wait(timeout=0.3)
        np.testing.assert_array_equal(_np(t.result()), 8 * np.ones(128))
        disp.flush()  # nothing pending: a no-op
    assert calls == []
    with pytest.raises(CheckError, match="closed"):
        disp.push_pull("solo", np.ones((8, 128), np.float32))
    with pytest.raises(CheckError, match="stateless"):
        eng.coalescer(handle="adam:1e-3")
