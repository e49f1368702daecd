"""D1 and D2 (``pslite_tpu_torch/ops/reduce_update.py``) against the JAX
engine's XLA programs.

The JAX engine runs ``impl="xla"`` (``_program``, ``_group_program``,
``_stateful_program``) on the 8-device virtual CPU mesh; the port runs the
same numpy inputs on ``DeviceGroup(8, device="cpu")``, the 2-D ``(dp 4,
kv 2)`` group and a composite kv axis without ``worker_axis``, where the
wrappers take their plain versions.

Tolerances, as in tests/test_torch_engine.py: ``sum``, ``assign``, a
callable and the bf16 sum are bit-exact (rank-order adds in f32, one
rounding to the dtype); ``sgd`` rtol/atol 1e-6 and the optimizers rtol
1e-5 / atol 1e-6 (XLA's CPU backend contracts a*b + c into one FMA, eager
PyTorch does not); ``sgd`` on bf16 within 2^-7, relative and absolute,
two bf16 roundings of the values here (all of order 1): XLA rounds lr to
bf16 before the product, the port multiplies by the f32 lr (PyTorch's
rule for a Python scalar), so a product can round one way in one and the
other way in the other, and the difference rounds again.  Adam on
bf16, which the JAX Pallas kernel refuses, is held against float64 Adam as
``test_bf16_stateful_bucket_not_ported`` holds it.

The plain versions equal the engine's composition before D1/D2 (the
rank-order sum, the handle or K1-K3's plain versions, the copy) bit for
bit.  An emulated kernel behind a monkeypatched ``_native.call`` reads the
launch tables the wrappers build (segments, strides, row addresses,
constants, splits into several launches) from memory and applies them, so
the wrappers' side of every launch is checked here; the kernels' own bits
are held against the plain versions on the card (tests/test_torch_chip.py).
"""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pslite_tpu.parallel.engine import CollectiveEngine as JaxEngine
from pslite_tpu.parallel.mesh import default_mesh, make_mesh
from pslite_tpu_torch import CollectiveEngine, DeviceGroup, make_group
from pslite_tpu_torch.ops import _native
from pslite_tpu_torch.ops import fused_update as fu
from pslite_tpu_torch.ops import reduce_update as ru
from pslite_tpu_torch.utils.logging import CheckError

W = 8
KEYS, VAL_LEN = 4, 33  # 132 values: padded to 136 on the 8 ranks
_ON_CUDA = ru._on_cuda


def _half(s, a):
    return s * 0.5 + a


HANDLES = ["sum", "assign", "sgd:0.05", _half, "sgd_momentum:0.05,0.9",
           "adagrad:0.05", "adam:1e-2"]


def _engines(layout, handle):
    """(JAX engine, port engine, worker rows) of a layout."""
    if layout == "1d":
        return (JaxEngine(default_mesh(), server_handle=handle, impl="xla"),
                CollectiveEngine(DeviceGroup(W, device="cpu"),
                                 server_handle=handle, impl="xla"), W)
    if layout == "2d":
        return (JaxEngine(mesh=make_mesh((4, 2), ("dp", "kv")),
                          worker_axis="dp", server_handle=handle,
                          impl="xla"),
                CollectiveEngine(make_group((4, 2), ("dp", "kv"),
                                            device="cpu"),
                                 worker_axis="dp", server_handle=handle,
                                 impl="xla"), 4)
    axes = ("dp", "kv1", "kv2")
    return (JaxEngine(mesh=make_mesh((2, 2, 2), axes),
                      axis_name=("kv1", "kv2"), server_handle=handle,
                      impl="xla"),
            CollectiveEngine(make_group((2, 2, 2), axes, device="cpu"),
                             axis_name=("kv1", "kv2"), server_handle=handle,
                             impl="xla"), 4)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _check(got, want, handle, bf16):
    got, want = _np(got), _np(want)
    if callable(handle) or handle in ("sum", "assign"):
        np.testing.assert_array_equal(got, want)
    elif handle.startswith("sgd:"):
        tol = 2.0 ** -7 if bf16 else 1e-6
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _grads(seed, rows, dtype):
    g = np.random.RandomState(seed).randn(rows, KEYS * VAL_LEN).astype(
        np.float32)
    if dtype == "bfloat16":
        return (torch.from_numpy(g).to(torch.bfloat16),
                jnp.asarray(g, jnp.bfloat16))
    return g, g


@pytest.mark.parametrize("layout", ["1d", "2d", "composite"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("handle", HANDLES,
                         ids=lambda h: h if isinstance(h, str) else "callable")
def test_engine_matches_jax_xla(layout, dtype, handle):
    """push_pull, push_pull, push then pull; for an optimizer also its
    state.  Adam on bf16 is held against float64 Adam (JAX refuses it)."""
    if dtype == "bfloat16" and handle == "adam:1e-2":
        _bf16_adam_against_float64(layout)
        return
    jeng, teng, rows = _engines(layout, handle)
    keys = np.arange(KEYS, dtype=np.uint64)
    init = np.random.RandomState(9).randn(KEYS * VAL_LEN).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jeng.register_dense("b", keys, VAL_LEN, dtype=jdt, init=init)
    teng.register_dense("b", keys, VAL_LEN, dtype=getattr(torch, dtype),
                        init=init)
    assert teng._effective_impl(getattr(torch, dtype), handle) == "torch"
    bf16 = dtype == "bfloat16"
    for step in range(2):
        tg, jg = _grads(step, rows, dtype)
        _check(teng.push_pull("b", tg), jeng.push_pull("b", jg), handle,
               bf16)
    tg, jg = _grads(7, rows, dtype)
    teng.push("b", tg)
    jeng.push("b", jg)
    _check(teng.pull("b"), jeng.pull("b"), handle, bf16)
    if isinstance(handle, str) and teng._is_stateful(handle):
        (jkind, jstate), (tkind, tstate) = (jeng.opt_state("b"),
                                            teng.opt_state("b"))
        assert jkind == tkind
        for t, j in zip(tstate, jstate):
            _check(t, j, handle, bf16)


def _bf16_adam_against_float64(layout):
    _, teng, rows = _engines(layout, "adam:1e-3")
    teng.register_dense("h", np.arange(KEYS, dtype=np.uint64), VAL_LEN,
                        dtype=torch.bfloat16)
    n = KEYS * VAL_LEN
    s64, m64, v64 = np.zeros(n), np.zeros(n), np.zeros(n)
    for t in range(1, 4):
        g, _ = _grads(30 + t, rows, "bfloat16")
        out = teng.push_pull("h", g)
        assert out.dtype == torch.bfloat16
        agg = ru.rank_order_sum_reference(g).double().numpy()
        m64 = 0.9 * m64 + 0.1 * agg
        v64 = 0.999 * v64 + 0.001 * agg * agg
        alpha = 1e-3 * np.sqrt(1 - 0.999 ** t) / (1 - 0.9 ** t)
        s64 = s64 - alpha * m64 / (np.sqrt(v64) + 1e-8)
        err = np.abs(out.double().numpy() - s64)
        assert np.all(err <= 2.0 ** -6 * (np.abs(s64) + 1e-3 * t)), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("handle", ["sum", "sgd:0.05", _half],
                         ids=["sum", "sgd", "callable"])
def test_group_matches_jax_group_program(dtype, handle):
    """push_pull_group off the ring against JAX's _group_program: buckets
    of several sizes, one padded."""
    jeng, teng, _ = _engines("1d", "sum")
    sizes = [(3, 7), (1, 64), (5, 33), (2, 8)]
    names = [f"g{i}" for i in range(len(sizes))]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    for name, (k, v) in zip(names, sizes):
        jeng.register_dense(name, np.arange(k, dtype=np.uint64), v,
                            dtype=jdt)
        teng.register_dense(name, np.arange(k, dtype=np.uint64), v,
                            dtype=getattr(torch, dtype))
    rng = np.random.RandomState(3)
    for _ in range(2):
        gs = [rng.randn(W, k * v).astype(np.float32) for k, v in sizes]
        if dtype == "bfloat16":
            tg = [torch.from_numpy(g).to(torch.bfloat16) for g in gs]
            jg = [jnp.asarray(g, jnp.bfloat16) for g in gs]
        else:
            tg = jg = gs
        got = teng.push_pull_group(names, tg, handle=handle)
        want = jeng.push_pull_group(names, jg, handle=handle)
        for g_, w_ in zip(got, want):
            _check(g_, w_, handle, dtype == "bfloat16")


@pytest.mark.parametrize("keep", ["all", "last"])
@pytest.mark.parametrize("handle", ["sgd:0.05", "adagrad:0.05"])
def test_replay_matches_jax(keep, handle):
    """replay off the ring (T = 3 steps): the pulled rows of keep="all"
    written by each step's launch, against JAX's replay."""
    jeng, teng, _ = _engines("1d", handle)
    for eng in (jeng, teng):
        eng.register_dense("r", np.arange(KEYS, dtype=np.uint64), VAL_LEN)
    seq = np.random.RandomState(5).randn(3, W, KEYS * VAL_LEN).astype(
        np.float32)
    _check(teng.replay("r", seq, keep=keep), jeng.replay("r", seq,
                                                         keep=keep),
           handle, False)


# -- the plain versions ----------------------------------------------------------

def _old_sum(rows):
    """The engine's rank_order_sum before D1, as it was written."""
    acc = rows[0].to(torch.float32, copy=True)
    for w in range(1, len(rows)):
        acc += rows[w]
    return acc.to(rows[0].dtype)


def _inputs(rows, n, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    g = torch.randn((rows, n), generator=gen).to(dtype)
    store = torch.randn(n, generator=gen).to(dtype)
    return g, store


@pytest.mark.parametrize("rows", [1, 3, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("handle", ["sum", "assign", "sgd:0.05", "sgd"])
def test_apply_reference_is_the_old_composition(rows, dtype, handle):
    g, store = _inputs(rows, 1003, dtype)
    want = store.clone()
    agg = _old_sum(g)
    if handle == "sum":
        want.add_(agg)
    elif handle == "assign":
        want.copy_(agg)
    else:
        want.sub_((0.05 if ":" in handle else 0.01) * agg)
    got, pulled = store.clone(), torch.empty_like(store)
    ru.reduce_apply_reference(g, got, handle, pulled)
    assert torch.equal(got, want) and torch.equal(pulled, want)
    assert torch.equal(ru.rank_order_sum_reference(list(g)), agg)


@pytest.mark.parametrize("rows", [1, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ru.OPTIMIZERS)
def test_update_reference_is_the_old_composition(rows, dtype, kind):
    g, store = _inputs(rows, 1003, dtype, seed=1)
    gen = torch.Generator().manual_seed(2)
    state = tuple(torch.rand(1003, generator=gen).to(dtype) * 0.1
                  for _ in range(2 if kind == "adam" else 1))
    alpha = fu.adam_alpha(torch.tensor([3.0]), 1e-3)
    params = {"sgd_momentum": (0.05, 0.9), "adagrad": (0.05, 1e-8),
              "adam": (0.9, 0.999, 1e-8)}[kind]
    want, wstate = store.clone(), tuple(t.clone() for t in state)
    agg = _old_sum(g)
    if kind == "sgd_momentum":
        fu.sgd_update(want, wstate[0], agg, 0.05, 0.9)
    elif kind == "adagrad":
        fu.adagrad_update(want, wstate[0], agg, 0.05, 1e-8)
    else:
        fu.adam_update_with_alpha(want, *wstate, agg, alpha, 0.9, 0.999,
                                  1e-8)
    for fused in (False, True):
        got, gstate = store.clone(), tuple(t.clone() for t in state)
        pulled = torch.empty_like(store)
        ru.reduce_update_reference(g, got, gstate, kind, params, alpha,
                                   pulled, fused=fused)
        assert torch.equal(got, want) and torch.equal(pulled, want)
        for a, b in zip(gstate, wstate):
            assert torch.equal(a, b)


def test_wrappers_on_cpu_run_the_plain_versions():
    ru.reset_launches()
    g, store = _inputs(8, 517, torch.float32)
    got, want = store.clone(), store.clone()
    ru.reduce_apply(g, got, "sgd:0.1")
    ru.reduce_apply_reference(g, want, "sgd:0.1")
    assert torch.equal(got, want)
    assert torch.equal(ru.rank_order_sum(g), _old_sum(g))
    pulled = ru.reduce_group([g, g[:3]], [store.clone(), store.clone()])
    assert torch.equal(pulled[1], store + _old_sum(g[:3]))
    assert not any(ru.launches.values())


def test_wrappers_refuse_bad_operands():
    g, store = _inputs(4, 64, torch.float32)
    with pytest.raises(CheckError, match="rows bfloat16|rows torch"):
        ru.reduce_apply(g.bfloat16(), store)
    with pytest.raises(CheckError, match="values"):
        ru.reduce_apply(g, store[:63].clone())
    with pytest.raises(CheckError, match="lengths differ"):
        ru.rank_order_sum([g[0], g[1, :32]])
    with pytest.raises(CheckError, match="different devices"):
        ru.reduce_apply(g, torch.empty(64, device="meta"))
    with pytest.raises(CheckError, match="unsupported device"):
        ru.reduce_apply(g.to("meta"), torch.empty(64, device="meta"))
    with pytest.raises(CheckError, match="contiguous"):
        ru.reduce_apply(g, torch.zeros(128)[::2])
    with pytest.raises(ValueError, match="not an elementwise server handle"):
        ru.reduce_apply(g, store, "adam")
    with pytest.raises(CheckError, match="state tensors"):
        ru.reduce_update(g, store, (), "adagrad", (0.1, 1e-8))
    with pytest.raises(CheckError, match="alpha"):
        ru.reduce_update(g, store, (store.clone(), store.clone()), "adam",
                         (0.9, 0.999, 1e-8))
    with pytest.raises(CheckError, match="runs on the card"):
        ru.reduce_peers([([0], 0, 64)], store)


def test_the_card_path_raises_without_a_card(monkeypatch):
    """Where the operands are on the card the wrapper launches or raises:
    with the card claimed and no kernel library to be had, the store is
    left as it was and nothing is counted."""
    monkeypatch.setattr(ru, "_on_cuda", lambda device, dtype, dtypes=(): True)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(_native, "DEFAULT_NVCC", "/nonexistent/nvcc")
    ru.reset_launches()
    g, store = _inputs(4, 64, torch.float32)
    before = store.clone()
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        ru.reduce_apply(g, store)
    assert torch.equal(store, before) and not any(ru.launches.values())


# -- the launch tables, through an emulated kernel --------------------------------

def _mem(addr: int, n: int, dtype) -> torch.Tensor:
    """A tensor on the ``n`` values of ``dtype`` at host address ``addr``."""
    buf = (ctypes.c_uint8 * (n * dtype.itemsize)).from_address(int(addr))
    return torch.frombuffer(buf, dtype=torch.uint8).view(dtype)


class _Emulated:
    """``_native.call`` for ``pstt_reduce_update`` on host memory: reads
    the segment and address tables as csrc/reduce_update.cu does and
    applies each segment's mode with the plain arithmetic; ``tables``
    records (segments, addresses, mode) per launch."""

    def __init__(self):
        self.tables = []

    def __call__(self, name, seg_ptr, nseg, addr_ptr, naddr, dtype, mode,
                 *rest):
        assert name == "pstt_reduce_update"
        assert 0 < nseg <= ru.MAX_SEGS and 0 <= naddr <= ru.MAX_ADDRS
        p = [float(np.float32(x)) for x in rest[:5]]
        alpha = rest[5]
        segs = np.ctypeslib.as_array(
            (ctypes.c_int64 * (9 * nseg)).from_address(seg_ptr)).reshape(-1, 9)
        addrs = np.ctypeslib.as_array(
            (ctypes.c_int64 * max(naddr, 1)).from_address(addr_ptr))
        dt = (torch.float32, torch.bfloat16, torch.float16)[dtype]
        self.tables.append((nseg, naddr, mode))
        for row0, stride, n, st, pulled, aux0, aux1, rows, at in segs:
            rws = [_mem(addrs[at + w] if at >= 0 else row0 + w * stride, n,
                        dt) for w in range(rows)]
            agg = ru.rank_order_sum_reference(rws)
            if mode == 3:
                _mem(aux0, n, dt).copy_(agg)
                continue
            s = _mem(st, n, dt)
            if mode == 0:
                s.add_(agg)
            elif mode == 1:
                s.copy_(agg)
            elif mode == 2:
                s.sub_(p[0] * agg)
            elif mode == 4:
                m = _mem(aux0, n, dt)
                m.mul_(p[1]).add_(agg)
                s.sub_(p[0] * m)
            elif mode == 5:
                a = _mem(aux0, n, dt)
                a.add_(agg * agg)
                s.sub_(p[0] * agg / (a.sqrt() + p[1]))
            else:
                m, v = _mem(aux0, n, dt), _mem(aux1, n, dt)
                al = _mem(alpha, 1, torch.float32)
                m.mul_(p[0]).add_(p[2] * agg)
                v.mul_(p[1]).add_(p[3] * agg * agg)
                s.sub_(al * m / (v.sqrt() + p[4]))
            if pulled:
                _mem(pulled, n, dt).copy_(s)


@pytest.fixture
def emulated(monkeypatch):
    """The CPU plays the card: the wrappers build their tables and call
    the emulated kernel."""
    emu = _Emulated()

    def on_card(device, dtype, dtypes=tuple(ru._DTYPE_CODES)):
        _ON_CUDA(torch.device("cuda", 0), dtype, dtypes)  # its dtype check
        return True

    monkeypatch.setattr(ru, "_on_cuda", on_card)
    monkeypatch.setattr(_native, "call", emu)
    monkeypatch.setattr(_native, "stream_ptr", lambda device: 0)
    ru.reset_launches()
    return emu


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("handle", ["sum", "assign", "sgd:0.05"])
@pytest.mark.parametrize("rows", [1, 3, 16])
def test_tables_apply(emulated, dtype, handle, rows):
    """One segment from a [W, n] tensor (a row of it the store itself
    when W = 1), and from W separate rows; pulled or not."""
    g, store = _inputs(rows, 1001, dtype, seed=rows)
    for rws in (g, list(g)):
        for with_pull in (True, False):
            got, want = store.clone(), store.clone()
            pulled = torch.empty_like(store) if with_pull else None
            ru.reduce_apply(rws, got, handle, pulled)
            ru.reduce_apply_reference(rws, want, handle)
            assert torch.equal(got, want)
            if with_pull:
                assert torch.equal(pulled, want)
    own = store.clone()
    want = own.clone()
    ru.reduce_apply_reference(own.unsqueeze(0).clone(), want, handle)
    ru.reduce_apply(own.unsqueeze(0), own, handle)  # the row is the store
    assert torch.equal(own, want)
    name = str(dtype).replace("torch.", "")
    assert ru.launches[f"reduce_push_pull[{name}]"] == 2
    assert ru.launches[f"reduce_push[{name}]"] == 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ru.OPTIMIZERS)
def test_tables_update(emulated, dtype, kind):
    g, store = _inputs(8, 1003, dtype, seed=4)
    gen = torch.Generator().manual_seed(5)
    state = tuple(torch.rand(1003, generator=gen).to(dtype) * 0.1
                  for _ in range(2 if kind == "adam" else 1))
    alpha = fu.adam_alpha(torch.tensor([2.0]), 1e-3)
    params = {"sgd_momentum": (0.05, 0.9), "adagrad": (0.05, 1e-8),
              "adam": (0.9, 0.999, 1e-8)}[kind]
    got, gstate = store.clone(), tuple(t.clone() for t in state)
    want, wstate = store.clone(), tuple(t.clone() for t in state)
    pulled = torch.empty_like(store)
    ru.reduce_update(g, got, gstate, kind, params, alpha, pulled)
    ru.reduce_update_reference(g, want, wstate, kind, params, alpha)
    assert torch.equal(got, want) and torch.equal(pulled, want)
    for a, b in zip(gstate, wstate):
        assert torch.equal(a, b)
    assert emulated.tables == [(1, 0, ru._MODES[kind])]
    assert ru.launches[f"reduce_{kind}[{str(dtype)[6:]}]"] == 1


def test_tables_group_split_at_forty_buckets(emulated):
    """45 buckets of two dtypes: f32 in two launches (40 + 3), bf16 in
    one, each bucket bit-equal to its own plain push_pull."""
    rng = np.random.RandomState(8)
    rows_list, stores = [], []
    for i in range(45):
        dt = torch.bfloat16 if i % 15 == 7 else torch.float32
        n = int(rng.randint(1, 300))
        rows_list.append(torch.from_numpy(
            rng.randn(4, n).astype(np.float32)).to(dt))
        stores.append(torch.from_numpy(rng.randn(n).astype(np.float32)).to(
            dt))
    wants = [s.clone() for s in stores]
    for r, s in zip(rows_list, wants):
        ru.reduce_apply_reference(r, s, "sgd:0.1")
    pulled = ru.reduce_group(rows_list, stores, "sgd:0.1")
    for p, s, w in zip(pulled, stores, wants):
        assert torch.equal(s, w) and torch.equal(p, w)
        assert p.data_ptr() % 16 == 0
    assert sorted(t[0] for t in emulated.tables) == [2, 3, 40]
    assert ru.launches["reduce_push_pull_group[float32]"] == 2
    assert ru.launches["reduce_push_pull_group[bfloat16]"] == 1


@pytest.mark.parametrize("kind", ["sum", "sgd:0.05", "adam"])
def test_tables_peers_by_address(emulated, kind):
    """Pieces of a store whose rows come by address at odd offsets, 20
    pieces of 8 rows: 160 addresses, so two launches (16 + 4 pieces)."""
    n_piece, pieces_n, rows = 37, 20, 8
    gen = torch.Generator().manual_seed(6)
    slab = torch.randn(rows, pieces_n * n_piece + 5, generator=gen)
    store = torch.randn(pieces_n * n_piece, generator=gen)
    state = (torch.rand(store.numel(), generator=gen) * 0.1,
             torch.rand(store.numel(), generator=gen) * 0.01)
    alpha = fu.adam_alpha(torch.tensor([1.0]), 1e-3)
    pieces = [([slab[w, 3 + k * n_piece:].data_ptr() for w in range(rows)],
               k * n_piece, n_piece) for k in range(pieces_n)]
    kw = (dict(state=state, params=(0.9, 0.999, 1e-8), alpha=alpha)
          if kind == "adam" else {})
    got = store.clone()
    gkw = dict(kw, state=tuple(t.clone() for t in state)) if kw else {}
    ru.reduce_peers(pieces, got, kind, **gkw)
    want = store.clone()
    wstate = tuple(t.clone() for t in state)
    for k in range(pieces_n):
        sl = slice(k * n_piece, (k + 1) * n_piece)
        rws = slab[:, 3 + k * n_piece:3 + (k + 1) * n_piece]
        if kind == "adam":
            ru.reduce_update_reference(rws, want[sl], [t[sl] for t in wstate],
                                       "adam", (0.9, 0.999, 1e-8), alpha)
        else:
            ru.reduce_apply_reference(rws, want[sl], kind)
    assert torch.equal(got, want)
    if kind == "adam":
        for a, b in zip(gkw["state"], wstate):
            assert torch.equal(a, b)
    assert [t[:2] for t in emulated.tables] == [(16, 128), (4, 32)]
    key = "reduce_adam[float32]" if kind == "adam" else "reduce_push[float32]"
    assert ru.launches[key] == 2


@pytest.mark.parametrize("handle", ["sum", "adam:1e-3", _half],
                         ids=["sum", "adam", "callable"])
def test_engine_paths_launch_d1_d2(emulated, handle):
    """On the emulated card the engine's torch path, its groups and
    replays, and every stateful handle go through D1/D2 and nothing
    else: the counts, and the results against a CPU engine."""
    teng, ref = (CollectiveEngine(DeviceGroup(W, device="cpu"), impl="xla",
                                  server_handle=handle) for _ in range(2))
    names = ["a", "b", "c"]
    for eng in (teng, ref):
        for i, name in enumerate(names):
            eng.register_dense(name, np.arange(3, dtype=np.uint64), 16 + i)
    rng = np.random.RandomState(1)
    gs = [rng.randn(W, 3 * (16 + i)).astype(np.float32) for i in range(3)]
    stateful = handle == "adam:1e-3"

    def run(eng):
        out = [eng.push_pull("a", gs[0]), eng.push("b", gs[1])]
        if not stateful:
            out += eng.push_pull_group(names, gs)
        out.append(eng.replay("c", np.stack([gs[2]] * 2), keep="all"))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ru, "_on_cuda", _ON_CUDA)  # the plain versions
        want = run(ref)
    ru.reset_launches()
    fu.reset_launches()
    for a, b in zip(run(teng), want):
        assert torch.equal(a, b)
    made = {k: v for k, v in ru.launches.items() if v}
    if stateful:
        assert made == {"reduce_adam[float32]": 4}
    elif callable(handle):
        assert made == {"reduce_sum[float32]": 7}  # the group: 1 a bucket
    else:
        assert made == {"reduce_push_pull[float32]": 3,
                        "reduce_push[float32]": 1,
                        "reduce_push_pull_group[float32]": 1}
    assert not any(fu.launches.values())
