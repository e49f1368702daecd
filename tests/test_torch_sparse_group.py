"""The sparse group program: ``SparseEngine.push_group``/``pull_group``
as grouped kernels (``scatter_add_group``, ``row_adagrad_group``,
``gather_rows_group`` of ``ops/sparse_rows.py``), the counterpart of the
JAX package's ``_sparse_group_program`` (one XLA program over every table
of a group).

- The plain group versions equal the per-table plain versions with 0
  differing elements, over tables of different rows, dims (1, 3, 16,
  64), batches (0 included), out-of-range indices, and a group that mixes
  f32 and bf16 tables.
- The card's wrappers build their launch tables as the kernels read
  them: behind an emulated ``_native.call`` that runs each described
  table's plain version from the pointers it was given, a group push is
  three launches per dtype (per 48 tables), a pull one, every table's
  scratch is 16-byte aligned and apart from the others, and the results
  equal the per-table plain versions.
- The port's ``push_group``/``pull_group`` against JAX's on the CPU: the
  sum push and the pull bit for bit, row-wise Adagrad within rtol 1e-5 /
  atol 1e-6 (the order of the row's sum of squares,
  tests/test_torch_sparse.py); a duplicate table refused as JAX refuses
  it.
- Two gloo processes of 4 CPU ranks (``tests/torch_sparse_group_child.py``)
  on a 1-D group and on ``(kv 4, dp 2)``: each group push takes one
  exchange, each group pull two (indices, then rows), whatever the number
  of tables, and every result equals the single-process group's bit for
  bit.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pslite_tpu.parallel.mesh import default_mesh
from pslite_tpu.parallel.sparse import SparseEngine as JaxSparse
from pslite_tpu.utils import logging as jax_log
from pslite_tpu_torch import DeviceGroup, SparseEngine, make_group
from pslite_tpu_torch.ops import _native
from pslite_tpu_torch.ops import sparse_rows as sr
from pslite_tpu_torch.utils import logging as port_log

sys.path.insert(0, os.path.dirname(__file__))
import torch_sparse_group_child as child  # noqa: E402
from test_torch_ici_multiprocess import _root_port  # noqa: E402

CHILD = os.path.join(os.path.dirname(__file__), "torch_sparse_group_child.py")
TIMEOUT = 120
W = 8
LR, EPS = 0.05, 1e-8
# (rows, dim, batch): dims 1, 3, 16, 64, a table without updates, a
# 3-row table whose runs are long.
SPEC = [(37, 4, 6), (3, 16, 40), (20, 1, 5), (11, 3, 0), (90, 64, 7),
        (5, 16, 3)]


def _tables(spec, dtypes, seed=0):
    """Per table (store, acc, indices, rows, rps) on ``W`` shards, with
    out-of-range indices where the batch allows."""
    rng = np.random.default_rng(seed)
    out = []
    for (rows, dim, n), dt in zip(spec, dtypes):
        rps = -(-rows // W)
        idx = rng.integers(0, rows, size=(W, n)).astype(np.int32)
        if n >= 2:
            idx[0, :2] = [-3, W * rps + 1]
            idx[:, -1] = 1  # a row every worker pushes
        out.append((torch.from_numpy(rng.standard_normal(
            (W * rps, dim)).astype(np.float32)).to(dt),
            torch.from_numpy(rng.random(W * rps).astype(np.float32)),
            torch.from_numpy(idx),
            torch.from_numpy(rng.standard_normal(
                (W, n, dim)).astype(np.float32)).to(dt), rps))
    return out


def _run(tables, handle, how):
    """Push then pull every table: ``how`` is "group" (the wrappers),
    "plain" (the plain group versions) or "single" (per-table plain
    versions).  Returns (stores, accs, pulled)."""
    stores = [t[0].clone() for t in tables]
    accs = [t[1].clone() for t in tables]
    idxs, gs, rps = ([t[i] for t in tables] for i in (2, 3, 4))
    if how == "single":
        for s, a, ix, g, r in zip(stores, accs, idxs, gs, rps):
            if handle:
                sr.row_adagrad_reference(s, a, ix, g, W, r, LR, EPS)
            else:
                sr.scatter_add_reference(s, ix, g, W, r)
        return stores, accs, [sr.gather_rows_reference(s, ix, W, r)
                              for s, ix, r in zip(stores, idxs, rps)]
    push = {("group", None): sr.scatter_add_group,
            ("plain", None): sr.scatter_add_group_reference}.get(
        (how, handle))
    if push is not None:
        push(stores, idxs, gs, W, rps)
    elif how == "group":
        sr.row_adagrad_group(stores, accs, idxs, gs, W, rps, LR, EPS)
    else:
        sr.row_adagrad_group_reference(stores, accs, idxs, gs, W, rps, LR,
                                       EPS)
    pull = (sr.gather_rows_group if how == "group"
            else sr.gather_rows_group_reference)
    return stores, accs, pull(stores, idxs, W, rps)


def _differing(a, b) -> int:
    return sum(int((x != y).sum()) for xs, ys in zip(a, b)
               for x, y in zip(xs, ys))


MIXES = {"f32": [torch.float32] * len(SPEC),
         "bf16": [torch.bfloat16] * len(SPEC),
         "mixed": [torch.float32, torch.bfloat16] * (len(SPEC) // 2)}


@pytest.mark.parametrize("handle", [None, "row_adagrad"])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_plain_group_versions_equal_per_table(mix, handle):
    """0 differing elements against the per-table plain versions, through
    the plain group versions and through the wrappers on CPU tensors."""
    tables = _tables(SPEC, MIXES[mix], seed=len(mix))
    want = _run(tables, handle, "single")
    assert _differing(_run(tables, handle, "plain"), want) == 0
    assert _differing(_run(tables, handle, "group"), want) == 0
    if handle is None:  # the accumulators are left alone
        assert _differing(([], want[1], []), ([], [t[1] for t in tables],
                                              [])) == 0


class _Card:
    """``_native.call`` emulated: each launch table is decoded and each
    described table runs its plain version from the pointers given (the
    tensors the test made), with checks on what the kernels would read."""

    def __init__(self, tensors):
        self.by_ptr = {t.data_ptr(): t for t in tensors}
        self.calls = []
        self.sorted = None
        self.works = []

    def call(self, name, *args):
        self.calls.append(name)
        if name == "pstt_sparse_gather_group":
            ptr, count, _ = args
            rows = np.ctypeslib.as_array(
                (np.ctypeslib.ctypes.c_longlong * (7 * count)).from_address(
                    ptr)).reshape(count, 7)
            for store, idx, out, m, row_b, S, rps in rows.tolist():
                s, ix, o = (self.by_ptr[p] for p in (store, idx, out))
                assert ix.numel() == m > 0
                assert row_b == s.shape[1] * s.element_size()
                o.copy_(sr.gather_rows_reference(s, ix, S, rps))
            return
        ptr, count = args[0], args[1]
        rows = np.ctypeslib.as_array(
            (np.ctypeslib.ctypes.c_longlong * (9 * count)).from_address(
                ptr)).reshape(count, 9).tolist()
        assert 1 <= count <= sr.MAX_GROUP
        if name == "pstt_sparse_sort_group":
            self.sorted = rows
            return
        assert name == "pstt_sparse_push_group" and rows == self.sorted
        _, _, dtype, adagrad, lr, eps, _ = args
        work = self.by_ptr_of_work(rows)
        for store, acc, g, idx, wptr, m, dim, S, rps in rows:
            s, gg, ix = (self.by_ptr[p] for p in (store, g, idx))
            assert (wptr - work.data_ptr()) % 16 == 0
            assert ix.numel() == m > 0 and s.shape[1] == dim
            assert sr._DTYPE_CODES[s.dtype] == dtype
            if adagrad:
                sr.row_adagrad_reference(s, self.by_ptr[acc], ix, gg, S, rps,
                                         lr, eps)
            else:
                assert acc == 0
                sr.scatter_add_reference(s, ix, gg, S, rps)

    def by_ptr_of_work(self, rows):
        """The scratch of one chain: one int32 allocation, each table's
        Work (9m + 3 ints) inside it and apart from the others."""
        spans = sorted((r[4], r[4] + 4 * (9 * r[5] + 3)) for r in rows)
        for (_, end), (nxt, _) in zip(spans, spans[1:]):
            assert end <= nxt
        work = self.works[-1]
        assert work.data_ptr() <= spans[0][0]
        assert spans[-1][1] <= work.data_ptr() + 4 * work.numel()
        return work


@pytest.mark.parametrize("handle", [None, "row_adagrad"])
def test_card_wrappers_build_the_kernels_tables(monkeypatch, handle):
    """Three launches per dtype chain (per 48 tables) for a push, one per
    48 tables for a pull; tables without updates left out; the results
    equal the per-table plain versions."""
    spec = SPEC + [(7 + t, 1 + t % 4, 2 + t % 3) for t in range(46)]
    dtypes = [torch.float32] * 40 + [torch.bfloat16] * (len(spec) - 40)
    tables = _tables(spec, dtypes, seed=7)
    want = _run(tables, handle, "single")
    group = _run(tables, handle, "plain")
    card = _Card([])
    real_empty = torch.empty

    def empty(*a, **k):  # every allocation the wrappers make, by address
        t = real_empty(*a, **k)
        card.by_ptr[t.data_ptr()] = t
        if k.get("dtype") == torch.int32 and t.dim() == 1:
            card.works.append(t)
        return t

    stores = [t[0].clone() for t in tables]
    accs = [t[1].clone() for t in tables]
    idxs, gs, rps = ([t[i] for t in tables] for i in (2, 3, 4))
    for t in stores + accs + idxs + gs:
        card.by_ptr[t.data_ptr()] = t
    monkeypatch.setattr(sr, "_on_cuda", lambda *a: True)
    monkeypatch.setattr(_native, "call", card.call)
    monkeypatch.setattr(_native, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(sr.torch, "empty", empty)
    sr.reset_launches()
    if handle:
        sr.row_adagrad_group(stores, accs, idxs, gs, W, rps, LR, EPS)
    else:
        sr.scatter_add_group(stores, idxs, gs, W, rps)
    outs = sr.gather_rows_group(stores, idxs, W, rps)
    monkeypatch.undo()
    live = sum(1 for ix in idxs if ix.numel())  # 51 of 52 tables
    f32_live = sum(1 for ix, d in zip(idxs, dtypes)
                   if ix.numel() and d == torch.float32)
    chains = -(-f32_live // sr.MAX_GROUP) + -(-(live - f32_live)
                                               // sr.MAX_GROUP)
    counter = ("sparse_row_adagrad_group" if handle
               else "sparse_scatter_add_group")
    assert sr.launches[counter] == 3 * chains
    pulls = -(-live // sr.MAX_GROUP)
    assert pulls == 2 and chains == 2
    assert sr.launches["sparse_gather_rows_group"] == pulls
    assert card.calls.count("pstt_sparse_gather_group") == pulls
    got = (stores, accs, outs)
    assert _differing(got, want) == 0
    assert _differing(got, group) == 0


def test_group_push_refuses_a_store_twice():
    t = _tables(SPEC[:2], [torch.float32] * 2)
    stores = [t[0][0], t[0][0]]
    with pytest.raises(port_log.CheckError, match="twice"):
        sr.scatter_add_group(stores, [t[0][2]] * 2, [t[0][3]] * 2, W,
                             [t[0][4]] * 2)
    # A pull may read one table twice.
    outs = sr.gather_rows_group(stores, [t[0][2]] * 2, W, [t[0][4]] * 2)
    assert torch.equal(outs[0], outs[1])


# -- the engines: the port against JAX ---------------------------------------

ENGINE_SPEC = {"a": (37, 4, 6, "float32"), "b": (9, 1, 3, "float32"),
               "c": (70, 16, 5, "bfloat16"), "d": (130, 64, 8, "float32"),
               "e": (5, 3, 12, "float32")}


def _engine_pair(seed):
    rng = np.random.default_rng(seed)
    jeng, teng = JaxSparse(default_mesh()), SparseEngine(
        DeviceGroup(W, device="cpu"))
    for n, (rows, dim, _, dt) in ENGINE_SPEC.items():
        init = rng.standard_normal((rows, dim)).astype(np.float32)
        jeng.register_sparse(n, rows, dim, dtype=dt, init=init)
        teng.register_sparse(n, rows, dim, dtype=dt, init=init)
    return rng, jeng, teng


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("handle", [None, "row_adagrad:0.1,1e-8"])
def test_port_group_ops_match_jax(handle):
    """Two group pushes and a group pull of five tables (dims 1, 3, 4, 16,
    64; one bf16) through both engines: the sum push and the pull bit for
    bit, row-wise Adagrad within rtol 1e-5 / atol 1e-6."""
    rng, jeng, teng = _engine_pair(3)
    names = list(ENGINE_SPEC)
    for step in range(2):
        idx, gs = [], []
        for n in names:
            rows, dim, b, _ = ENGINE_SPEC[n]
            ix = rng.integers(0, rows, size=(W, b)).astype(np.int32)
            ix[:, 0] = 2  # a row every worker pushes
            idx.append(ix)
            gs.append((rng.standard_normal((W, b, dim)) * 3).astype(
                np.float32))
        jeng.push_group(names, idx, gs, handle=handle)
        tok = teng.push_group(names, idx, gs, handle=handle)
        assert tok.shape == (1, 1)
        jouts = jeng.pull_group(names, idx)
        touts = teng.pull_group(names, idx)
        for n, j, t in zip(names, jouts, touts):
            rows, dim, b, _ = ENGINE_SPEC[n]
            assert tuple(t.shape) == (W, b, dim)
            pairs = [(_f32(t), _f32(j)),
                     (_f32(teng.store_array(n)), _f32(jeng.store_array(n)))]
            if handle:
                pairs.append((_f32(teng.acc_array(n)),
                              _f32(jeng.acc_array(n))))
            for got, want in pairs:
                if handle is None:
                    np.testing.assert_array_equal(got, want, err_msg=n)
                else:
                    np.testing.assert_allclose(got, want, rtol=1e-5,
                                               atol=1e-6, err_msg=n)


def test_duplicate_table_refused_as_jax_refuses_it():
    _, jeng, teng = _engine_pair(4)
    idx = np.zeros((W, 2), np.int32)
    g = np.ones((W, 2, 4), np.float32)
    with pytest.raises(jax_log.CheckError, match="duplicate table in group"):
        jeng.push_group(["a", "a"], [idx, idx], [g, g])
    with pytest.raises(port_log.CheckError, match="duplicate table in group"):
        teng.push_group(["a", "a"], [idx, idx], [g, g])
    # Neither store moved.
    np.testing.assert_array_equal(_f32(teng.store_array("a")),
                                  _f32(jeng.store_array("a")))


def test_group_observes_like_jax():
    """The byte counters take every table, the profiler's latency the
    first table only (one call)."""
    class Prof:
        enabled = True

        def __init__(self):
            self.events = []

        def record_engine(self, name, op, payload, dur_us):
            self.events.append((name, op, payload))

    teng = SparseEngine(DeviceGroup(W, device="cpu"), profiler=Prof())
    for n, (rows, dim, _, dt) in ENGINE_SPEC.items():
        teng.register_sparse(n, rows, dim, dtype=dt)
    names = ["a", "b"]
    idx = [np.zeros((W, 6), np.int32), np.zeros((W, 3), np.int32)]
    gs = [np.ones((W, 6, 4), np.float32), np.ones((W, 3, 1), np.float32)]
    teng.push_group(names, idx, gs)
    teng.pull_group(names, idx)
    assert teng.push_bytes == teng.pull_bytes == W * (6 * 4 + 3) * 4
    assert [e[:2] for e in teng.profiler.events] == [
        ("a", "sparse_push"), ("b", "sparse_push"), ("a", "sparse_pull"),
        ("b", "sparse_pull")]
    assert teng.exchanges == 0  # one process: nothing exchanged


# -- two processes -------------------------------------------------------------

@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    """Both processes' saved results."""
    out = tmp_path_factory.mktemp("group")
    port = _root_port()
    env = dict(os.environ, DMLC_NUM_WORKER="2", DMLC_PS_ROOT_URI="127.0.0.1",
               DMLC_PS_ROOT_PORT=str(port), PSTEST_OUT=str(out),
               PSTEST_DEADLINE=str(TIMEOUT - 10))
    procs = [subprocess.Popen([sys.executable, CHILD],
                              env=dict(env, DMLC_RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError("\n".join(
            f"[worker {r} rc={p.returncode}]\n{o[-3000:]}"
            for r, (p, o) in enumerate(zip(procs, outs))))
    return [dict(np.load(out / f"group{r}.npz")) for r in (0, 1)]


def _single(gname):
    shape, names, kv = child.GROUPS[gname]
    grp = (DeviceGroup(shape, device="cpu") if gname == "1d"
           else make_group(shape, names, device="cpu"))
    return child.run(SparseEngine(grp, kv), child.inputs(), gname,
                     lambda x: x)


@pytest.mark.parametrize("gname", sorted(child.GROUPS))
def test_two_process_group_takes_one_exchange_per_op(workers, gname):
    """Each group push of three tables takes one exchange and each group
    pull two, in both processes (the single-process engine none); every
    pull, store and accumulator bit-equal to the single-process group."""
    single = _single(gname)
    shape, names, kv = child.GROUPS[gname]
    from pslite_tpu_torch.parallel import placement

    for rank, got in enumerate(workers):
        for step in (0, 1):
            assert got[f"{gname}_push{step}_exchanges"] == 1
            assert got[f"{gname}_pull{step}_exchanges"] == 2
            assert single[f"{gname}_push{step}_exchanges"] == 0
        grp = DeviceGroup(shape, device="cpu", axis_name=names,
                          owners=child.OWNERS, process_index=rank)
        shard, _ = placement.shard_replicas(grp, (kv,))
        mine = [int(shard[r]) for r in grp.local_ranks]
        for name, _, _, _ in child.TABLES:
            for step in (0, 1):
                key = f"{gname}_pull{step}_{name}"
                np.testing.assert_array_equal(got[key], single[key][mine],
                                              err_msg=f"{key} {rank}")
            for what in ("store", "acc"):
                key = f"{gname}_{what}_{name}"
                np.testing.assert_array_equal(got[key], single[key],
                                              err_msg=f"{key} {rank}")
