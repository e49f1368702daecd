"""pslite_tpu_torch.checkpoint against pslite_tpu.checkpoint.

Both packages' engines are given the same state, made with numpy from a
seed (stores, optimizer states, tables, accumulators set directly, so
that no FMA contraction separates them), and each package writes its
file.  The files must hold the same members in the same order, with the
same dtypes, shapes and bytes, ``__meta__`` included (``np.savez``
stamps zip members with the time, so whole files are not compared).
Then each package restores the other's file: the v2 files onto 4 shards
(written on 8), the async checkpointer's v1 files onto 8, and the state
restored must be the same bits in both packages.  The JAX engines run
on the 8-device CPU mesh of tests/conftest.py, the port's on
``DeviceGroup(n, device="cpu")``.
"""

import os

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from pslite_tpu import checkpoint as jckpt
from pslite_tpu.kv.kv_app import KVServerDefaultHandle as JaxDefaultHandle
from pslite_tpu.kv.kv_app import KVServerOptimizerHandle as JaxOptHandle
from pslite_tpu.parallel.engine import CollectiveEngine as JaxEngine
from pslite_tpu.parallel.sparse import SparseEngine as JaxSparse
from pslite_tpu_torch import checkpoint as tckpt
from pslite_tpu_torch import (CollectiveEngine, DeviceGroup,
                              KVServerDefaultHandle, KVServerOptimizerHandle,
                              SparseEngine)
from pslite_tpu_torch.convert import load_engine_npz
from pslite_tpu_torch.utils.logging import CheckError

KEYS = np.arange(6, dtype=np.uint64)
VAL_LEN = 99  # total 594: padded 600 on 8 shards, 596 on 4
TABLES = (("t", 37, 8, True), ("u", 13, 4, False))  # name, rows, dim, acc
N_STATES = {"sgd_momentum": 1, "adagrad": 1, "adam": 3}


def _jmesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("kv",))


def _group(n):
    return DeviceGroup(n, device="cpu")


def _raw(x) -> np.ndarray:
    """Host bits of a tensor, JAX array or numpy array (bfloat16 as its
    2-byte pattern)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.view(torch.int16).numpy() if x.dtype == torch.bfloat16
                else x.numpy())
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


def _same_bits(a, b, what=""):
    a, b = _raw(a), _raw(b)
    assert (a.dtype, a.shape) == (b.dtype, b.shape), what
    assert a.tobytes() == b.tobytes(), what


def _members(path):
    """(name, dtype, shape, bytes) of every member, in file order."""
    with np.load(path, allow_pickle=False) as data:
        return [(k, data[k].dtype.str, data[k].shape, data[k].tobytes())
                for k in data.files]


def _same_members(jpath, tpath):
    jm, tm = _members(jpath), _members(tpath)
    assert [m[0] for m in jm] == [m[0] for m in tm]
    for a, b in zip(jm, tm):
        assert a == b, f"member {a[0]!r} differs"


def _engines(n, kind=None, dtype=None):
    """JAX and port (dense, sparse) engines on n shards with the buckets
    ``a`` (optimizer ``kind``) and ``s`` and the tables of TABLES
    registered, all zero."""
    handle = kind or "sum"
    jeng = JaxEngine(_jmesh(n), server_handle=handle)
    teng = CollectiveEngine(_group(n), server_handle=handle)
    jse, tse = JaxSparse(jeng.mesh), SparseEngine(teng.group)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    for eng, dt in ((jeng, jdt), (teng, dtype)):
        eng.register_dense("a", KEYS, VAL_LEN, dtype=dt)
        eng.register_dense("s", KEYS[:3], 5, dtype=dt)
    for se in (jse, tse):
        for name, rows, dim, _ in TABLES:
            se.register_sparse(name, rows, dim)
    return jeng, teng, jse, tse


def _fill(engines, kind, seed, dtype=np.float32):
    """The same random state into both packages' engines."""
    jeng, teng, jse, tse = engines
    rng = np.random.default_rng(seed)
    total = len(KEYS) * VAL_LEN

    def vec(n):
        return rng.normal(size=n).astype(np.float32).astype(dtype)

    store, small = vec(total), vec(15)
    states = [np.abs(vec(total)) for _ in range(N_STATES[kind])]
    if kind == "adam":
        states[2] = np.array([3.0], np.float32)
    for eng in (jeng, teng):
        eng.set_store_array("a", store)
        eng.set_store_array("s", small)
        eng.set_opt_state("a", kind, states)
    for name, rows, dim, acc in TABLES:
        table = rng.normal(size=(rows, dim)).astype(np.float32)
        acc_v = np.abs(rng.normal(size=rows)).astype(np.float32)
        for se in (jse, tse):
            se.set_store_array(name, table, global_rows=True)
            if acc:
                se.set_acc_array(name, acc_v, global_rows=True)


def _same_state(a, b):
    """Every store, optimizer state, table and accumulator of two
    engine sets (JAX or port, in any mix) are the same bits."""
    (ea, sa), (eb, sb) = a, b
    for name in ("a", "s"):
        _same_bits(ea.store_array(name), eb.store_array(name), name)
        oa, ob = ea.opt_state(name), eb.opt_state(name)
        assert (oa is None) == (ob is None), name
        if oa is not None:
            assert oa[0] == ob[0] and len(oa[1]) == len(ob[1])
            for i, (x, y) in enumerate(zip(oa[1], ob[1])):
                _same_bits(x, y, f"opt {name}/{i}")
    for name, _, _, acc in TABLES:
        _same_bits(sa.store_array(name), sb.store_array(name), name)
        if acc:
            _same_bits(sa.acc_array(name), sb.acc_array(name), name)


@pytest.mark.parametrize("kind", ["sgd_momentum", "adagrad", "adam"])
def test_v2_files_match_and_restore_across_fleets(tmp_path, kind):
    engines = _engines(8, kind)
    _fill(engines, kind, seed=11)
    jeng, teng, jse, tse = engines
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jckpt.save_engine(jeng, jpath, sparse_engine=jse)
    tckpt.save_engine(teng, tpath, sparse_engine=tse)
    _same_members(jpath, tpath)
    # Each package restores the other's file onto 4 shards.
    jeng4, teng4, jse4, tse4 = _engines(4, kind)
    jckpt.restore_engine(jeng4, tpath, sparse_engine=jse4)
    tckpt.restore_engine(teng4, jpath, sparse_engine=tse4)
    assert teng4.bucket("a").padded_len == 596
    _same_state((jeng4, jse4), (teng4, tse4))
    # load_engine_npz is the same restore path.
    _, teng4b, _, tse4b = _engines(4, kind)
    load_engine_npz(teng4b, jpath, sparse_engine=tse4b)
    _same_state((teng4, tse4), (teng4b, tse4b))


@pytest.mark.parametrize("kind", ["sgd_momentum", "adagrad", "adam"])
def test_async_v1_files_match_and_restore(tmp_path, kind):
    engines = _engines(8, kind)
    _fill(engines, kind, seed=12)
    jeng, teng, jse, tse = engines
    jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "port")
    for ck_cls, eng, se, path in (
            (jckpt.AsyncEngineCheckpointer, jeng, jse, jpath),
            (tckpt.AsyncEngineCheckpointer, teng, tse, tpath)):
        ck = ck_cls()
        ck.save(eng, path, sparse_engine=se)
        ck.close()
    _same_members(jpath + ".npz", tpath + ".npz")
    with np.load(tpath + ".npz") as data:
        meta = bytes(data["__meta__"]).decode()
        assert '"version"' not in meta  # v1, as the JAX checkpointer writes
        assert data["dense/a"].shape == (600,)
    jeng8, teng8, jse8, tse8 = _engines(8, kind)
    jckpt.restore_engine(jeng8, tpath, sparse_engine=jse8)
    tckpt.restore_engine(teng8, jpath, sparse_engine=tse8)
    _same_state((jeng8, jse8), (teng8, tse8))
    _same_state((jeng8, jse8), (jeng, jse))
    # load_engine_npz reads v2 only.
    with pytest.raises(CheckError, match="unsupported checkpoint version"):
        load_engine_npz(_engines(8, kind)[1], jpath)


@pytest.mark.parametrize("kind,val_len", [
    ("sum", VAL_LEN),  # 594 values: padded to 600 on 8, to 596 on 4
    ("adam", 100),     # 600 values: no padding; the step vector shows S
])
def test_v1_file_from_another_shard_count_is_refused(tmp_path, kind,
                                                     val_len):
    """A v1 file records no shard count.  At config 5 an 8-shard file's
    table has as many rows on 4 shards (1,048,576 = 8 x 131,072 = 4 x
    262,144), so its interleaved rows would restore permuted: the port
    refuses it, seeing 8 shards in a store padded to a multiple of 8 or
    in the adam step vector, before it restores anything."""
    teng = CollectiveEngine(_group(8), server_handle=kind)
    tse = SparseEngine(teng.group)
    teng.register_dense("a", KEYS, val_len)
    tse.register_sparse("emb", 1 << 20, 4)
    rng = np.random.default_rng(3)
    total = len(KEYS) * val_len
    teng.set_store_array("a", rng.normal(size=total).astype(np.float32))
    if kind == "adam":
        teng.set_opt_state("a", "adam", [np.zeros(total, np.float32),
                                         np.zeros(total, np.float32),
                                         np.array([2.0], np.float32)])
    path = str(tmp_path / "v1")
    ck = tckpt.AsyncEngineCheckpointer()
    ck.save(teng, path, sparse_engine=tse)
    ck.close()
    teng4 = CollectiveEngine(_group(4), server_handle=kind)
    tse4 = SparseEngine(teng4.group)
    teng4.register_dense("a", KEYS, val_len)
    tse4.register_sparse("emb", 1 << 20, 4)
    assert tse4.store_array("emb").shape == tse.store_array("emb").shape
    before = tse4.store_array("emb").clone()
    with pytest.raises(CheckError, match="v1 checkpoint"):
        tckpt.restore_engine(teng4, path, sparse_engine=tse4)
    assert torch.equal(tse4.store_array("emb"), before)
    # Onto the saver's own shard count it restores.
    tckpt.restore_engine(teng, path, sparse_engine=tse)


def test_bf16_bucket_from_jax_restores_bit_equal(tmp_path):
    """bf16 stores and momentum: the JAX file (``V2`` members) restores
    into the port bit for bit, and the port writes the same members.  The
    JAX restore refuses ``V2`` (no cast into bfloat16): the difference
    ROADMAP Queue 3 records."""
    engines = _engines(8, "sgd_momentum", dtype="bfloat16")
    _fill(engines, "sgd_momentum", seed=13, dtype=ml_dtypes.bfloat16)
    jeng, teng, jse, tse = engines
    assert teng.store_array("a").dtype == torch.bfloat16
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jckpt.save_engine(jeng, jpath, sparse_engine=jse)
    tckpt.save_engine(teng, tpath, sparse_engine=tse)
    _same_members(jpath, tpath)
    with np.load(tpath) as data:
        assert data["dense/a"].dtype.kind == "V"
    _, teng4, _, tse4 = _engines(4, "sgd_momentum", dtype="bfloat16")
    tckpt.restore_engine(teng4, jpath, sparse_engine=tse4)
    for name in ("a", "s"):
        total = teng4.bucket(name).total_len
        _same_bits(teng4.store_array(name)[:total],
                   jeng.store_array(name)[:total], name)
    _same_bits(teng4.opt_state("a")[1][0][:594],
               jeng.opt_state("a")[1][0][:594])
    jeng4 = _engines(4, "sgd_momentum", dtype="bfloat16")[0]
    with pytest.raises(ValueError):
        jckpt.restore_engine(jeng4, tpath)


def test_async_snapshot_at_call_time(tmp_path):
    """Pushes after save() are not in the file; the optimizer state and
    tables restore (port counterpart of tests/test_async_checkpoint.py)."""
    teng = CollectiveEngine(_group(8), server_handle="sgd_momentum:0.1,0.9")
    keys = np.arange(4, dtype=np.uint64)
    teng.register_dense("b", keys, 64)
    teng.push_pull("b", np.ones((8, 256), np.float32))
    at_save = teng.store_array("b")
    mom_at_save = teng.opt_state("b")[1][0]
    se = SparseEngine(teng.group)
    init = np.arange(20 * 4, dtype=np.float32).reshape(20, 4)
    se.register_sparse("t", 20, 4, init=init)

    ck = tckpt.AsyncEngineCheckpointer()
    path = str(tmp_path / "snap")
    ck.save(teng, path, sparse_engine=se)
    teng.push_pull("b", np.ones((8, 256), np.float32))
    se.push("t", np.zeros((8, 1), np.int32), np.ones((8, 1, 4), np.float32))
    ck.wait()

    teng2 = CollectiveEngine(_group(8), server_handle="sgd_momentum:0.1,0.9")
    teng2.register_dense("b", keys, 64)
    se2 = SparseEngine(teng2.group)
    se2.register_sparse("t", 20, 4)
    tckpt.restore_engine(teng2, path, sparse_engine=se2)
    assert torch.equal(teng2.store_array("b"), at_save)
    kind, st = teng2.opt_state("b")
    assert kind == "sgd_momentum" and torch.equal(st[0], mom_at_save)
    got = se2.pull("t", np.broadcast_to(np.array([0, 7, 19], np.int32),
                                        (8, 3)))[0]
    np.testing.assert_array_equal(got.numpy(), init[[0, 7, 19]])
    ck.close()


def test_async_error_surfaces(tmp_path):
    teng = CollectiveEngine(_group(8))
    teng.register_dense("b", np.arange(2, dtype=np.uint64), 16)
    blocker = tmp_path / "blocker"
    blocker.write_text("a file, not a dir")
    ck = tckpt.AsyncEngineCheckpointer()
    ck.save(teng, str(blocker / "sub" / "snap"))
    with pytest.raises(Exception):
        ck.wait()
    # Usable after a failure; a failure also surfaces on the next save().
    ck.save(teng, str(blocker / "sub" / "again"))
    ck._q.join()
    with pytest.raises(Exception):
        ck.save(teng, str(tmp_path / "never"))
    ok = str(tmp_path / "ok")
    ck.save(teng, ok)
    ck.wait()
    teng2 = CollectiveEngine(_group(8))
    teng2.register_dense("b", np.arange(2, dtype=np.uint64), 16)
    tckpt.restore_engine(teng2, ok)
    ck.close()


def test_sparse_adagrad_acc_checkpoint_roundtrip(tmp_path):
    """Resumed row-wise Adagrad equals uninterrupted training, bit for bit
    (the accumulator is in the file)."""
    rng = np.random.default_rng(9)
    rows, dim = 13, 4
    init = rng.normal(size=(rows, dim)).astype(np.float32)
    idx = rng.integers(0, rows, size=(4, 3)).astype(np.int32)
    g1, g2 = (rng.normal(size=(4, 3, dim)).astype(np.float32)
              for _ in range(2))
    ref = SparseEngine(_group(4))
    ref.register_sparse("t", rows, dim, init=init)
    for g in (g1, g2):
        ref.push("t", idx, g, handle="row_adagrad:0.1")
    se1 = SparseEngine(_group(4))
    se1.register_sparse("t", rows, dim, init=init)
    se1.push("t", idx, g1, handle="row_adagrad:0.1")
    path = str(tmp_path / "ck")
    tckpt.save_engine(CollectiveEngine(_group(4)), path, sparse_engine=se1)
    se2 = SparseEngine(_group(4))
    se2.register_sparse("t", rows, dim)
    tckpt.restore_engine(CollectiveEngine(_group(4)), path, sparse_engine=se2)
    se2.push("t", idx, g2, handle="row_adagrad:0.1")
    assert torch.equal(se2.store_array("t"), ref.store_array("t"))
    assert torch.equal(se2.acc_array("t"), ref.acc_array("t"))


def test_kv_store_files_match(tmp_path):
    rng = np.random.default_rng(14)
    store = {int(k): rng.normal(size=5).astype(np.float32)
             for k in (3, 70, 2 ** 40)}
    jpath, tpath = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save_kv_store(store, jpath)
    tckpt.save_kv_store(store, tpath)
    _same_members(jpath + ".npz", tpath + ".npz")
    for got in (tckpt.load_kv_store(jpath), jckpt.load_kv_store(tpath)):
        assert sorted(got) == sorted(store)
        for k, v in store.items():
            np.testing.assert_array_equal(got[k], v)


@pytest.mark.parametrize("kind", ["default", "sgd_momentum", "adam"])
def test_server_handle_files_match(tmp_path, kind):
    """save_server_handle of the default and optimizer handles (store,
    ``_m``, ``_v``, ``_t``): same members in both packages, and each
    package loads the other's file into the same state."""
    rng = np.random.default_rng(15)
    if kind == "default":
        jh, th = JaxDefaultHandle(), KVServerDefaultHandle()
        mk = JaxDefaultHandle, KVServerDefaultHandle
    else:
        jh, th = JaxOptHandle(kind=kind), KVServerOptimizerHandle(kind=kind)
        mk = (lambda: JaxOptHandle(kind=kind),
              lambda: KVServerOptimizerHandle(kind=kind))
    slots = ["store"] + ([] if kind == "default" else
                         ["_m"] + (["_v"] if kind == "adam" else []))
    for slot in slots:
        vals = {k: rng.normal(size=4).astype(np.float32) for k in (5, 9, 2)}
        for h in (jh, th):
            getattr(h, slot).update({k: v.copy() for k, v in vals.items()})
    if kind == "adam":
        for h in (jh, th):
            h._t.update({5: 3, 9: 1, 2: 7})
    jpath, tpath = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save_server_handle(jh, jpath)
    tckpt.save_server_handle(th, tpath)
    _same_members(jpath + ".npz", tpath + ".npz")
    jh2, th2 = mk[0](), mk[1]()
    jckpt.load_server_handle(jh2, tpath)
    tckpt.load_server_handle(th2, jpath)
    for slot in slots:
        a, b = getattr(jh2, slot), getattr(th2, slot)
        assert sorted(a) == sorted(b) == [2, 5, 9]
        for k in a:
            _same_bits(a[k], b[k], f"{slot}[{k}]")
    if kind == "adam":
        assert jh2._t == th2._t == {5: 3, 9: 1, 2: 7}


def test_server_handle_checkpoint_resume(tmp_path):
    """An optimizer handle snapshotted mid-stream and restored continues
    exactly as an uninterrupted one (port counterpart of
    tests/test_async_checkpoint.py)."""
    from pslite_tpu_torch.kv.kv_app import KVMeta, KVPairs

    class _Sink:
        def response(self, *a, **k):
            pass

    def push(h, key, grad):
        h(KVMeta(push=True),
          KVPairs(keys=np.array([key], np.uint64), vals=grad), _Sink())

    rng = np.random.default_rng(3)
    grads = [rng.normal(size=6).astype(np.float32) for _ in range(8)]
    for kind in ("sgd", "sgd_momentum", "adam"):
        ref = KVServerOptimizerHandle(kind=kind, lr=0.02)
        ref.init(4, np.ones(6, np.float32))
        for g in grads:
            push(ref, 4, g)
        first = KVServerOptimizerHandle(kind=kind, lr=0.02)
        first.init(4, np.ones(6, np.float32))
        for g in grads[:4]:
            push(first, 4, g)
        path = str(tmp_path / f"handle_{kind}")
        tckpt.save_server_handle(first, path)
        resumed = KVServerOptimizerHandle(kind=kind, lr=0.02)
        tckpt.load_server_handle(resumed, path)
        for g in grads[4:]:
            push(resumed, 4, g)
        np.testing.assert_array_equal(resumed.store[4], ref.store[4],
                                      err_msg=kind)


def test_range_segment_layout_and_atomic_rename(tmp_path, monkeypatch):
    rng = np.random.default_rng(16)
    keys = np.array([4, 9, 30], np.uint64)
    vals = rng.normal(size=9).astype(np.float32)
    lens = np.array([2, 3, 4])
    jpath, tpath = str(tmp_path / "j" / "seg"), str(tmp_path / "t" / "seg")
    assert jckpt.save_range_segment(jpath, keys, vals, lens) == "npz"
    assert tckpt.save_range_segment(tpath, keys, vals, lens) == "npz"
    _same_members(jpath + ".npz", tpath + ".npz")
    assert os.listdir(tmp_path / "t") == ["seg.npz"]  # no temporary left
    for got in (tckpt.load_range_segment(jpath),
                jckpt.load_range_segment(tpath)):
        np.testing.assert_array_equal(got[0], keys)
        np.testing.assert_array_equal(got[1], vals)
        assert got[2].dtype == np.int64
        np.testing.assert_array_equal(got[2], lens)
    bare = str(tmp_path / "t" / "bare")
    tckpt.save_range_segment(bare, keys, vals, None)
    assert tckpt.load_range_segment(bare)[2] is None

    # A write that dies before its rename leaves the old segment whole.
    def dead(fd):
        raise OSError("killed mid-write")

    monkeypatch.setattr(os, "fsync", dead)
    with pytest.raises(OSError, match="killed"):
        tckpt.save_range_segment(tpath, keys, vals * 2, lens)
    monkeypatch.undo()
    np.testing.assert_array_equal(tckpt.load_range_segment(tpath)[1], vals)


def test_orbax_is_refused(tmp_path, caplog):
    assert tckpt.have_orbax() is False
    teng = CollectiveEngine(_group(2))
    for fn in (tckpt.save_engine_orbax, tckpt.restore_engine_orbax):
        with pytest.raises(NotImplementedError, match="orbax"):
            fn(teng, str(tmp_path / "o"))
    path = str(tmp_path / "seg")
    keys, vals = np.arange(3, dtype=np.uint64), np.ones(3, np.float32)
    assert tckpt.save_range_segment(path, keys, vals, None,
                                    fmt="orbax") == "npz"
    np.testing.assert_array_equal(tckpt.load_range_segment(path)[1], vals)
    with pytest.raises(NotImplementedError, match="orbax"):
        tckpt.load_range_segment(path, fmt="orbax")


def test_train_state_files_match(tmp_path):
    store = np.random.default_rng(17).normal(size=50).astype(np.float32)
    jp = jckpt.save_train_state(store, 12, str(tmp_path / "j"))
    tp = tckpt.save_train_state(torch.from_numpy(store), 12,
                                str(tmp_path / "t"))
    assert tp.endswith(".npz")
    _same_members(jp, tp)
    arr, step = tckpt.load_train_state(jp)
    assert step == 12 and isinstance(arr, np.ndarray)
    t, step = tckpt.load_train_state(tp, device="cpu")
    assert step == 12 and t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), store)
    jarr, jstep = jckpt.load_train_state(tp)
    np.testing.assert_array_equal(jarr, store)
