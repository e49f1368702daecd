"""The group shapes that span worker processes, beyond the 1-D ring of
tests/test_torch_ici_multiprocess.py: a 2-D ``worker_axis`` group, a
composite kv axis with and without ``worker_axis``, an N-D group with one
kv axis (dense and sparse), and int8 wire compression, each over two
gloo processes of 4 CPU ranks (``tests/torch_mp_shapes_child.py``).

The same seeded numpy inputs go through the port's single-process engines
on the same shapes, and through JAX's single-process engines on 8
virtual CPU devices with the same mesh.  Bars: the ring, int8 and
``sum`` results bit for bit against the port's single-process engine
(itself bit-exact with JAX's Pallas ring, tests/test_torch_engine2d.py);
the torch impl's ``sum`` and the sparse table bit for bit against JAX's
XLA engines; adam bit for bit against the port's single-process engine
and within rtol 1e-5 / atol 1e-6 of JAX (FMA contraction differs); the
2-D ring also bit for bit against JAX's Pallas ring in interpret mode.  Ranks on several cards still raise, by name.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from pslite_tpu.parallel.engine import CollectiveEngine as JaxEngine
from pslite_tpu.parallel.sparse import SparseEngine as JaxSparse
from pslite_tpu_torch import (CollectiveEngine, DeviceGroup, SparseEngine,
                              make_group)
from pslite_tpu_torch.parallel import distributed

sys.path.insert(0, os.path.dirname(__file__))
import torch_mp_shapes_child as child  # noqa: E402
from test_torch_ici_multiprocess import _root_port  # noqa: E402

CHILD = os.path.join(os.path.dirname(__file__), "torch_mp_shapes_child.py")
TIMEOUT = 150
TOTAL = len(child.KEYS) * child.VAL_LEN


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    """Both processes' saved results."""
    out = tmp_path_factory.mktemp("shapes")
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
    return [dict(np.load(out / f"shapes{r}.npz")) for r in (0, 1)]


@pytest.fixture(scope="module")
def single():
    """The port's single-process engines on the same shapes and rows."""
    data = child.inputs()
    ref = {}
    for name, (shape, names, kv, wa) in child.SHAPES.items():
        grp = make_group(shape, names, device="cpu")
        g = data[name]
        for impl in ("ring", "torch"):
            eng = CollectiveEngine(grp, axis_name=kv, worker_axis=wa,
                                   impl=impl)
            eng.register_dense("b", child.KEYS, child.VAL_LEN)
            ref[f"{name}_{impl}_pp"] = eng.push_pull("b", g[0]).numpy()
            eng.push("b", g[1])
            ref[f"{name}_{impl}_pull"] = eng.pull("b").numpy()
            ref[f"{name}_{impl}_store"] = eng.store_array("b").numpy()
        eng = CollectiveEngine(grp, axis_name=kv, worker_axis=wa,
                               impl="ring", server_handle=child.ADAM)
        eng.register_dense("a", child.KEYS, child.VAL_LEN)
        for step in (2, 3):
            ref[f"{name}_adam{step}"] = eng.push_pull("a", g[step]).numpy()
        ref[f"{name}_adam_m"] = eng.opt_state("a")[1][0].numpy()
        if wa:
            eng = CollectiveEngine(grp, axis_name=kv, worker_axis=wa,
                                   impl="ring", wire_compress="int8")
            eng.register_dense("c", child.KEYS, child.VAL_LEN)
            ref[f"{name}_int8_pp"] = eng.push_pull("c", g[0]).numpy()
            eng.push("c", g[1])
            ref[f"{name}_int8_pull"] = eng.pull("c").numpy()
    eng = CollectiveEngine(make_group((4, 2), ("dp", "kv"), device="cpu"),
                           worker_axis="dp", impl="ring")
    eng.register_dense("r", child.KEYS, child.VAL_LEN)
    eng.push_pull("r", data["2d"][0])
    eng.reshard(make_group((2, 4), ("dp", "kv"), device="cpu"))
    ref["2d_recut_pull"] = eng.pull("r").numpy()
    ref["2d_recut_pp"] = eng.push_pull("r", data["2d"][1][:2]).numpy()
    eng = CollectiveEngine(DeviceGroup(8, device="cpu"), impl="ring",
                           wire_compress="int8")
    eng.register_dense("c", child.KEYS, child.INT8_VAL_LEN)
    ref["int8_pp"] = eng.push_pull("c", data["int8"][0]).numpy()
    eng.push("c", data["int8"][1])
    ref["int8_pull"] = eng.pull("c").numpy()
    ref["int8_pp2"] = eng.push_pull("c", data["int8"][2]).numpy()
    ref["int8_store"] = eng.store_array("c").numpy()
    return ref


def _mesh(name):
    shape, names, _, _ = child.SHAPES[name]
    return Mesh(np.array(jax.devices()[:8]).reshape(shape), names)


def _jax_engine(name, impl, **kw):
    _, _, kv, wa = child.SHAPES[name]
    return JaxEngine(_mesh(name), axis_name=kv, worker_axis=wa, impl=impl,
                     **kw)


@pytest.mark.parametrize("impl", ["ring", "torch"])
@pytest.mark.parametrize("name", list(child.SHAPES))
def test_dense_shapes_match_single_process_engines(workers, single, name,
                                                   impl):
    """push_pull, push then pull, and the gathered store of both
    processes bit-equal to the single-process port engine; the torch
    impl bit-equal to JAX's XLA engine too."""
    for rank, got in enumerate(workers):
        for op in ("pp", "pull", "store"):
            key = f"{name}_{impl}_{op}"
            np.testing.assert_array_equal(got[key], single[key],
                                          err_msg=f"{key} worker {rank}")
    if impl == "torch":
        data = child.inputs()[name]
        jeng = _jax_engine(name, "xla")
        jeng.register_dense("b", child.KEYS, child.VAL_LEN)
        want = np.asarray(jeng.push_pull("b", data[0]))
        jeng.push("b", data[1])
        for got in workers:
            np.testing.assert_array_equal(got[f"{name}_torch_pp"],
                                          want[:TOTAL])
            np.testing.assert_array_equal(got[f"{name}_torch_pull"],
                                          np.asarray(jeng.pull("b")))


@pytest.mark.parametrize("name", list(child.SHAPES))
def test_adam_on_shapes(workers, single, name):
    """The stateful handle (K3 on each process's pieces) bit-equal to the
    single-process engine, and within rtol 1e-5 / atol 1e-6 of JAX."""
    data = child.inputs()[name]
    jeng = _jax_engine(name, "xla", server_handle=child.ADAM)
    jeng.register_dense("a", child.KEYS, child.VAL_LEN)
    want = {step: np.asarray(jeng.push_pull("a", data[step]))
            for step in (2, 3)}
    for got in workers:
        for step in (2, 3):
            key = f"{name}_adam{step}"
            np.testing.assert_array_equal(got[key], single[key])
            np.testing.assert_allclose(got[key], want[step][:TOTAL],
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got[f"{name}_adam_m"],
                                      single[f"{name}_adam_m"])


@pytest.mark.parametrize("name", ["2d", "composite_wa"])
def test_int8_dp_sub_rings(workers, single, name):
    """The compressed dp sub-rings across processes (the store takes the
    pulled values): bit-equal to the single-process engine."""
    for got in workers:
        for op in ("pp", "pull"):
            key = f"{name}_int8_{op}"
            np.testing.assert_array_equal(got[key], single[key])


def test_2d_ring_matches_jax_pallas(workers):
    """The 2-D ring across processes bit-equal to JAX's Pallas sub-rings
    (interpret mode) on the same (dp 4, kv 2) mesh.  (JAX's interpreter
    stalls on the compressed 4-rank sub-rings; their int8 form is held
    against JAX on (dp 2, kv 4) in tests/test_torch_engine2d.py, and here
    against the port's single-process engine.)"""
    data = child.inputs()["2d"]
    jeng = _jax_engine("2d", "pallas")
    jeng.register_dense("b", child.KEYS, child.VAL_LEN)
    want = np.asarray(jeng.push_pull("b", data[0]))
    for got in workers:
        np.testing.assert_array_equal(got["2d_ring_pp"], want[:TOTAL])


def test_2d_stays_2d_across_a_recut(workers, single):
    """A 2-D engine recut onto another 2-D group spanning both processes
    pulls and pushes as the single-process recut does."""
    for got in workers:
        for key in ("2d_recut_pull", "2d_recut_pp"):
            np.testing.assert_array_equal(got[key], single[key])


def test_int8_1d_across_processes(workers, single):
    """int8 wire compression on the 1-D group: push_pull, push, pull
    (the full-precision store) and the store, bit-equal to one process;
    a pull differs from the dequantized pulled values."""
    for got in workers:
        for key in ("int8_pp", "int8_pull", "int8_pp2", "int8_store"):
            np.testing.assert_array_equal(got[key], single[key],
                                          err_msg=key)
        assert not np.array_equal(got["int8_pull"][:got["int8_pp"].size],
                                  got["int8_pp"])


def test_sparse_table_on_an_nd_group(workers):
    """A table on (kv 4, dp 2), replicated over dp, each process's rows
    its ranks' workers': a push and a pull bit-equal to JAX's
    SparseEngine on the same mesh; after a row-wise Adagrad push the
    store, accumulator and a pull bit-equal to the port's single-process
    engine and within the sparse optimizer's bar of JAX (rtol 1e-5 /
    atol 1e-6, tests/test_torch_sparse.py)."""
    data = child.inputs()
    jse = JaxSparse(_mesh("nd"), "kv")
    se = SparseEngine(make_group((4, 2), ("kv", "dp"), device="cpu"), "kv")
    want, single = {}, {}
    for eng, out in ((jse, want), (se, single)):
        eng.register_sparse("emb", child.ROWS, child.DIM)
        eng.push("emb", data["sp_idx"][0], data["sp_g"][0])
        out["sum_pull"] = np.asarray(eng.pull("emb", data["sp_idx"][2]))
        out["sum_store"] = np.asarray(eng.store_array("emb"))
        eng.push("emb", data["sp_idx"][1], data["sp_g"][1],
                 handle=child.ADAGRAD)
        out["pull"] = np.asarray(eng.pull("emb", data["sp_idx"][2]))
        out["store"] = np.asarray(eng.store_array("emb"))
        out["acc"] = np.asarray(eng.acc_array("emb"))
    for rank, got in enumerate(workers):
        mp = DeviceGroup((4, 2), device="cpu", axis_name=("kv", "dp"),
                         owners=child.OWNERS, process_index=rank)
        for key in ("sum_pull", "pull"):
            mine = child.worker_rows(mp, "kv", want[key])
            np.testing.assert_array_equal(
                got[f"sparse_{key}"], child.worker_rows(mp, "kv",
                                                        single[key]))
            if key == "sum_pull":
                np.testing.assert_array_equal(got["sparse_sum_pull"], mine)
            else:
                np.testing.assert_allclose(got["sparse_pull"], mine,
                                           rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got["sparse_sum_store"],
                                      want["sum_store"])
        for key in ("store", "acc"):
            np.testing.assert_array_equal(got[f"sparse_{key}"], single[key])
            np.testing.assert_allclose(got[f"sparse_{key}"], want[key],
                                       rtol=1e-5, atol=1e-6)


def test_ranks_on_several_cards_still_raise(monkeypatch):
    """A group whose processes name different devices (ranks on several
    cards, ROADMAP Queue 1 item 9(d)) raises by name."""
    monkeypatch.setattr(distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(distributed, "process_index", lambda: 0)
    monkeypatch.setattr(distributed, "allgather_object",
                        lambda obj: [(4, "cpu"), (4, "meta")])
    with pytest.raises(NotImplementedError,
                       match="ranks on several cards.*Queue 1 item 9"):
        distributed.global_group(local_ranks=4, device="cpu")


def test_global_group_takes_a_shape(monkeypatch):
    """``global_group(shape=)`` lays every process's ranks out on an N-D
    grid, in process order."""
    monkeypatch.setattr(distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(distributed, "process_index", lambda: 1)
    monkeypatch.setattr(distributed, "allgather_object",
                        lambda obj: [(4, "cpu"), (4, "cpu")])
    g = distributed.global_group(("dp", "kv"), local_ranks=4, device="cpu",
                                 shape=(4, 2))
    assert g.shape == {"dp": 4, "kv": 2} and g.owners == child.OWNERS
    assert list(g.local_ranks) == [4, 5, 6, 7]
