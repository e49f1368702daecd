"""One device group across two worker processes (``PS_ICI_MULTIHOST=1``)
through the port, against the JAX package's single-process engines.

``tests/torch_ici_mp_child.py`` runs ``tests/ici_tcp_child.py``'s
program (a dense bucket pushed and pulled across both processes, a
sparse table pushed and pulled across them, ``KVWorker.reshard`` onto 2
ranks of each process on the live cluster, then more ops on the 4
ranks) over ``ici_tcp`` and ``ici_shm``, each worker process holding 4
ranks of a CPU group whose rows travel through gloo.  The parent puts
the same global rows through JAX's 8-device ``CollectiveEngine`` and
``SparseEngine`` (then recut onto 4 devices): the dense ``sum`` and the
sparse rows bit for bit, adam within rtol 1e-5 / atol 1e-6 (FMA
contraction differs).  On the ring impl (``PS_ICI_IMPL=pallas``, the
cross-process K4's plain version) the dense bucket is held against the
port's single-process ring, itself bit-exact with JAX's Pallas ring
(tests/test_torch_engine.py).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from pslite_tpu.parallel.engine import CollectiveEngine as JaxEngine
from pslite_tpu.parallel.sparse import SparseEngine as JaxSparse
from pslite_tpu_torch import CollectiveEngine, DeviceGroup
from pslite_tpu_torch.utils.network import get_available_port

sys.path.insert(0, os.path.dirname(__file__))
import torch_ici_mp_child as child  # noqa: E402

CHILD = os.path.join(os.path.dirname(__file__), "torch_ici_mp_child.py")
TIMEOUT = 120


def _root_port() -> int:
    """A free port whose successor is free too: the process group's
    coordinator listens on the scheduler's port + 1."""
    for _ in range(100):
        port = get_available_port()
        with socket.socket() as s:
            try:
                s.bind(("", port + 1))
            except OSError:
                continue
        return port
    raise RuntimeError("no free pair of ports")


def _cluster(tmp_path, van: str, impl: str, extra=None) -> list:
    """Scheduler + server in one process, two worker processes; the two
    workers' saved results."""
    port = _root_port()
    base = dict(os.environ, DMLC_NUM_WORKER="2", DMLC_NUM_SERVER="1",
                DMLC_PS_ROOT_URI="127.0.0.1", DMLC_PS_ROOT_PORT=str(port),
                DMLC_NODE_HOST="127.0.0.1", PS_VAN_TYPE=van,
                PS_ICI_MULTIHOST="1", PS_ICI_IMPL=impl,
                PSTEST_OUT=str(tmp_path), PS_SHM_NS=f"mp{port}",
                PSTEST_DEADLINE=str(TIMEOUT - 10), **(extra or {}))
    base.pop("DMLC_RANK", None)
    procs = []
    for roles, rank in (("scheduler,server", None), ("worker", 0),
                        ("worker", 1)):
        env = dict(base, PSTEST_ROLES=roles)
        if rank is not None:
            env["DMLC_RANK"] = str(rank)
        procs.append(subprocess.Popen(
            [sys.executable, CHILD], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
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
            f"[{roles} rc={p.returncode}]\n{out[-3000:]}" for roles, p, out
            in zip(("scheduler,server", "worker 0", "worker 1"), procs,
                   outs)))
    if os.path.isdir("/dev/shm"):
        # The shm van leaves only its pipes' .lock files (by design, while
        # nodes live); every process of the cluster is gone now.
        ours = [f for f in os.listdir("/dev/shm") if base["PS_SHM_NS"] in f]
        assert all(f.endswith(".lock") for f in ours), ours
        for f in ours:
            os.unlink(os.path.join("/dev/shm", f))
    return [dict(np.load(tmp_path / f"worker{r}.npz")) for r in (0, 1)]


def _jax_reference(ring: bool) -> dict:
    """The same global rows through JAX's single-process engines (the
    dense bucket through the port's single-process ring when ``ring``)."""
    r = child.rows()
    devs = jax.devices()
    jeng = JaxEngine(Mesh(np.array(devs[:8]), ("kv",)))
    jse = JaxSparse(jeng.mesh)
    dense = (CollectiveEngine(DeviceGroup(8, device="cpu"), impl="ring")
             if ring else jeng)
    dense.register_dense("g", child.KEYS, child.VAL_LEN)
    jeng.register_dense("a", child.ADAM_KEYS, child.VAL_LEN)
    ref = {}
    for step in range(2):
        ref[f"dense{step}"] = np.asarray(dense.push_pull(
            "g", r["dense"][step]))
        ref[f"adam{step}"] = np.asarray(jeng.push_pull(
            "a", r["adam"][step], handle=child.ADAM))
    jse.register_sparse("emb", child.ROWS, child.DIM)
    jse.push("emb", r["sp_idx"], r["sp_g"])
    ref["sparse_pull"] = np.asarray(jse.pull("emb", r["sp_pull"]))
    ref["sparse_store"] = np.asarray(jse.store_array("emb"))
    ref["store8"] = np.asarray(dense.store_array("g"))
    if ring:
        dense.reshard(DeviceGroup(4, device="cpu"))
    mesh4 = Mesh(np.array(devs[:4]), ("kv",))
    jeng.reshard(mesh4)
    jse.reshard(mesh4)
    ref["pull4"] = np.asarray(dense.pull("g"))
    ref["dense4"] = np.asarray(dense.push_pull("g", r["dense4"]))
    ref["adam4"] = np.asarray(jeng.push_pull("a", r["adam4"],
                                             handle=child.ADAM))
    ref["sparse_pull4"] = np.asarray(jse.pull("emb", r["sp_pull4"]))
    return ref


@pytest.mark.parametrize("van,impl,extra", [
    ("ici_tcp", "xla", {}),
    # Same-host flavour: bootstrap and messages over /dev/shm (with the
    # ring pipes), the rows over the process group.
    ("ici_shm", "xla", {"PS_SHM_RING": "1"}),
    # The cross-process K4's plain version (the ring impl).
    ("ici_tcp", "pallas", {}),
])
def test_two_process_group_matches_single_process_engines(
        tmp_path, van, impl, extra):
    workers = _cluster(tmp_path, van, impl, extra)
    ref = _jax_reference(ring=impl == "pallas")
    total = len(child.KEYS) * child.VAL_LEN
    for rank, got in enumerate(workers):
        for key in ("dense0", "dense1", "pull4", "dense4"):
            np.testing.assert_array_equal(got[key], ref[key][:total],
                                          err_msg=f"{key} worker {rank}")
        np.testing.assert_array_equal(got["store8"][:total],
                                      ref["store8"][:total])
        for key in ("adam0", "adam1", "adam4"):
            np.testing.assert_allclose(got[key], ref[key][:total],
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{key} worker {rank}")
        np.testing.assert_array_equal(got["sparse_pull"],
                                      ref["sparse_pull"][4 * rank:
                                                         4 * rank + 4])
        np.testing.assert_array_equal(got["sparse_store"],
                                      ref["sparse_store"])
        np.testing.assert_array_equal(got["sparse_pull4"],
                                      ref["sparse_pull4"][2 * rank:
                                                          2 * rank + 2])


def test_cross_process_kernels_refuse_the_cpu():
    """The cross-process K4 and its exchange memory run on the card only:
    on CPU tensors they raise, and a CPU group's rows take the plain
    version (above), never a silent substitute."""
    from pslite_tpu_torch.ops import ring_collective as ring
    from pslite_tpu_torch.parallel.peers import PeerSlab
    from pslite_tpu_torch.utils.logging import CheckError

    store = torch.zeros(8)
    with pytest.raises(CheckError, match="runs on the card"):
        ring.ring_reduce_peers([0, 0], store, 0, 8)
    with pytest.raises(CheckError, match="runs on the card"):
        ring.ring_gather_peers([(0, 0, 8)], store)
    group = DeviceGroup(4, device="cpu", owners=(0, 0, 1, 1))
    with pytest.raises(CheckError, match="processes of a CUDA group"):
        PeerSlab(group, 1024)
