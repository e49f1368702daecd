"""The port's multi-process bootstrap (``parallel/distributed.py``),
device groups across processes (``parallel/mesh.py``) and the placement
helpers (``parallel/placement.py``), against the JAX package's.

The lease tests mirror ``tests/test_ici_tcp_multiprocess.py``'s
``test_init_distributed_idempotent`` and
``test_acquire_release_owned_lifecycle`` on a monkeypatched
``torch.distributed``; the placement helpers run on a real 2-process
gloo group (two subprocesses, each under a 120 s deadline).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pslite_tpu.environment import Environment as JaxEnvironment
from pslite_tpu.parallel import distributed as jdist
from pslite_tpu.utils.logging import CheckError as JaxCheckError
from pslite_tpu_torch import DeviceGroup
from pslite_tpu_torch.environment import Environment
from pslite_tpu_torch.parallel import distributed, placement
from pslite_tpu_torch.utils.logging import CheckError
from pslite_tpu_torch.utils.network import get_available_port

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BASE = {"DMLC_NUM_WORKER": "2", "DMLC_PS_ROOT_URI": "127.0.0.1",
        "DMLC_PS_ROOT_PORT": "12345", "DMLC_RANK": "0"}


@pytest.mark.parametrize("env", [
    BASE,
    dict(BASE, DMLC_RANK="1", DMLC_PS_ROOT_URI="10.0.0.9",
         DMLC_PS_ROOT_PORT="999"),
    dict(BASE, DMLC_NUM_WORKER="4", DMLC_RANK="3"),
    {k: v for k, v in BASE.items() if k != "DMLC_PS_ROOT_URI"},
    {k: v for k, v in BASE.items() if k != "DMLC_NUM_WORKER"},
    {k: v for k, v in BASE.items() if k != "DMLC_RANK"},
    dict(BASE, DMLC_RANK="2"),
    dict(BASE, DMLC_RANK="-1"),
], ids=["rank0", "rank1", "four", "no_uri", "no_workers", "no_rank",
        "rank_past_world", "negative_rank"])
def test_distributed_options_match_jax(env):
    """The same coordinator/world/rank arithmetic, and the same check
    (and message) where an environment is incomplete."""
    try:
        want = jdist.distributed_options(JaxEnvironment(env))
    except JaxCheckError as exc:
        with pytest.raises(CheckError) as got:
            distributed.distributed_options(Environment(env))
        assert str(got.value) == str(exc)
        return
    assert distributed.distributed_options(Environment(env)) == want


@pytest.fixture
def fresh_leases(monkeypatch):
    """Module lease state restored after the test."""
    monkeypatch.setattr(distributed, "_leases", 0)
    monkeypatch.setattr(distributed, "_opts", None)
    monkeypatch.setattr(distributed, "_owned", False)


def test_init_distributed_idempotent(monkeypatch, fresh_leases):
    """A process hosting several worker instances joins once; on a group
    someone else created, a lease never destroys it."""
    env = Environment(BASE)
    calls, destroys = [], []
    monkeypatch.setattr(distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **kw: calls.append(kw))
    monkeypatch.setattr(torch.distributed, "destroy_process_group",
                        lambda *a: destroys.append(1))
    assert distributed.init_distributed(env) is None
    assert calls == []
    assert distributed.acquire(env) is True
    distributed.release()
    assert destroys == []


def test_acquire_release_owned_lifecycle(monkeypatch, fresh_leases):
    """Owned path: acquire initializes once (gloo, the coordinator's
    tcp:// address, world size and rank); two leases; the group is
    destroyed exactly once, on the LAST release.  Mismatched options are
    refused; single-process configs never touch torch.distributed."""
    env = Environment(BASE)
    state = {"init": [], "destroy": 0, "up": False}
    monkeypatch.setattr(distributed, "is_initialized", lambda: state["up"])

    def fake_init(backend, **kw):
        state["init"].append((backend, kw["init_method"], kw["world_size"],
                              kw["rank"]))
        state["up"] = True

    def fake_destroy(*a):
        state["destroy"] += 1
        state["up"] = False

    monkeypatch.setattr(torch.distributed, "init_process_group", fake_init)
    monkeypatch.setattr(torch.distributed, "destroy_process_group",
                        fake_destroy)
    assert distributed.acquire(env) is True
    assert distributed.acquire(env) is True
    assert state["init"] == [("gloo", "tcp://127.0.0.1:12346", 2, 0)]
    other = Environment(dict(BASE, DMLC_PS_ROOT_URI="10.0.0.9",
                             DMLC_PS_ROOT_PORT="999"))
    with pytest.raises(CheckError, match="mismatched"):
        distributed.acquire(other)
    distributed.release()
    assert state["destroy"] == 0  # a sibling lease is still out
    distributed.release()
    assert state["destroy"] == 1
    distributed.release()  # an extra release is a no-op
    assert state["destroy"] == 1
    monkeypatch.setattr(distributed, "is_initialized",
                        lambda: (_ for _ in ()).throw(AssertionError))
    assert distributed.init_distributed(Environment(
        {"DMLC_NUM_WORKER": "1"})) is None
    assert distributed.acquire(Environment({"DMLC_NUM_WORKER": "1"})) is False


def test_failed_connect_unwinds(monkeypatch, fresh_leases):
    """A connect that fails after the group registered is destroyed, so
    a retry initializes again; no lease is taken."""
    state = {"up": False, "destroyed": 0}
    monkeypatch.setattr(torch.distributed, "is_initialized",
                        lambda: state["up"])

    def half_init(*a, **kw):
        state["up"] = True
        raise RuntimeError("coordinator unreachable")

    def destroy(*a):
        state["destroyed"] += 1
        state["up"] = False

    monkeypatch.setattr(torch.distributed, "init_process_group", half_init)
    monkeypatch.setattr(torch.distributed, "destroy_process_group", destroy)
    with pytest.raises(RuntimeError, match="unreachable"):
        distributed.acquire(Environment(BASE))
    assert state == {"up": False, "destroyed": 1}
    assert distributed._leases == 0 and distributed._opts is None


def test_device_group_owners():
    g0 = DeviceGroup(6, device="cpu", owners=(0, 0, 0, 1, 1, 1),
                     process_index=0)
    g1 = DeviceGroup(6, device="cpu", owners=(0, 0, 0, 1, 1, 1),
                     process_index=1)
    assert g0.is_multiprocess and g1.is_multiprocess
    assert (g0.owners, g0.shape, g0.axis_names) == \
        (g1.owners, g1.shape, g1.axis_names)
    assert list(g0.local_ranks) == [0, 1, 2]
    assert list(g1.local_ranks) == [3, 4, 5]
    assert [g0.process_of(r) for r in range(6)] == [0, 0, 0, 1, 1, 1]
    assert g0.processes == (0, 1)
    assert placement.mesh_is_multiprocess(g0)
    assert placement.local_shard_count(g1) == 3
    single = DeviceGroup(6, device="cpu")
    assert not single.is_multiprocess and single.owners is None
    assert list(single.local_ranks) == list(range(6))
    assert placement.local_shard_count(single) == 6
    with pytest.raises(ValueError, match="process order"):
        DeviceGroup(4, device="cpu", owners=(1, 0, 0, 1))
    with pytest.raises(ValueError, match="owns no rank"):
        DeviceGroup(2, device="cpu", owners=(0, 1), process_index=2)


_PLACEMENT_CHILD = r"""
import json, os, sys
sys.path.insert(0, os.environ["REPO"])
import torch
from pslite_tpu_torch.environment import Environment
from pslite_tpu_torch.parallel import distributed, placement

rank = int(os.environ["DMLC_RANK"])
assert distributed.acquire(Environment({}))
g = distributed.global_group(local_ranks=rank + 1, device="cpu")
host = torch.arange(12.0).reshape(6, 2)
local = placement.place_host_array(g, host)
full = placement.to_host_global(local, placement.mesh_is_multiprocess(g))
padded = placement.place_host_array(g, torch.arange(5.0), length=6)
print(json.dumps({
    "owners": list(g.owners), "local": list(g.local_ranks),
    "multi": placement.mesh_is_multiprocess(g),
    "count": placement.local_shard_count(g),
    "placed": local.tolist(), "full": full.tolist(),
    "padded": padded.tolist(),
    "objs": distributed.allgather_object(rank * 10)}), flush=True)
distributed.release()
assert not distributed.is_initialized()
"""


def test_placement_helpers_on_two_processes():
    """``global_group`` over 1 + 2 ranks, then ``place_host_array`` (each
    process its ranks' rows) and ``to_host_global`` (the whole array
    again, a collective) on a real gloo group."""
    port = get_available_port()
    env = dict(os.environ, REPO=_REPO, DMLC_NUM_WORKER="2",
               DMLC_PS_ROOT_URI="127.0.0.1", DMLC_PS_ROOT_PORT=str(port))
    procs = [subprocess.Popen([sys.executable, "-c", _PLACEMENT_CHILD],
                              env=dict(env, DMLC_RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    got = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    rows = np.arange(12.0).reshape(6, 2)
    for r, g in enumerate(got):
        assert g["owners"] == [0, 1, 1] and g["multi"]
        assert g["local"] == ([0] if r == 0 else [1, 2])
        assert g["count"] == r + 1
        assert g["placed"] == (rows[:2] if r == 0 else rows[2:]).tolist()
        assert g["full"] == rows.tolist()
        assert g["padded"] == ([0.0, 1.0] if r == 0 else [2.0, 3.0, 4.0,
                                                          0.0])
        assert g["objs"] == [0, 10]
