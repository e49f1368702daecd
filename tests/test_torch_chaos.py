"""pslite_tpu_torch's chaos van, mirroring ``tests/test_chaos.py``.

The ``PS_CHAOS`` grammar parses as JAX's does, and the port's
``ChaosPolicy`` draws what JAX's draws for the same spec and node ids
(the same seeded ``random.Random`` streams; compared exactly).  Over
``chaos+loopback`` port clusters: drops, delays, reorders and duplicates
healed by the resender, the store exact; a one-way partition timing out
through the resender's give-up; a deaf server (``crash=recv:N``)
detected by the scheduler and its requests bounded by their deadlines.
Over ``chaos+tcp`` the wrapper takes the Python lanes and turns the
native core's reassembly off, so injection sees every data message.
"""

import time

import numpy as np
import pytest

import pslite_tpu_torch as tps
from pslite_tpu.utils.logging import CheckError as JaxCheckError
from pslite_tpu.vans import chaos_van as jchaos
from pslite_tpu_torch.base import server_rank_to_id, worker_rank_to_id
from pslite_tpu_torch.environment import Environment
from pslite_tpu_torch.utils.logging import CheckError
from pslite_tpu_torch.vans import chaos_van as tchaos

from test_torch_msg_plane import (DEADLINE, PortCluster,
                                  _port_loopback_isolation)  # noqa: F401

SPEC = ("seed=42,drop=0.2,send_drop=0.1,delay=1:20,send_delay=5,"
        "reorder=0.1,dup=0.05,part=9>8;8>9,crash=recv:50")


def test_spec_grammar_matches_jax():
    spec = tchaos.parse_spec(SPEC)
    assert spec == jchaos.parse_spec(SPEC)
    assert spec["delay"] == (0.001, 0.02)
    assert spec["partitions"] == {(9, 8), (8, 9)}
    assert (spec["crash_phase"], spec["crash_after"]) == ("recv", 50)
    assert tchaos.parse_spec("")["crash_phase"] is None
    for bad in ("drop=1.5", "crash=apply:3", "frob=1", "drop"):
        with pytest.raises(CheckError):
            tchaos.parse_spec(bad)
        with pytest.raises(JaxCheckError):
            jchaos.parse_spec(bad)


@pytest.mark.parametrize("node_id", [1, 8, 9, 11])
def test_policy_draws_equal_jax(node_id):
    """Same spec and node id: the same drop/dup/reorder decisions and
    delays, in the same order, as JAX's policy (exactly)."""
    spec = "seed=7,drop=0.3,dup=0.2,reorder=0.1,delay=1:20,send_delay=2:4"
    port, jax = tchaos.ChaosPolicy(spec), jchaos.ChaosPolicy(spec)
    kinds = ["drop", "dup", "reorder", "delay", "send_delay"] * 40
    for kind in kinds:
        if kind in ("delay", "send_delay"):
            assert port.delay_s(node_id, kind) == jax.delay_s(node_id, kind)
        else:
            assert port.draw(node_id, kind) == jax.draw(node_id, kind)
    # Different ids diverge.
    a, b = tchaos.ChaosPolicy(spec), tchaos.ChaosPolicy(spec)
    assert ([a.draw(9, "drop") for _ in range(64)]
            != [b.draw(11, "drop") for _ in range(64)])


def test_crash_counter_phases():
    p = tchaos.ChaosPolicy("crash=recv:2")
    for _ in range(2):
        p.count_data("recv")
    assert not p.crashed.is_set()
    p.count_data("send")  # the wrong phase: no effect
    assert not p.crashed.is_set()
    p.count_data("recv")
    assert p.crashed.is_set()
    assert p.crash_blocks("recv") and not p.crash_blocks("send")


def test_chaos_tcp_van_declines_the_native_lanes():
    """Over the native core the wrapper keeps every data message in
    Python: no native submit, no core-side reassembly."""
    po = tps.Postoffice("worker", env=Environment({
        "PS_VAN_TYPE": "chaos+tcp", "PS_NATIVE": "1",
        "PS_NATIVE_REASSEMBLY": "1"}))
    try:
        van = po.van
        assert van._native is not None
        assert van._native_submit(object()) is None
        with pytest.raises(ValueError, match="cannot wrap"):
            tchaos.create_chaos("ici_tcp", po)
    finally:
        po.van._native.destroy()


def test_chaos_matrix_healed_by_resender():
    """drop + delay + reorder + dup on every node, healed by
    ``PS_RESEND``'s acks, retransmits and dedup: the store still sums
    exactly."""
    cluster = PortCluster(num_workers=1, num_servers=2,
                          van_type="chaos+loopback", env_extra={
                              "PS_CHAOS": "seed=11,drop=0.15,delay=0.5:2,"
                                          "reorder=0.1,dup=0.1",
                              "PS_RESEND": "1", "PS_RESEND_TIMEOUT": "60"})
    cluster.start()
    servers = []
    try:
        for po in cluster.servers:
            s = tps.KVServer(0, postoffice=po)
            s.set_request_handle(tps.KVServerDefaultHandle())
            servers.append(s)
        worker = tps.KVWorker(0, 0, postoffice=cluster.workers[0])
        keys = np.array([3, 2**63 + 9], dtype=np.uint64)  # both ranges
        vals = np.ones(32, dtype=np.float32)
        rounds = 8
        for _ in range(rounds):
            worker.wait(worker.push(keys, vals))
        out = np.zeros_like(vals)
        worker.wait(worker.pull(keys, out))
        np.testing.assert_array_equal(out, rounds * vals)
        injected = sum(sum(po.van.chaos_stats.values())
                       for po in cluster.all_nodes())
        assert injected > 0, "chaos injected nothing"
        worker.stop()
    finally:
        for s in servers:
            s.stop()
        cluster.finalize()


def test_oneway_partition_times_out():
    """A one-way partition worker -> server starves the request path:
    the resender gives up and the wait raises TimeoutError."""
    cluster = PortCluster(
        num_workers=1, num_servers=1, van_type="chaos+loopback",
        env_extra={"PS_CHAOS": f"part={worker_rank_to_id(0)}>"
                               f"{server_rank_to_id(0)}",
                   "PS_RESEND": "1", "PS_RESEND_TIMEOUT": "40"})
    cluster.start()
    srv = tps.KVServer(0, postoffice=cluster.servers[0])
    srv.set_request_handle(tps.KVServerDefaultHandle())
    worker = tps.KVWorker(0, 0, postoffice=cluster.workers[0])
    try:
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            worker.wait(worker.push(np.array([3], dtype=np.uint64),
                                    np.ones(8, dtype=np.float32)))
        assert time.monotonic() - t0 < 30.0
        # Cut at the sender (the receiver's filter covers deployments
        # where one endpoint alone carries the spec).
        assert cluster.workers[0].van.chaos_stats["send_partitioned"] > 0
        assert cluster.servers[0].van.chaos_stats["recv_partitioned"] == 0
    finally:
        worker.stop()
        srv.stop()
        for po in cluster.all_nodes():
            po.van.stop()


def test_crash_hook_deaf_server_detected_and_bounded():
    """crash=recv:3: after 3 data messages the server goes deaf and stops
    heartbeating; the next request times out within its deadlines and
    the scheduler declares the server dead."""
    cluster = PortCluster(
        num_workers=1, num_servers=1, van_type="chaos+loopback",
        env_extra={"PS_HEARTBEAT_INTERVAL": "0.3",
                   "PS_HEARTBEAT_TIMEOUT": "1.0",
                   "PS_REQUEST_TIMEOUT": "0.3", "PS_REQUEST_RETRIES": "1"},
        per_node_env={"server0": {"PS_CHAOS": "crash=recv:3"}})
    cluster.start()
    srv = tps.KVServer(0, postoffice=cluster.servers[0])
    srv.set_request_handle(tps.KVServerDefaultHandle())
    worker = tps.KVWorker(0, 0, postoffice=cluster.workers[0])
    keys = np.array([3], dtype=np.uint64)
    vals = np.ones(8, dtype=np.float32)
    try:
        for _ in range(3):
            worker.wait(worker.push(keys, vals))
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            worker.wait(worker.push(keys, vals))
        assert time.monotonic() - t0 < 10.0
        assert cluster.servers[0].van.chaos_crashed.is_set()
        end = time.monotonic() + DEADLINE
        while (server_rank_to_id(0)
               not in cluster.scheduler.get_dead_nodes(1.0)):
            assert time.monotonic() < end, "never declared dead"
            time.sleep(0.05)
        assert cluster.servers[0].van.chaos_stats["heartbeat_suppressed"] > 0
    finally:
        worker.stop()
        srv.stop()
        for po in cluster.all_nodes():
            po.van.stop()
