"""pslite_tpu_torch's recovery tier against ``tests/test_fault_tolerance.py``.

Whole port clusters in one process over the loopback van
(``PortCluster`` of test_torch_msg_plane.py): heartbeats and the
scheduler's failure detector, recovery of a dead id (a replacement takes
it back, its preferred rank winning among several), request deadlines
(``PS_REQUEST_TIMEOUT``/``PS_REQUEST_RETRIES``) surfacing TimeoutError
through ``wait``, the resender's give-up failing the owning request,
rehabilitation of a node falsely declared dead, and the elastic
Postoffice that item 8(b2) ported (its deadline default).  A retried int8 push resends the bytes it
sent first, so the server applies the codes once and its store is
bit-equal to a decode of them (tolerance: none).

Every start, wait and poll has a deadline of its own; the time bounds
asserted are JAX's (10 s for two retries of 0.3 s), far above what the
runs need.  Heartbeats are 0.5 s / 2 s (JAX's tests use 0.3 s / 1 s and
1 s / 2 s): a false alarm of the detector under load would fail a
healthy request.
"""

import time

import numpy as np
import pytest

import pslite_tpu_torch as tps
from pslite_tpu_torch.base import SCHEDULER_ID, server_rank_to_id
from pslite_tpu_torch.environment import Environment
from pslite_tpu_torch.message import Message, Node, Role
from pslite_tpu_torch.ops import codecs as tcodecs
from pslite_tpu_torch.vans.resender import Resender

from test_torch_msg_plane import (DEADLINE, PortCluster, run_all,
                                  _port_loopback_isolation)  # noqa: F401

HB = {"PS_HEARTBEAT_INTERVAL": "0.5", "PS_HEARTBEAT_TIMEOUT": "2.0"}
HB_TIMEOUT = float(HB["PS_HEARTBEAT_TIMEOUT"])


def poll(cond, what: str, deadline: float = DEADLINE) -> None:
    end = time.monotonic() + deadline
    while not cond():
        assert time.monotonic() < end, f"{what} within {deadline}s"
        time.sleep(0.05)


def crash_exit(nodes) -> None:
    """Stop every van still running: a finalize barrier would wait for
    the dead node forever."""
    for po in nodes:
        try:
            po.van.stop()
        except Exception:  # noqa: BLE001 - best-effort teardown
            pass


def start_replacement(cluster, role, **env) -> tps.Postoffice:
    """A new node of ``role`` that registers with the running cluster
    (on a thread of its own, under the deadline)."""
    po = tps.Postoffice(role, env=Environment(dict(cluster.base_env, **env)))
    run_all([po.start], "replacement start")
    return po


def test_dead_server_recovers_and_takes_pushes_again():
    """A server's van stops (a crash); the detector declares it dead; a
    replacement registers and takes the dead id back (``is_recovery``:
    no startup barrier); the worker resets its sids toward it, clears
    its down mark and hears about it through the hook; a push then
    reaches the replacement's store, which starts empty."""
    cluster = PortCluster(num_workers=1, num_servers=2, env_extra=HB)
    cluster.start()
    worker_po = cluster.workers[0]
    events = []
    worker_po.register_node_failure_hook(
        lambda nid, down: events.append((nid, down)))
    dead_id = server_rank_to_id(1)
    victim = next(po for po in cluster.servers
                  if po.van.my_node.id == dead_id)
    alive = [cluster.scheduler, worker_po] + [
        po for po in cluster.servers if po is not victim]
    apps = []
    try:
        w = tps.KVWorker(0, 0, postoffice=worker_po)
        apps.append(w)
        keys = np.array([r.begin + 3 for r in
                         worker_po.get_server_key_ranges()], np.uint64)
        for po in cluster.servers:
            srv = tps.KVServer(0, postoffice=po)
            srv.set_request_handle(tps.KVServerDefaultHandle())
            apps.append(srv)
        w.wait(w.push(keys, np.ones(8, np.float32)))
        assert dead_id in worker_po.van._send_sids
        victim.van.stop()
        poll(lambda: worker_po.van.is_peer_down(dead_id), "declared dead")
        assert dead_id in cluster.scheduler.get_dead_nodes(HB_TIMEOUT)

        rep = start_replacement(cluster, "server", **HB)
        alive.append(rep)
        assert rep.van.my_node.id == dead_id
        assert rep.is_recovery
        srv = tps.KVServer(0, postoffice=rep)
        srv.set_request_handle(tps.KVServerDefaultHandle())
        apps.append(srv)
        addr = rep.van.my_node.addr_key()
        poll(lambda: worker_po.van._connected_nodes.get(addr) == dead_id,
             "the worker connected to the replacement")
        assert not worker_po.van.is_peer_down(dead_id)
        assert (dead_id, True) in events and (dead_id, False) in events
        assert dead_id not in worker_po.van._send_sids  # reset
        assert not cluster.scheduler.van.is_peer_down(dead_id)

        w.wait(w.push(keys, np.full(8, 2.0, np.float32)))
        out = np.zeros(8, np.float32)
        w.wait(w.pull(keys, out))
        # Server 0 kept its store; the replacement starts empty.
        np.testing.assert_array_equal(out, [3.0] * 4 + [2.0] * 4)
    finally:
        for a in apps:
            a.stop()
        crash_exit(alive)


def test_two_dead_servers_recovery_honours_the_preferred_rank():
    """With two dead servers, a replacement carrying ``DMLC_RANK=2``
    takes rank 2's id, although rank 0's is first; a second one without
    a preference takes the remaining one.  A worker registering late
    with no dead id of its role is ignored (JAX's "unexpected late
    ADD_NODE")."""
    cluster = PortCluster(num_workers=1, num_servers=3, env_extra=HB)
    cluster.start()
    victims = [po for po in cluster.servers
               if po.van.my_node.id in (server_rank_to_id(0),
                                        server_rank_to_id(2))]
    alive = [cluster.scheduler, cluster.workers[0]] + [
        po for po in cluster.servers if po not in victims]
    try:
        for v in victims:
            v.van.stop()
        poll(lambda: {server_rank_to_id(0), server_rank_to_id(2)}
             <= set(cluster.scheduler.get_dead_nodes(HB_TIMEOUT)),
             "both dead")
        first = start_replacement(cluster, "server", DMLC_RANK="2", **HB)
        alive.append(first)
        assert first.van.my_node.id == server_rank_to_id(2)
        assert first.is_recovery
        second = start_replacement(cluster, "server", **HB)
        alive.append(second)
        assert second.van.my_node.id == server_rank_to_id(0)

        # No worker is dead: a worker registering now is ignored.
        sched = cluster.scheduler.van
        before = [n.id for n in sched._registrations]
        sched._handle_late_registration([Node(role=Role.WORKER,
                                              hostname="lo", ports=[1])])
        assert [n.id for n in sched._registrations] == before
    finally:
        crash_exit(alive)


def test_retransmitted_barrier_request_counts_once():
    """With ``PS_RESEND``, a startup barrier request that reached the
    scheduler before its resender existed is retransmitted later; the
    scheduler must not count it toward the next barrier (it did, once in
    ~15 chaos-matrix runs, releasing the finalize barrier early and
    leaving two nodes in it forever)."""
    from pslite_tpu_torch.base import ALL_GROUP
    from pslite_tpu_torch.message import Command, Control

    cluster = PortCluster(num_workers=1, num_servers=1)
    cluster.start()
    try:
        sched = cluster.scheduler.van
        stale = Message()
        stale.meta.request = True
        stale.meta.sender = cluster.workers[0].van.my_node.id
        stale.meta.timestamp = 1  # older than its counted startup request
        stale.meta.control = Control(cmd=Command.INSTANCE_BARRIER,
                                     barrier_group=ALL_GROUP)
        sched._process_barrier(stale, instance=True)
        assert not sched._barrier_senders[(ALL_GROUP, True)]
    finally:
        cluster.finalize()


def test_heartbeat_timeout_implied_by_interval():
    """PS_HEARTBEAT_INTERVAL implies a timeout of 5 intervals; an
    explicit timeout wins, an explicit 0 turns detection off."""
    base = {"DMLC_NUM_WORKER": "1", "DMLC_NUM_SERVER": "1",
            "DMLC_PS_ROOT_URI": "lo", "DMLC_PS_ROOT_PORT": "1",
            "PS_VAN_TYPE": "loopback", "PS_HEARTBEAT_INTERVAL": "2"}
    for extra, want in (({}, 10.0), ({"PS_HEARTBEAT_TIMEOUT": "3"}, 3.0),
                        ({"PS_HEARTBEAT_TIMEOUT": "0"}, 0.0)):
        po = tps.Postoffice(Role.SCHEDULER,
                            env=Environment(dict(base, **extra)))
        assert po.van.heartbeat_timeout_s() == want


def test_registration_seeds_heartbeat_entries():
    """The scheduler seeds every registrant and every node seeds the
    scheduler: a late registrant is never aged from process start."""
    cluster = PortCluster(num_workers=1, num_servers=1)
    cluster.start()
    try:
        assert set(cluster.scheduler._heartbeats) >= {8, 9}
        for po in cluster.servers + cluster.workers:
            assert SCHEDULER_ID in po._heartbeats
            assert po.get_dead_nodes(timeout_s=30) == []
    finally:
        cluster.finalize()


def _timeout_cluster(heartbeats=True, **extra):
    """1 + 1 + 1 with deadlines of 0.3 s and 2 retries (``extra``
    overrides).  The retry tests that check exact stores run without
    heartbeats: a detector's false alarm under load would retry a
    healthy push, and a retried push applies twice."""
    env = dict(HB if heartbeats else {}, PS_REQUEST_TIMEOUT="0.3",
               PS_REQUEST_RETRIES="2")
    env.update(extra)
    cluster = PortCluster(num_workers=1, num_servers=1, env_extra=env)
    cluster.start()
    srv = tps.KVServer(0, postoffice=cluster.servers[0])
    srv.set_request_handle(tps.KVServerDefaultHandle())
    return cluster, srv, tps.KVWorker(0, 0, postoffice=cluster.workers[0])


def test_wait_raises_timeout_against_killed_server():
    """A push to a dead server raises TimeoutError through ``wait``,
    bounded in time, and an abandoned request's callback never fires."""
    cluster, srv, w = _timeout_cluster()
    keys = np.array([3], np.uint64)
    vals = np.ones(8, np.float32)
    try:
        w.wait(w.push(keys, vals))  # a healthy round first
        assert w._sweep_thread is not None and w._sweep_thread.is_alive()
        cluster.servers[0].van.stop()  # crash
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            w.wait(w.push(keys, vals))
        assert time.monotonic() - t0 < 10.0
        fired = []
        with pytest.raises(TimeoutError):
            w.wait(w.push(keys, vals, callback=lambda: fired.append(1)))
        out = np.zeros(8, np.float32)
        with pytest.raises(TimeoutError):
            w.wait(w.pull(keys, out, callback=lambda: fired.append(2)))
        assert not fired
        assert not w._pending
    finally:
        w.stop()
        assert w._sweep_thread is None
        srv.stop()
        crash_exit([cluster.scheduler, cluster.workers[0]])


def test_lost_request_is_retried_and_completes():
    """The server's van swallows the worker's first push: after the
    deadline the sweeper sends the slice again as a new message (a new
    sid), the push applies once and ``wait`` returns."""
    cluster, srv, w = _timeout_cluster(False, PS_REQUEST_TIMEOUT="1.0",
                                       PS_REQUEST_RETRIES="3")
    sv = cluster.servers[0].van
    dropped = []
    inner = sv._accept_data

    def drop_first_push(msg):
        if msg.meta.push and msg.meta.request and not dropped:
            dropped.append(msg.meta.sid)
            return
        inner(msg)

    sv._accept_data = drop_first_push
    keys = np.array([5], np.uint64)
    try:
        t0 = time.monotonic()
        w.wait(w.push(keys, np.ones(4, np.float32)))
        assert time.monotonic() - t0 < 10.0
        assert len(dropped) == 1
        out = np.zeros(4, np.float32)
        w.wait(w.pull(keys, out))
        np.testing.assert_array_equal(out, np.ones(4, np.float32))
        w.stop()
        srv.stop()
    finally:
        del sv._accept_data
        cluster.finalize()


def test_retried_int8_push_resends_identical_bytes():
    """An int8 push whose first send is lost is retried with the codes
    and scales encoded the first time (the error-feedback residual is
    folded once): both sends carry the same bytes, and the store is
    the decode of those codes, exactly."""
    cluster, srv, w = _timeout_cluster(False, PS_REQUEST_TIMEOUT="1.0",
                                       PS_REQUEST_RETRIES="3")
    wv, sv = cluster.workers[0].van, cluster.servers[0].van
    sent = []
    inner_send = wv.send

    def capture(msg):
        if msg.meta.push and msg.meta.request:
            sent.append([msg.meta.codec.flags]
                        + [np.asarray(d.data).tobytes() for d in msg.data])
        return inner_send(msg)

    wv.send = capture
    dropped = []
    inner_accept = sv._accept_data

    def drop_first_push(msg):
        if msg.meta.push and msg.meta.request and not dropped:
            dropped.append(1)
            return
        inner_accept(msg)

    sv._accept_data = drop_first_push
    keys = np.array([7, 8], np.uint64)
    vals = np.random.default_rng(3).standard_normal(512).astype(np.float32)
    try:
        w.wait(w.push(keys, vals, codec="int8"))
        assert len(sent) == 2 and dropped
        assert sent[0] == sent[1]
        codes = np.frombuffer(sent[0][2], np.uint8)
        scales = np.frombuffer(sent[0][3], np.float32)
        want = tcodecs.get_codec("int8").decode(codes, scales, vals.size,
                                                flags=sent[0][0])
        got = np.concatenate([srv._handle.store[7], srv._handle.store[8]])
        assert got.tobytes() == want.tobytes()
        w.stop()
        srv.stop()
    finally:
        del wv.send
        del sv._accept_data
        cluster.finalize()


def test_resender_exhaustion_fails_owning_request():
    """When the resender gives up, the owning request fails (an
    OPT_SEND_FAILED response): ``wait`` raises TimeoutError."""
    cluster = PortCluster(num_workers=1, num_servers=1, env_extra={
        "PS_RESEND": "1", "PS_RESEND_TIMEOUT": "40"})
    cluster.start()
    srv = tps.KVServer(0, postoffice=cluster.servers[0])
    srv.set_request_handle(tps.KVServerDefaultHandle())
    w = tps.KVWorker(0, 0, postoffice=cluster.workers[0])
    keys = np.array([3], np.uint64)
    vals = np.ones(8, np.float32)
    try:
        w.wait(w.push(keys, vals))
        cluster.servers[0].van.stop()
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            w.wait(w.push(keys, vals))
        assert time.monotonic() - t0 < 30.0
    finally:
        w.stop()
        srv.stop()
        crash_exit([cluster.scheduler, cluster.workers[0]])


class _FakeVan:
    env = Environment({"PS_RESEND_ACK_CACHE": "1024"})

    @staticmethod
    def send(msg):
        pass

    @staticmethod
    def is_peer_down(node_id):
        return False


def _msg(ts, sender=9, recver=8):
    m = Message()
    m.meta.sender, m.meta.recver, m.meta.timestamp = sender, recver, ts
    return m


def test_resender_ack_cache_bounded_and_reset_per_peer():
    """The dedup set is bounded FIFO; after ``reset_peer`` a restarted
    sender's messages (timestamps and sids from the start again) are
    new, and the messages still unacked toward it are handed back."""
    r = Resender(_FakeVan(), timeout_ms=10_000)
    try:
        for i in range(3000):
            assert not r.add_incoming(_msg(i))
        assert len(r._acked) == 1024
        assert r.add_incoming(_msg(2999))  # recent: a duplicate
        out = _msg(5, sender=8, recver=9)
        r.add_outgoing(out)
        r.add_outgoing(_msg(6, sender=8, recver=11))
        assert r.reset_peer(9) == [out]
        assert not r.add_incoming(_msg(2999))  # the new life's message
        assert r.add_incoming(_msg(2999))
        assert r.add_incoming(_msg(2999, sender=13)) is False
    finally:
        r.stop()


def test_false_positive_rehabilitation_reaches_peers():
    """A node falsely declared dead (slow, not crashed) is
    rehabilitated on its next heartbeat, at the scheduler and at every
    peer that heard the NODE_FAILURE."""
    cluster = PortCluster(num_workers=1, num_servers=1, env_extra={
        "PS_HEARTBEAT_INTERVAL": "0.2", "PS_HEARTBEAT_TIMEOUT": "30"})
    cluster.start()
    victim = server_rank_to_id(0)
    sched_van = cluster.scheduler.van
    worker_van = cluster.workers[0].van
    events = []
    cluster.workers[0].register_node_failure_hook(
        lambda nid, down: events.append((nid, down)))
    try:
        sched_van._announced_dead.add(victim)
        sched_van.mark_peer_down(victim)
        worker_van.mark_peer_down(victim)
        poll(lambda: not worker_van.is_peer_down(victim), "rehabilitated")
        assert not sched_van.is_peer_down(victim)
        assert victim not in sched_van._announced_dead
        assert (victim, False) in events
    finally:
        cluster.finalize()


def test_what_stays_refused_names_item_8b():
    """Elastic membership, refused until item 8(b2) was ported, builds:
    a ``PS_ELASTIC=1`` Postoffice holds no table before its cluster
    starts (static ranks), and a worker of an elastic cluster gets JAX's
    default deadline of 10 s.  Deadlines under replication build a
    worker whose retries fail over down the replica chain
    (``tests/test_torch_replication.py`` drives them)."""
    po = tps.Postoffice("worker", env=Environment({"PS_ELASTIC": "1",
                                                   "PS_VAN_TYPE": "ici"}))
    assert po.elastic and not po.elastic_join
    assert po.current_routing() is None and po.active_server_ranks is None
    elastic = PortCluster(env_extra={"PS_ELASTIC": "1"})
    elastic.start()
    try:
        w = tps.KVWorker(0, 0, postoffice=elastic.workers[0])
        assert w._req_timeout == 10.0
        assert elastic.workers[0].current_routing().epoch == 0
        w.stop()
    finally:
        elastic.finalize()
    cluster = PortCluster(env_extra={"PS_REQUEST_TIMEOUT": "1",
                                     "PS_KV_REPLICATION": "2"})
    cluster.start()
    try:
        w = tps.KVWorker(0, 0, postoffice=cluster.workers[0])
        assert w._req_timeout == 1.0 and w._replication == 2
        w.stop()
    finally:
        cluster.finalize()
