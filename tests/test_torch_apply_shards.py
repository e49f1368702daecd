"""pslite_tpu_torch's apply-shard pool against serial apply and against
the JAX package's pool.

Whole clusters run in one process over the loopback van (the JAX package
through ``tests/helpers.py``'s ``LoopbackCluster``, the port through
``test_torch_msg_plane.PortCluster``), the same seeded pushes through
each.  Tolerance: none.  Stores and pulls are bit-equal: each key's ops
run on one shard thread in arrival order, so every key sees the serial
path's float32 ``+=`` and optimizer updates in the same order (a
two-worker storm pushes small integers, exact in any order across
workers).  Mirrors ``tests/test_apply_shards.py``; then the pool's own
contracts on a stub server: per-sender response order, streamed feeds,
the fence, and what waits for ROADMAP Queue 1 item 6(b).
"""

import threading
import time
import types

import numpy as np
import pytest

import pslite_tpu as jps
import pslite_tpu.ops.codecs  # noqa: F401 - jps.ops.codecs
import pslite_tpu_torch as tps
from pslite_tpu_torch.kv.apply_shards import ApplyShardPool
from pslite_tpu_torch.kv.kv_app import KVMeta, KVPairs
from pslite_tpu_torch.message import Message, OPT_XFER_PART
from pslite_tpu_torch.sarray import SArray
from pslite_tpu_torch.utils.queues import PriorityRecvQueue

from helpers import LoopbackCluster
from test_torch_msg_plane import (  # noqa: F401 - the fixture applies here
    PortCluster,
    _port_loopback_isolation,
)

JAX = types.SimpleNamespace(cluster=LoopbackCluster, KVServer=jps.KVServer,
                            KVWorker=jps.KVWorker,
                            DefaultHandle=jps.KVServerDefaultHandle,
                            OptimizerHandle=jps.KVServerOptimizerHandle)
PORT = types.SimpleNamespace(cluster=PortCluster, KVServer=tps.KVServer,
                             KVWorker=tps.KVWorker,
                             DefaultHandle=tps.KVServerDefaultHandle,
                             OptimizerHandle=tps.KVServerOptimizerHandle)


def run(api, shards, scenario, num_workers=1, make_handle=None):
    """``scenario(api, server, handle, workers)`` on a started cluster of
    one server (``PS_APPLY_SHARDS=shards``, None for the default) and
    ``num_workers`` workers; returns (its result, a copy of the store)."""
    env = {} if shards is None else {"PS_APPLY_SHARDS": str(shards)}
    cluster = api.cluster(num_workers=num_workers, num_servers=1,
                          env_extra=env)
    cluster.start()
    srv = None
    try:
        handle = (make_handle or api.DefaultHandle)()
        srv = api.KVServer(0, postoffice=cluster.servers[0])
        srv.set_request_handle(handle)
        workers = [api.KVWorker(0, 0, postoffice=po)
                   for po in cluster.workers]
        out = scenario(api, srv, handle, workers)
        store = {int(k): v.copy() for k, v in handle.store.items()}
        for w in workers:
            w.stop()
        return out, store
    finally:
        if srv is not None:
            srv.stop()
        cluster.finalize()


def assert_bit_equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert_bit_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_bit_equal(x, y)
    else:
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def storm(api, srv, handle, workers):
    """Two workers push concurrently to shared and own keys (small
    integers: exact in any cross-worker order), then one pulls."""
    shared = np.arange(1, 9, dtype=np.uint64)
    k = 64
    errors = []

    def pusher(w):
        try:
            own = np.arange(100 + 10 * w, 104 + 10 * w, dtype=np.uint64)
            ts = []
            for i in range(12):
                ts.append(workers[w].push(
                    shared, np.full(len(shared) * k, 1.0 + w, np.float32)))
                ts.append(workers[w].push(
                    own, np.full(len(own) * k, 2.0 + i, np.float32)))
            for t in ts:
                workers[w].wait(t)
        except Exception as exc:  # noqa: BLE001 - asserted below
            errors.append(exc)

    threads = [threading.Thread(target=pusher, args=(w,)) for w in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    out = np.zeros(len(shared) * k, np.float32)
    workers[0].wait(workers[0].pull(shared, out))
    return [out]


def sequential(codec=None, rounds=6, n_keys=24, k=700):
    """One worker's seeded normal pushes (one order of addition), a fused
    push_pull and a pull; ``codec`` registers the keys' bucket codec (a
    fixed-k codec push reaches the pool undecoded, and each shard
    decodes its own keys)."""
    def scenario(api, srv, handle, workers):
        w = workers[0]
        keys = np.arange(3, 3 + 2 * n_keys, 2, dtype=np.uint64)
        if codec is not None:
            w.register_bucket(keys, codec=codec)
        rng = np.random.default_rng(5)
        for _ in range(rounds):
            w.wait(w.push(keys, rng.standard_normal(n_keys * k,
                                                    dtype=np.float32)))
        fused = np.zeros(n_keys * k, np.float32)
        w.wait(w.push_pull(keys, rng.standard_normal(n_keys * k,
                                                     dtype=np.float32),
                           fused))
        out = np.zeros(n_keys * k, np.float32)
        w.wait(w.pull(keys, out))
        return [fused, out]
    return scenario


CASES = {
    "default-storm": (storm, 2, None),
    "default": (sequential(), 1, None),
    "sgd_momentum": (sequential(), 1, "sgd_momentum"),
    "adam": (sequential(), 1, "adam"),
    "default-int8": (sequential("int8"), 1, None),
    "default-fp8_e4m3": (sequential("fp8_e4m3"), 1, None),
    "adam-bf16": (sequential("bf16"), 1, "adam"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pool_stores_bit_equal_to_serial_and_to_jax_pool(case):
    scenario, workers, kind = CASES[case]

    def handle_of(api):
        if kind is None:
            return None
        return lambda: api.OptimizerHandle(kind=kind, lr=0.05)

    # The JAX package sets its two fp8 tables one after the other, so
    # its shard threads decoding at once may find the second unset
    # (ROADMAP Queue 3): build them first.
    jps.ops.codecs.Fp8E4M3Codec._luts()
    jax = run(JAX, 4, scenario, workers, handle_of(JAX))
    pool = run(PORT, 4, scenario, workers, handle_of(PORT))
    serial = run(PORT, 0, scenario, workers, handle_of(PORT))
    assert_bit_equal(pool, serial)
    assert_bit_equal(pool, jax)


def test_shard_count_has_jax_meaning():
    """Default ``min(8, cores)`` shards; ``0`` is serial, ``1`` a pool of
    one shard (JAX's meaning); a handle without ``apply_shard`` runs
    serially whatever the setting."""
    import os

    def shards(api, srv, handle, workers):
        pool = srv._apply_pool
        return None if pool is None else pool.num_shards

    cores = len(os.sched_getaffinity(0))
    assert run(PORT, None, shards)[0] == min(8, cores)
    assert run(PORT, 0, shards)[0] is None
    assert run(PORT, 1, shards)[0] == 1
    assert run(JAX, 1, shards)[0] == 1

    cluster = PortCluster(env_extra={"PS_APPLY_SHARDS": "4"})
    cluster.start()
    try:
        srv = tps.KVServer(0, postoffice=cluster.servers[0])
        srv.set_request_handle(lambda meta, kvs, server:
                               server.response(meta))
        assert srv._apply_pool is None
        srv.set_request_handle(tps.KVServerDefaultHandle())
        assert srv._apply_pool.num_shards == 4
        srv.stop()
    finally:
        cluster.finalize()


def test_global_op_barrier_for_lens_requests():
    """A ``lens`` request cannot be split by key: it runs once through
    the plain handler while every shard is parked, in order with the
    split requests around it."""
    def scenario(api, srv, handle, workers):
        w = workers[0]
        keys = np.array([2, 5], np.uint64)
        vals = np.arange(8, dtype=np.float32)
        w.wait(w.push(keys, vals))
        w.wait(w.push(keys, vals, lens=np.array([4, 4], np.int32)))
        w.wait(w.push(keys, vals))
        out = np.zeros(8, np.float32)
        lens = np.zeros(2, np.int32)
        w.wait(w.pull(keys, out, lens=lens))
        pool = srv._apply_pool
        return [out, lens, np.array([pool.global_requests,
                                     pool.sharded_requests])]

    jax, port = run(JAX, 4, scenario), run(PORT, 4, scenario)
    assert_bit_equal(port, jax)
    out, _lens, counts = port[0]
    np.testing.assert_array_equal(out, 3 * np.arange(8, dtype=np.float32))
    assert counts[0] == 1 and counts[1] >= 3  # the lens push; the others


@pytest.mark.parametrize("shards", [0, 4])
def test_apply_error_fails_fast(shards):
    """A handler exception (a pull of a key never pushed) answers with an
    error: ``wait`` raises at once, and the server keeps working."""
    def scenario(api, srv, handle, workers):
        w = workers[0]
        out = np.zeros(64, np.float32)
        with pytest.raises(RuntimeError, match="failed server-side"):
            w.wait(w.pull(np.array([12345], np.uint64), out))
        vals = np.arange(64, dtype=np.float32)
        w.wait(w.push(np.array([7], np.uint64), vals))
        w.wait(w.pull(np.array([7], np.uint64), out))
        np.testing.assert_array_equal(out, vals)
        return [out]

    assert_bit_equal(run(PORT, shards, scenario), run(JAX, shards, scenario))


def test_registered_buffer_pushes_apply_synchronously():
    """Pipelined pushes into one registered receive buffer (the pump
    overwrites it with each arrival) must each apply before the next is
    copied in, so they aggregate exactly."""
    def scenario(api, srv, handle, workers):
        w = workers[0]
        wid = w.po.van.my_node.id
        srv.register_recv_buffer(wid, 7, np.zeros(256, np.float32))
        keys = np.array([7], np.uint64)
        ts = [w.push(keys, np.full(256, 1.0 + (i % 3), np.float32))
              for i in range(8)]
        for t in ts:
            w.wait(t)
        return [handle.store[7].copy()]

    port = run(PORT, 4, scenario)
    assert_bit_equal(port, run(JAX, 4, scenario))
    np.testing.assert_array_equal(port[0][0], np.full(256, 15.0))


def test_pull_during_pushes_sees_whole_keys():
    """Pulls racing in-place pushes see, per key, one prefix of the push
    sequence: a key's values are uniform, never half-applied."""
    cluster = PortCluster(num_workers=2, env_extra={"PS_APPLY_SHARDS": "4"})
    cluster.start()
    srv = None
    try:
        srv = tps.KVServer(0, postoffice=cluster.servers[0])
        srv.set_request_handle(tps.KVServerDefaultHandle())
        pusher, puller = (tps.KVWorker(0, 0, postoffice=po)
                          for po in cluster.workers)
        keys = np.arange(8, dtype=np.uint64)
        k, rounds = 512, 16
        pusher.wait(pusher.push(keys, np.ones(8 * k, np.float32)))

        def push_storm():
            ts = [pusher.push(keys, np.ones(8 * k, np.float32))
                  for _ in range(rounds)]
            for t in ts:
                pusher.wait(t)

        t = threading.Thread(target=push_storm)
        t.start()
        try:
            for _ in range(20):
                out = np.zeros(8 * k, np.float32)
                puller.wait(puller.pull(keys, out))
                for blk in out.reshape(8, k):
                    assert np.all(blk == blk[0]), np.unique(blk)
                    assert 1.0 <= blk[0] <= rounds + 1
        finally:
            t.join(timeout=60)
        assert not t.is_alive()
        pusher.stop()
        puller.stop()
    finally:
        if srv is not None:
            srv.stop()
        cluster.finalize()


# -- the pool on a stub server ---------------------------------------------------

class _StubServer:
    """Records what the pool emits, in order."""

    def __init__(self):
        self.sent = []
        self.mu = threading.Lock()

    def response(self, meta, res=None):
        with self.mu:
            self.sent.append(("ok" if res is None else "res",
                              meta.timestamp))

    def response_error(self, meta):
        with self.mu:
            self.sent.append(("error", meta.timestamp))


class _SlowHandle(tps.KVServerDefaultHandle):
    """Sleeps on the keys it is told to, so later requests on other
    shards finish first."""

    def __init__(self, slow_keys, fail_keys=()):
        super().__init__()
        self.slow, self.fail = set(slow_keys), set(fail_keys)

    def apply_shard(self, meta, keys, segs):
        if self.slow & {int(k) for k in keys}:
            time.sleep(0.2)
        if self.fail & {int(k) for k in keys}:
            raise ValueError("boom")
        return super().apply_shard(meta, keys, segs)


def _push(ts, keys, vals, sender=9, priority=0):
    meta = KVMeta(push=True, sender=sender, timestamp=ts, priority=priority)
    return meta, KVPairs(keys=np.asarray(keys, np.uint64),
                         vals=np.asarray(vals, np.float32))


def _wait_sent(server, n, timeout=10.0):
    end = time.monotonic() + timeout
    while len(server.sent) < n and time.monotonic() < end:
        time.sleep(0.005)
    assert len(server.sent) == n, server.sent


def test_responses_leave_in_arrival_order_per_sender():
    """A slow request on one shard holds back the responses of later,
    faster requests from the same sender; another sender's responses
    do not wait for it; a failing shard answers with an error in its
    slot; a done response of higher priority overtakes."""
    server = _StubServer()
    pool = ApplyShardPool(_SlowHandle(slow_keys=[0], fail_keys=[6]), 4,
                          server)
    try:
        pool.submit(*_push(1, [0], np.ones(4)))           # slow, shard 0
        pool.submit(*_push(2, [1], np.ones(4)))           # shard 1
        pool.submit(*_push(3, [6], np.ones(4)))           # fails, shard 2
        pool.submit(*_push(4, [3], np.ones(4), sender=5))  # other sender
        pool.submit(*_push(5, [5], np.ones(4), priority=3))  # overtakes
        _wait_sent(server, 5)
        assert server.sent.index(("ok", 4)) < server.sent.index(("ok", 1))
        assert server.sent.index(("ok", 5)) < server.sent.index(("ok", 1))
        mine = [e for e in server.sent if e[1] in (1, 2, 3)]
        assert mine == [("ok", 1), ("ok", 2), ("error", 3)]
        assert pool.quiesce(pool.submit_token(), timeout_s=5)
    finally:
        pool.stop()


def test_streamed_feeds_bit_equal_to_the_whole_push():
    """A push fed in whole-key slices (as a chunked transfer's partials)
    applies exactly as the push applied whole, and its response leaves
    only at close, after every fed slice."""
    rng = np.random.default_rng(11)
    keys = np.arange(40, dtype=np.uint64) * 3
    seed = rng.standard_normal(40 * 300, dtype=np.float32)
    vals = rng.standard_normal(40 * 300, dtype=np.float32)
    stores = []
    for streamed in (False, True):
        server = _StubServer()
        handle = _SlowHandle(slow_keys=[])
        pool = ApplyShardPool(handle, 4, server)
        try:
            pool.submit(*_push(1, keys, seed))
            if streamed:
                h = pool.begin_stream(KVMeta(push=True, sender=9,
                                             timestamp=2))
                for a, b in ((0, 7), (7, 8), (8, 40)):
                    h.feed(KVPairs(keys=keys[a:b],
                                   vals=vals[a * 300:b * 300]))
                time.sleep(0.05)
                assert server.sent == [("ok", 1)]  # not before close
                h.close()
            else:
                pool.submit(*_push(2, keys, vals))
            _wait_sent(server, 2)
            assert server.sent == [("ok", 1), ("ok", 2)]
        finally:
            pool.stop()
        stores.append(handle.store)
    assert_bit_equal(stores[1], stores[0])


def test_stream_of_a_dead_sender_is_reclaimed_without_a_response():
    """A partial opens a stream; the sender's death reclaims it, and
    nothing answers the dead sender."""
    cluster = PortCluster()
    cluster.start()
    srv = None
    try:
        srv = tps.KVServer(0, postoffice=cluster.servers[0])
        handle = tps.KVServerDefaultHandle()
        srv.set_request_handle(handle)
        wid = cluster.workers[0].van.my_node.id
        part = Message()
        m = part.meta
        m.request, m.push, m.sender, m.timestamp = True, True, wid, 1
        m.option, m.key = OPT_XFER_PART, 4
        part.add_data(SArray(np.array([4, 5], np.uint64)))
        part.add_data(SArray(np.ones(8, np.float32)))
        part._xfer_key = (wid, 1)
        srv._process(part)
        assert srv.streams_opened == 1 and len(srv._streams) == 1
        cluster.servers[0].notify_node_failure(wid, True)
        assert not srv._streams
        # The fed slice still applies (a stream is not in quiesce's
        # ledger: wait for the shard).
        end = time.monotonic() + 10
        while not {4, 5} <= set(handle.store) and time.monotonic() < end:
            time.sleep(0.005)
        np.testing.assert_array_equal(handle.store[4], np.ones(4))
        np.testing.assert_array_equal(handle.store[5], np.ones(4))
    finally:
        if srv is not None:
            srv.stop()
        cluster.finalize()


def test_priority_queue_fence_blocks_overtaking():
    """Mirror of the JAX test: a fence pops in priority order among what
    was queued before it, and nothing pushed after it overtakes it."""
    q = PriorityRecvQueue(lambda item: item[0])
    q.push((0, "bulk1"))
    q.push((0, "global"), fence=True)
    q.push((5, "prio-after-1"))
    q.push((5, "prio-after-2"))
    assert q.try_pop() == (0, "bulk1")
    assert q.try_pop() == (0, "global")
    q.push((0, "bulk2"))
    assert q.try_pop() == (5, "prio-after-1")
    assert q.try_pop() == (5, "prio-after-2")
    assert q.try_pop() == (0, "bulk2")
    assert q.try_pop() is None
    q.push((1, "prio-before"))
    q.push((0, "global2"), fence=True)
    q.push((9, "after"))
    assert q.try_pop() == (1, "prio-before")
    assert q.try_pop() == (0, "global2")
    assert q.try_pop() == (9, "after")
