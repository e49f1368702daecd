"""pslite_tpu_torch's tenants, weighted-fair queues and hot-key cache
against the JAX package's.

Mirrors ``test_qos.py``: ``TenantTable`` parses to the same results and
refuses the same specs; ``EXT_QOS`` frames are JAX's byte for byte
(absent when tenant and stamp are zero, composed with codec and chunk
extensions, carried by every chunk); the per-tenant heaps pop the same
sequence as JAX's on seeded pushes, and with one tenant the sequence of
a single ``(-priority, seq)`` heap; ``HotKeyCache`` gives the same
results on one seeded op sequence under a stepped clock; and in
clusters, admission sheds leave the store exact, an overload keeps its
callback silent, a pull after a push is never stale, and
``fetch_hot_keys`` returns JAX's keys.  Tolerance: none.

The weighted-fair share itself is not held as a timing bound: the pop
sequences are deterministic, so they are compared whole instead.
"""

import heapq
import threading

import numpy as np
import pytest

from pslite_tpu import message as jmsg
from pslite_tpu import sarray as jsarray
from pslite_tpu import tenants as jten
from pslite_tpu import wire as jwire
from pslite_tpu.kv import hot_cache as jhot
from pslite_tpu.utils import queues as jq
from pslite_tpu.vans import chunking as jchunk
from pslite_tpu_torch import message as tmsg
from pslite_tpu_torch import sarray as tsarray
from pslite_tpu_torch import tenants as tten
from pslite_tpu_torch import wire as twire
from pslite_tpu_torch.kv import hot_cache as thot
from pslite_tpu_torch.utils import queues as tq
from pslite_tpu_torch.vans import chunking as tchunk

from test_torch_batching import _servers, _stop
from test_torch_msg_plane import (  # noqa: F401 - the fixture applies here
    JAX,
    PORT,
    _port_loopback_isolation,
    assert_same,
    run_both,
    stores,
)

# -- tenant table -------------------------------------------------------------

SPECS = ["", "serve:8,train:1", "a,b:3,default:2", " x : 2 , y ",
         "serve:0.5,batch:4,etl"]
BAD = ["serve:8,serve:1", "serve:0", "serve.v2:8", ":3", "a b:1",
       "x:-1", "q:nan"]


def _table_view(t, spec):
    ids = [t.resolve(n) for n in t.names()]
    return (t.enabled, t.names(), ids, [t.weight(i) for i in ids],
            [t.name(i) for i in ids], t.weights_by_id(), t.resolve(None),
            t.name(99))


@pytest.mark.parametrize("spec", SPECS)
def test_tenant_table_parses_as_jax(spec):
    assert _table_view(tten.TenantTable(spec), spec) == _table_view(
        jten.TenantTable(spec), spec)


def _refusal(mod, spec, lookup=None):
    try:
        t = mod.TenantTable(spec)
        if lookup is not None:
            t.resolve(lookup)
    except Exception as exc:  # noqa: BLE001 - compared below
        return type(exc).__name__, str(exc)
    return None


@pytest.mark.parametrize("spec,lookup", [(s, None) for s in BAD] + [
    ("serve:8", "typo"), ("serve:8", 70000), ("serve:8", 5)])
def test_tenant_table_refuses_as_jax(spec, lookup):
    got = _refusal(tten, spec, lookup)
    want = _refusal(jten, spec, lookup)
    assert got is not None and got == want


# -- EXT_QOS frames -----------------------------------------------------------


def _qos_frame(m, sa, w, tenant, stamp, codec=False, chunk=False):
    msg = m.Message()
    mm = msg.meta
    mm.timestamp, mm.sender, mm.recver = 9, 9, 8
    mm.request, mm.push = True, True
    mm.tenant, mm.stamp, mm.priority = tenant, stamp, 1
    if codec:
        mm.codec = m.CodecInfo(codec=1, raw_len=64, block=128)
    if chunk:
        mm.chunk = m.ChunkInfo(xfer=4, index=1, total=3, offset=100,
                               seg_lens=(8, 256), seg_types=(8, 10))
    msg.add_data(sa.SArray(np.array([3], np.uint64)))
    msg.add_data(sa.SArray(np.arange(16, dtype=np.float32)))
    return b"".join(bytes(c) for c in w.pack_frame(msg)), mm


@pytest.mark.parametrize("tenant,stamp,codec,chunk", [
    (0, 0, False, False), (3, 0, False, False), (0, 12345, False, False),
    (2, 5, True, True), (65535, 2 ** 63, True, False)])
def test_ext_qos_frames_equal_jax(tenant, stamp, codec, chunk):
    got, meta = _qos_frame(tmsg, tsarray, twire, tenant, stamp, codec, chunk)
    want, _ = _qos_frame(jmsg, jsarray, jwire, tenant, stamp, codec, chunk)
    assert got == want
    packed = twire.pack_meta(meta)
    out = twire.unpack_meta(packed)
    assert (out.tenant, out.stamp) == (tenant, stamp)
    meta.tenant = meta.stamp = 0
    bare = twire.pack_meta(meta)
    if not (tenant or stamp):
        assert bare == packed  # absent when both are zero
    else:
        assert len(bare) < len(packed)
    if chunk:
        assert packed[-twire.chunk_ext_payload_size(2):] == bare[
            -twire.chunk_ext_payload_size(2):]


def test_chunk_split_carries_tenant():
    frames = {}
    for name, (m, sa, w, ch) in {"jax": (jmsg, jsarray, jwire, jchunk),
                                 "port": (tmsg, tsarray, twire,
                                          tchunk)}.items():
        msg = m.Message()
        msg.meta.recver, msg.meta.tenant, msg.meta.request = 8, 2, True
        msg.meta.push = True
        msg.add_data(sa.SArray(np.arange(4, dtype=np.uint64)))
        msg.add_data(sa.SArray(np.ones(1 << 14, np.float32)))
        chunks = ch.split_message(msg, 1 << 12, xfer_id=1)
        assert all(c.meta.tenant == 2 for c in chunks)
        assert [ch.recv_tenant(c) for c in chunks] == [2] * len(chunks)
        frames[name] = ([b"".join(bytes(x) for x in w.pack_frame(c))
                         for c in chunks], [ch.recv_cost(c) for c in chunks])
    assert frames["port"] == frames["jax"] and len(frames["port"][0]) == 17


# -- weighted-fair heaps ------------------------------------------------------


def _script(seed, n=600, tenants=(0, 1, 2), prios=(-1, 0, 0, 0, 0, 2),
            fences=True, drain=True):
    """A seeded interleaving of pushes and pops."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n):
        if rng.random() < 0.35:
            ops.append(("pop",))
            continue
        prio = int(rng.choice(prios))
        if drain and rng.random() < 0.01:
            prio = jq.DRAIN_LEVEL
        ops.append(("push", int(rng.choice(tenants)), prio,
                    int(rng.integers(1, 5000)),
                    fences and rng.random() < 0.03))
    return ops + [("pop",)] * n


def _run_recv(qmod, ops, weights):
    q = qmod.PriorityRecvQueue(lambda x: 0, weights=weights)
    out, i = [], 0
    for op in ops:
        if op[0] == "pop":
            out.append(q.try_pop())
        else:
            _, tenant, prio, cost, fence = op
            q.push(i, priority=prio, fence=fence, tenant=tenant, cost=cost)
            i += 1
    return out


def _run_lane(qmod, ops, weights):
    q = qmod.LaneQueue(weights)
    out, i = [], 0
    for op in ops:
        if op[0] == "pop":
            if len(q):
                item, _ = q.pop(lambda: False, lambda: False)
                q.done()
                out.append(item)
            else:
                out.append(None)
        else:
            _, tenant, prio, cost, _fence = op
            q.push(prio, i, tenant=tenant, cost=cost)
            i += 1
    return out


WEIGHTS = [None, {0: 1.0, 1: 8.0, 2: 1.0}, {0: 2.0, 1: 1.0, 2: 3.5}]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("weights", WEIGHTS, ids=["none", "8to1", "mixed"])
def test_tenant_heaps_pop_as_jax(weights, seed):
    """Seeded pushes of three tenants (bytes costs, express priorities,
    drain-level items, fences) with pops between them: both queues pop
    JAX's sequence."""
    ops = _script(seed)
    assert _run_recv(tq, ops, weights) == _run_recv(jq, ops, weights)
    assert _run_lane(tq, ops, weights) == _run_lane(jq, ops, weights)


def test_weighted_by_bytes_and_express_first():
    """Equal weights and 4x the bytes per item: the small tenant gets
    about 4x the pops in a contended window; an express item jumps every
    tenant; the drain level pops last."""
    ops = []
    for i in range(200):
        ops += [("push", 1, 0, 4000, False), ("push", 2, 0, 1000, False)]
    ops += [("push", 2, 1, 1, False), ("push", 0, jq.DRAIN_LEVEL, 1, False)]
    ops += [("pop",)] * 402
    weights = {1: 1.0, 2: 1.0}
    got = _run_recv(tq, ops, weights)
    assert got == _run_recv(jq, ops, weights)
    assert got[0] == 400 and got[-1] == 401  # express first, drain last
    first = got[1:151]
    small = sum(1 for x in first if x % 2 == 1)
    assert 2.5 < small / (150 - small) < 6.0


@pytest.mark.parametrize("seed", [3, 4])
def test_single_tenant_order_is_one_heap(seed):
    """With no tenants every item is tenant 0 and the pop sequence is a
    single ``(-priority, seq)`` heap's, the order before tenants."""
    ops = _script(seed, tenants=(0,), fences=False)
    got = _run_recv(tq, ops, None)
    heap, want, i = [], [], 0
    for op in ops:
        if op[0] == "pop":
            want.append(heapq.heappop(heap)[2] if heap else None)
        else:
            heapq.heappush(heap, (-op[2], i, i))
            i += 1
    assert got == want
    assert _run_lane(tq, ops, None) == want


def test_fence_with_tenants_as_jax():
    ops = [("push", 1, 0, 10, True), ("push", 2, 10, 10, False),
           ("push", 2, 0, 10, False), ("push", 1, 0, 10, True),
           ("push", 2, 5, 10, False)] + [("pop",)] * 5
    weights = {1: 1.0, 2: 1.0}
    got = _run_recv(tq, ops, weights)
    assert got == _run_recv(jq, ops, weights)
    assert got[0] == 0  # nothing pushed after a fence overtakes it


# -- hot-key cache ------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


def _cache_run(hot, monkeypatch, seed):
    clock = _Clock()
    monkeypatch.setattr(hot, "time", clock)
    rng = np.random.default_rng(seed)
    c = hot.HotKeyCache(max_bytes=2048, ttl_s=0.5, max_val_bytes=256)
    log = []
    for step in range(400):
        op = rng.integers(0, 10)
        server = int(rng.choice([8, 10]))
        keys = np.unique(rng.integers(0, 12, size=int(
            rng.integers(1, 3)))).astype(np.uint64)
        k = int(rng.choice([4, 4, 8, 80]))
        if op <= 2:
            stamp = int(rng.integers(20, 40))
            vals = rng.normal(size=len(keys) * k).astype(np.float32)
            c.fill(server, stamp, keys, vals)
            log.append(("fill", len(c), c.nbytes))
        elif op <= 5:
            out = np.zeros(len(keys) * k, np.float32)
            log.append(("serve", c.serve(keys, out), out.tobytes()))
        elif op == 6:
            out = np.zeros(len(keys) * k, np.float32)
            mask = c.serve_mask(keys, out)
            log.append(("mask", None if mask is None else mask.tolist(),
                        out.tobytes()))
        elif op == 7:
            c.observe(server, int(rng.integers(0, 40)))
            log.append(("observe", len(c)))
        elif op == 8:
            clock.t += float(rng.choice([0.01, 0.05, 0.6]))
            log.append(("tick",))
        else:
            if rng.random() < 0.5:
                lo = int(rng.integers(0, 24))
                log.append(("invalidate", c.invalidate_range(lo, lo + 4)))
            else:
                c.seed(keys)
                log.append(("seed", len(c)))
    log.append(("final", len(c), c.nbytes, sorted(c._entries)))
    return log


@pytest.mark.parametrize("seed", [0, 1])
def test_hot_cache_sequence_as_jax(monkeypatch, seed):
    """Fills, serves (whole and partial), stamp observations, clock
    steps past the TTL, range invalidations and seeding under the LRU
    byte bound: the same results and evictions as JAX's cache."""
    got = _cache_run(thot, monkeypatch, seed)
    want = _cache_run(jhot, monkeypatch, seed)
    assert got == want
    kinds = {e[0] for e in got}
    assert {"fill", "serve", "mask", "observe", "tick", "invalidate",
            "seed"} <= kinds
    assert any(e[0] == "serve" and e[1] for e in got)


def test_hot_cache_rules():
    """The fill-race guard, the TTL, the LRU bound and seed admission."""
    c = thot.HotKeyCache(max_bytes=64, ttl_s=60.0)
    key = np.array([5], np.uint64)
    c.observe(8, 10)
    c.fill(8, 9, key, np.ones(4, np.float32))  # older than a known push
    assert len(c) == 0
    for k in range(2, 9):
        c.fill(8, 11, np.array([k], np.uint64), np.ones(4, np.float32))
    assert c.nbytes <= 64 and len(c) == 4
    c.seed([7])
    c.fill(8, 11, np.array([7, 30], np.uint64), np.ones(8, np.float32))
    assert 30 not in c._entries and 7 in c._entries


# -- clusters -----------------------------------------------------------------


class _GateHandle:
    """The default handle, holding every apply until ``gate`` opens."""

    def __init__(self, base, gate):
        self._h = base()
        self.store = self._h.store
        self._gate = gate

    def apply_shard(self, meta, keys, segs):
        assert self._gate.wait(30.0)
        return self._h.apply_shard(meta, keys, segs)


def _shed_run(api, cluster, with_callbacks):
    gate = threading.Event()
    servers = _servers(api, cluster,
                       lambda: _GateHandle(api.DefaultHandle, gate))
    w = api.KVWorker(0, 0, postoffice=cluster.workers[0])
    try:
        keys = np.arange(8, dtype=np.uint64)
        fired = []
        tss = [w.push(keys, np.ones(8 * 64, np.float32), tenant="train",
                      callback=(lambda i=i: fired.append(i))
                      if with_callbacks else None) for i in range(24)]
        out = []
        for ts in tss[4:]:  # shed at intake: answered with the gate shut
            try:
                w.wait(ts)
                out.append(None)
            except Exception as exc:  # noqa: BLE001 - compared below
                out.append(type(exc).__name__)
        gate.set()
        for ts in tss[:4]:
            w.wait(ts)
        pulled = np.zeros(8 * 64, np.float32)
        w.wait(w.pull(keys, pulled, tenant="train"))
        return out, sorted(fired), pulled, stores(servers)
    finally:
        gate.set()
        _stop(w, servers)


@pytest.mark.parametrize("with_callbacks", [False, True])
def test_admission_sheds_leave_the_store_exact(with_callbacks):
    """With the tenant's bound (4) full of held applies, the next pushes
    shed at intake: each wait raises ``OverloadError`` fast, its
    callback never fires, nothing of it applies, and the store holds
    exactly the four admitted pushes, as in JAX."""
    env = {"PS_TENANTS": "serve:8,train:1", "PS_TENANT_QUEUE_LIMIT": "4"}
    want, got = run_both(lambda api, cl: _shed_run(api, cl, with_callbacks),
                         env_extra=env)
    assert_same(got, want)
    assert got[0] == ["OverloadError"] * 20
    assert got[1] == ([0, 1, 2, 3] if with_callbacks else [])
    np.testing.assert_array_equal(got[2], np.full(8 * 64, 4.0, np.float32))


def test_push_then_pull_never_stale():
    """A pull issued after its push's wait never reads the pre-push
    value from the cache, while another thread keeps refilling it."""
    def scenario(api, cluster):
        servers = _servers(api, cluster, api.DefaultHandle)
        w = api.KVWorker(0, 0, postoffice=cluster.workers[0])
        stop = threading.Event()
        try:
            key = np.array([3], np.uint64)
            one = np.ones(64, np.float32)
            w.wait(w.push(key, one))

            def racer():
                buf = np.zeros_like(one)
                while not stop.is_set():
                    w.wait(w.pull(key, buf))

            t = threading.Thread(target=racer, daemon=True)
            t.start()
            seen, out = [], np.zeros_like(one)
            try:
                for i in range(2, 40):
                    w.wait(w.push(key, one))
                    w.wait(w.pull(key, out))
                    seen.append(float(out[0]))
            finally:
                stop.set()
                t.join(timeout=10)
            for _ in range(3):  # repeat pulls of a fresh value: cache hits
                w.wait(w.pull(key, out))
            return seen, len(w.hot_cache) > 0, stores(servers)
        finally:
            stop.set()
            _stop(w, servers)

    want, got = run_both(scenario, env_extra={"PS_HOT_CACHE": "1",
                                              "PS_HOT_CACHE_TTL_S": "60"})
    assert_same(got, want)
    assert got[0] == [float(i) for i in range(2, 40)] and got[1]


def test_fetch_hot_keys_as_jax():
    """Repeat pulls of a key answer from the cache; ``fetch_hot_keys``
    returns the servers' top-k, JAX's, and seeds admission."""
    def scenario(api, cluster):
        servers = _servers(api, cluster, api.DefaultHandle)
        w = api.KVWorker(0, 0, postoffice=cluster.workers[0])
        try:
            keys = np.arange(16, dtype=np.uint64)
            vals = np.arange(16 * 32, dtype=np.float32)
            w.wait(w.push(keys, vals))
            out = np.zeros(32, np.float32)
            sent = []
            real = cluster.workers[0].van.send
            cluster.workers[0].van.send = lambda m: sent.append(m) or real(m)
            for _ in range(20):
                w.wait(w.pull(keys[2:3], out))
            for _ in range(3):
                w.wait(w.pull(keys[5:6], out))
            del cluster.workers[0].van.send
            got = w.fetch_hot_keys(k=4)
            return (len(sent), out, got.tolist(),
                    sorted(w.hot_cache._hot))
        finally:
            if "send" in vars(cluster.workers[0].van):
                del cluster.workers[0].van.send
            _stop(w, servers)

    want, got = run_both(scenario, env_extra={"PS_HOT_CACHE": "1",
                                              "PS_HOT_CACHE_TTL_S": "60"})
    assert_same(got, want)
    assert got[0] == 2  # one pull per key left the worker
    assert got[2][:2] == [2, 5] and got[3] == sorted(got[2])
