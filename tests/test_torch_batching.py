"""pslite_tpu_torch's small-op batching plane against the JAX package's.

Mirrors ``test_batching.py``.  The wire pieces (``batchable``,
``op_wire_cost``, ``build_batch_message`` packed by ``wire.pack_frame``,
``split_batch_message``) must give the same results and bytes as JAX's on
the same messages; the combiner must group, pass through, cap and fail
as JAX's does; and loopback clusters with batching on must end with
stores and pulls bit-equal to the same op sequence through a JAX
cluster.  Tolerance: none (integer-valued sums, assign, and the same
momentum arithmetic in the same order).

Timing: the clusters that must form batches run the worker combiner in
window mode with a 30 s window (``PS_BATCH_WINDOW_US``), so nothing
leaves until the test calls ``combiner.flush_all()``: every frame's
membership is the issue order, whatever the machine's load.
"""

import struct

import numpy as np
import pytest

from pslite_tpu import message as jmsg
from pslite_tpu import sarray as jsarray
from pslite_tpu import wire as jwire
from pslite_tpu.kv import batching as jbatch
from pslite_tpu.kv import kv_app as jkv
from pslite_tpu_torch import message as tmsg
from pslite_tpu_torch import sarray as tsarray
from pslite_tpu_torch import wire as twire
from pslite_tpu_torch.base import SERVER_GROUP
from pslite_tpu_torch.kv import batching as tbatch
from pslite_tpu_torch.kv import kv_app as tkv

from test_torch_msg_plane import (  # noqa: F401 - the fixture applies here
    JAX,
    PORT,
    _port_loopback_isolation,
    assert_same,
    run_both,
    stores,
)

# Batching on, no probe, and a window long enough that only
# flush_all() closes a frame.
WINDOW = {"PS_BATCH_BYTES": "65536", "PS_BATCH_NEGOTIATE": "0",
          "PS_BATCH_WINDOW_US": "30000000"}

MODS = {"jax": (jmsg, jsarray, jwire, jbatch, jkv),
        "port": (tmsg, tsarray, twire, tbatch, tkv)}


def _op(m, sa, ts, key, vals, recver=8, tenant=0, priority=0, pull=False,
        push=None, codec=None, lens=None, head=0, option=0, trace=0,
        request=True, stamp=0, val_len=None):
    """One sliced op message built with message module ``m`` and
    SArray module ``sa``."""
    msg = m.Message()
    mm = msg.meta
    mm.request = request
    mm.head = head
    mm.push = (not pull) if push is None else push
    mm.pull = pull
    mm.timestamp = ts
    mm.key = key
    mm.recver = recver
    mm.tenant = tenant
    mm.priority = priority
    mm.option = option
    mm.trace = trace
    mm.stamp = stamp
    msg.add_data(sa.SArray(np.array([key], np.uint64)))
    if codec is not None:
        mm.codec = m.CodecInfo(codec=codec, raw_len=16, block=128)
        msg.add_data(sa.SArray(np.arange(4, dtype=np.uint8)))
        msg.add_data(sa.SArray(np.ones(1, np.float32)))
    else:
        msg.add_data(sa.SArray(np.asarray(vals, np.float32)))
    if lens is not None:
        msg.add_data(sa.SArray(np.asarray(lens, np.int32)))
    mm.val_len = msg.data[1].nbytes if val_len is None else val_len
    return msg


def _frame(wire_mod, msg) -> bytes:
    return b"".join(bytes(c) for c in wire_mod.pack_frame(msg))


# The op matrix: (label, kwargs of _op).
VARIANTS = [
    ("push", dict(vals=np.arange(4.0))),
    ("pull", dict(vals=np.empty(0), pull=True, val_len=64)),
    ("push_pull", dict(vals=np.ones(8), push=True, pull=True)),
    ("codec", dict(vals=None, codec=1)),
    ("codec_lens", dict(vals=None, codec=2, lens=[4])),
    ("lens", dict(vals=np.ones(4), lens=[4])),
    ("tenant_prio", dict(vals=np.ones(2), tenant=2, priority=3)),
    ("traced", dict(vals=np.ones(2), trace=0xABC)),
    ("cmd", dict(vals=np.ones(2), head=0x77)),
    ("zpull", dict(vals=np.empty(0), pull=True, option=2)),
    ("response_ack", dict(vals=np.empty(0), request=False, stamp=5)),
    ("response_err", dict(vals=np.empty(0), request=False, option=3)),
]


@pytest.mark.parametrize("label,kw", VARIANTS, ids=[v[0] for v in VARIANTS])
def test_batchable_and_cost_match_jax(label, kw):
    """``batchable`` (both directions) and ``op_wire_cost`` agree with
    JAX's on every row of the decline matrix."""
    out = {}
    for name, (m, sa, _w, b, _k) in MODS.items():
        msg = _op(m, sa, 1, 7, **kw)
        if label == "response_ack":
            msg.data.clear()  # an ack carries no segments
            msg.meta.data_type.clear()
        out[name] = (b.batchable(msg), b.batchable(msg, response=True),
                     b.op_wire_cost(msg), b.op_wire_cost(msg, response=True))
    assert out["port"] == out["jax"]


BATCHES = {
    "pushes": [dict(vals=np.full(4, float(i))) for i in range(1, 5)],
    "pulls": [dict(vals=np.empty(0), pull=True, val_len=32)
              for _ in range(3)],
    "mixed": [dict(vals=np.ones(4)), dict(vals=np.empty(0), pull=True),
              dict(vals=np.ones(8), push=True, pull=True)],
    "codec": [dict(vals=None, codec=1), dict(vals=None, codec=1)],
    "tenant_prio_traced": [dict(vals=np.ones(2), tenant=2, priority=1,
                                trace=0x55),
                           dict(vals=np.ones(2), tenant=2, priority=1)],
    "responses": [dict(vals=np.ones(4), request=False, pull=True, stamp=7),
                  dict(vals=np.ones(4), request=False, pull=True,
                       stamp=8, option=7)],
}


@pytest.mark.parametrize("case", sorted(BATCHES))
def test_batch_frames_byte_equal_jax(case):
    """``build_batch_message`` packs to JAX's bytes, and the port splits
    a JAX-built frame back into the same per-op messages."""
    frames, jenv = {}, None
    for name, (m, sa, w, b, _k) in MODS.items():
        msgs = [_op(m, sa, 10 + i, 100 * (i + 1), **kw)
                for i, kw in enumerate(BATCHES[case])]
        env = b.build_batch_message(msgs)
        frames[name] = _frame(w, env)
        if name == "jax":
            jenv = env
    assert frames["port"] == frames["jax"]
    # A JAX frame read by the port and split.
    raw = frames["jax"]
    meta_len, n_data = twire.unpack_frame_header(raw[:twire.FRAME_HEADER_SIZE])
    off = twire.FRAME_HEADER_SIZE
    lens = struct.unpack_from(f"<{n_data}Q", raw, off)
    off += 8 * n_data
    meta = twire.unpack_meta(raw[off:off + meta_len])
    off += meta_len
    bufs = []
    for ln in lens:
        bufs.append(raw[off:off + ln])
        off += ln
    got = tbatch.split_batch_message(twire.rebuild_message(meta, bufs))
    want = jbatch.split_batch_message(jenv)
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        for f in ("push", "pull", "timestamp", "key", "val_len", "option",
                  "stamp", "trace", "tenant", "priority", "request"):
            assert getattr(g.meta, f) == getattr(w_.meta, f), f
        assert g.meta.batch is None
        assert (g.meta.codec is None) == (w_.meta.codec is None)
        assert len(g.data) == len(w_.data)
        for x, y in zip(g.data, w_.data):
            assert bytes(x.numpy().reshape(-1).view(np.uint8)) == bytes(
                y.numpy().reshape(-1).view(np.uint8))


def _combiner_run(name):
    """Group keys, a flush with a codec-mismatched op in the middle, an
    op-capped flush, a failing send and a lone passthrough, through one
    package's OpCombiner.  Returns what each produced."""
    m, sa, _w, b, _k = MODS[name]
    base = _op(m, sa, 1, 1, np.ones(4))
    keys = [b.OpCombiner.group_key(x) for x in (
        base, _op(m, sa, 2, 2, np.ones(4), recver=10),
        _op(m, sa, 3, 3, np.ones(4), tenant=1),
        _op(m, sa, 4, 4, np.ones(4), priority=1),
        _op(m, sa, 5, 5, None, codec=1))]
    sent = []
    c = b.OpCombiner(lambda x: sent.append(x) or 0, lambda msgs, exc: None,
                     max_bytes=1 << 20)
    c._flush([(_op(m, sa, 1, 1, np.ones(4)), 40, True),
              (_op(m, sa, 2, 2, np.ones(4)), 40, True),
              (_op(m, sa, 5, 5, None, codec=1), 40, True),
              (_op(m, sa, 6, 6, np.ones(4)), 40, True)])
    flush = [[op.timestamp for op in x.meta.batch.ops] if x.meta.batch
             else [x.meta.timestamp] for x in sent]
    sent.clear()
    capped = b.OpCombiner(lambda x: sent.append(x) or 0,
                          lambda msgs, exc: None, max_bytes=1 << 30,
                          max_ops=4)
    capped._flush([(_op(m, sa, i, i, np.ones(2)), 8, True)
                   for i in range(10)])
    cap = [[op.timestamp for op in x.meta.batch.ops] if x.meta.batch
           else [x.meta.timestamp] for x in sent]
    failed = []

    def boom(x):
        raise ConnectionError("down")

    bad = b.OpCombiner(boom, lambda msgs, exc: failed.append(
        ([x.meta.timestamp for x in msgs], type(exc).__name__)),
        max_bytes=1 << 20)
    bad._flush([(_op(m, sa, 1, 1, np.ones(2)), 8, True),
                (_op(m, sa, 2, 2, np.ones(2)), 8, True)])
    sent.clear()
    lone = _op(m, sa, 9, 9, np.ones(4))
    c.flush_all()
    c._flush([(lone, 24, True)])
    passthrough = sent[0] is lone and sent[0].meta.batch is None
    c.stop()
    return keys, flush, cap, failed, passthrough


def test_combiner_groups_caps_and_failures_as_jax():
    """Lanes never cross destination, tenant or priority; a codec change
    splits a run but keeps its place; frames cap at ``max_ops``; a failed
    send reaches the error hook with its members; a lone op goes as its
    original message."""
    want = _combiner_run("jax")
    got = _combiner_run("port")
    assert got == want
    keys, flush, cap, failed, passthrough = got
    assert len(set(keys[:4])) == 4 and keys[0] == keys[4]
    assert flush == [[1, 2], [5], [6]]
    assert cap == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]
    assert failed == [([1, 2], "ConnectionError")]
    assert passthrough


# -- clusters -----------------------------------------------------------------


def _servers(api, cluster, handle):
    out = []
    for po in cluster.servers:
        s = api.KVServer(0, postoffice=po)
        s.set_request_handle(handle())
        out.append(s)
    return out


def _stop(w, servers):
    w.stop()
    for s in servers:
        s.stop()


def _flushed(w, tss):
    """Close the window, then wait for every timestamp; the exception
    type name (or None) of each."""
    w.combiner.flush_all()
    out = []
    for ts in tss:
        try:
            w.wait(ts)
            out.append(None)
        except Exception as exc:  # noqa: BLE001 - compared below
            out.append(type(exc).__name__)
    return out


def _spread(cluster, n):
    ranges = cluster.workers[0].get_server_key_ranges()
    return np.sort(np.array([ranges[i % len(ranges)].begin + i
                             for i in range(n)], np.uint64))


def test_push_storm_and_batched_pulls_bit_equal_jax():
    """150 pushes of four keys over two servers, then one-key pulls of
    each: batched into frames, stores and pulls bit-equal to JAX's."""
    def scenario(api, cluster):
        servers = _servers(api, cluster, api.DefaultHandle)
        w = api.KVWorker(0, 0, postoffice=cluster.workers[0])
        try:
            keys = _spread(cluster, 4)
            rng = np.random.default_rng(7)
            # 150 x 144 B per server: under the byte cap, so only
            # flush_all() closes the window.
            tss = [w.push(keys, rng.integers(-8, 8, 4 * 16).astype(
                np.float32)) for _ in range(150)]
            fails = _flushed(w, tss)
            outs = [np.zeros(16, np.float32) for _ in range(4)]
            tss = [w.pull(keys[i:i + 1], outs[i]) for i in range(4)]
            fails += _flushed(w, tss)
            frames = (w.combiner.flushed_frames, w.combiner.flushed_ops)
            return fails, outs, stores(servers), frames
        finally:
            _stop(w, servers)

    want, got = run_both(scenario, num_servers=2, env_extra=WINDOW)
    assert_same(got, want)
    assert got[3] == (4, 304)  # one push and one pull frame per server


def test_mixed_push_pull_order_and_serial_path():
    """Pushes and pulls of one key share a lane: each pull sees every
    push issued before it, in one window; with ``PS_APPLY_SHARDS=0`` the
    serial server answers a batched frame with one batched response."""
    def scenario(api, cluster):
        servers = _servers(api, cluster, api.DefaultHandle)
        w = api.KVWorker(0, 0, postoffice=cluster.workers[0])
        try:
            key = np.array([5], np.uint64)
            outs, tss = [], []
            for i in range(20):
                tss.append(w.push(key, np.full(32, float(i + 1),
                                               np.float32)))
                if i % 5 == 4:
                    outs.append(np.zeros(32, np.float32))
                    tss.append(w.pull(key, outs[-1]))
            return _flushed(w, tss), outs, stores(servers)
        finally:
            _stop(w, servers)

    for extra in ({}, {"PS_APPLY_SHARDS": "0"}):
        want, got = run_both(scenario, env_extra=dict(WINDOW, **extra))
        assert_same(got, want)
        np.testing.assert_array_equal(got[1][-1],
                                      np.full(32, 210.0, np.float32))


def _momentum_run(api, cluster, with_cmd):
    servers = _servers(api, cluster, lambda: api.OptimizerHandle(
        kind="sgd_momentum", lr=0.1))
    w = api.KVWorker(0, 0, postoffice=cluster.workers[0])
    try:
        key = np.array([3], np.uint64)
        rng = np.random.default_rng(23)
        tss = [w.push(key, rng.normal(size=32).astype(np.float32),
                      cmd=5 if with_cmd and i % 5 == 4 else 0)
               for i in range(40)]
        out = np.zeros(32, np.float32)
        tss.append(w.pull(key, out))
        if w.combiner is not None:
            w.combiner.flush_all()
        for ts in tss:
            w.wait(ts)
        return out
    finally:
        _stop(w, servers)


@pytest.mark.parametrize("with_cmd", [False, True],
                         ids=["plain", "unmergeable_cmd"])
def test_optimizer_order_through_batching(with_cmd):
    """The order-sensitive momentum handle ends bit-equal batched and
    unbatched, and to JAX's; every fifth push carrying a custom cmd (not
    mergeable) rides its lane in position and never overtakes."""
    batched = run_both(lambda api, cl: _momentum_run(api, cl, with_cmd),
                       env_extra=WINDOW)
    plain = run_both(lambda api, cl: _momentum_run(api, cl, with_cmd),
                     env_extra={"PS_BATCH_BYTES": "0"})
    assert_same(batched[1], batched[0])
    assert_same(batched[1], plain[0])
    assert_same(plain[1], plain[0])


class _RaggedHandle:
    """A serial handler answering each pull with key + 1 values."""

    def __init__(self, kv_mod):
        self._kv = kv_mod

    def __call__(self, meta, kvs, server):
        if meta.pull:
            k = int(kvs.keys[0])
            server.response(meta, self._kv.KVPairs(
                keys=kvs.keys, vals=np.full(k + 1, float(k), np.float32),
                lens=np.array([k + 1], np.int32)))
        else:
            server.response(meta)


def test_ragged_pull_responses_carry_lens():
    """A batched pull whose serial-path result is ragged gets its per-op
    lens segment back, as in JAX."""
    def scenario(api, cluster):
        kv_mod = jkv if api is JAX else tkv
        servers = _servers(api, cluster, lambda: _RaggedHandle(kv_mod))
        w = api.KVWorker(0, 0, postoffice=cluster.workers[0])
        try:
            outs = {k: np.zeros(k + 1, np.float32) for k in (1, 2, 3, 4)}
            lens = {k: np.zeros(1, np.int32) for k in outs}
            tss = [w.pull(np.array([k], np.uint64), outs[k], lens=lens[k])
                   for k in outs]
            return _flushed(w, tss), outs, lens
        finally:
            _stop(w, servers)

    want, got = run_both(scenario, env_extra=dict(WINDOW,
                                                  PS_APPLY_SHARDS="0"))
    assert_same(got, want)
    assert [int(v[0]) for v in got[2].values()] == [2, 3, 4, 5]


class _PoisonHandle:
    """The default handle, raising on a push of key 13."""

    def __init__(self, base):
        self._h = base()
        self.store = self._h.store

    def apply_shard(self, meta, keys, segs):
        if meta.push and 13 in keys.tolist():
            raise RuntimeError("poison key")
        return self._h.apply_shard(meta, keys, segs)

    def __call__(self, meta, kvs, server):
        if meta.push and 13 in kvs.keys.tolist():
            raise RuntimeError("poison key")
        return self._h(meta, kvs, server)


@pytest.mark.parametrize("shards", ["2", "0"])
def test_per_op_error_codes_fail_only_the_poisoned_op(shards):
    """A sub-op whose apply raises fails its own wait; its siblings in
    the same frame apply."""
    def scenario(api, cluster):
        servers = _servers(api, cluster,
                           lambda: _PoisonHandle(api.DefaultHandle))
        w = api.KVWorker(0, 0, postoffice=cluster.workers[0])
        try:
            tss = [w.push(np.array([k], np.uint64), np.ones(64, np.float32))
                   for k in (1, 2, 13, 4, 5)]
            return _flushed(w, tss), stores(servers)
        finally:
            _stop(w, servers)

    want, got = run_both(scenario, env_extra=dict(WINDOW,
                                                  PS_APPLY_SHARDS=shards))
    assert_same(got, want)
    assert got[0] == [None, None, "RuntimeError", None, None]


def test_admission_sheds_sub_ops_individually():
    """Admission through one batched frame sheds sub-ops, not the frame:
    the frame's first ops fill the tenant's bound, the rest answer
    ``OPT_OVERLOAD`` in the per-op table, and the store holds exactly the
    applied count (the same ops in JAX and the port: the bound counts the
    frame's own admitted ops at intake)."""
    def scenario(api, cluster):
        servers = _servers(api, cluster, api.DefaultHandle)
        w = api.KVWorker(0, 0, postoffice=cluster.workers[0])
        try:
            keys = np.arange(8, dtype=np.uint64)
            tss = [w.push(keys, np.ones(8 * 64, np.float32), tenant="train")
                   for _ in range(16)]
            fails = _flushed(w, tss)
            return fails, stores(servers)
        finally:
            _stop(w, servers)

    want, got = run_both(scenario, env_extra=dict(
        WINDOW, PS_TENANTS="serve:8,train:1", PS_TENANT_QUEUE_LIMIT="4"))
    assert_same(got, want)
    applied = got[0].count(None)
    assert got[0] == [None] * 4 + ["OverloadError"] * 12
    for arr in got[1][0].values():
        np.testing.assert_array_equal(arr, np.full(64, float(applied),
                                                   np.float32))


def test_abandoned_batch_frame_fails_every_sub_op():
    """The van's give-up path fails every sub-op of an abandoned batch
    frame, not only the envelope's first timestamp."""
    def scenario(api, cluster):
        m, sa, _w, b, _k = MODS[api.name]
        servers = _servers(api, cluster, api.DefaultHandle)
        w = api.KVWorker(0, 0, postoffice=cluster.workers[0])
        try:
            dest = cluster.servers[0].van.my_node.id
            subs, tss = [], []
            for k in (1, 2, 3):
                ts = w._customer.new_request(dest)
                tss.append(ts)
                sub = _op(m, sa, ts, k, np.ones(8), recver=dest)
                sub.meta.app_id = w._customer.app_id
                sub.meta.customer_id = w._customer.customer_id
                subs.append(sub)
            cluster.workers[0].van._delivery_failed(
                b.build_batch_message(subs), RuntimeError("gone"))
            out = []
            for ts in tss:
                try:
                    w.wait(ts)
                    out.append(None)
                except Exception as exc:  # noqa: BLE001 - compared below
                    out.append(type(exc).__name__)
            return out
        finally:
            _stop(w, servers)

    want, got = run_both(scenario, env_extra=WINDOW)
    assert got == want == ["TimeoutError"] * 3


# -- capability and byte identity ---------------------------------------------


def test_capability_negotiation_and_incapable_peer():
    """The first op toward a server probes it (``BATCH_PROBE_CMD``) and
    goes unbatched; a capable answer turns batching on; a peer recorded
    incapable never gets a batch frame again."""
    def scenario(api, cluster):
        servers = _servers(api, cluster, api.DefaultHandle)
        w = api.KVWorker(0, 0, postoffice=cluster.workers[0])
        try:
            key = np.array([1], np.uint64)
            w.wait(w.push(key, np.ones(8, np.float32)))  # answers the probe
            caps = dict(w._batch_caps)
            tss = [w.push(key, np.ones(8, np.float32)) for _ in range(30)]
            fails = _flushed(w, tss)
            after_capable = w.combiner.flushed_frames
            for dest in caps:
                w._batch_caps[dest] = False
            tss = [w.push(key, np.ones(8, np.float32)) for _ in range(30)]
            fails += _flushed(w, tss)
            out = np.zeros(8, np.float32)
            w.wait(w.pull(key, out))
            return (caps, fails, after_capable,
                    w.combiner.flushed_frames - after_capable, out)
        finally:
            _stop(w, servers)

    env = dict(WINDOW, PS_BATCH_NEGOTIATE="1")
    want, got = run_both(scenario, env_extra=env)
    assert_same(got, want)
    assert list(got[0].values()) == [True]
    assert got[2] == 1 and got[3] == 0
    np.testing.assert_array_equal(got[4], np.full(8, 61.0, np.float32))


def _frames_sent(api, env, probe_too=False):
    """The frames a worker sends for 5 pushes and a pull (addr zeroed:
    the JAX worker writes an in-process token there)."""
    w_mod = jwire if api is JAX else twire
    cluster = api.cluster(num_workers=1, num_servers=1, env_extra=env)
    cluster.start()
    node = cluster.workers[0]
    sent = []
    try:
        servers = _servers(api, cluster, api.DefaultHandle)
        w = api.KVWorker(0, 0, postoffice=node)
        real = node.van.send
        node.van.send = lambda msg: sent.append(msg) or real(msg)
        key = np.array([4], np.uint64)
        tss = [w.push(key, np.full(16, float(i), np.float32))
               for i in range(5)]
        for ts in tss:
            w.wait(ts)
        out = np.zeros(16, np.float32)
        w.wait(w.pull(key, out))
        del node.van.send
        _stop(w, servers)
        frames = []
        for msg in sent:
            msg.meta.addr = 0
            frames.append(_frame(w_mod, msg))
        return sent, frames
    finally:
        if "send" in vars(node.van):
            del node.van.send
        cluster.finalize()


def test_batching_off_sends_no_batch_frame_nor_probe():
    """With ``PS_BATCH_BYTES`` unset the worker has no combiner, sends no
    probe and no batch frame, and its frames are JAX's byte for byte."""
    jsent, want = _frames_sent(JAX, {})
    tsent, got = _frames_sent(PORT, {})
    assert got == want and len(got) == 6
    for msg in tsent:
        assert msg.meta.batch is None
        assert msg.meta.head != tbatch.BATCH_PROBE_CMD
        assert msg.meta.tenant == 0 and msg.meta.stamp == 0


def test_negotiation_off_sends_no_probe():
    """``PS_BATCH_NEGOTIATE=0`` asserts a homogeneous cluster: no probe,
    and the same frames as JAX's."""
    env = {"PS_BATCH_BYTES": "65536", "PS_BATCH_NEGOTIATE": "0"}
    _j, want = _frames_sent(JAX, env)
    tsent, got = _frames_sent(PORT, env)
    assert all(m.meta.head != tbatch.BATCH_PROBE_CMD for m in tsent)
    # Single-op frames leave as their original messages; merged ones
    # depend on the dispatcher's timing, so compare the op streams.
    def ops(frames, w_mod):
        out = []
        for raw in frames:
            meta_len, _n = w_mod.unpack_frame_header(
                raw[:w_mod.FRAME_HEADER_SIZE])
            off = w_mod.FRAME_HEADER_SIZE + 8 * _n
            meta = w_mod.unpack_meta(raw[off:off + meta_len])
            out += ([op.timestamp for op in meta.batch.ops]
                    if meta.batch else [meta.timestamp])
        return out
    assert ops(got, twire) == ops(want, jwire) == list(range(6))


# -- what stays refused -------------------------------------------------------


def test_refused_pieces_name_item_8(monkeypatch):
    """Batching under replication and under elastic membership, and the
    re-slice of a slice bounced ``OPT_WRONG_OWNER``, raise naming their
    ROADMAP item."""
    import types

    from pslite_tpu_torch.environment import Environment
    from pslite_tpu_torch.message import Message, OPT_WRONG_OWNER
    from test_torch_msg_plane import PortCluster

    for env, item in (({"PS_BATCH_BYTES": "1024",
                        "PS_KV_REPLICATION": "2"}, r"8\(b\)"),
                      ({"PS_BATCH_BYTES": "1024", "PS_ELASTIC": "1"},
                       r"8\b")):
        po = types.SimpleNamespace(env=Environment(env))
        for cls in (tkv.KVWorker, tkv.KVServer):
            with pytest.raises(NotImplementedError,
                               match=rf"Queue 1 item {item}"):
                cls(0, postoffice=po)
    cluster = PortCluster()
    cluster.start()
    try:
        w = tkv.KVWorker(0, 0, postoffice=cluster.workers[0])
        ts = w._customer.new_request(SERVER_GROUP)
        bounce = Message()
        bm = bounce.meta
        bm.app_id, bm.customer_id, bm.timestamp = 0, 0, ts
        bm.sender = cluster.servers[0].van.my_node.id
        bm.recver = cluster.workers[0].van.my_node.id
        bm.pull, bm.option = True, OPT_WRONG_OWNER
        cluster.workers[0].van._process_data_msg(bounce)
        with pytest.raises(NotImplementedError,
                           match=r"OPT_WRONG_OWNER.*Queue 1 item 8\(b\)"):
            w.wait(ts)
        w.stop()
    finally:
        cluster.finalize()
