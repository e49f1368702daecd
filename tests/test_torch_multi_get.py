"""pslite_tpu_torch's serving fan-in against the JAX package's.

Mirrors ``test_multi_get.py``: ``KVWorker.multi_get`` bit-exact against
sequential pulls and against JAX under every codec, one frame per
contacted server each way, the handle and its callbacks, hot-cache
partial hits, ``serve_mask``'s validity rules, per-sub-get admission
sheds, and the server's response combiner (separate frames aggregate,
unproved senders never see an aggregated response, option and stamp
ride the table, ``submit_many`` flushes at once).  Tolerance: none
(codec pulls compare the codec's own bytes, with error feedback off so
consecutive encodes of one slice are the same).
"""

import threading
import time

import numpy as np
import pytest

from pslite_tpu import message as jmsg
from pslite_tpu import sarray as jsarray
from pslite_tpu.kv import batching as jbatch
from pslite_tpu.kv import hot_cache as jhot
from pslite_tpu.ops import codecs as jcodecs
from pslite_tpu_torch import message as tmsg
from pslite_tpu_torch import sarray as tsarray
from pslite_tpu_torch.kv import batching as tbatch
from pslite_tpu_torch.kv import hot_cache as thot

from test_torch_batching import _op, _servers, _stop
from test_torch_msg_plane import (  # noqa: F401 - the fixture applies here
    JAX,
    PORT,
    _port_loopback_isolation,
    assert_same,
    run_both,
    stores,
)

BATCH = {"PS_BATCH_BYTES": "65536", "PS_BATCH_NEGOTIATE": "0"}


def _keys(cluster, n):
    """``n`` keys spread over the servers' ranges, sorted."""
    ranges = cluster.workers[0].get_server_key_ranges()
    return np.sort(np.array([ranges[i % len(ranges)].begin + i
                             for i in range(n)], np.uint64))


def _errors(handle):
    try:
        handle.wait()
    except Exception:  # noqa: BLE001 - the per-sub errors are compared
        pass
    return {i: type(e).__name__ for i, e in sorted(handle.errors.items())}


@pytest.mark.parametrize("batch_bytes", ["0", "65536"])
@pytest.mark.parametrize("codec", [None, "int8", "fp8_e4m3", "bf16"])
def test_multi_get_bit_exact_vs_sequential_and_jax(codec, batch_bytes):
    """32 one-row sub-gets over two servers return the bytes of 32
    sequential pulls, and JAX's."""
    # JAX sets its two fp8 tables one after the other (ROADMAP Queue 3):
    # build them before its threads can race on the first use.
    jcodecs.Fp8E4M3Codec._luts()
    def scenario(api, cluster):
        servers = _servers(api, cluster, api.DefaultHandle)
        w = api.KVWorker(0, 0, postoffice=cluster.workers[0])
        try:
            keys = _keys(cluster, 32)
            vals = np.random.default_rng(5).normal(size=32 * 8).astype(
                np.float32)
            w.wait(w.push(keys, vals))
            kw = {"codec": codec} if codec else {}
            handle = w.multi_get([keys[i:i + 1] for i in range(32)],
                                 val_len=8, **kw)
            got = handle.wait()
            seq = []
            for i in range(32):
                out = np.zeros(8, np.float32)
                w.wait(w.pull(keys[i:i + 1], out, **kw))
                seq.append(out)
            return got, seq, handle.errors, handle.cached
        finally:
            _stop(w, servers)

    env = dict(BATCH, PS_BATCH_BYTES=batch_bytes, PS_CODEC_EF="0")
    want, got = run_both(scenario, num_servers=2, env_extra=env)
    assert_same(got, want)
    assert_same(got[0], got[1])
    assert got[2] == {} and got[3] == 0


def _capture(node, sink):
    real = node.van.send
    node.van.send = lambda msg: sink.append(msg) or real(msg)


def test_one_frame_per_server_each_way():
    """A fan-out of 64 sub-gets over two servers leaves as one
    ``EXT_BATCH`` frame per server and comes back as one batched
    response frame from each."""
    def scenario(api, cluster):
        servers = _servers(api, cluster, api.DefaultHandle)
        w = api.KVWorker(0, 0, postoffice=cluster.workers[0])
        nodes = [cluster.workers[0]] + list(cluster.servers)
        sent = [[] for _ in nodes]
        try:
            keys = _keys(cluster, 64)
            vals = np.arange(64 * 8, dtype=np.float32)
            w.wait(w.push(keys, vals))
            for node, sink in zip(nodes, sent):
                _capture(node, sink)
            handle = w.multi_get([keys[i:i + 1] for i in range(64)],
                                 val_len=8)
            outs = handle.wait()
            for node in nodes:
                del node.van.send
            shapes = [sorted((m.meta.recver, len(m.meta.batch.ops))
                             for m in sink if m.meta.batch is not None)
                      for sink in sent]
            singles = [sum(1 for m in sink if m.meta.batch is None)
                       for sink in sent]
            return outs, shapes, singles
        finally:
            for node in nodes:
                if "send" in vars(node.van):
                    del node.van.send
            _stop(w, servers)

    want, got = run_both(scenario, num_servers=2, env_extra=BATCH)
    assert_same(got, want)
    wid = 9  # the worker's node id
    assert got[2] == [0, 0, 0]
    assert [len(s) for s in got[1]] == [2, 1, 1]
    assert [n for _d, n in got[1][0]] == [32, 32]
    assert got[1][1] == [(wid, 32)] and got[1][2] == [(wid, 32)]


def test_handle_callbacks_and_pull_multi():
    """One handle; per-sub callbacks fire as each completes; the
    aggregate callback once after the last; ``pull_multi`` is the same
    path."""
    def scenario(api, cluster):
        servers = _servers(api, cluster, api.DefaultHandle)
        w = api.KVWorker(0, 0, postoffice=cluster.workers[0])
        try:
            keys = np.arange(8, dtype=np.uint64)
            w.wait(w.push(keys, np.arange(32, dtype=np.float32)))
            fired, done = [], threading.Event()
            handle = w.multi_get(
                [keys[i:i + 1] for i in range(8)], val_len=4,
                callbacks=[(lambda i=i: fired.append(i)) for i in range(8)],
                callback=done.set)
            outs = handle.wait()
            assert done.wait(10.0)
            h2 = w.pull_multi([keys[:2], keys[5:]], val_len=4)
            return (outs, sorted(fired), len(handle), h2.wait(),
                    h2.timestamps != [None, None])
        finally:
            _stop(w, servers)

    want, got = run_both(scenario, env_extra=BATCH)
    assert_same(got, want)
    assert got[1] == list(range(8)) and got[2] == 8 and got[4]


def test_partial_cache_hit_fetches_only_misses():
    """Cached rows are served here and only the misses travel; a
    sub-get cached whole sends nothing; a push invalidates the fill so
    the next ``multi_get`` reads the new value."""
    def scenario(api, cluster):
        servers = _servers(api, cluster, api.DefaultHandle)
        w = api.KVWorker(0, 0, postoffice=cluster.workers[0])
        node = cluster.workers[0]
        sent = []
        try:
            keys = np.arange(8, dtype=np.uint64)
            vals = np.arange(32, dtype=np.float32)
            w.wait(w.push(keys, vals))
            o = np.zeros(4, np.float32)
            for k in range(0, 8, 2):
                w.wait(w.pull(keys[k:k + 1], o))
            _capture(node, sent)
            h1 = w.multi_get([keys], val_len=4)
            h1.wait()
            miss_keys = [int(k) for m in sent
                         for k in m.data[0].numpy().view(np.uint64)]
            n1 = len(sent)
            h2 = w.multi_get([keys[0:1], keys[2:3]], val_len=4)
            h2.wait()
            n2 = len(sent) - n1
            del node.van.send
            w.wait(w.push(keys[0:1], np.full(4, 50.0, np.float32)))
            h3 = w.multi_get([keys[0:1]], val_len=4)
            h3.wait()
            return (h1.outs, miss_keys, h2.cached, h2.timestamps, n2,
                    h3.cached, h3.outs)
        finally:
            if "send" in vars(node.van):
                del node.van.send
            _stop(w, servers)

    want, got = run_both(scenario, env_extra=dict(BATCH, PS_HOT_CACHE="1"))
    assert_same(got, want)
    np.testing.assert_array_equal(got[0][0], np.arange(32, dtype=np.float32))
    assert got[1] == [1, 3, 5, 7]
    assert got[2:5] == (2, [None, None], 0)
    assert got[5] == 0
    np.testing.assert_array_equal(got[6][0], np.arange(4.0) + 50.0)


def _serve_mask_run(hot):
    c = hot.HotKeyCache(max_bytes=1 << 20, ttl_s=30.0)
    keys = np.arange(4, dtype=np.uint64)
    c.fill(8, 5, keys[:2], np.arange(8, dtype=np.float32))
    out = np.zeros(16, np.float32)
    mask1 = c.serve_mask(keys, out).tolist()
    c.observe(8, 9)
    out2 = np.zeros(16, np.float32)
    mask2 = c.serve_mask(keys, out2).tolist()
    n2 = len(c)
    c.fill(8, 7, keys[:1], np.ones(4, np.float32))  # older than stamp 9
    n3 = len(c)
    c.fill(8, 11, keys[:1], np.ones(4, np.float32))
    declined = c.serve_mask(keys, np.zeros(7, np.float32)) is None
    short = c.serve_mask(keys[:1], np.zeros(2, np.float32)).tolist()
    return mask1, out, mask2, out2, n2, n3, declined, short, len(c)


def test_serve_mask_validity_rules_as_jax():
    """Live rows copy in place; a newer stamp drops every older fill; a
    fill older than a known stamp is skipped; a buffer that cannot be
    split into rows is declined; a row of another length misses."""
    want = _serve_mask_run(jhot)
    got = _serve_mask_run(thot)
    assert_same(list(got), list(want))
    assert got[0] == [True, True, False, False]
    assert got[2] == [False] * 4 and got[4] == 0 and got[5] == 0
    assert got[6] and got[7] == [False] and got[8] == 1


def test_overload_fails_only_the_shed_sub_gets():
    """Admission through one fan-out frame admits the first four
    sub-gets and sheds the rest: their waits raise ``OverloadError`` and
    their callbacks stay silent; the admitted ones are bit-exact."""
    def scenario(api, cluster):
        servers = _servers(api, cluster, api.DefaultHandle)
        w = api.KVWorker(0, 0, postoffice=cluster.workers[0])
        try:
            keys = np.arange(64, dtype=np.uint64)
            vals = np.arange(64 * 16, dtype=np.float32)
            w.wait(w.push(keys, vals, tenant="train"))
            fired = []
            handle = w.multi_get(
                [keys[i:i + 1] for i in range(64)], val_len=16,
                tenant="train",
                callbacks=[(lambda i=i: fired.append(i)) for i in range(64)])
            errors = _errors(handle)
            return errors, sorted(fired), [handle.outs[i] for i in fired]
        finally:
            _stop(w, servers)

    env = dict(BATCH, PS_TENANTS="serve:8,train:1",
               PS_TENANT_QUEUE_LIMIT="4")
    want, got = run_both(scenario, env_extra=env)
    assert_same(got, want)
    assert got[0] == {i: "OverloadError" for i in range(4, 64)}
    assert got[1] == [0, 1, 2, 3]
    for i, out in zip(got[1], got[2]):
        np.testing.assert_array_equal(out, np.arange(16 * i, 16 * i + 16,
                                                     dtype=np.float32))


def test_separate_frames_aggregate_responses():
    """Requests too large to merge (``PS_BATCH_BYTES=64``) still get
    their responses merged toward the probed sender: 81 push acks and a
    pull's answer leave as one batched frame (the response window is
    held open until the test flushes it), after the probe's own answer,
    and the store is JAX's."""
    def scenario(api, cluster):
        servers = _servers(api, cluster, api.DefaultHandle)
        w = api.KVWorker(0, 0, postoffice=cluster.workers[0])
        srv, node = servers[0], cluster.servers[0]
        sent = []
        try:
            _capture(node, sent)
            key = np.array([3], np.uint64)
            tss = [w.push(key, np.ones(64, np.float32)) for _ in range(81)]
            out = np.zeros(64, np.float32)
            tss.append(w.pull(key, out))
            comb = srv._resp_combiner
            end = time.monotonic() + 20.0
            while time.monotonic() < end:
                with comb._cv:
                    held = sum(len(g) for g in comb._groups.values())
                if held >= 82:
                    break
                time.sleep(0.005)
            comb.flush_all()
            for ts in tss:
                w.wait(ts)
            del node.van.send
            shapes = [len(m.meta.batch.ops) if m.meta.batch else 1
                      for m in sent]
            return held, shapes, out, stores(servers)
        finally:
            if "send" in vars(node.van):
                del node.van.send
            _stop(w, servers)

    env = {"PS_BATCH_BYTES": "64", "PS_RESP_BATCH_BYTES": "65536",
           "PS_RESP_BATCH_WINDOW_US": "30000000"}
    want, got = run_both(scenario, env_extra=env)
    assert_same(got, want)
    assert got[0] == 82 and got[1] == [1, 82]
    np.testing.assert_array_equal(got[2], np.full(64, 81.0, np.float32))


def test_unproved_sender_never_sees_aggregated_response():
    """A worker that never probed and never sent a batch frame gets only
    single responses, with the server's response combiner on."""
    def scenario(api, cluster):
        servers = _servers(api, cluster, api.DefaultHandle)
        w = api.KVWorker(0, 0, postoffice=cluster.workers[0])
        node = cluster.servers[0]
        sent = []
        try:
            _capture(node, sent)
            key = np.array([1], np.uint64)
            tss = [w.push(key, np.ones(8, np.float32)) for _ in range(40)]
            for ts in tss:
                w.wait(ts)
            del node.van.send
            out = np.zeros(8, np.float32)
            w.wait(w.pull(key, out))
            return (servers[0]._resp_combiner is not None,
                    [m.meta.batch is None for m in sent],
                    sorted(servers[0]._batch_senders), out)
        finally:
            if "send" in vars(node.van):
                del node.van.send
            _stop(w, servers)

    want, got = run_both(scenario, env_extra={
        "PS_BATCH_BYTES": "0", "PS_RESP_BATCH_BYTES": "65536"})
    assert_same(got, want)
    assert got[0] and all(got[1]) and len(got[1]) == 40 and got[2] == []


def _response_combiner_run(m, sa, b):
    a = _op(m, sa, 1, 10, np.ones(4), request=False, pull=True, stamp=7)
    bb = _op(m, sa, 2, 11, np.ones(4), request=False, pull=True, stamp=8)
    ack = _op(m, sa, 3, 12, np.empty(0), request=False, stamp=0)
    ack.data.clear()
    ack.meta.data_type.clear()
    err = _op(m, sa, 4, 13, np.empty(0), request=False, pull=True, option=3)
    flags = (b.batchable(a, response=True), b.batchable(ack, response=True),
             b.batchable(err, response=True), b.batchable(a))
    env = b.build_batch_message([a, bb, ack])
    subs = b.split_batch_message(env)
    sent = []
    c = b.OpCombiner(lambda x: sent.append(x) or 0, lambda msgs, exc: None,
                     max_bytes=1 << 20, response=True)
    c._flush([(a, 16, True), (bb, 16, True), (ack, 0, True),
              (err, 16, False)])
    return (flags, env.meta.request, [s.meta.stamp for s in subs],
            [s.meta.timestamp for s in subs], len(subs[2].data),
            [len(x.meta.batch.ops) if x.meta.batch else 1 for x in sent],
            sent[1] is err)


def test_response_combiner_carries_option_and_stamp():
    """Response-direction build and split keep per-op stamps; acks merge,
    error-marked responses go alone in position, as in JAX."""
    want = _response_combiner_run(jmsg, jsarray, jbatch)
    got = _response_combiner_run(tmsg, tsarray, tbatch)
    assert got == want
    assert got[0] == (True, True, False, False)
    assert got[2] == [7, 8, 0] and got[5] == [3, 1] and got[6]


def _submit_many_run(m, sa, b):
    sent, done = [], threading.Event()

    def send(x):
        sent.append(x)
        if len(sent) >= 2:
            done.set()
        return 0

    c = b.OpCombiner(send, lambda msgs, exc: None, max_bytes=1 << 20,
                     min_ops=1000, hold_max_us=20_000_000)
    c.submit_many([_op(m, sa, dest * 100 + i, i, np.ones(4), recver=dest)
                   for dest in (8, 10) for i in range(5)])
    ok = done.wait(10.0)
    c.stop()
    return ok, sorted((x.meta.recver, [op.timestamp for op in
                                       x.meta.batch.ops]) for x in sent)


def test_submit_many_flushes_whole_fanout_at_once():
    """``submit_many`` marks every touched lane ready: the fan-out
    leaves as one frame per lane at the next pickup, with no hold."""
    want = _submit_many_run(jmsg, jsarray, jbatch)
    got = _submit_many_run(tmsg, tsarray, tbatch)
    assert got == want
    assert got[0] and [r for r, _ in got[1]] == [8, 10]
