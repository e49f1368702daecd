"""pslite_tpu_torch's socket van, chunked transfers and launcher against
the JAX package's, across real OS processes.

- Frames: the port's ``split_message`` + ``wire.pack_frame``, written by
  its ``TcpVan`` to a raw accepted socket, are byte-identical to the JAX
  package's Python path for every variant of
  ``tests/test_native_plane.py:_variants``.
- Clusters over tcp (each of ``tests/torch_mixed_child.py``'s processes
  hosts some of the nodes of one package), the key ones on both of the
  port's planes (the native core by default, ``PS_NATIVE=0``): a JAX
  scheduler and worker
  against port servers, a port worker against JAX servers, all-port;
  the first two also under each wire codec (``register_bucket`` and
  ``codec=``); all-port with and without the apply-shard pool, the
  chunked pushes streamed into the pool;
  the ``multi`` van (2 tcp rails, mixed); ``DMLC_LOCAL`` unix sockets
  (no socket file left after it); a port ``ici_tcp`` worker process on a
  CPU device group.  Keys of 1,024,000 B, so each message is chunked at
  the 1 MiB default.  Stores and pulls are bit-equal to an all-JAX tcp
  cluster's on the same seeded pushes (tolerance: none; one worker, so
  one order of addition).
- The ChunkAssembler: ``tests/test_chunking.py``'s cases through both
  packages in one process, outputs compared.
- The launcher: ``python -m pslite_tpu_torch.tracker.local`` runs the
  verify recipe's demo; with ``--no-keepalive`` an exit of 254 fails
  the run.

Every child process has a deadline of its own (``DEADLINE`` s) and is
killed after it.
"""

import copy
import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap
import time
import types

import numpy as np
import pytest

from pslite_tpu import KVServer as JaxKVServer
from pslite_tpu import KVServerDefaultHandle as JaxDefaultHandle
from pslite_tpu import KVWorker as JaxKVWorker
from pslite_tpu import wire as jwire
from pslite_tpu.ops import codecs as jcodecs
from pslite_tpu.vans import chunking as jchunking
from pslite_tpu_torch import wire as twire
from pslite_tpu_torch.environment import Environment
from pslite_tpu_torch.message import Message, Node, OPT_XFER_PART
from pslite_tpu_torch.sarray import SArray
from pslite_tpu_torch.utils.network import get_available_port
from pslite_tpu_torch.vans import chunking as tchunking
from pslite_tpu_torch.vans.tcp_van import TcpVan, _RecvPool
from pslite_tpu_torch.vans.van import Van

import torch_mixed_child as child
from helpers import LoopbackCluster
from test_chunking import _big_msg
from test_native_plane import _python_wire_bytes, _variants

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_HERE)
CHILD = os.path.join(_HERE, "torch_mixed_child.py")
DEADLINE = 60.0


# -- processes -----------------------------------------------------------------

def cluster_env(van: str, workers: int = 1, servers: int = 2, **extra):
    env = {"DMLC_NUM_WORKER": str(workers), "DMLC_NUM_SERVER": str(servers),
           "DMLC_PS_ROOT_URI": "127.0.0.1",
           "DMLC_PS_ROOT_PORT": str(get_available_port()),
           "DMLC_NODE_HOST": "127.0.0.1", "PS_VAN_TYPE": van,
           "PSTEST_DEADLINE": str(DEADLINE)}
    env.update(extra)
    return env


def run_children(cmds, out_dir, deadline: float = DEADLINE):
    """Start every ``(argv, env)`` at once, wait for all within
    ``deadline``; kill all on a failure or at the deadline.  Returns
    each child's output."""
    procs, logs = [], []
    try:
        for i, (argv, env) in enumerate(cmds):
            log = open(os.path.join(out_dir, f"child{i}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(argv, env=env, stdout=log,
                                          stderr=subprocess.STDOUT,
                                          cwd=_REPO))
        end = time.monotonic() + deadline
        for p in procs:
            p.wait(timeout=max(0.1, end - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"child failed ({p.returncode}):\n{out}"
    return outs


def run_cluster(tmp_path, env, procs):
    """``procs``: ``(pkg, roles, extra env)`` per process of the
    cluster.  Returns each process's JSON report."""
    cmds = []
    for pkg, roles, extra in procs:
        e = dict(os.environ, **env, PSTEST_PKG=pkg,
                 PSTEST_ROLES=",".join(roles), PSTEST_OUT=str(tmp_path),
                 **extra)
        e.pop("PYTHONPATH", None)
        cmds.append(([sys.executable, CHILD], e))
    outs = run_children(cmds, str(tmp_path))
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


def results(tmp_path):
    """``{"server<r>" / "worker<r>": {name: array}}`` of a run."""
    out = {}
    for name in sorted(os.listdir(tmp_path)):
        if name.endswith(".npz"):
            with np.load(os.path.join(tmp_path, name)) as z:
                out[name[:-4]] = {k: z[k] for k in z.files}
    return out


def assert_bit_equal(got, want):
    assert sorted(got) == sorted(want)
    for node in want:
        assert sorted(got[node]) == sorted(want[node]), node
        for k in want[node]:
            assert got[node][k].dtype == want[node][k].dtype
            assert got[node][k].tobytes() == want[node][k].tobytes(), (node,
                                                                        k)


@pytest.fixture(scope="module")
def jax_reference():
    """The scenario on an all-JAX cluster over tcp (1 worker, 2
    servers, in this process): its server stores and worker pulls."""
    c = LoopbackCluster(num_workers=1, num_servers=2, van_type="tcp")
    c.start()
    servers = []
    try:
        for po in c.servers:
            srv = JaxKVServer(0, postoffice=po)
            srv.set_request_handle(JaxDefaultHandle())
            servers.append((po, srv))
        kv = JaxKVWorker(0, 0, postoffice=c.workers[0])
        pulls = child.run_worker(kv, c.workers[0])
        out = {"worker0": pulls}
        for po, srv in servers:
            out[f"server{po.my_rank()}"] = {
                str(k): v.copy() for k, v in srv._handle.store.items()}
        kv.stop()
    finally:
        for _po, srv in servers:
            srv.stop()
        c.finalize()
    # One worker: the stores are its three pushes added in order.
    p = child.scenario_pushes(len(pulls["keys"]))
    want = p[0].copy()
    want += p[1]
    want += p[2]
    np.testing.assert_array_equal(pulls["pull"], want)
    np.testing.assert_array_equal(pulls["push_pull"], want)
    return out


MIXES = {
    "jax_worker_port_servers": [("jax", ["scheduler", "worker"], {}),
                                ("port", ["server", "server"], {})],
    "port_worker_jax_servers": [("port", ["scheduler", "worker"], {}),
                                ("jax", ["server", "server"], {})],
    "all_port": [("port", ["scheduler", "worker"], {}),
                 ("port", ["server", "server"], {})],
}


# The port's two planes: the native core (the default on this host's
# cores) and the Python one.
PLANES = {"native": {}, "python": {"PS_NATIVE": "0"}}


def assert_plane(reports, plane):
    """Every node of the port ran the plane ``plane``."""
    for r in reports:
        if r["pkg"] == "port":
            assert r["native"] == [plane == "native"] * len(r["roles"]), r


@pytest.mark.parametrize("plane", sorted(PLANES))
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_mixed_tcp_cluster_bit_equal_to_jax(tmp_path, jax_reference, mix,
                                            plane):
    reports = run_cluster(tmp_path, cluster_env("tcp", **PLANES[plane]),
                          MIXES[mix])
    assert_bit_equal(results(tmp_path), jax_reference)
    assert_chunked(reports)
    assert_plane(reports, plane)


def assert_chunked(reports):
    """The port's side of the cluster sent or received chunks: every
    2 MB message crossed in pieces of at most 1 MiB."""
    chunks = [c for r in reports if r["pkg"] == "port"
              for c in r["chunks"].values()]
    assert sum(s + r for s, r in chunks) > 0, reports


@pytest.mark.parametrize("plane", sorted(PLANES))
@pytest.mark.parametrize("case", ["multi_mixed", "local_port"])
def test_multi_rail_and_local_socket_clusters(tmp_path, jax_reference, case,
                                              plane):
    """``multi`` with 2 tcp rails (a JAX worker against port servers:
    each transfer's chunks stripe over both rails), and ``DMLC_LOCAL``
    unix sockets under the children's own temporary directory, where no
    socket file may be left afterwards."""
    tmpdir = tmp_path / "tmp"
    tmpdir.mkdir()
    if case == "multi_mixed":
        env = cluster_env("multi", DMLC_NUM_PORTS="2", **PLANES[plane])
        procs = MIXES["jax_worker_port_servers"]
    else:
        env = cluster_env("tcp", DMLC_LOCAL="1", TMPDIR=str(tmpdir),
                          **PLANES[plane])
        procs = MIXES["all_port"]
    reports = run_cluster(tmp_path, env, procs)
    assert_bit_equal(results(tmp_path), jax_reference)
    assert_chunked(reports)
    assert_plane(reports, plane)
    assert not [f for f in os.listdir(tmpdir) if f.endswith(".sock")]


def test_ici_tcp_worker_process_runs_the_bucket_and_the_messages(tmp_path,
                                                                jax_reference):
    """A port ``ici_tcp`` worker process (its engine on a CPU group of 8
    ranks, K4's plain version) against a JAX scheduler and servers: the
    registered bucket through the engine, exact; the message keys bit-
    equal to the all-JAX cluster."""
    reports = run_cluster(tmp_path, cluster_env("ici_tcp"), [
        ("jax", ["scheduler", "server", "server"], {}),
        ("port", ["worker"], {"PSTEST_CPU_GROUP": "8"})])
    assert_bit_equal(results(tmp_path), jax_reference)
    worker = [r for r in reports if r["roles"] == ["worker"]][0]
    assert worker["bucket_steps"] == 3
    assert worker["native"] == [True]  # the engine beside the native core


_CODEC_REFS = {}


def jax_codec_reference(codec):
    """``run_codec_worker`` on an all-JAX tcp cluster (1 worker, 2
    servers, in this process), once per codec: stores and pulls."""
    if codec in _CODEC_REFS:
        return _CODEC_REFS[codec]
    # The JAX package sets its two fp8 tables one after the other, so
    # its shard threads decoding at once may find the second unset
    # (ROADMAP Queue 3): build them first.
    jcodecs.Fp8E4M3Codec._luts()
    c = LoopbackCluster(num_workers=1, num_servers=2, van_type="tcp")
    c.start()
    servers = []
    try:
        for po in c.servers:
            srv = JaxKVServer(0, postoffice=po)
            srv.set_request_handle(JaxDefaultHandle())
            servers.append((po, srv))
        kv = JaxKVWorker(0, 0, postoffice=c.workers[0])
        out = {"worker0": child.run_codec_worker(kv, c.workers[0], codec)}
        for po, srv in servers:
            out[f"server{po.my_rank()}"] = {
                str(k): v.copy() for k, v in srv._handle.store.items()}
        kv.stop()
    finally:
        for _po, srv in servers:
            srv.stop()
        c.finalize()
    _CODEC_REFS[codec] = out
    return out


@pytest.mark.parametrize("mix", ["jax_worker_port_servers",
                                 "port_worker_jax_servers"])
@pytest.mark.parametrize("codec", ["int8", "fp8_e4m3", "bf16"])
def test_mixed_codec_cluster_bit_equal_to_jax(tmp_path, codec, mix):
    """A JAX worker against port servers and a port worker against JAX
    servers, every push and pull under ``codec`` (``register_bucket`` and
    ``codec=``): stores and pulls bit-equal to an all-JAX cluster's, the
    residuals of both sides' error feedback included."""
    run_cluster(tmp_path, cluster_env("tcp"),
                [(pkg, roles, dict(extra, PSTEST_CODEC=codec))
                 for pkg, roles, extra in MIXES[mix]])
    want = jax_codec_reference(codec)
    assert_bit_equal(results(tmp_path), want)
    pulls = want["worker0"]
    # Lossy, but close.  With error feedback the store is off the exact
    # sum by about the last push's encode error, and the pull adds one
    # more encode: int8 half a scale step (max|block| / 254) twice, fp8
    # e4m3 2^-4 of a value twice, bf16 2^-8 twice.  Stated bound: that,
    # rounded up, times the largest exact value.  (The store holds the
    # three pushes and the push_pull's second one again.)
    p = child.scenario_pushes(len(pulls["keys"]))
    exact = p[0] + p[1] + p[2] + p[1]
    bound = {"int8": 0.02, "fp8_e4m3": 0.15, "bf16": 0.01}[codec]
    for name in ("pull", "pull_codec_arg"):
        want_vals = exact if name == "pull" else sum(p[:3])
        err = np.abs(pulls[name] - want_vals).max()
        assert err < bound * np.abs(want_vals).max(), (name, err)


_TIER_ENVS = {
    "batching": {"PS_BATCH_BYTES": "65536"},
    "tenants": {"PS_TENANTS": "serve:8,train:1"},
    "hot_cache": {"PS_HOT_CACHE": "1", "PS_HOT_CACHE_TTL_S": "60"},
}
_TIER_REFS = {}


def jax_tier_reference(tier):
    """``run_tier_worker`` on an all-JAX tcp cluster under ``tier``'s
    knobs (1 worker, 2 servers, in this process): stores and pulls."""
    if tier in _TIER_REFS:
        return _TIER_REFS[tier]
    c = LoopbackCluster(num_workers=1, num_servers=2, van_type="tcp",
                        env_extra=_TIER_ENVS[tier])
    c.start()
    servers = []
    try:
        for po in c.servers:
            srv = JaxKVServer(0, postoffice=po)
            srv.set_request_handle(JaxDefaultHandle())
            servers.append((po, srv))
        kv = JaxKVWorker(0, 0, postoffice=c.workers[0])
        out = {"worker0": child.run_tier_worker(kv, c.workers[0])}
        for po, srv in servers:
            out[f"server{po.my_rank()}"] = {
                str(k): v.copy() for k, v in srv._handle.store.items()}
        kv.stop()
    finally:
        for _po, srv in servers:
            srv.stop()
        c.finalize()
    _TIER_REFS[tier] = out
    return out


@pytest.mark.parametrize("mix", ["jax_worker_port_servers",
                                 "port_worker_jax_servers"])
@pytest.mark.parametrize("tier", sorted(_TIER_ENVS))
def test_mixed_tier_cluster_bit_equal_to_jax(tmp_path, tier, mix):
    """A JAX worker against port servers and the reverse, under
    ``PS_BATCH_BYTES`` (each side answers the other's capability probe
    before its handler, and batch frames and batched responses cross
    packages), ``PS_TENANTS`` (``EXT_QOS`` tenants, weighted-fair queues)
    or ``PS_HOT_CACHE`` (push-version stamps): stores and pulls bit-equal
    to an all-JAX cluster's."""
    reports = run_cluster(tmp_path, cluster_env("tcp", **_TIER_ENVS[tier]),
                          [(pkg, roles, dict(extra, PSTEST_TIERS="1"))
                           for pkg, roles, extra in MIXES[mix]])
    want = jax_tier_reference(tier)
    assert_bit_equal(results(tmp_path), want)
    frames = [r["batch_frames"] for r in reports if "batch_frames" in r]
    # The multi_get leaves as one frame per server (the storm of pushes
    # may merge too, as the dispatcher's timing falls; the pull_multi
    # sends one op per server, which goes alone).
    if tier == "batching":
        assert len(frames) == 1 and frames[0] >= 2, frames
    else:
        assert frames == [0]
    pulls = want["worker0"]
    np.testing.assert_array_equal(pulls["after_push"],
                                  pulls["repeat"] + np.float32(5.0))


def test_chunked_push_streamed_into_the_pool(tmp_path, jax_reference):
    """All-port tcp: each 2 MB push arrives in 1 MiB chunks; with the
    pool (the default) the servers apply each whole key as it lands,
    without (``PS_APPLY_SHARDS=0``) the reassembled push applies whole.
    Both are bit-equal to the all-JAX cluster."""
    opened = {}
    for shards in ("default", "0"):
        out = tmp_path / shards
        out.mkdir()
        extra = {} if shards == "default" else {"PS_APPLY_SHARDS": "0"}
        reports = run_cluster(out, cluster_env("tcp", **extra),
                              MIXES["all_port"])
        assert_bit_equal(results(out), jax_reference)
        opened[shards] = sum(n for r in reports
                             for n in r.get("streams_opened", []))
    # 2 pushes to each of 2 servers (a push_pull is not streamed: its
    # response needs the whole request).
    assert opened == {"default": 4, "0": 0}


# -- frames ------------------------------------------------------------------

class _StubPo:
    """What a bare Van needs of its Postoffice."""
    is_scheduler = False
    is_worker = True
    flight = None

    def __init__(self, env=None):
        self.env = Environment(env or {})


def _to_port(jmsg):
    """The port's Message with the JAX message's meta and data."""
    meta = twire.unpack_meta(jwire.pack_meta(jmsg.meta))
    meta.data_type = list(jmsg.meta.data_type)
    msg = Message(meta=meta)
    msg.data = [SArray(np.asarray(d.data)) for d in jmsg.data]
    return msg


def _read_exact(conn, n):
    buf = bytearray()
    conn.settimeout(10.0)
    while len(buf) < n:
        got = conn.recv(min(1 << 20, n - len(buf)))
        if not got:
            break
        buf += got
    return bytes(buf)


@pytest.mark.parametrize("plane", sorted(PLANES))
@pytest.mark.parametrize("variant", [v[0] for v in _variants()])
def test_chunk_frames_byte_identical_to_jax(variant, plane):
    """The port's chunks as its van writes them, inline: through the
    core's ``psl_send`` or Python's ``sendmsg``."""
    name, jmsg, chunk_bytes = [v for v in _variants() if v[0] == variant][0]
    want, n_frames = _python_wire_bytes(jmsg, chunk_bytes, xfer_id=5,
                                        sid_start=3)
    msg = _to_port(copy.deepcopy(jmsg))
    chunks = (tchunking.split_message(msg, chunk_bytes, 5)
              if chunk_bytes > 0 else None) or [msg]
    assert len(chunks) == n_frames
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    van = TcpVan(_StubPo(PLANES[plane]))
    assert (van._native is not None) == (plane == "native")
    try:
        van.connect_transport(Node(id=77, hostname="127.0.0.1",
                                   ports=[srv.getsockname()[1]]))
        conn, _ = srv.accept()
        for i, c in enumerate(chunks):
            c.meta.sid = 3 + i
            van.send_msg(c)
        got = _read_exact(conn, len(want))
        conn.close()
    finally:
        van.stop_transport()
        van.post_stop()
        srv.close()
    assert got == want, name


# -- the chunk assembler, both packages in one process ------------------------

def _roundtrip(wire_mod, chunk):
    meta = wire_mod.unpack_meta(wire_mod.pack_meta(chunk.meta))
    return wire_mod.rebuild_message(meta, [np.asarray(d.data)
                                           for d in chunk.data])


def _digest(outs):
    """What an assembler handed back: per message its option, partial
    range and data bytes."""
    return [(o.meta.option, getattr(o, "_xfer_range", None),
             [np.asarray(d.data).tobytes() for d in o.data]) for o in outs]


def _assembler_case(case, pkg):
    """One of test_chunking.py's assembler cases through ``pkg``
    (a namespace of its chunking and wire modules)."""
    kw = dict(nkeys=16, val_len=1024, lens=case == "lens")
    msg, _keys, _vals = _big_msg(**kw)
    if pkg.name == "port":
        msg = _to_port(msg)
    asm = pkg.chunking.ChunkAssembler(ttl_s=0.05 if case == "ttl" else 120)
    chunks = [_roundtrip(pkg.wire, c)
              for c in pkg.chunking.split_message(msg, 4096, 5)]
    outs = []
    if case in ("fifo", "lens"):
        order = chunks
    elif case == "reversed":
        order = chunks[::-1]
    elif case == "shuffled":
        order = [chunks[i] for i in
                 np.random.default_rng(0).permutation(len(chunks))]
    elif case == "duplicate":
        order = [c for c in chunks[:-1] for _ in (0, 1)] + chunks[-1:]
    elif case == "stale_duplicate":
        order = chunks + chunks[:1]
    elif case == "corrupt":
        evil = _roundtrip(pkg.wire, chunks[1])
        evil.meta.chunk = dataclasses.replace(
            evil.meta.chunk, offset=sum(d.nbytes for d in msg.data) - 1)
        order = [chunks[0], evil]
    elif case == "drop_peer":
        # Sender 9 completes (tombstoned), restarts and reuses its xfer
        # ids; drop_peer must clear the tombstones too.
        for c in chunks:
            outs.extend(asm.add(c))
        stale = asm.add(chunks[0])
        dropped = asm.drop_peer(9)
        for c in chunks:
            outs.extend(asm.add(c))
        return [len(stale), dropped, len(asm)] + _digest(outs)
    elif case == "ttl":
        outs.extend(asm.add(chunks[0]))
        time.sleep(0.1)
        asm._sweep_stale()
        return [len(asm)]
    for c in order:
        outs.extend(asm.add(c))
    return [len(asm)] + _digest(outs)


_JAX_CHUNKING = types.SimpleNamespace(name="jax", chunking=jchunking,
                                      wire=jwire)
_PORT_CHUNKING = types.SimpleNamespace(name="port", chunking=tchunking,
                                       wire=twire)


@pytest.mark.parametrize("case", [
    "fifo", "reversed", "shuffled", "lens", "duplicate", "stale_duplicate",
    "corrupt", "drop_peer", "ttl"])
def test_chunk_assembler_matches_jax(case):
    got = _assembler_case(case, _PORT_CHUNKING)
    want = _assembler_case(case, _JAX_CHUNKING)
    assert got == want
    if case in ("fifo", "shuffled"):
        # Partials then the whole message, as in JAX.
        assert [o[0] for o in got[1:]][-1] != OPT_XFER_PART


def test_split_message_keeps_the_callers_meta():
    msg, _, _ = _big_msg()
    msg = _to_port(msg)
    types_before = list(msg.meta.data_type)
    assert tchunking.split_message(msg, 4096, 1)
    assert msg.meta.data_type == types_before
    assert tchunking.split_message(msg, 1 << 30, 2) is None  # small


def test_van_drops_a_dead_peers_partial_transfers():
    """Mirror of test_chunking.py::test_van_reclaims_partial_transfers_
    on_peer_death (the port's van has no recovery path yet)."""
    van = Van(_StubPo())
    msg, _, _ = _big_msg(sender=9)
    chunk = _roundtrip(twire, tchunking.split_message(_to_port(msg), 8192,
                                                      1)[0])
    van._assembler.add(chunk)
    assert len(van._assembler) == 1
    van.mark_peer_down(9)
    assert len(van._assembler) == 0


def test_recv_pool_recycles_free_blocks_only():
    pool = _RecvPool(budget_mb=1)
    a = pool.acquire(5000)
    assert a.nbytes == 8192 and pool.misses == 1
    b = pool.acquire(5000)  # a is referenced: a new block
    assert b is not a and pool.misses == 2
    del a
    c = pool.acquire(6000)
    assert pool.hits == 1 and c.nbytes == 8192
    big = pool.acquire(4 << 20)  # over the 1 MiB budget: not pooled
    assert big.nbytes == 4 << 20


# -- the launcher ----------------------------------------------------------------

DEMO = textwrap.dedent("""\
    import os, sys; sys.path.insert(0, {repo!r})
    import numpy as np, pslite_tpu_torch as ps
    role = os.environ["DMLC_ROLE"]; ps.start_ps()
    if role == "server":
        s = ps.KVServer(0); s.set_request_handle(ps.KVServerDefaultHandle())
    elif role == "worker":
        po = ps.postoffice(ps.Role.WORKER); kv = ps.KVWorker(0, 0)
        r = po.get_server_key_ranges()
        keys = np.array(sorted(rr.begin + i for i, rr in enumerate(r)),
                        dtype=np.uint64)
        kv.wait(kv.push(keys, np.ones(len(keys) * 8, np.float32)))
        po.barrier(0, ps.WORKER_GROUP)
        out = np.zeros(len(keys) * 8, np.float32); kv.wait(kv.pull(keys, out))
        print(f"WORKER_OK {{out[0]}}", flush=True)
    ps.finalize(); print(f"{{role}} DONE", flush=True)
    """)


def test_launcher_runs_the_verify_demo(tmp_path):
    """Every process prints DONE (one write per line: the processes
    share the launcher's output)."""
    demo = tmp_path / "demo.py"
    demo.write_text(DEMO.format(repo=_REPO))
    env = dict(os.environ, DMLC_NODE_HOST="127.0.0.1")
    env.pop("PYTHONPATH", None)
    out = run_children([([sys.executable, "-m",
                          "pslite_tpu_torch.tracker.local", "-n", "2", "-s",
                          "2", "--van", "tcp", "--", sys.executable,
                          str(demo)], env)], str(tmp_path))[0]
    assert out.count("DONE") == 5, out
    assert out.count("WORKER_OK 2.0") == 2, out


def test_launcher_fails_on_a_restart_request(tmp_path):
    """With ``--no-keepalive`` exit 254 is a failure like any other, as
    in JAX's launcher: the run fails with 254 and the other processes
    are terminated (with keepalive, the default, it restarts the
    process: tests/test_torch_recovery.py)."""
    prog = ("import os, sys, time\n"
            "if os.environ['DMLC_ROLE'] == 'worker': sys.exit(254)\n"
            "time.sleep(60)\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    t0 = time.monotonic()
    res = subprocess.run([sys.executable, "-m",
                          "pslite_tpu_torch.tracker.local", "-n", "1", "-s",
                          "1", "--no-keepalive", "--", sys.executable, "-c",
                          prog],
                         cwd=_REPO, env=env, capture_output=True, text=True,
                         timeout=DEADLINE)
    assert res.returncode == 254
    assert "restarting" not in res.stderr
    assert time.monotonic() - t0 < 30
