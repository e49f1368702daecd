"""pslite_tpu_torch's native core against the JAX package's planes.

The port builds its own copy of the core (``csrc/host/pslite_core.cc``)
with g++; the JAX package's core (``cpp/pslite_core.cc``, unmodified) is
built here into a temporary directory with the flags of its Makefile
plus ``-include functional`` (this compiler's libstdc++ does not bring
``std::function`` in through the headers the file names), and loaded by
the JAX package through its own search path.  Tolerance: none anywhere.

- Frames: for every variant of ``tests/test_native_plane.py`` (chunk and
  trace extension tails, int8 options, empty vals, codec tails), the
  bytes the port's native sender lane writes to a raw socket equal the
  JAX package's Python encoder's, the port's Python encoder's and the
  JAX core's lane's; the port's descriptors equal JAX's, and their
  ``wire_bytes`` the frames' length.
- Clusters (``tests/torch_mixed_child.py`` processes, the storm of bulk,
  priority and int8-coded pushes): port-native against JAX-native,
  against JAX's ``PS_NATIVE=0`` plane, port-native with
  ``PS_NATIVE_REASSEMBLY=1`` over 2 rails, and one process hosting JAX
  and port nodes with both cores loaded; stores and pulls bit-equal to
  an all-JAX cluster's.  ``PS_SHM_RING=1`` clusters (port alone, and a
  JAX-native worker against port servers) bit-equal too, with no pipe
  or segment left; a ring whose reader never attaches falls back to
  the socket (``tests/test_pipe_fallback.py``).
- ``try_iadd`` equals numpy's ``+=`` bit for bit; the native codec
  (int8, fp8_e4m3; encode with and without error feedback, decode,
  ``decode_key_ranges``; span threads at their default and 1) equals the
  port's numpy codec and the JAX core's codec byte for byte, NaN and
  +/-Inf included.
- The build: the stamp matches; a stale source, a stale library, a
  library without a symbol, a failed compile and a missing compiler
  raise; the library exports the ``psl_*`` API only.  Each native
  setting (``PS_NATIVE=1``, ``PS_NATIVE_RAILS=2``, ``PS_SHM_RING=1``,
  ``PS_NATIVE_REASSEMBLY=1``) builds its van on the core.
"""

import copy
import dataclasses
import os
import shutil
import socket
import subprocess

import numpy as np
import pytest

from pslite_tpu.ops import codecs as jc
from pslite_tpu.vans import chunking as jchunking
from pslite_tpu.vans import native as jnative
import pslite_tpu_torch as tps
from pslite_tpu_torch import wire as twire
from pslite_tpu_torch.environment import Environment
from pslite_tpu_torch.message import CodecInfo as TCodecInfo
from pslite_tpu_torch.ops import codecs as tc
from pslite_tpu_torch.vans import chunking as tchunking
from pslite_tpu_torch.vans import native
from pslite_tpu_torch.vans.shm_van import SHM_DIR

import torch_mixed_child as child
from helpers import LoopbackCluster
from pslite_tpu import KVServer as JaxKVServer
from pslite_tpu import KVServerDefaultHandle as JaxDefaultHandle
from pslite_tpu import KVWorker as JaxKVWorker
from test_native_plane import _python_wire_bytes, _variants
from test_torch_codecs import _bits, _payload
from test_torch_tcp import (  # noqa: F401 - jax_reference is a fixture
    _read_exact,
    _to_port,
    assert_bit_equal,
    cluster_env,
    jax_reference,
    results,
    run_cluster,
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PEER = 77
_VARIANTS = [v[0] for v in _variants()]


@pytest.fixture(scope="module")
def jax_core_dir(tmp_path_factory):
    """A directory holding the JAX package's core as
    ``libpslite_core.so`` (its loader's last candidate, found through
    ``LD_LIBRARY_PATH`` in a child)."""
    out = tmp_path_factory.mktemp("jaxcore")
    subprocess.run(
        [native.find_cxx(), "-O2", "-std=c++17", "-fPIC", "-Wall",
         "-Wextra", "-pthread", "-shared", "-include", "functional", "-o",
         str(out / "libpslite_core.so"),
         os.path.join(_REPO, "cpp", "pslite_core.cc")],
        check=True, capture_output=True, timeout=300)
    return str(out)


@pytest.fixture
def jax_lib(jax_core_dir, monkeypatch):
    """The JAX core loaded by the JAX package in this process (its codec
    re-probes it); undone after the test."""
    monkeypatch.setattr(jnative, "_LIB_PATHS",
                        [os.path.join(jax_core_dir, "libpslite_core.so")])
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_load_failed", False)
    monkeypatch.delenv("PS_NATIVE", raising=False)
    lib = jnative.load()
    assert lib is not None and lib.psl_abi_version() == jnative.ABI_VERSION
    monkeypatch.setattr(jc, "_native_lib", None)
    monkeypatch.setattr(jc, "_native_probed", False)
    return lib


# -- frames -------------------------------------------------------------------

def _capture_lane(transport, desc_of):
    """The bytes one core's sender lane writes for each variant, read off
    a raw accepted socket: ``{variant: bytes}``."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    out = {}
    try:
        transport.connect(_PEER, "127.0.0.1", srv.getsockname()[1])
        conn, _ = srv.accept()
        try:
            sid = 0
            for name, msg, chunk_bytes in _variants():
                want, n_frames = _python_wire_bytes(msg, chunk_bytes,
                                                    1000 + sid, sid)
                desc = desc_of(msg, chunk_bytes, iter([1000 + sid]))
                transport.send_enqueue(_PEER, 0, desc.meta_buf, desc.arrs,
                                       desc.chunk_bytes, desc.ext_off)
                assert transport.send_flush(10000)
                out[name] = _read_exact(conn, len(want))
                assert [st for _t, st in transport.send_reap(_PEER)] == [0]
                sid += n_frames
        finally:
            conn.close()
    finally:
        transport.stop()
        transport.destroy()
        srv.close()
    return out


def _port_desc(jmsg, chunk_bytes, xfer_seq):
    return tchunking.native_descriptor(_to_port(copy.deepcopy(jmsg)),
                                       chunk_bytes, xfer_seq)


def _port_python_bytes(jmsg, chunk_bytes, xfer_id, sid_start):
    """The port's Python encoder: split_message + pack_frame."""
    msg = _to_port(copy.deepcopy(jmsg))
    chunks = (tchunking.split_message(msg, chunk_bytes, xfer_id)
              if chunk_bytes > 0 else None) or [msg]
    blob = bytearray()
    for i, c in enumerate(chunks):
        c.meta.sid = sid_start + i
        for part in twire.pack_frame(c):
            blob += bytes(part)
    return bytes(blob)


def test_lane_frames_byte_identical_to_every_encoder(jax_lib):
    """The port's native lane, the JAX core's lane, the JAX package's
    Python encoder and the port's: one byte stream per variant."""
    port_lane = _capture_lane(native.NativeTransport(), _port_desc)
    jax_lane = _capture_lane(jnative.NativeTransport(),
                             jchunking.native_descriptor)
    sid = 0
    for name, msg, chunk_bytes in _variants():
        want, n_frames = _python_wire_bytes(msg, chunk_bytes, 1000 + sid,
                                            sid)
        assert port_lane[name] == want, name
        assert jax_lane[name] == want, name
        assert _port_python_bytes(msg, chunk_bytes, 1000 + sid, sid) == \
            want, name
        sid += n_frames


@pytest.mark.parametrize("variant", _VARIANTS)
def test_descriptor_equals_jax_and_counts_the_wire(variant):
    _name, jmsg, chunk_bytes = [v for v in _variants() if v[0] == variant][0]
    want, n_frames = _python_wire_bytes(jmsg, chunk_bytes, 55, 0)
    got = _port_desc(jmsg, chunk_bytes, iter([55]))
    ref = jchunking.native_descriptor(copy.deepcopy(jmsg), chunk_bytes,
                                      iter([55]))
    assert got.meta_buf == ref.meta_buf
    assert (got.chunk_bytes, got.ext_off, got.n_chunks, got.wire_bytes) == (
        ref.chunk_bytes, ref.ext_off, ref.n_chunks, ref.wire_bytes)
    assert [a.tobytes() for a in got.arrs] == [a.tobytes() for a in ref.arrs]
    assert got.wire_bytes == len(want) and got.n_chunks == n_frames


def test_natively_reassembled_frame_rebuilds_the_message():
    """A frame the core reassembled (index ``NATIVE_XFER_COMPLETE``)
    becomes the original message, as JAX's ``finalize_native_transfer``
    makes it."""
    _name, jmsg, _cb = [v for v in _variants()
                        if v[0] == "chunked_with_lens"][0]
    outs = []
    for chunking, msg in ((jchunking, copy.deepcopy(jmsg)),
                          (tchunking, _to_port(copy.deepcopy(jmsg)))):
        first = chunking.split_message(msg, 4096, 9)[0]
        first.meta.chunk = dataclasses.replace(
            first.meta.chunk, index=chunking.NATIVE_XFER_COMPLETE)
        first.data = [np.frombuffer(b"".join(
            np.asarray(d.data).tobytes() for d in msg.data), np.uint8)]
        # Whole segments, as the core hands them over.
        bounds = np.cumsum([0] + [d.nbytes for d in msg.data])
        raw = first.data[0]
        first.data = [raw[bounds[i]:bounds[i + 1]]
                      for i in range(len(bounds) - 1)]
        got = chunking.finalize_native_transfer(first)
        outs.append((got.meta.data_type, got.meta.data_size,
                     [np.asarray(d.data).dtype.str for d in got.data],
                     [np.asarray(d.data).tobytes() for d in got.data]))
    assert outs[0] == outs[1]
    assert outs[1][0] == list(jmsg.meta.data_type)


# -- clusters -----------------------------------------------------------------

_STORM_REF = {}


def jax_storm_reference():
    """``run_storm_worker`` on an all-JAX tcp cluster in this process."""
    if "ref" in _STORM_REF:
        return _STORM_REF["ref"]
    c = LoopbackCluster(num_workers=1, num_servers=2, van_type="tcp")
    c.start()
    servers = []
    try:
        for po in c.servers:
            srv = JaxKVServer(0, postoffice=po)
            srv.set_request_handle(JaxDefaultHandle())
            servers.append((po, srv))
        kv = JaxKVWorker(0, 0, postoffice=c.workers[0])
        out = {"worker0": child.run_storm_worker(kv, c.workers[0])}
        for po, srv in servers:
            out[f"server{po.my_rank()}"] = {
                str(k): v.copy() for k, v in srv._handle.store.items()}
        kv.stop()
    finally:
        for _po, srv in servers:
            srv.stop()
        c.finalize()
    _STORM_REF["ref"] = out
    return out


def _storm_mixes(jax_core_dir):
    jax_native = {"LD_LIBRARY_PATH": jax_core_dir}
    jax_python = {"PS_NATIVE": "0"}
    reasm = {"PS_NATIVE_REASSEMBLY": "1", "PS_NATIVE_RAILS": "2"}
    return {
        # (processes, every node's expected plane)
        "jax_native_worker_port_servers": [
            ("jax", ["scheduler", "worker"], jax_native),
            ("port", ["server", "server"], {})],
        "port_worker_jax_native_servers": [
            ("port", ["scheduler", "worker"], {}),
            ("jax", ["server", "server"], jax_native)],
        "port_worker_jax_python_servers": [
            ("port", ["scheduler", "worker"], {}),
            ("jax", ["server", "server"], jax_python)],
        "port_reassembly": [
            ("port", ["scheduler", "worker"], reasm),
            ("port", ["server", "server"], reasm)],
        "both_cores_one_process": [
            ("port", ["scheduler@jax", "worker@jax", "server@port",
                      "server@port"], jax_native)],
    }


@pytest.mark.parametrize("mix", [
    "jax_native_worker_port_servers", "port_worker_jax_native_servers",
    "port_worker_jax_python_servers", "port_reassembly",
    "both_cores_one_process"])
def test_mixed_native_storm_bit_equal_to_jax(tmp_path, jax_core_dir, mix):
    procs = _storm_mixes(jax_core_dir)[mix]
    procs = [(pkg, roles, dict(extra, PSTEST_STORM="1"))
             for pkg, roles, extra in procs]
    reports = run_cluster(tmp_path, cluster_env(
        "tcp", PS_CHUNK_BYTES=str(256 << 10)), procs)
    assert_bit_equal(results(tmp_path), jax_storm_reference())
    for (pkg, roles, extra), rep in zip(procs, reports):
        want = extra.get("PS_NATIVE") != "0"
        assert rep["native"] == [want] * len(roles), (pkg, roles, rep)


@pytest.mark.parametrize("plane", ["native", "python"])
def test_chunked_push_racing_set_request_handle_applies_every_key(plane):
    """A chunked push (2 keys of 1 MB in 256 KiB chunks, streamed to the
    server as whole-key partials) that reaches a port server before its
    ``set_request_handle``: the server holds it until the handle and its
    apply pool exist, so every key is applied and the pull is exact.
    (A JAX server drops the first partial here but opens the stream at
    the next one, and that key is never applied: ROADMAP Queue 3.)"""
    import threading

    from pslite_tpu_torch.utils.network import get_available_port

    class Watched(threading.Event):
        """The server's handle event; ``waiting`` tells that a request
        waits on it."""

        def __init__(self):
            super().__init__()
            self.waiting = threading.Event()

        def wait(self, timeout=None):
            self.waiting.set()
            return super().wait(timeout)

    env = {"DMLC_NUM_WORKER": "1", "DMLC_NUM_SERVER": "1",
           "DMLC_PS_ROOT_URI": "127.0.0.1",
           "DMLC_PS_ROOT_PORT": str(get_available_port()),
           "DMLC_NODE_HOST": "127.0.0.1", "PS_VAN_TYPE": "tcp",
           "PS_CHUNK_BYTES": str(256 << 10),
           "PS_NATIVE": "1" if plane == "native" else "0"}
    nodes = [tps.Postoffice(r, env=Environment(env))
             for r in ("scheduler", "server", "worker")]
    threads = [threading.Thread(target=po.start) for po in nodes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert all(po.van.ready.is_set() for po in nodes)
    srv = tps.KVServer(0, postoffice=nodes[1])
    srv._handle_set = watched = Watched()
    w = tps.KVWorker(0, 0, postoffice=nodes[2])
    try:
        r = nodes[2].get_server_key_ranges()[0]
        keys = np.array([r.begin + 1, r.begin + 2], np.uint64)
        vals = np.random.default_rng(3).standard_normal(
            2 * 256_000, dtype=np.float32)
        ts = w.push(keys, vals)
        # the push's first chunk is at the server before the handle
        assert watched.waiting.wait(30)
        srv.set_request_handle(tps.KVServerDefaultHandle())
        w.wait(ts)
        out = np.zeros_like(vals)
        w.wait(w.pull(keys, out))
        np.testing.assert_array_equal(out, vals)
        assert srv.streams_opened == 1  # applied through the partials
    finally:
        for app in (w, srv):
            app.stop()
        threads = [threading.Thread(target=po.finalize) for po in nodes]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)


def test_both_cores_in_one_process_export_their_own_symbols(jax_lib):
    """The JAX core exports what its Makefile leaves visible; the port's
    exports the ``psl_*`` API and nothing else, so neither interposes on
    the other (the storm above runs them in one process)."""
    nm = shutil.which("nm")
    if nm is None:
        pytest.skip("no nm on this host")
    port = subprocess.run([nm, "-D", "--defined-only",
                           str(native.build())], capture_output=True,
                          text=True, check=True).stdout.split("\n")
    syms = [ln.split()[-1] for ln in port if ln.strip()]
    assert syms and all(s.startswith("psl_") for s in syms), syms[:5]
    assert len(syms) == 35
    assert native.load() is not jax_lib
    assert native.load()._name != jax_lib._name


def _shm_env(van="shm", **extra):
    env = cluster_env(van, **extra)
    env["PS_SHM_NS"] = f"torchnat{env['DMLC_PS_ROOT_PORT']}"
    return env


@pytest.mark.parametrize("mix", ["all_port", "jax_native_worker_port_servers"])
def test_shm_ring_cluster_bit_equal_to_jax(tmp_path, jax_core_dir,
                                          jax_reference, mix):
    """``PS_SHM_RING=1``: the whole frame stream between same-host peers
    through shared-memory pipes; the stores and pulls bit-equal, every
    pipe and segment gone afterwards."""
    env = _shm_env(PS_SHM_RING="1")
    jax_native = {"LD_LIBRARY_PATH": jax_core_dir}
    procs = {"all_port": [("port", ["scheduler", "worker"], {}),
                          ("port", ["server", "server"], {})],
             "jax_native_worker_port_servers": [
                 ("jax", ["scheduler", "worker"], jax_native),
                 ("port", ["server", "server"], {})]}[mix]
    reports = run_cluster(tmp_path, env, procs)
    assert_bit_equal(results(tmp_path), jax_reference)
    for rep in reports:
        assert all(rep["native"]), rep
        assert all(rep["pipe_mode"]), rep
    ours = [f for f in os.listdir(SHM_DIR) if env["PS_SHM_NS"] in f]
    left = [f for f in ours if not f.endswith(".lock")]
    assert not left, left
    # The pipes' .lock files stay by design (unlinking one while a node
    # lives would hand the next locker another inode); every process of
    # the cluster is gone now.
    for f in ours:
        os.unlink(os.path.join(SHM_DIR, f))


def test_dead_reader_falls_back_to_socket(monkeypatch):
    """``tests/test_pipe_fallback.py`` on the port's core: no reader ever
    attaches, the ring fills, the writer retires the pipe after
    ``PS_SHM_RING_DEAD_MS`` (floored at 1 s) and the rest arrives over
    the socket."""
    monkeypatch.setenv("PS_SHM_RING_DEAD_MS", "700")
    path = f"{SHM_DIR}/pslpipe_torchdead_{os.getpid()}"
    writer, reader = native.NativeTransport(), native.NativeTransport()
    payload = np.arange(1024, dtype=np.float64)
    try:
        port = reader.bind(0)
        writer.connect(7, "127.0.0.1", port, timeout_ms=10000)
        writer.pipe_connect(7, path, 1 << 16)
        assert os.path.exists(path)
        for i in range(12):
            writer.send(7, f"frame-{i}".encode(),
                        [memoryview(payload.tobytes())])
        assert not os.path.exists(path)  # retired, the name freed
        metas, got = [], None
        while True:
            try:
                got = reader.recv(timeout_ms=5000)
            except TimeoutError:
                break
            if got is None:
                break
            metas.append(got[0])
            if got[0] == b"frame-11":
                break
        assert b"frame-11" in metas, metas
        assert bytes(got[1][0]) == payload.tobytes()
    finally:
        for core in (writer, reader):
            core.stop()
            core.destroy()
        for leftover in (path, path + ".lock"):
            try:
                os.unlink(leftover)
            except OSError:
                pass


# -- the single-shot kernels and the codec ------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_try_iadd_bit_equal_to_numpy(dtype):
    rng = np.random.default_rng(5)
    n = 100_003
    dst = (rng.standard_normal(n) * 1e3).astype(dtype)
    src = (rng.standard_normal(n) * 1e-3).astype(dtype)
    dst[[1, 50]] = np.nan
    src[[2, 60]] = np.inf
    src[[3, 61]] = -np.inf
    dst[61] = np.inf
    want = dst.copy()
    with np.errstate(invalid="ignore"):  # inf + -inf
        want += src
    got = dst.copy()
    assert native.try_iadd(got, src)
    assert got.tobytes() == want.tobytes()
    # Declined (the caller adds with numpy): small, mixed dtypes,
    # misaligned, non-contiguous, and PS_NATIVE=0 for the node.
    assert not native.try_iadd(got[:100], src[:100])
    assert not native.try_iadd(got, src.astype(np.float16))
    raw = np.zeros(n * dst.itemsize + 1, np.uint8)
    odd = raw[1:].view(dtype)
    assert not native.try_iadd(odd, src)
    assert not native.try_iadd(got[::2], src[::2])
    assert not native.try_iadd(got, src,
                               env=Environment({"PS_NATIVE": "0"}))


def _numpy_codec(monkeypatch):
    monkeypatch.setattr(tc, "_native_codec", lambda: None)


@pytest.mark.parametrize("threads", [None, "1"])
@pytest.mark.parametrize("name", ["int8", "fp8_e4m3"])
def test_native_codec_bit_equal_to_numpy_and_to_jax(name, threads, jax_lib,
                                                    monkeypatch):
    if threads is None:
        monkeypatch.delenv("PS_CODEC_THREADS", raising=False)
    else:
        monkeypatch.setenv("PS_CODEC_THREADS", threads)
    assert tc._native_codec() is not None and jc._native_codec() is jax_lib
    x = _payload(seed=21)
    n = x.size
    codec, jcodec = tc.get_codec(name), jc.get_codec(name)
    runs = {}
    for side in ("native", "jax", "numpy"):
        resid = np.zeros(n, np.float32)
        rounds = []
        with monkeypatch.context() as m:
            if side == "numpy":
                _numpy_codec(m)
            c = jcodec if side == "jax" else codec
            for r in range(2):  # the second round folds the residual
                codes, scales, flags = c.encode(x + np.float32(r),
                                                resid=resid)
                dec = c.decode(codes, scales, n, flags=flags)
                plain = c.encode(x)[0]
                rounds.append((codes.tobytes(), _bits(scales).tobytes(),
                               flags, _bits(dec).tobytes(),
                               _bits(resid).tobytes(), plain.tobytes()))
        runs[side] = rounds
    assert runs["native"] == runs["numpy"]
    assert runs["native"] == runs["jax"]
    if name == "int8":
        assert runs["native"][0][2] == tc.FLAG_HAS_NAN


@pytest.mark.parametrize("name", ["int8", "fp8_e4m3"])
def test_native_decode_ranges_bit_equal(name, jax_lib, monkeypatch):
    n_keys, k = 64, 700  # blocks straddle keys
    x = _payload(seed=4, n=n_keys * k)
    codes, scales, flags = tc.get_codec(name).encode(x)
    info = TCodecInfo(codec=tc.get_codec(name).wire_id, raw_len=x.nbytes,
                      block=tc.BLOCK, flags=flags)
    pos = np.array([0, 5, 17, 63, 2])
    got = tc.decode_key_ranges(codes, scales, info, n_keys, positions=pos)
    with monkeypatch.context() as m:
        _numpy_codec(m)
        want = tc.decode_key_ranges(codes, scales, info, n_keys,
                                    positions=pos)
    from pslite_tpu.message import CodecInfo as JCodecInfo

    jinfo = JCodecInfo(codec=info.codec, raw_len=info.raw_len,
                       block=info.block, flags=info.flags)
    ref = jc.decode_key_ranges(codes, scales, jinfo, n_keys, positions=pos)
    for a, b, c in zip(got, want, ref):
        assert _bits(a).tobytes() == _bits(b).tobytes() == \
            _bits(c).tobytes()


# -- the build ----------------------------------------------------------------

def test_abi_stamp_matches():
    assert native.source_stamp() == native.ABI_VERSION
    assert native.load().psl_abi_version() == native.ABI_VERSION
    # Built from the port's own copy, into the port's build directory.
    assert native.SOURCE.is_relative_to(native._PKG)
    assert native.build().parent == native.BUILD_DIR


def _stale_source(tmp_path, stamp=9999):
    text = native.SOURCE.read_text().replace(
        f"kAbiVersion = {native.ABI_VERSION};", f"kAbiVersion = {stamp};")
    src = tmp_path / "stale_core.cc"
    src.write_text(text)
    return src


def test_stale_source_raises_before_compiling(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="ABI stamp 9999, expected"):
        native.build(_stale_source(tmp_path))
    assert not (tmp_path / "build").exists()


def _compile(src, out, *flags):
    subprocess.run([native.find_cxx(), "-O0", "-std=c++17", "-fPIC",
                    "-shared", "-pthread", *flags, "-o", str(out), str(src)],
                   check=True, capture_output=True, timeout=300)


def test_stale_or_symbolless_library_raises(tmp_path):
    stale = tmp_path / "libstale.so"
    _compile(_stale_source(tmp_path), stale)
    with pytest.raises(RuntimeError, match="ABI stamp 9999"):
        native.open_library(stale)
    lean = tmp_path / "lean.cc"
    lean.write_text('extern "C" int psl_abi_version() { return %d; }\n'
                    % native.ABI_VERSION)
    _compile(lean, tmp_path / "liblean.so")
    with pytest.raises(RuntimeError, match="lacks a symbol.*psl_"):
        native.open_library(tmp_path / "liblean.so")


def test_failed_build_and_missing_compiler_raise(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    bad = tmp_path / "bad.cc"
    bad.write_text(f"constexpr int kAbiVersion = {native.ABI_VERSION};\n"
                   "int broken( {\n")
    with pytest.raises(RuntimeError, match="native core build failed"
                       "(.|\n)*error"):
        native.build(bad)
    assert not list((tmp_path / "build").glob("*.so"))
    monkeypatch.setenv("PATH", str(tmp_path / "nothing"))
    monkeypatch.delenv("CXX", raising=False)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.find_cxx()


def test_a_failed_load_raises_every_time(monkeypatch, tmp_path):
    """No quiet fallback: the error is kept and raised again, and only
    ``PS_NATIVE=0`` answers None."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", None)
    monkeypatch.setattr(native, "SOURCE", _stale_source(tmp_path))
    for _ in range(2):
        with pytest.raises(RuntimeError, match="ABI stamp 9999"):
            native.load()
    assert native.load(Environment({"PS_NATIVE": "0"})) is None


# -- the vans -----------------------------------------------------------------

@pytest.mark.parametrize("van,env,rails", [
    ("tcp", {}, 2),
    ("tcp", {"PS_NATIVE": "1"}, 2),
    ("tcp", {"PS_NATIVE_REASSEMBLY": "1"}, 2),
    ("tcp", {"PS_NATIVE_RAILS": "3"}, 3),
    ("tcp", {"PS_RESEND": "1"}, 1),
    ("multi", {"PS_NATIVE_RAILS": "2"}, 2),
    ("shm", {"PS_SHM_RING": "1"}, 2),
    ("ici_tcp", {}, 2),
    ("tcp", {"PS_NATIVE": "0"}, None),
    ("shm", {"PS_NATIVE": "0", "PS_SHM_RING": "1"}, None),
])
def test_native_settings_build_their_plane(van, env, rails):
    """Each setting that raised before the native core builds its van on
    the core (on this 2+ core host ``auto`` takes it too); ``PS_NATIVE=0``
    keeps the Python plane, the ring included."""
    po = tps.Postoffice("server", env=Environment({"PS_VAN_TYPE": van,
                                                   **env}))
    vans = getattr(po.van, "_rails", [po.van])
    try:
        for v in vans:
            assert (v._native is not None) == (rails is not None)
            if rails is not None:
                assert v._native_rails == rails
        if van == "shm":
            assert po.van._pipe_mode == (rails is not None)
            assert (po.van._copy_pool is not None) == (rails is not None)
    finally:
        for v in vans:
            if v._native is not None:
                v._native.destroy()
