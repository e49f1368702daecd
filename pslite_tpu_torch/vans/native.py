"""The native transport core: build, load and ctypes bindings.

Counterpart of ``pslite_tpu/vans/native.py`` over the port's own copy of
the C++ core, ``pslite_tpu_torch/csrc/host/pslite_core.cc``
(``docs/native_core.md``, ``docs/shm_pipes.md``): per-peer sender lanes
and receive pumps on native threads, rails, receive-side reassembly,
the shared-memory copy pool and ring pipes, the int8/fp8 wire codec and
the f32/f64 in-place add, all running without the GIL.

The library is built at first use by a host C++ compiler (``$CXX``, then
``g++``, then ``c++``; never ``nvcc``) into ``pslite_tpu_torch/_build/``
under a name that hashes the source, the flags and the compiler, with
the JAX package's flags plus ``-fvisibility=hidden`` and a version
script, so only the ``psl_*`` C API is exported and the JAX package's
``libpslite_core.so`` can live in the same process.  Concurrent builds
(several processes) serialize on an ``fcntl`` lock and publish the
library by rename.

Nothing falls back quietly: a missing compiler, a failed build, a source
or library whose ABI stamp is not :data:`ABI_VERSION`, or a missing
symbol raise ``RuntimeError`` with the compiler's output or the
symbol's name.  Only ``PS_NATIVE=0`` (process-wide, or per node through
an ``Environment``) selects the Python plane; the tcp van's ``auto``
default also keeps it on a host with fewer than 2 cores.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import struct
import subprocess
import threading
import time
import weakref
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "host" / "pslite_core.cc"
BUILD_DIR = _PKG / "_build"
# The JAX package's cpp/Makefile flags, plus hidden visibility.  No
# -march=native, -ffast-math or -ffp-contract=fast: the codec's bytes and
# the in-place add's bits must equal numpy's.
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
             "-shared", "-fvisibility=hidden")
# Linker version script: the psl_* C API and nothing else (libstdc++'s
# template instantiations keep default visibility under
# -fvisibility=hidden).
EXPORTS = "{ global: psl_*; local: *; };\n"

# Must equal kAbiVersion in csrc/host/pslite_core.cc.
ABI_VERSION = 9

_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[BaseException] = None
_load_mu = threading.Lock()
# Filled by build(): the library's path, the compiler and, when it was
# compiled in this process, the seconds it took.
build_info = {"path": None, "compiler": None, "seconds": None}


class _FrameView(ctypes.Structure):
    _fields_ = [
        ("buf", ctypes.POINTER(ctypes.c_uint8)),
        ("meta_len", ctypes.c_uint32),
        ("n_data", ctypes.c_uint32),
    ]


class _WireStats(ctypes.Structure):
    """Mirror of ``psl_wire_stats``: the core's counter block, read whole
    in one call.  ``abi`` echoes the library's stamp; the struct only
    grows at the end and ``psl_stats_snapshot`` returns the size it
    wrote."""

    _fields_ = [
        ("abi", ctypes.c_uint64),
        ("tx_syscalls", ctypes.c_uint64),
        ("tx_frames", ctypes.c_uint64),
        ("tx_chunks", ctypes.c_uint64),
        ("tx_bytes", ctypes.c_uint64),
        ("tx_msgs", ctypes.c_uint64),
        ("rx_syscalls", ctypes.c_uint64),
        ("rx_frames", ctypes.c_uint64),
        ("rx_bytes_copy", ctypes.c_uint64),
        ("rx_bytes_zc", ctypes.c_uint64),
        ("rx_pool_hits", ctypes.c_uint64),
        ("rx_pool_misses", ctypes.c_uint64),
    ]


class _NativeFrame(np.ndarray):
    """ndarray view over a pooled native frame buffer (plain ndarrays
    take no weak references): ``recv`` attaches the ``psl_frame_free``
    finalizer to it, and every segment sliced from it keeps it alive
    through the base chain."""


# A writable memoryview over the frame's foreign memory, without a
# ctypes array type per distinct length.
_PyMemoryView_FromMemory = ctypes.pythonapi.PyMemoryView_FromMemory
_PyMemoryView_FromMemory.restype = ctypes.py_object
_PyMemoryView_FromMemory.argtypes = [
    ctypes.c_void_p, ctypes.c_ssize_t, ctypes.c_int,
]
_PyBUF_WRITE = 0x200


# -- build --------------------------------------------------------------------

def find_cxx() -> str:
    """The host C++ compiler: ``$CXX``, then ``g++``, then ``c++``."""
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        if not cand:
            continue
        path = shutil.which(cand)
        if path:
            return path
    raise RuntimeError(
        "no C++ compiler ($CXX, g++ or c++) on PATH: the native core of "
        "pslite_tpu_torch cannot be built (PS_NATIVE=0 selects the "
        "Python plane)")


def source_stamp(source: Optional[Path] = None) -> int:
    """The ``kAbiVersion`` a core source declares."""
    source = source or SOURCE
    m = re.search(r"kAbiVersion = (\d+);", source.read_text())
    if m is None:
        raise RuntimeError(f"{source} declares no kAbiVersion")
    return int(m.group(1))


def build(source: Optional[Path] = None, force: bool = False) -> Path:
    """Compile the core (``source``, default :data:`SOURCE`) unless built
    already and return the library's path.  Raises on a stale source
    stamp or a failed compile."""
    source = source or SOURCE
    stamp = source_stamp(source)
    if stamp != ABI_VERSION:
        raise RuntimeError(
            f"{source} has ABI stamp {stamp}, expected {ABI_VERSION} "
            f"(vans/native.py ABI_VERSION): bump both together")
    cxx = find_cxx()
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(EXPORTS.encode())
    h.update(cxx.encode())
    lib_path = BUILD_DIR / f"libpslite_core_{h.hexdigest()[:16]}.so"
    build_info.update(path=str(lib_path), compiler=cxx)
    if lib_path.exists() and not force:
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "pslite_core.lock", "w") as lock:
        # Several processes (test workers, a cluster's nodes) may build
        # at once: the first compiles, the rest find its library.
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib_path.exists() and not force:
            return lib_path
        tag = f"{os.getpid()}_{threading.get_ident()}"
        script = BUILD_DIR / f"pslite_core_{tag}.map"
        tmp = BUILD_DIR / f"{lib_path.name}.{tag}.tmp"
        script.write_text(EXPORTS)
        cmd = [cxx, *CXX_FLAGS, f"-Wl,--version-script={script}", "-o",
               str(tmp), str(source)]
        t0 = time.monotonic()
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        finally:
            script.unlink(missing_ok=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"native core build failed ({res.returncode}): "
                f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, lib_path)  # atomic: no reader sees a torn file
        build_info.update(seconds=time.monotonic() - t0)
    return lib_path


def open_library(path) -> ctypes.CDLL:
    """dlopen ``path``, declare every symbol and check the stamp; raises
    naming a missing symbol or a wrong stamp."""
    lib = ctypes.CDLL(str(path))
    try:
        _declare(lib)
    except AttributeError as exc:
        raise RuntimeError(
            f"native core {path} lacks a symbol ({exc}): stale library, "
            f"rebuild it") from None
    stamp = lib.psl_abi_version()
    if stamp != ABI_VERSION:
        raise RuntimeError(
            f"native core {path} has ABI stamp {stamp}, expected "
            f"{ABI_VERSION}: stale library, rebuild it")
    return lib


def enabled(env=None) -> bool:
    """False when ``PS_NATIVE`` is ``0``/``false``: through ``env`` (a
    node's :class:`~..environment.Environment`) when given, so a
    per-node override holds in an in-process cluster."""
    val = (env.find("PS_NATIVE", "1") if env is not None
           else os.environ.get("PS_NATIVE", "1"))
    return val not in ("0", "false")


def load(env=None) -> Optional[ctypes.CDLL]:
    """The native library, building it on first use; None when
    ``PS_NATIVE=0`` for this node.  Raises when it cannot be built or
    loaded (the same error again on every later call)."""
    if not enabled(env):
        return None
    if _lib is not None:
        return _lib
    return _load_once()


def _load_once() -> ctypes.CDLL:
    global _lib, _load_error
    with _load_mu:
        if _lib is None:
            if _load_error is not None:
                raise _load_error
            try:
                _lib = open_library(build())
            except Exception as exc:  # noqa: BLE001 - cached, re-raised
                _load_error = exc
                raise
        return _lib


def _declare(lib: ctypes.CDLL) -> None:
    """Declare every symbol's signature (AttributeError names a missing
    one)."""
    vp, i, u32, u64, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                           ctypes.c_uint64, ctypes.c_longlong)
    cp = ctypes.c_char_p
    lib.psl_abi_version.restype = i
    lib.psl_abi_version.argtypes = []
    lib.psl_stats_snapshot.restype = i
    lib.psl_stats_snapshot.argtypes = [vp, ctypes.POINTER(_WireStats)]
    lib.psl_create.restype = vp
    lib.psl_bind.argtypes = [vp, i, i]
    lib.psl_connect.argtypes = [vp, i, cp, i, i]
    lib.psl_bind_local.argtypes = [vp, cp, i]
    lib.psl_connect_local.argtypes = [vp, i, cp, i]
    lib.psl_pipe_connect.argtypes = [vp, i, cp, u64]
    lib.psl_pipe_watch.argtypes = [vp, cp, cp, cp, i]
    lib.psl_send.restype = ll
    lib.psl_send.argtypes = [
        vp, i, ctypes.POINTER(ctypes.c_uint8), u32, u32,
        ctypes.POINTER(vp), ctypes.POINTER(u64),
    ]
    lib.psl_send_enqueue.restype = ll
    lib.psl_send_enqueue.argtypes = [
        vp, i, i, cp, u32, u32, ctypes.POINTER(vp), ctypes.POINTER(u64),
        u64, ctypes.c_int32,
    ]
    lib.psl_send_reap.restype = i
    lib.psl_send_reap.argtypes = [
        vp, i, ctypes.POINTER(u64), ctypes.POINTER(ll), i,
    ]
    lib.psl_send_flush.restype = i
    lib.psl_send_flush.argtypes = [vp, i]
    lib.psl_send_cancel.restype = ll
    lib.psl_send_cancel.argtypes = [vp, i]
    lib.psl_send_reset_sid.argtypes = [vp, i]
    lib.psl_set_reassembly.argtypes = [vp, i]
    lib.psl_set_rails.argtypes = [vp, i]
    lib.psl_add_rail.restype = i
    lib.psl_add_rail.argtypes = [vp, i, cp, i, i, i]
    lib.psl_set_sockbuf.argtypes = [vp, i, i]
    lib.psl_recv.argtypes = [vp, ctypes.POINTER(_FrameView), i]
    lib.psl_frame_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.psl_stop.argtypes = [vp]
    lib.psl_destroy.argtypes = [vp]
    lib.psl_memcpy.argtypes = [vp, vp, u64]
    lib.psl_iadd_f32.argtypes = [vp, vp, u64]
    lib.psl_iadd_f64.argtypes = [vp, vp, u64]
    lib.psl_copy_pool_create.restype = vp
    lib.psl_copy_pool_create.argtypes = [i]
    lib.psl_copy_pool_copy.argtypes = [vp, vp, vp, u64]
    lib.psl_copy_pool_destroy.argtypes = [vp]
    # The wire codec (ops/codecs.py).
    lib.psl_codec_set_fp8_tables.restype = None
    lib.psl_codec_set_fp8_tables.argtypes = [vp, vp]
    lib.psl_codec_encode.restype = i
    lib.psl_codec_encode.argtypes = [i, vp, vp, u64, u64, vp, vp]
    lib.psl_codec_decode.restype = i
    lib.psl_codec_decode.argtypes = [i, vp, vp, u64, u64, i, vp]
    lib.psl_codec_encode_mt.restype = i
    lib.psl_codec_encode_mt.argtypes = [i, vp, vp, u64, u64, vp, vp, i]
    lib.psl_codec_decode_mt.restype = i
    lib.psl_codec_decode_mt.argtypes = [i, vp, vp, u64, u64, i, vp, i]
    lib.psl_codec_decode_ranges.restype = i
    lib.psl_codec_decode_ranges.argtypes = [i, vp, vp, vp, vp, i, u64, i,
                                            vp]


# -- single-shot kernels without the GIL --------------------------------------
#
# ctypes releases the GIL around a call, so the receive side's large
# copies (chunk scatter) and the server's in-place adds run beside the
# receive pump and the apply shards.  Both are bit-identical to the numpy
# operations they replace (memcpy; an element-wise IEEE add in the same
# dtype).  A call costs a ctypes trampoline (~1 us): only work above a
# size floor goes native.

#: Below this many bytes a numpy slice-assign beats the ctypes call.
COPY_KERNEL_MIN = 64 << 10
#: Below this many elements numpy's ufunc dispatch is cheaper.
IADD_KERNEL_MIN = 4096

_IADD_SYMS = {"float32": "psl_iadd_f32", "float64": "psl_iadd_f64"}


def _copy_threads(env=None) -> int:
    if env is not None:
        return env.find_int("PS_COPY_THREADS", 4)
    try:
        return int(os.environ.get("PS_COPY_THREADS", "4"))
    except ValueError:
        return 4


def scatter_copy_kernel(env=None):
    """A ``(dst_ptr, src_ptr, nbytes)`` copy for the chunk assembler's
    scatter: multi-MiB copies split over the process-wide
    :class:`CopyPool` (``PS_COPY_THREADS``, default 4; 0 = one
    ``psl_memcpy``), or None when ``PS_NATIVE=0`` for this node.  The
    pool's threads start at the first copy, not here: every van builds
    an assembler, and most never receive a chunk."""
    lib = load(env)
    if lib is None:
        return None
    n = _copy_threads(env)
    if n <= 0:
        return lib.psl_memcpy
    state: dict = {}

    def kernel(dst_addr, src_addr, nbytes):
        fn = state.get("fn")
        if fn is None:
            fn = state["fn"] = shared_copy_pool(n, env).copy
        fn(dst_addr, src_addr, nbytes)

    return kernel


def try_iadd(dst: np.ndarray, src: np.ndarray, env=None) -> bool:
    """``dst += src`` in the core when eligible; False (the caller runs
    numpy) for small, non-f32/f64, mixed-dtype, unaligned or
    non-contiguous operands, or when ``PS_NATIVE=0``.  The bits equal
    numpy's in-place add."""
    if dst.size < IADD_KERNEL_MIN or dst.dtype != src.dtype:
        return False
    sym = _IADD_SYMS.get(dst.dtype.name)
    if sym is None:
        return False
    lib = load(env)
    if lib is None:
        return False
    if (not dst.flags.c_contiguous or not src.flags.c_contiguous
            or dst.size != src.size):
        return False
    align = dst.dtype.itemsize
    dp, sp = dst.ctypes.data, src.ctypes.data
    if dp % align or sp % align:
        # A payload view may start at any wire offset; the C loop
        # dereferences typed pointers.
        return False
    getattr(lib, sym)(dp, sp, dst.size)
    return True


class CopyPool:
    """Parallel memcpy on persistent native threads (the IPC transport's
    copy-thread pool, rdma_transport.h:469-633), alive as long as the
    process (:func:`shared_copy_pool`)."""

    def __init__(self, lib: ctypes.CDLL, n_threads: int):
        self._lib = lib
        self._h = lib.psl_copy_pool_create(n_threads)

    def copy(self, dst_addr: int, src_addr: int, nbytes: int) -> None:
        """Raw-pointer copy; the caller keeps both buffers alive."""
        self._lib.psl_copy_pool_copy(self._h, dst_addr, src_addr, nbytes)


_shared_pool: Optional[CopyPool] = None
_shared_pool_mu = threading.Lock()


def shared_copy_pool(n_threads: int, env=None) -> Optional[CopyPool]:
    """One process-wide pool (BYTEPS_IPC_COPY_NUM_THREADS): co-located
    vans share its threads and it lives as long as the process, so no
    van's shutdown frees it under another's copy.  The first caller's
    thread count wins; None when ``PS_NATIVE=0`` for this node."""
    global _shared_pool
    lib = load(env)
    if lib is None:
        return None
    with _shared_pool_mu:
        if _shared_pool is None:
            _shared_pool = CopyPool(lib, n_threads)
        return _shared_pool


def _check(rc: int) -> int:
    if rc < 0:
        raise OSError(-rc, os.strerror(-rc))
    return rc


class NativeTransport:
    """One core: sockets, sender lanes, receive pumps and pipes."""

    _REAP_CAP = 256

    def __init__(self, env=None):
        self._lib = load(env)
        if self._lib is None:
            raise RuntimeError("PS_NATIVE=0: no native transport")
        self._h = self._lib.psl_create()

    def bind(self, port: int, backlog: int = 128) -> int:
        return _check(self._lib.psl_bind(self._h, port, backlog))

    def stats(self) -> dict:
        """The core's counter block: absolute monotonic totals."""
        out = _WireStats()
        n = self._lib.psl_stats_snapshot(self._h, ctypes.byref(out))
        if n < ctypes.sizeof(_WireStats):
            raise RuntimeError(f"psl_stats_snapshot wrote {n} bytes, "
                               f"expected {ctypes.sizeof(_WireStats)}")
        return {name: int(getattr(out, name))
                for name, _ in _WireStats._fields_ if name != "abi"}

    def connect(self, node_id: int, host: str, port: int,
                timeout_ms: int = 30000) -> None:
        _check(self._lib.psl_connect(self._h, node_id, host.encode(), port,
                                     timeout_ms))

    def bind_local(self, path: str, backlog: int = 128) -> None:
        """``DMLC_LOCAL``: listen on a unix socket at ``path``."""
        _check(self._lib.psl_bind_local(self._h, path.encode(), backlog))

    def connect_local(self, node_id: int, path: str,
                      timeout_ms: int = 30000) -> None:
        _check(self._lib.psl_connect_local(self._h, node_id, path.encode(),
                                           timeout_ms))

    def pipe_connect(self, node_id: int, path: str, data_bytes: int) -> None:
        """``PS_SHM_RING``: route this peer's whole stream through a
        shared-memory byte pipe created at ``path``."""
        _check(self._lib.psl_pipe_connect(self._h, node_id, path.encode(),
                                          data_bytes))

    def pipe_watch(self, directory: str, prefix: str, suffix: str,
                   idle_cap_us: int = 0) -> None:
        """Attach inbound pipes named ``<prefix>*<suffix>`` in
        ``directory`` as they appear; ``idle_cap_us`` caps the poller's
        idle backoff (0 keeps the default)."""
        _check(self._lib.psl_pipe_watch(self._h, directory.encode(),
                                        prefix.encode(), suffix.encode(),
                                        idle_cap_us))

    def send(self, node_id: int, meta: bytes, data: List) -> int:
        """One frame, written inline under the peer's write lock."""
        n = len(data)
        bufs = (ctypes.c_void_p * n)()
        lens = (ctypes.c_uint64 * n)()
        keep = []
        for k, d in enumerate(data):
            mv = memoryview(d).cast("B")
            if mv.readonly:
                mv = memoryview(bytearray(mv))
            c = (ctypes.c_uint8 * len(mv)).from_buffer(mv)
            keep.append((mv, c))
            bufs[k] = ctypes.addressof(c)
            lens[k] = len(mv)
        meta_buf = (ctypes.c_uint8 * len(meta)).from_buffer_copy(meta)
        return _check(self._lib.psl_send(self._h, node_id, meta_buf,
                                         len(meta), n, bufs, lens))

    # -- sender lanes ---------------------------------------------------------

    def send_enqueue(self, node_id: int, priority: int, meta: bytes,
                     arrs: List[np.ndarray], chunk_bytes: int = 0,
                     chunk_ext_off: int = -1) -> int:
        """Queue one data frame (or a whole chunked transfer) on the
        peer's sender lane; returns a ticket at once.  The caller keeps
        ``arrs`` (contiguous) alive and unmutated until the ticket is
        reaped: the lane holds raw pointers and copies only ``meta``."""
        n = len(arrs)
        bufs = (ctypes.c_void_p * n)()
        lens = (ctypes.c_uint64 * n)()
        for k, a in enumerate(arrs):
            bufs[k] = a.ctypes.data
            lens[k] = a.nbytes
        return _check(self._lib.psl_send_enqueue(
            self._h, node_id, priority, meta, len(meta), n, bufs, lens,
            chunk_bytes, chunk_ext_off))

    def send_reap(self, node_id: int) -> List[Tuple[int, int]]:
        """Completed ``(ticket, status)`` pairs of one peer: 0 sent,
        negative -errno (abandoned)."""
        out: List[Tuple[int, int]] = []
        tickets = (ctypes.c_uint64 * self._REAP_CAP)()
        status = (ctypes.c_longlong * self._REAP_CAP)()
        while True:
            n = self._lib.psl_send_reap(self._h, node_id, tickets, status,
                                        self._REAP_CAP)
            out.extend((int(tickets[k]), int(status[k])) for k in range(n))
            if n < self._REAP_CAP:
                return out

    def send_flush(self, timeout_ms: int = -1) -> bool:
        """Wait until every lane sent (or abandoned) its queue."""
        return self._lib.psl_send_flush(self._h, timeout_ms) == 0

    def send_cancel(self, node_id: int) -> int:
        """Drop the peer's queued frames (their tickets reap as errors)."""
        return int(self._lib.psl_send_cancel(self._h, node_id))

    def send_reset_sid(self, node_id: int) -> None:
        self._lib.psl_send_reset_sid(self._h, node_id)

    def set_rails(self, n: int) -> None:
        """``PS_NATIVE_RAILS``: stripe each chunked transfer over ``n``
        connections per peer.  Before ``bind`` and the first send."""
        self._lib.psl_set_rails(self._h, n)

    def add_rail(self, node_id: int, host: str, port: int,
                 timeout_ms: int = 30000, idx: int = 1) -> None:
        """Dial data rail ``idx`` (1-based beyond the main connection);
        dialing an index again replaces its connection."""
        _check(self._lib.psl_add_rail(self._h, node_id, host.encode(), port,
                                      timeout_ms, idx))

    def set_sockbuf(self, snd: int, rcv: int) -> None:
        """``PS_TCP_SNDBUF``/``PS_TCP_RCVBUF`` on the core's sockets (0
        keeps the OS default)."""
        self._lib.psl_set_sockbuf(self._h, snd, rcv)

    def set_reassembly(self, on: bool) -> None:
        """Receive-side reassembly: the chunks of a transfer land in one
        pooled buffer and ``recv`` hands over one frame whose
        ``ChunkInfo.index`` is ``NATIVE_XFER_COMPLETE``."""
        self._lib.psl_set_reassembly(self._h, 1 if on else 0)

    def recv(self, timeout_ms: int = -1) -> Optional[Tuple[bytes, List]]:
        """``(meta, segments)``, None once stopped; TimeoutError on a
        timeout.  The segments are writable uint8 views of the pooled
        frame, freed when the last view derived from them dies."""
        view = _FrameView()
        rc = self._lib.psl_recv(self._h, ctypes.byref(view), timeout_ms)
        if rc == -1:
            return None
        if rc == 0:
            raise TimeoutError
        n_data = view.n_data
        base = ctypes.addressof(view.buf.contents)
        ptr = ctypes.cast(base, ctypes.POINTER(ctypes.c_uint8))
        fin = None
        try:
            lens = struct.unpack(f"<{n_data}Q",
                                 ctypes.string_at(view.buf, 8 * n_data))
            total = 8 * n_data + view.meta_len + sum(lens)
            mv = _PyMemoryView_FromMemory(base, total, _PyBUF_WRITE)
            frame = np.frombuffer(mv, dtype=np.uint8).view(_NativeFrame)
            fin = weakref.finalize(frame, self._lib.psl_frame_free, ptr)
            off = 8 * n_data
            meta = frame[off:off + view.meta_len].tobytes()
            off += view.meta_len
            segs = []
            for ln in lens:
                segs.append(frame[off:off + ln])
                off += ln
            return meta, segs
        except BaseException:
            if fin is not None:
                fin()
            else:
                self._lib.psl_frame_free(ptr)
            raise

    def stop(self) -> None:
        if self._h:
            self._lib.psl_stop(self._h)

    def destroy(self) -> None:
        if self._h:
            self._lib.psl_destroy(self._h)
            self._h = None
