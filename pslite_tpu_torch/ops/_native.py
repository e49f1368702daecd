"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, which is
loaded with ``ctypes``.  The library is built at first use into
``pslite_tpu_torch/_build/`` under a name that hashes the sources, the
headers they include and the flags, so an edited source never loads a
stale build.  The sources compile in parallel (one ``nvcc`` each) and
are then linked.

Nothing here runs at import time: a host without ``nvcc`` imports the
package and uses the plain PyTorch versions for CPU tensors.  A failed
build raises; no caller falls back to a plain version for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("fused_update.cu", "reduce_update.cu", "ring_push_pull.cu",
           "ring_int8.cu", "ring_int8_group.cu", "quantize_int8.cu",
           "sparse_rows.cu")
HEADERS = ("fused_update.cuh", "ring_geometry.cuh", "ring_int8.cuh")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry points and their argument types (see csrc/*.cu).
_SIGNATURES = {
    "pstt_sgd_update": (_P, _P, _P, _L, _F, _F, _P),
    "pstt_adagrad_update": (_P, _P, _P, _L, _F, _F, _P),
    "pstt_adam_update": (_P, _P, _P, _P, _P, _L, _F, _F, _F, _F, _F, _P),
    "pstt_sgd_update_bf16": (_P, _P, _P, _L, _F, _F, _P),
    "pstt_adagrad_update_bf16": (_P, _P, _P, _L, _F, _F, _P),
    "pstt_adam_update_bf16": (_P, _P, _P, _P, _P, _L, _F, _F, _F, _F, _F,
                              _P),
    "pstt_reduce_update": (_P, _I, _P, _I, _I, _I, _F, _F, _F, _F, _F, _P,
                           _P),
    "pstt_ring_push_pull": (_P, _P, _P, _I, _I, _L, _L, _L, _I, _L, _I, _F,
                            _P),
    "pstt_ring_group": (_P, _I, _I, _I, _F, _P, ctypes.POINTER(_I)),
    "pstt_ring_replay": (_P, _P, _P, _I, _I, _L, _L, _L, _I, _L, _I, _F, _I,
                         _P),
    "pstt_ring_reduce_peers_segs": (_P, _I, _P, _P, _I, _I, _L, _L, _L, _I,
                                    _L, _I, _F, _P),
    "pstt_ring_gather_peers": (_P, _I, _P, _I, _P),
    "pstt_ipc_alloc": (_I, _L, ctypes.POINTER(_P)),
    "pstt_ipc_free": (_I, _P),
    "pstt_ipc_export": (_I, _P, _P),
    "pstt_ipc_open": (_I, _P, ctypes.POINTER(_P)),
    "pstt_ipc_close": (_I, _P),
    "pstt_ring_int8": (_P, _I, _P, _L, _I, _I, _P, _I, _I, _F, _I, _I, _P),
    "pstt_ring_int8_occupancy": (_I, _I, _I, _I, ctypes.POINTER(_I)),
    "pstt_ring_int8_peers": (_P, _I, _P, _L, _I, _I, _P, _I, _I, _F, _I, _I,
                             _P),
    "pstt_ring_int8_peers_occupancy": (_I, _I, _I, _I, ctypes.POINTER(_I)),
    "pstt_quantize_int8": (_P, _P, _P, _L, _L, _P),
    "pstt_dequantize_int8": (_P, _P, _L, _I, _P, _L, _P),
    "pstt_sparse_sort": (_P, _P, _L, _I, _I, _P),
    "pstt_sparse_scatter_add": (_P, _P, _P, _L, _I, _I, _P),
    "pstt_sparse_row_adagrad": (_P, _P, _P, _P, _L, _I, _F, _F, _I, _P),
    "pstt_sparse_walk_probe": (_P, _P, _P, _L, _I, _I, _P, _P),
    "pstt_sparse_gather_rows": (_P, _P, _P, _L, _I, _I, _I, _P),
}

# Where the CUDA toolkit installs nvcc by default.
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# Filled by build(): the library's path and, when it was compiled in
# this process, the compiler's -Xptxas -v report.
build_info = {"log": "", "path": None}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's standard install prefix."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append(shutil.which("nvcc"))
    cands.append(DEFAULT_NVCC)
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of pslite_tpu_torch cannot be built"
    )


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Start every command at once; raise with its output if any fails.
    Returns the combined stderr+stdout text."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"kernel build failed ({p.returncode}): {' '.join(cmd)}\n{out}"
            )
    return "".join(outs)


def build(force: bool = False) -> Path:
    """Compile the sources into the shared library (if not already
    built) and return its path."""
    lib_path = BUILD_DIR / f"libpslite_tpu_torch_{_digest()}.so"
    if lib_path.exists() and not force:
        build_info.update(path=str(lib_path))
        return lib_path
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}_{threading.get_ident()}"
    objs = [BUILD_DIR / f"{Path(s).stem}_{tag}.o" for s in SOURCES]
    log = _run_all([
        [nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)]
        for s, o in zip(SOURCES, objs)
    ])
    tmp = BUILD_DIR / f"{lib_path.name}.{tag}.tmp"
    _run_all([[nvcc, NVCC_FLAGS[0], "-shared", "-o", str(tmp),
               *map(str, objs)]])
    os.replace(tmp, lib_path)  # atomic: concurrent builds never tear it
    for o in objs:
        o.unlink(missing_ok=True)
    build_info.update(log=log, path=str(lib_path))
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, building it on first use."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            so.pstt_error_string.argtypes = [ctypes.c_int]
            so.pstt_error_string.restype = ctypes.c_char_p
            _lib = so
        return _lib


def call(name: str, *args) -> None:
    """Launch through C entry ``name``; raise on a non-zero CUDA error
    (a refused launch never runs, and a later synchronize would not
    report it).  ``pstt_error_string`` also clears the runtime's record
    of the error, so the next launch does not report it again."""
    so = lib()
    err = getattr(so, name)(*args)
    if err != 0:
        msg = so.pstt_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def stream_ptr(device) -> int:
    """The current PyTorch stream of ``device``, for a launch."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
