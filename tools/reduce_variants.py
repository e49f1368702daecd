"""Variants of the D1/D2 kernel (``csrc/reduce_update.cu``) timed side by
side on one card.

Each variant is the source with a few textual substitutions (rows loaded
per batch, the launch bounds, 8-byte packs for 2-byte dtypes, ...; "base"
is the source as it is),
built by nvcc into a library of its own under
``pslite_tpu_torch/_build/variants/`` (all at once, one nvcc each).  For
each, the wrappers of ``ops/reduce_update.py`` launch that library's
``pstt_reduce_update``: D1 push_pull (f32, bf16) and D2 with its pull
(adam f32 and bf16, sgd_momentum and adagrad bf16) on the 40 x 1 MB
bucket over 8
worker rows, each held against the plain version (0 differing elements;
D2 against the plain reduction followed by the K1-K3 launch), then timed
host-free (``chip_smoke.graph_ms``).  Prints ``VARIANTS {json}``: per
variant its registers and spills (``-Xptxas -v``) and its ms per row,
beside the row's bound.

    python3 tools/reduce_variants.py [VARIANT ...]
"""

import ctypes
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

BATCH = ("constexpr int kBatch = sizeof(T) == 4 ? 8 : "
         "(MODE >= kSgdMomentum ? 2 : 4);")
BLOCKS = "constexpr int kMinBlocks = sizeof(T) == 4 ? 1 : 4;"
# The source's own choice ("base": f32 8 rows a batch; 2-byte dtypes 4
# rows for D1, 2 for D2, and launch bounds of 4 blocks a SM) and the
# designs it was chosen over.
VARIANTS = {
    "base": [],
    "batch8_2byte": [(BATCH, "constexpr int kBatch = 8;"),
                     (BLOCKS, "constexpr int kMinBlocks = 1;")],
    "batch8_bounds4_2byte": [(BATCH, "constexpr int kBatch = 8;")],
    "batch4_2byte_nobounds": [(BATCH, "constexpr int kBatch = sizeof(T) == "
                                      "4 ? 8 : 4;"),
                              (BLOCKS, "constexpr int kMinBlocks = 1;")],
    "batch4_2byte": [(BATCH, "constexpr int kBatch = sizeof(T) == 4 ? 8 : "
                             "4;")],
    "batch2_2byte": [(BATCH, "constexpr int kBatch = sizeof(T) == 4 ? 8 : "
                             "2;")],
    "bounds3_2byte": [(BLOCKS, "constexpr int kMinBlocks = sizeof(T) == 4 "
                               "? 1 : 3;")],
    "bounds4_f32": [(BLOCKS, "constexpr int kMinBlocks = 4;")],
    "pack8_2byte": [("constexpr int V = 16 / sizeof(T);",
                     "constexpr int V = 4;"),
                    ("struct alignas(16) Pack",
                     "struct alignas(sizeof(T) * V) Pack")],
    "threads128": [("constexpr int kThreads = 256;",
                    "constexpr int kThreads = 128;")],
}


def build(names):
    from pslite_tpu_torch.ops import _native

    src = open(os.path.join(_native.CSRC, "reduce_update.cu")).read()
    out = os.path.join(_native.BUILD_DIR, "variants")
    os.makedirs(out, exist_ok=True)
    cmds, libs = [], {}
    for name in names:
        text = src
        for a, b in VARIANTS[name]:
            if a not in text:
                raise AssertionError(f"{name}: {a!r} not in the source")
            text = text.replace(a, b)
        path = os.path.join(out, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        libs[name] = os.path.join(out, f"lib{name}.so")
        cmds.append([_native.find_nvcc(), *_native.NVCC_FLAGS, "-I",
                     str(_native.CSRC), "-shared", path, "-o", libs[name]])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    reports = {}
    for name, p in zip(names, procs):
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        # Per instantiation (dtype, mode): registers and spill stores.
        kernels = {}
        for m in re.finditer(r"reduce_kernelI(\w+?)Li(\d)E.*?"
                             r"(\d+) bytes spill stores.*?Used (\d+) "
                             r"registers", log, re.S):
            dt = {"f": "f32", "13__nv_bfloat16": "bf16",
                  "6__half": "f16"}.get(m.group(1), m.group(1))
            kernels[f"{dt}/{m.group(2)}"] = [int(m.group(4)),
                                             int(m.group(3))]
        reports[name] = {"registers_spills": kernels}
    return libs, reports


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("reduce_variants: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from pslite_tpu_torch.ops import _native
    from pslite_tpu_torch.ops import fused_update as fu
    from pslite_tpu_torch.ops import reduce_update as ru

    names = sys.argv[1:] or list(VARIANTS)
    libs, reports = build(names)
    _native.lib()  # K1-K3 for the plain compositions
    real_call = _native.call
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    N, P = cs.N, cs.P
    out = {}
    for name in names:
        so = ctypes.CDLL(libs[name])
        fn = so.pstt_reduce_update
        fn.argtypes = list(_native._SIGNATURES["pstt_reduce_update"])
        fn.restype = ctypes.c_int

        def call(entry, *args, _fn=fn):
            if entry != "pstt_reduce_update":
                return real_call(entry, *args)
            err = _fn(*args)
            if err:
                raise RuntimeError(f"pstt_reduce_update: CUDA error {err}")

        _native.call = call
        rows = {}
        for dtype in (torch.float32, torch.bfloat16):
            tag = str(dtype).replace("torch.", "")
            grads = torch.randn((N, P), generator=gen, device=dev).to(dtype)
            store = torch.randn(P, generator=gen, device=dev).to(dtype)
            pk, pp = torch.empty_like(store), torch.empty_like(store)
            sk, sp = store.clone(), store.clone()
            ru.reduce_apply(grads, sk, "sum", pk)
            ru.reduce_apply_reference(grads, sp, "sum", pp)
            torch.cuda.synchronize()
            cs.mismatches(sk, sp)
            cs.mismatches(pk, pp)
            rows[f"reduce_push_pull[{tag}]"] = (
                cs.graph_ms(lambda: ru.reduce_apply(grads, sk, "sum", pk)),
                (N + 3) * P * dtype.itemsize / cs.HBM_BYTES_PER_S * 1e3)
            alpha = fu.adam_alpha(torch.ones(1, device=dev), 1e-3)
            for kind, params in (("adam", (0.9, 0.999, 1e-8)),
                                 ("sgd_momentum", (0.01, 0.9)),
                                 ("adagrad", (0.01, 1e-8))):
                if kind != "adam" and dtype == torch.float32:
                    continue
                n_state = 2 if kind == "adam" else 1
                state = tuple((torch.rand(P, generator=gen, device=dev)
                               * 0.01).to(dtype) for _ in range(n_state))
                runs = []
                for fused in (None, True):
                    s, st = store.clone(), tuple(t.clone() for t in state)
                    p = torch.empty_like(store)
                    if fused is None:
                        ru.reduce_update(grads, s, st, kind, params, alpha, p)
                    else:
                        ru.reduce_update_reference(grads, s, st, kind, params,
                                                   alpha, p, fused=True)
                    runs.append((s, p) + st)
                torch.cuda.synchronize()
                for a, b in zip(*runs):
                    cs.mismatches(a, b)
                s, p, *st = runs[0]
                words = N + (7 if kind == "adam" else 5)
                rows[f"reduce_{kind}[{tag}]"] = (
                    cs.graph_ms(lambda: ru.reduce_update(
                        grads, s, st, kind, params, alpha, p)),
                    words * P * dtype.itemsize / cs.HBM_BYTES_PER_S * 1e3)
            del grads, store, sk, sp, pk, pp
        out[name] = dict(reports[name], rows={
            k: {"ms": ms, "bound_ms": b, "share": b / ms}
            for k, (ms, b) in rows.items()})
    _native.call = real_call
    print("VARIANTS", json.dumps({"card": cs.nvidia_smi(), "variants": out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
