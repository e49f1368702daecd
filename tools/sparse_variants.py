"""Variants of the sparse row kernels (``csrc/sparse_rows.cu``) timed side
by side on one card.

Each variant is the source with a few textual substitutions ("base" is
the source as it is), or another source given by its path (say, a
parent commit's ``csrc/sparse_rows.cu`` unpacked with ``git archive``),
built by nvcc into a library of its own under
``pslite_tpu_torch/_build/variants/`` (all at once, one nvcc each).  For
each, the wrappers of ``ops/sparse_rows.py`` launch that library's C
entries: S1 and S2 of one table at config 5's shapes (``chip_smoke``'s
``sparse_rows_rows`` inputs) and, where the library has the group
entries, the sum and row-wise Adagrad group push of the Criteo Kaggle
layer (``chip_smoke.group_specs()["kaggle26"]``), each held against the
plain version (sum 0 differing elements, row-wise Adagrad rtol 1e-5 /
atol 1e-6), then timed host-free (``chip_smoke.graph_ms``) in turns:
every variant once per round, ``ROUNDS`` rounds.  Prints ``VARIANTS
{json}``: per variant each kernel's registers and stack frame (``-Xptxas
-v``) and its ms per row in each round.

    python3 tools/sparse_variants.py [VARIANT | path/to/sparse_rows.cu ...]
"""

import ctypes
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

ROUNDS = 3
LOAD_F32 = ("  static __device__ __forceinline__ float load(const float* p) "
            "{ return *p; }")
LOAD_BF16 = ("  static __device__ __forceinline__ float load(const "
             "__nv_bfloat16* p) {\n    return __bfloat162float(*p);\n  }")
ROW_LOAD = ("Elem<T>::load(rows + static_cast<long long>(ps[r]) * dim + "
            "c)")
# The source as it is, and the designs weighed against it.
VARIANTS = {
    "base": [],
    # The short runs' row-wise Adagrad reads its update rows through the
    # read-only path.
    "adagrad_short_ldg": [
        (LOAD_F32, LOAD_F32 + "\n  static __device__ __forceinline__ float "
                              "load_nc(const float* p) { return __ldg(p); }"),
        (LOAD_BF16, LOAD_BF16 + "\n  static __device__ __forceinline__ "
                                "float load_nc(const __nv_bfloat16* p) {\n"
                                "    return __bfloat162float(__ldg(p));\n"
                                "  }"),
        (ROW_LOAD, ROW_LOAD.replace("::load(", "::load_nc(")),
    ],
    # The short-run kernels held to 32 registers a thread (8 blocks of 256
    # a SM), as the single-table kernels before groups compiled to: their
    # grid is capped at the blocks that fit at once, and row-wise
    # Adagrad's takes one run a warp.
    "short_bounds8": [
        ("__global__ void scatter_short_kernel(",
         "__global__ void __launch_bounds__(256, 8) scatter_short_kernel("),
        ("__global__ void adagrad_short_kernel(",
         "__global__ void __launch_bounds__(256, 8) adagrad_short_kernel("),
    ],
}


def build(names):
    from pslite_tpu_torch.ops import _native

    src = open(os.path.join(_native.CSRC, "sparse_rows.cu")).read()
    out = os.path.join(_native.BUILD_DIR, "variants")
    os.makedirs(out, exist_ok=True)
    cmds, libs = [], {}
    for i, name in enumerate(names):
        if name.endswith(".cu"):
            text = open(name).read()
        else:
            text = src
            for a, b in VARIANTS[name]:
                if a not in text:
                    raise AssertionError(f"{name}: {a!r} not in the source")
                text = text.replace(a, b)
        path = os.path.join(out, f"sparse_v{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        libs[name] = os.path.join(out, f"libsparse_v{i}.so")
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
        kernels = {}
        for m in re.finditer(r"Compiling entry function '(\w+)'.*?(\d+) "
                             r"bytes stack frame.*?Used (\d+) registers",
                             log, re.S):
            k = re.search(r"(sort|long_runs|scatter_short|adagrad_short|"
                          r"gather_rows|gather_group)_kernel\w*", m.group(1))
            if k:
                kernels[k.group(0)] = [int(m.group(3)), int(m.group(2))]
        reports[name] = {"registers_stack": kernels}
    return libs, reports


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sparse_variants: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from pslite_tpu_torch.models import embedding as emb
    from pslite_tpu_torch.ops import _native
    from pslite_tpu_torch.ops import sparse_rows as sr

    names = sys.argv[1:] or list(VARIANTS)
    libs, reports = build(names)
    real_call = _native.call
    dev = torch.device("cuda:0")
    N = cs.N
    S, rps = cs.emb_layout()
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 5)
    idx = torch.from_numpy(emb.skewed_indices(cs.EMB_ROWS, N, cs.EMB_BATCH,
                                              seed=0)).to(dev)
    rows = torch.randn((N, cs.EMB_BATCH, cs.EMB_DIM), generator=gen,
                       device=dev)
    store = torch.randn((S * rps, cs.EMB_DIM), generator=gen, device=dev)
    acc = torch.rand(S * rps, generator=gen, device=dev)
    spec = cs.group_specs()["kaggle26"]
    grps = [cs.table_rps(r, d) for _, r, d, _, _, _ in spec]
    gstores = [torch.randn((N * p, d), generator=gen, device=dev)
               for p, (_, _, d, _, _, _) in zip(grps, spec)]
    gaccs = [torch.rand(N * p, generator=gen, device=dev) for p in grps]
    gidx = [torch.from_numpy(i).to(dev)
            for i, _, _ in cs.group_stats(emb, spec)]
    grows = [torch.randn((N, b, d), generator=gen, device=dev)
             for _, _, d, b, _, _ in spec]

    fns = {}
    for name in names:
        so = ctypes.CDLL(libs[name])
        entries = {}
        for entry, argtypes in _native._SIGNATURES.items():
            if entry.startswith("pstt_sparse") and hasattr(so, entry):
                fn = getattr(so, entry)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
                entries[entry] = fn
        fns[name] = entries

    def use(name):
        def call(entry, *args):
            if entry not in fns[name]:
                return real_call(entry, *args)
            err = fns[name][entry](*args)
            if err:
                raise RuntimeError(f"{entry}: CUDA error {err}")
        _native.call = call

    cases = {
        "sparse_scatter_add": (
            lambda s, a: sr.scatter_add(s, idx, rows, S, rps),
            lambda s, a: sr.scatter_add_reference(s, idx, rows, S, rps),
            None),
        "sparse_row_adagrad": (
            lambda s, a: sr.row_adagrad(s, a, idx, rows, S, rps, 0.01, 1e-8),
            lambda s, a: sr.row_adagrad_reference(s, a, idx, rows, S, rps,
                                                  0.01, 1e-8),
            None),
        "sparse_scatter_add_group[kaggle26]": (
            lambda s, a: sr.scatter_add_group(s, gidx, grows, N, grps),
            lambda s, a: sr.scatter_add_group_reference(s, gidx, grows, N,
                                                        grps),
            "pstt_sparse_push_group"),
        "sparse_row_adagrad_group[kaggle26]": (
            lambda s, a: sr.row_adagrad_group(s, a, gidx, grows, N, grps,
                                              0.01, 1e-8),
            lambda s, a: sr.row_adagrad_group_reference(
                s, a, gidx, grows, N, grps, 0.01, 1e-8),
            "pstt_sparse_push_group"),
    }
    out = {name: dict(reports[name], rows={}) for name in names}
    for name in names:  # every variant held against the plain versions
        use(name)
        for case, (fn, plain, needs) in cases.items():
            if needs and needs not in fns[name]:
                continue
            group = case.endswith("]")
            base_s = gstores if group else [store]
            base_a = gaccs if group else [acc]
            sk = [t.clone() for t in base_s]
            ak = [t.clone() for t in base_a]
            sp = [t.clone() for t in base_s]
            ap = [t.clone() for t in base_a]
            fn(sk if group else sk[0], ak if group else ak[0])
            plain(sp if group else sp[0], ap if group else ap[0])
            torch.cuda.synchronize()
            pairs = list(zip(sk + ak, sp + ap))
            if "adagrad" in case:
                if not cs.within(pairs, 1e-5, 1e-6):
                    raise AssertionError(f"{name} {case}: off the plain "
                                         f"version by {cs.max_err(pairs)}")
            else:
                for a, b in pairs:
                    cs.mismatches(a, b)
            out[name]["rows"][case] = []
    for _ in range(ROUNDS):
        for name in names:
            use(name)
            for case, (fn, _, _) in cases.items():
                if case not in out[name]["rows"]:
                    continue
                group = case.endswith("]")
                s = gstores if group else store
                a = gaccs if group else acc
                out[name]["rows"][case].append(cs.graph_ms(lambda: fn(s, a)))
    _native.call = real_call
    print("VARIANTS", json.dumps({"card": cs.nvidia_smi(), "variants": out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
