"""Microbenchmarks behind the sparse push kernels' design, on one card.

Builds ``pslite_tpu_torch/csrc/sparse_rows.cu`` together with two test
kernels into ``pslite_tpu_torch/_build/`` and prints one JSON line:

- ``exchange_cycles``: SM cycles per round, on a cluster of 16 CTAs of 512
  threads, of a cluster barrier with release semantics (``cluster.sync``),
  of a relaxed one, and of an exchange in which every thread stores one
  int into each peer CTA with ``st.async`` (completing on the peer's
  mbarrier) plus a relaxed barrier.
- ``walk_cycles_per_row``: the long-run kernel's ``walk`` alone (float
  rows of 32 values, ``kAhead`` rows loaded ahead), fed by a warp that
  marks ring slots full without copying anything: SM cycles per row of
  one column's chain, for a run of 6,028 rows (BASELINE config 5's
  hottest row).

Run it on the card: ``python3 tools/sparse_micro.py``.
"""

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

TESTS = r'''
namespace {

__global__ void exchange(long long* cyc, int rounds) {
  __shared__ __align__(8) unsigned long long bar;
  __shared__ int buf[16 * 512];
  cg::cluster_group cl = cg::this_cluster();
  const int c = static_cast<int>(cl.block_rank()), t = threadIdx.x;
  if (t == 0) {
    mbar_init(&bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  cl.sync();
  const long long t0 = clock64();
  for (int r = 0; r < rounds; ++r) cl.sync();
  const long long t1 = clock64();
  for (int r = 0; r < rounds; ++r) {
    cluster_arrive_relaxed();
    cluster_wait();
  }
  const long long t2 = clock64();
  for (int r = 0; r < rounds; ++r) {
    if (t == 0) mbar_expect(&bar, 16 * 512 * 4);
    for (int k = 0; k < 16; ++k)
      send(peer(&buf[c * 512 + t], k), r, peer(&bar, k));
    mbar_wait_peers(&bar, r & 1);
    cluster_arrive_relaxed();
    cluster_wait();
  }
  const long long t3 = clock64();
  if (c == 0 && t == 0) {
    cyc[0] = (t1 - t0) / rounds;
    cyc[1] = (t2 - t1) / rounds;
    cyc[2] = (t3 - t2) / rounds;
  }
}

__global__ void walk_alone(float* out, long long* cyc, int len, int rb) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) unsigned long long full[kStages], empty[kStages];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  float* ring = reinterpret_cast<float*>(smem);
  for (int i = threadIdx.x; i < (kStages * rb + kAhead) * 32;
       i += blockDim.x)
    ring[i] = 1.0f + (i & 7);
  __syncthreads();
  const int nb = (len + rb - 1) / rb;
  if (warp == 0) {
    unsigned it = 0;
    long long waited = 0;
    const long long t0 = clock64();
    const float x = walk<float, true, 7>(0.f, ring, lane, rb, len, it, full,
                                          empty, lane, waited);
    const long long t1 = clock64();
    out[lane] = x;
    if (lane == 0) cyc[0] = t1 - t0;
  } else {
    for (int b = 0; b < nb; ++b) {
      const int s = b % kStages;
      if (b >= kStages) mbar_wait(&empty[s], ((b / kStages) - 1) & 1);
      if (lane == 0) mbar_arrive(&full[s]);
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int micro_exchange(void* cyc, int rounds) {
  cudaFuncSetAttribute(exchange,
                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(16);
  cfg.blockDim = dim3(512);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 16;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, exchange,
                                     static_cast<long long*>(cyc), rounds);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

extern "C" int micro_walk(void* out, void* cyc, int len, int rb) {
  const int smem = (kStages * rb + kAhead) * 32 * 4;
  cudaFuncSetAttribute(walk_alone,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  walk_alone<<<1, 64, smem>>>(static_cast<float*>(out),
                              static_cast<long long*>(cyc), len, rb);
  return static_cast<int>(cudaGetLastError());
}
'''


def build():
    from pslite_tpu_torch.ops import _native

    src = os.path.join(_native.CSRC, "sparse_rows.cu")
    _native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _native.BUILD_DIR / "sparse_micro.cu"
    cu.write_text(f'#include "{src}"\n' + TESTS)
    so = _native.BUILD_DIR / "sparse_micro.so"
    subprocess.run([_native.find_nvcc(), *_native.NVCC_FLAGS, "-shared",
                    "-o", str(so), str(cu)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sparse_micro: CUDA is not available", file=sys.stderr)
        return 2
    lib = build()
    lib.micro_exchange.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.micro_walk.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_int]
    cyc = torch.zeros(3, dtype=torch.int64, device="cuda")
    for _ in range(2):
        if lib.micro_exchange(cyc.data_ptr(), 20):
            raise RuntimeError("the exchange test did not launch")
    torch.cuda.synchronize()
    exchange = dict(zip(("release_barrier", "relaxed_barrier",
                         "st_async_exchange"), cyc.cpu().tolist()))
    out = torch.zeros(32, device="cuda")
    walk = {}
    for rb in (128, 192):
        for _ in range(2):
            if lib.micro_walk(out.data_ptr(), cyc.data_ptr(), 6028, rb):
                raise RuntimeError("the walk test did not launch")
        torch.cuda.synchronize()
        walk[f"rows_per_slot_{rb}"] = cyc[0].item() / 6028
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": smi, "exchange_cycles": exchange,
                      "walk_cycles_per_row": walk}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
