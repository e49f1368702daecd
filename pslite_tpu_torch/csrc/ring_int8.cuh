// The int8 ring's kernel and its launch helpers, shared by ring_int8.cu
// (one cluster per region, and the C entries) and ring_int8_group.cu (region
// groups), which compile in parallel: the library built in 83.1 s with
// both in one source and in 46.3 s with two (nvcc 12.8 for sm_90a; PERF.md
// section 6).  ring_int8.cu's note describes the kernel.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

namespace cg = cooperative_groups;

namespace pstt_int8 {

constexpr int kThreads = 512;
constexpr int kUnroll = 8;  // vectors in flight per thread
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmemFloats = 57344;  // 224 KiB of the 227 KiB a CTA may use
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kFirst = 0, kHop = 1, kOwner = 2, kGather = 3 };

__device__ __forceinline__ float scale_of(float amax) {
  return fmaxf(amax * (1.0f / 127.0f), 1e-30f);
}

// clip(rint(x / scale), -127, 127) of V values, with x / scale rounded as
// IEEE division rounds it, given inv = __frcp_rn(scale).  |x| <= 127 * scale
// (up to the rounding of the scale) wherever the kernel quantizes, so
// t = x * inv is within 2^-16 of the true quotient and the rounded quotient
// within 2^-18 of it: where t is farther than 2^-12 from a half-integer,
// rint(t) is rint(x / scale).  A vector with a near-tie (or a NaN) takes the
// division; one branch per vector keeps the loop's schedule.
template <int V>
__device__ __forceinline__ void quant(const float (&x)[V], float scale,
                                      float inv, float (&q)[V]) {
  bool near = false;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float t = x[e] * inv;
    q[e] = rintf(t);
    near |= !(fabsf(t - q[e]) < 0.5f - 0x1p-12f);
  }
  if (near) {
#pragma unroll
    for (int e = 0; e < V; ++e) q[e] = rintf(__fdiv_rn(x[e], scale));
  }
#pragma unroll
  for (int e = 0; e < V; ++e) q[e] = fminf(fmaxf(q[e], -127.f), 127.f);
}

template <int V>
__device__ __forceinline__ void load_v(const float* p, long long i,
                                       float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p + i);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
    x[0] = p[i];
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* p, long long i,
                                        const float (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p + i) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    p[i] = x[0];
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The exchange words of a region group (see "Region groups" above):
// relaxed 64-bit accesses at GPU scope (a slot's exchange number and its
// maximum travel in one word, so a reader never sees one without the
// other), and the done count's acquire-release add.
__device__ __forceinline__ void st_gpu(unsigned long long* p,
                                       unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_gpu(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long add_gpu(unsigned long long* p,
                                                      unsigned long long v) {
  unsigned long long old;
  asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], %2;\n"
               : "=l"(old)
               : "l"(p), "l"(v)
               : "memory");
  return old;
}

// The registers a sweep keeps per batch of kUnroll vectors a thread: the
// hop's grads (g), the store (s, owner hop) and the partial sums when they
// come from global memory (p, a spilled slice).  Unused arrays cost nothing.
template <int V>
struct Batch {
  float g[kUnroll][V], s[kUnroll][V], p[kUnroll][V];
};

// One sweep over the slice values [lo, hi) (offsets from the slice start).
// `src`/`dst` hold the partial sums (shared memory, or with GSRC the spill in
// global memory), `row` the hop's grads, `st`/`pl` the store and pulled, all
// offset to the slice start.  Each batch issues all its global loads before
// it computes; `a` holds the first batch already when `have_pre` (issued
// before the hop's barrier).  Returns max |value| written.
template <int MODE, bool GSRC, int V>
__device__ __forceinline__ float sweep(long long lo, long long hi,
                                       const float* src, float* dst,
                                       const float* __restrict__ row,
                                       float* __restrict__ st,
                                       float* __restrict__ pl, float scale,
                                       int handle, float lr, bool write_store,
                                       Batch<V>& a, bool have_pre) {
  constexpr long long kStep = static_cast<long long>(kThreads) * V;
  const float inv = __frcp_rn(scale);
  float amax = 0.f;
  for (long long j0 = lo + threadIdx.x * V; j0 < hi;
       j0 += kStep * kUnroll) {
    if (!have_pre || j0 != lo + threadIdx.x * V) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long j = j0 + u * kStep;
        if (j < hi) {
          if (MODE != kGather) load_v<V>(row, j, a.g[u]);
          if (MODE == kOwner) load_v<V>(st, j, a.s[u]);
          if (GSRC && MODE != kFirst) load_v<V>(src, j, a.p[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = j0 + u * kStep;
      if (j >= hi) break;
      float p[V], q[V], v[V];
      if (MODE != kFirst) {
        if (GSRC) {
#pragma unroll
          for (int e = 0; e < V; ++e) p[e] = a.p[u][e];
        } else {
          load_v<V>(src, j, p);
        }
        quant<V>(p, scale, inv, q);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (MODE == kFirst) {
          v[e] = a.g[u][e];
        } else if (MODE == kGather) {
          v[e] = __fmul_rn(q[e], scale);
        } else {
          v[e] = fmaf(q[e], scale, a.g[u][e]);
          if (MODE == kOwner) {
            if (handle == 0) {
              v[e] = a.s[u][e] + v[e];
            } else if (handle == 2) {
              v[e] = a.s[u][e] - lr * v[e];
            }
          }
        }
        amax = fmaxf(amax, fabsf(v[e]));
      }
      if (MODE == kGather) {
        if (pl != nullptr) store_v<V>(pl, j, v);
        if (write_store) store_v<V>(st, j, v);
      } else {
        if (dst != nullptr) store_v<V>(dst, j, v);
        if (MODE == kOwner && write_store) store_v<V>(st, j, v);
      }
    }
  }
  return amax;
}

// Issue the first batch of the next hop's loads (its grads, and the store
// on the owner hop): they do not depend on the scale the barrier brings.
template <int MODE, int V>
__device__ __forceinline__ void prefetch(const float* __restrict__ row,
                                         const float* __restrict__ st,
                                         long long hi, Batch<V>& a) {
  constexpr long long kStep = static_cast<long long>(kThreads) * V;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long j = threadIdx.x * V + u * kStep;
    if (j < hi) {
      load_v<V>(row, j, a.g[u]);
      if (MODE == kOwner) load_v<V>(st, j, a.s[u]);
    }
  }
}

// One bucket of a launch: its pointers (pulled and scratch may be NULL),
// its length, its rank count, and whether it takes float4 accesses.  A
// PEERS launch's bucket is a store piece: `rows` is a device table of its n
// rank rows' addresses (grads unused), and store, pulled and scratch hold
// bucket element `off` at their index 0.  64 bytes.
struct Bucket {
  const float* grads;  // [n, padded], row w = rank w
  float* store;        // [padded]
  float* pulled;       // [padded] or NULL
  float* scratch;      // [padded] or NULL (a region of it spills)
  long long padded;
  int n;
  int vec;
  const long long* rows;  // PEERS: n row addresses on the device
  long long off;          // PEERS: the piece's first element
};

// Buckets per launch.  The table is passed by value as the kernel's
// parameter (8 + 48 * 64 = 3,080 bytes, inside the 4 KiB of parameters
// every CUDA 12 release accepts), so no copy to the device precedes the
// launch; longer groups take several launches (ops/ring_collective.py
// INT8_MAX_GROUP).
constexpr int kMaxGroup = 48;

struct BucketTable {
  int count;
  Bucket b[kMaxGroup];
};

// Region table row: start, length, owning chunk c, walk step (1 or n-1),
// and the bucket (an index into the launch's BucketTable).
struct Region {
  long long start, len, chunk, step, bucket;
};

// The CTA's reduction slots: one per warp, and the CTA's maximum for the
// two hop parities (read by the cluster's peers through DSMEM).
struct Slots {
  float warp[kWarps];
  float cta[2];
  float group;  // the region's maximum from the group's exchange
};

// The clusters that walk one region together: `count` (G) clusters, this
// one member `member` of them, and the region row's exchange words (NULL
// when G = 1): 2 * G slots, by hop parity and member, each holding
// (exchange number << 32 | the member's maximum as bits), then the count
// of the group's CTAs done with the last exchange.
struct Group {
  unsigned long long* words;
  int count;
  int member;
};

// Clusters per region: at most one warp's lanes, which poll one slot each.
constexpr int kMaxGroups = 32;

// One CTA's part of the walk of one region of one bucket.  Partial sums of
// the slice's first smem_floats values live in `buf` (dynamic shared
// memory), the rest in the bucket's scratch.  A cluster of one CTA (C = 1)
// takes the same path: its barrier is the CTA's, its slot its own.  The
// region is cut into G * C slices; this CTA's is number member * C + r.
template <int V, bool PEERS, bool GROUP>
__device__ __forceinline__ void walk(const Bucket& bk, const Region& reg,
                                     const Group& grp, int smem_floats,
                                     int handle, float lr, bool gather,
                                     bool kv_store) {
  // Declared here, not passed in, so that a walk called out of line still
  // addresses them as shared memory.
  extern __shared__ float4 smem_vec[];
  __shared__ Slots sh;
  float* buf = reinterpret_cast<float*>(smem_vec);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int n = bk.n;
  const long long padded = bk.padded;
  const long long parts = static_cast<long long>(C) * (GROUP ? grp.count : 1);
  const long long slice = ((reg.len + parts - 1) / parts + 3) / 4 * 4;
  const long long lo =
      min((static_cast<long long>(GROUP ? grp.member : 0) * C + r) * slice,
          reg.len);
  const long long m = min(lo + slice, reg.len) - lo;  // values in this slice
  const long long nsm = min(m, static_cast<long long>(smem_floats));
  const long long base = reg.start + lo;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  auto row_of = [&](int k) -> const float* {
    if constexpr (PEERS) {
      return reinterpret_cast<const float*>(
                 bk.rows[(reg.chunk + k * reg.step) % n]) + base;
    } else {
      return bk.grads + ((reg.chunk + k * reg.step) % n) * padded + base;
    }
  };
  // Max |value| over the CTA -> sh.cta[par]; arrive on the cluster barrier.
  auto publish = [&](float v, int par) {
    v = warp_max(v);
    if (lane == 0) sh.warp[warp] = v;
    __syncthreads();
    if (warp == 0) {
      v = warp_max(lane < kWarps ? sh.warp[lane] : 0.f);
      if (lane == 0) sh.cta[par] = v;
    }
    cluster_arrive();
  };
  // Exchange e (the maximum published after hop e) of a group: CTA 0 of
  // the cluster writes the cluster's maximum to its slot, and in every CTA
  // warp 0's first G lanes wait for the G slots of exchange e, one each.
  auto group_max = [&](float v, int e) {
    unsigned long long* slot = grp.words + (e & 1) * grp.count;
    if (warp == 0) {
      if (r == 0 && lane == 0)
        st_gpu(slot + grp.member, (static_cast<unsigned long long>(e) << 32) |
                                      __float_as_uint(v));
      float mx = 0.f;
      if (lane < grp.count) {
        unsigned long long w;
        do {
          w = ld_gpu(slot + lane);
        } while (static_cast<int>(w >> 32) != e);
        mx = __uint_as_float(static_cast<unsigned>(w));
      }
      mx = warp_max(mx);
      if (lane == 0) sh.group = mx;
    }
    __syncthreads();
    return sh.group;
  };
  // Wait on the barrier, then every warp reads the C slots of the cluster
  // (and, in a group, the group's maxima of exchange e).
  auto region_scale = [&](int par, int e) {
    cluster_wait();
    float v = 0.f;
    if (lane < C) v = *cluster.map_shared_rank(&sh.cta[par], lane);
    v = warp_max(v);
    if constexpr (GROUP) v = group_max(v, e);
    return scale_of(v);
  };
  // After the walk's last exchange: the group's last CTA to finish it
  // puts the words back to zero for the next launch (a graph replays a
  // launch with the same words).
  auto group_done = [&]() {
    if (GROUP && threadIdx.x == 0) {
      unsigned long long* done = grp.words + 2 * grp.count;
      if (add_gpu(done, 1) == static_cast<unsigned long long>(parts) - 1) {
        for (int j = 0; j < 2 * grp.count; ++j) st_gpu(grp.words + j, 0);
        st_gpu(done, 0);
      }
    }
  };

  // A piece's pointers hold element bk.off at index 0.
  const long long at = PEERS ? base - bk.off : base;
  float* spill = bk.scratch != nullptr ? bk.scratch + at : nullptr;
  float* st = bk.store + at;
  float* pl = bk.pulled != nullptr ? bk.pulled + at : nullptr;
  Batch<V> pre;
  // Hop 1: the first rank's grads; the spilled part stays where it is.
  const float* row1 = row_of(1);
  float amax = sweep<kFirst, false, V>(0, nsm, nullptr, buf, row1, nullptr,
                                       nullptr, 0.f, 0, 0.f, false, pre,
                                       false);
  if (m > nsm)
    amax = fmaxf(amax, sweep<kFirst, true, V>(nsm, m, nullptr, nullptr, row1,
                                              nullptr, nullptr, 0.f, 0, 0.f,
                                              false, pre, false));
  publish(amax, 0);
  for (int k = 2; k <= n; ++k) {
    const float* row = row_of(k);
    const bool owner = k == n;
    if (owner) {
      prefetch<kOwner, V>(row, st, nsm, pre);
    } else {
      prefetch<kHop, V>(row, nullptr, nsm, pre);
    }
    const float scale = region_scale(k & 1, k - 1);
    if (owner && !gather) group_done();
    const float* spill_src = k == 2 ? row1 : spill;
    if (!owner) {
      amax = sweep<kHop, false, V>(0, nsm, buf, buf, row, nullptr, nullptr,
                                   scale, 0, 0.f, false, pre, true);
      if (m > nsm)
        amax = fmaxf(amax, sweep<kHop, true, V>(nsm, m, spill_src, spill, row,
                                                nullptr, nullptr, scale, 0,
                                                0.f, false, pre, false));
    } else {
      amax = sweep<kOwner, false, V>(0, nsm, buf, buf, row, st, nullptr,
                                     scale, handle, lr, !kv_store, pre, true);
      if (m > nsm)
        amax = fmaxf(amax, sweep<kOwner, true, V>(nsm, m, spill_src, spill,
                                                  row, st, nullptr, scale,
                                                  handle, lr, !kv_store, pre,
                                                  false));
    }
    if (!owner || gather) publish(amax, (k + 1) & 1);
  }
  if (gather) {
    const float scale = region_scale((n + 1) & 1, n);
    group_done();
    sweep<kGather, false, V>(0, nsm, buf, nullptr, nullptr, st, pl, scale, 0,
                             0.f, kv_store, pre, false);
    if (m > nsm)
      sweep<kGather, true, V>(nsm, m, spill, nullptr, nullptr, st, pl, scale,
                              0, 0.f, kv_store, pre, false);
  }
}

// The mixed instantiation calls each walk out of line, once per CTA:
// inlined side by side they share one register allocation, and the float4
// walk spilled 160-216 bytes.
template <int V, bool PEERS, bool GROUP>
__device__ __noinline__ void walk_call(const Bucket bk, const Region reg,
                                       const Group grp, int smem_floats,
                                       int handle, float lr, bool gather,
                                       bool kv_store) {
  walk<V, PEERS, GROUP>(bk, reg, grp, smem_floats, handle, lr, gather,
                        kv_store);
}

// G clusters of C CTAs per region row, the G clusters of a row launched
// one after another.  VM: 4 when every bucket of the launch takes float4,
// 1 when none does, 0 when the launch mixes both (each cluster branches on
// its bucket's flag).  ONE: a launch of one bucket, whose fields the
// kernel then reads at fixed offsets of its parameter (constant-bank
// operands, as plain kernel parameters); a table index known only at run
// time makes the compiler hold the bucket's fields in registers, and the
// float4 walk spills (24 bytes; the single int8 rows ran 2-6 % slower).
// GROUP: a region group (G > 1); without it the kernel reads neither
// `groups` nor `xchg`, and compiles as one cluster per region did before
// groups existed (their code in the walk cost the single rows 2-3 %).
template <int VM, bool ONE, bool PEERS, bool GROUP>
__global__ void __launch_bounds__(kThreads, 1)
ring_int8_cluster(const BucketTable table, const Region* __restrict__ regions,
                  int groups, unsigned long long* xchg, int smem_floats,
                  int handle, float lr, bool gather,
                  bool store_takes_pulled) {
  const long long ci = blockIdx.x / cg::this_cluster().num_blocks();
  const long long row = GROUP ? ci / groups : ci;
  const Region reg = regions[row];
  const Group grp{GROUP ? xchg + row * (2 * groups + 1) : nullptr,
                  GROUP ? groups : 1,
                  GROUP ? static_cast<int>(ci - row * groups) : 0};
  const Bucket& bk = table.b[ONE ? 0 : reg.bucket];
  if constexpr (VM == 0) {
    if (bk.vec) {
      walk_call<4, PEERS, GROUP>(bk, reg, grp, smem_floats, handle, lr,
                                 gather, store_takes_pulled);
    } else {
      walk_call<1, PEERS, GROUP>(bk, reg, grp, smem_floats, handle, lr,
                                 gather, store_takes_pulled);
    }
  } else {
    walk<VM, PEERS, GROUP>(bk, reg, grp, smem_floats, handle, lr, gather,
                           store_takes_pulled);
  }
  // No CTA may leave while a peer can still read its slots.
  cluster_arrive();
  cluster_wait();
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Once per instantiation: allow the largest dynamic shared memory and the
// non-portable cluster sizes (outside any stream capture: the first call
// comes before).
template <int VM, bool ONE, bool PEERS, bool GROUP>
cudaError_t prepare() {
  static cudaError_t done = [] {
    cudaError_t e = cudaFuncSetAttribute(
        ring_int8_cluster<VM, ONE, PEERS, GROUP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmemFloats * static_cast<int>(sizeof(float)));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(ring_int8_cluster<VM, ONE, PEERS, GROUP>,
                                cudaFuncAttributeNonPortableClusterSizeAllowed,
                                1);
  }();
  return done;
}

// A launch's configuration: `clusters` clusters of `cluster` CTAs;
// cooperative when asked (a region group).
inline void config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[2],
            long long clusters, int cluster, int smem_floats, bool coop,
            cudaStream_t st) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_floats) * sizeof(float);
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = coop ? 2 : 1;
}

template <int VM, bool ONE, bool PEERS, bool GROUP>
cudaError_t occupancy(int cluster, int smem_floats, int* max_clusters) {
  cudaError_t err = prepare<VM, ONE, PEERS, GROUP>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  config(cfg, attr, 1, cluster, smem_floats, false, nullptr);
  return cudaOccupancyMaxActiveClusters(
      max_clusters, ring_int8_cluster<VM, ONE, PEERS, GROUP>, &cfg);
}

// occupancy(), asked once per (device, cluster size, shared memory).
template <int VM, bool ONE, bool PEERS, bool GROUP>
cudaError_t resident(int cluster, int smem_floats, int* max_clusters) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int>, int> seen;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(dev, cluster, smem_floats);
  std::lock_guard<std::mutex> hold(mu);
  const auto it = seen.find(key);
  if (it != seen.end()) {
    *max_clusters = it->second;
    return cudaSuccess;
  }
  err = occupancy<VM, ONE, PEERS, GROUP>(cluster, smem_floats, max_clusters);
  if (err == cudaSuccess) seen[key] = *max_clusters;
  return err;
}

template <int VM, bool ONE, bool PEERS, bool GROUP>
cudaError_t run(const BucketTable& table, const Region* regions,
                long long nregions, int cluster, int groups,
                unsigned long long* xchg, int smem_floats, int handle,
                float lr, bool gather, bool stp, cudaStream_t st) {
  cudaError_t err = prepare<VM, ONE, PEERS, GROUP>();
  if (err != cudaSuccess) return err;
  if constexpr (GROUP) {
    // The clusters of a group wait for one another: the whole grid must
    // be resident at once.  Checked here against the clusters the card
    // runs at once, because the cooperative launch's own limit is
    // documented per block, not per cluster (132 blocks of 1 CTA an SM,
    // where 16-CTA clusters fill 112), and a grid it let through that
    // did not fit would never finish.
    int fit = 0;
    err = resident<VM, ONE, PEERS, GROUP>(cluster, smem_floats, &fit);
    if (err != cudaSuccess) return err;
    if (nregions * groups > fit) return cudaErrorCooperativeLaunchTooLarge;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  config(cfg, attr, nregions * (GROUP ? groups : 1), cluster, smem_floats,
         GROUP, st);
  err = cudaLaunchKernelEx(&cfg, ring_int8_cluster<VM, ONE, PEERS, GROUP>,
                           table, regions, groups, xchg, smem_floats, handle,
                           lr, gather, stp);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The instantiation of a launch: `mode` 4 (every bucket float4), 1 (none)
// or 0 (mixed), and one bucket or several.
template <typename F>
cudaError_t dispatch(int mode, int count, F&& f) {
  if (count == 1) {
    if (mode == 4) return f(std::integral_constant<int, 4>{}, std::true_type{});
    if (mode == 1) return f(std::integral_constant<int, 1>{}, std::true_type{});
  } else {
    if (mode == 4) return f(std::integral_constant<int, 4>{}, std::false_type{});
    if (mode == 1) return f(std::integral_constant<int, 1>{}, std::false_type{});
    if (mode == 0) return f(std::integral_constant<int, 0>{}, std::false_type{});
  }
  return cudaErrorInvalidValue;
}

// Words per bucket of pstt_ring_int8's and pstt_ring_int8_peers'
// descriptor rows.
constexpr int kDescWords = 7;
constexpr int kPeerDescWords = 9;

// The table of a launch from its descriptor rows (`words` per bucket:
// grads or the row table, store, pulled, scratch, padded, n, vec, and for
// a PEERS launch the piece's first element); the count of float4 buckets,
// or -1 for a refused row.
inline int fill_table(const long long* desc, int count, int words, bool peers,
               BucketTable& table) {
  table.count = count;
  int nvec = 0;
  for (int i = 0; i < count; ++i) {
    const long long* w = desc + static_cast<long long>(words) * i;
    Bucket& b = table.b[i];
    b.grads = peers ? nullptr : reinterpret_cast<const float*>(w[0]);
    b.rows = peers ? reinterpret_cast<const long long*>(w[0]) : nullptr;
    b.store = reinterpret_cast<float*>(w[1]);
    b.pulled = reinterpret_cast<float*>(w[2]);
    b.scratch = reinterpret_cast<float*>(w[3]);
    b.padded = w[4];
    b.n = static_cast<int>(w[5]);
    b.off = peers ? w[7] : 0;
    if (b.padded <= 0 || b.n < 2 || (peers && (b.rows == nullptr || b.off < 0)))
      return -1;
    b.vec = w[6] != 0 && aligned16(b.grads) && aligned16(b.store) &&
            (b.pulled == nullptr || aligned16(b.pulled)) &&
            (b.scratch == nullptr || aligned16(b.scratch)) &&
            b.padded % 4 == 0;
    nvec += b.vec;
  }
  return nvec;
}

inline bool valid_launch(int count, int cluster, int groups, const void* xchg,
                  int smem_floats) {
  return count >= 1 && count <= kMaxGroup && cluster >= 1 && cluster <= 16 &&
         groups >= 1 && groups <= kMaxGroups &&
         (groups == 1 ||
          (xchg != nullptr && reinterpret_cast<uintptr_t>(xchg) % 8 == 0)) &&
         smem_floats >= 4 && smem_floats <= kMaxSmemFloats &&
         smem_floats % 4 == 0;
}

// The launch of `desc`'s buckets (`words` per row; PEERS: pieces across
// processes) over the region rows: GROUP for G > 1.
template <bool PEERS, bool GROUP>
int launch_desc(const long long* desc, int count, const void* regions,
                long long nregions, int cluster, int groups, void* xchg,
                int smem_floats, int handle, float lr, int gather,
                int store_takes_pulled, void* stream) {
  BucketTable table{};
  const int nvec = fill_table(desc, count,
                              PEERS ? kPeerDescWords : kDescWords, PEERS,
                              table);
  if (nvec < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* rg = static_cast<const Region*>(regions);
  auto st = static_cast<cudaStream_t>(stream);
  auto* xw = static_cast<unsigned long long*>(xchg);
  const bool ga = gather != 0, stp = store_takes_pulled != 0;
  const int mode = nvec == table.count ? 4 : (nvec == 0 ? 1 : 0);
  return static_cast<int>(dispatch(mode, table.count, [&](auto vm, auto one) {
    return run<decltype(vm)::value, decltype(one)::value, PEERS, GROUP>(
        table, rg, nregions, cluster, groups, xw, smem_floats, handle, lr, ga,
        stp, st);
  }));
}

// A region group's launch (ring_int8_group.cu, compiled apart so that the
// two sets of instantiations build in parallel); arguments as launch_desc.
int launch_group(bool peers, const long long* desc, int count,
                 const void* regions, long long nregions, int cluster,
                 int groups, void* xchg, int smem_floats, int handle,
                 float lr, int gather, int store_takes_pulled, void* stream);

}  // namespace pstt_int8
