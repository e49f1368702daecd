// The int8 wire-compressed ring push_pull / push on one Hopper card: one
// launch per call, each region walked on chip by one thread block cluster.
//
// Replaces the compressed variant of the Pallas TPU ring kernel of
// pslite_tpu/ops/ring_collective.py (_ring_call :389, pallas_call :445, with
// compress=True: quantize_to_send :251-262, dequant_recv :268-271, the
// reduce-scatter :285-297, the owner's sum :307-310, the all-gather
// :343-378), for the 1-D ring and for the (dp, kv) sub-rings of the 2-D data
// plane (the layout of ring_geometry.cuh, as a table of regions).
//
// What the TPU ring computes.  Each half-chunk ("region") of each chunk walks
// the ring as in ring_push_pull.cu, but every hop sends int8 codes with ONE
// absmax scale for the whole region:
//   hop 1 quantizes the first rank's grads of the region;
//   hop k = 2..n-1 dequantizes, adds its own grads, and re-quantizes:
//     v = fmaf(q, scale, g), scale = max(amax(|v| over the region) * (1/127),
//     1e-30), q = clip(rint(v / scale), -127, 127);
//   the owner (hop n) sums fmaf(q, scale, g[c]) and applies the handle to the
//   store at full precision (0 = sum, 1 = assign, 2 = sgd:lr);
//   the all-gather quantizes the updated region ONCE at the owner and every
//   rank, the owner included, gets q * scale as its pulled value.
// On a 1-D ring the store keeps the full-precision value; on the 2-D
// sub-rings the engine keeps the pulled value as the new store
// (pslite_tpu/parallel/engine.py:735-750), so store_takes_pulled writes it
// (once, at the gather).  fmaf and the reciprocal are written out because XLA
// contracts the TPU kernel's `q * scale + g` into one FMA and compiles
// `amax / 127.0` as a multiplication by the f32 reciprocal.
//
// Bound: HBM bandwidth.  The function must read n grads rows and the store and
// write the store and pulled: (n+3)*4*P bytes ((n+2)*4*P for a 1-D push), as
// the uncompressed ring (on one card the int8 payload never crosses a link).
//
// Design.  A hop needs the absmax of its whole region (up to 643,072 values at
// the main path's shapes) before the next hop can quantize, so no thread can
// walk its elements alone.  The TPU keeps the region in VMEM for the whole
// walk; here one thread block CLUSTER of C CTAs (C in 1..16, chosen per
// launch by the wrapper) owns one region (shard b, sub-chunk c, direction
// d of one bucket) and keeps it in shared memory:
//   - the region [start, start + len) (a table row computed once per
//     geometry by ops/ring_collective.py) is cut into C contiguous slices of
//     round4(ceil(len / C)) values, one per CTA;
//   - each CTA keeps the first `smem_floats` values of its slice in dynamic
//     shared memory (at most kMaxSmemFloats = 57,344 f32 = 224 KiB, so one
//     cluster holds C * 57,344 values: 917,504 at C = 16, 57,344 at C = 1);
//     the rest of a longer slice spills to the bucket's `scratch`, a
//     [padded] f32 tensor indexed like the bucket, which the wrapper
//     allocates only for a bucket that spills;
//   - every hop reads one grads row once and updates the partial sums in
//     place; each CTA reduces |v| over its slice and writes it to its own
//     shared slot, and after one cluster barrier every warp reads the C slots
//     of the cluster through distributed shared memory (C = 1: its own
//     slot, behind a barrier of one CTA).  Two slots alternate by hop
//     parity, so one barrier per hop suffices (a slot is rewritten two hops
//     later, after every peer has passed the barrier that follows its read).
//     The barrier is split (arrive, then wait): between the two, each thread
//     issues its first batch of the next hop's loads, which do not depend on
//     the scale;
//   - each thread keeps kUnroll = 8 float4 loads in flight (64 KiB per SM);
//   - the owner hop reads the store; the gather writes pulled (and, 2-D, the
//     store) from the values still on chip.
// The launch reads each grads row, the store and nothing else once and writes
// the store and pulled once: exactly the bound's bytes when nothing spills.
// A spilled value costs 8 more bytes per hop (written and read back).  No
// memsets or atomics; a max does not depend on order, and every element's
// arithmetic is that of the plain version, so the result is bit-exact and
// does not depend on C.  The IEEE division of the quantizer is the costliest
// instruction sequence per value; quant() replaces it by a multiplication by
// the reciprocal wherever that provably rounds to the same integer.
//
// One launch, many buckets.  A launch takes a table of up to 48 buckets
// (pointers, length, rank count, float4 flag) BY VALUE as its parameter, as
// ring_push_pull.cu's grouped kernel does, and a device table of region rows
// (start, len, chunk, step, bucket) that spans all of them: one cluster per
// row.  The single push_pull/push is a launch over a table of one bucket; the
// engine's push_pull_group (the JAX engine's k ring kernels in one program,
// pslite_tpu/parallel/engine.py:1333-1433) puts the regions of every int8
// bucket of the call in one launch (the ResNet-50 trace: 528 regions of 36
// buckets, 128 to 65,536 values each).  The wrapper sorts the rows longest
// first, so the block scheduler hands the short regions to SMs as the long
// walks finish, and caches the table per group geometry on the device.  A
// bucket whose pointers or regions cannot take float4 runs the scalar walk
// inside the same launch (the <0> instantiation branches per cluster); the
// others keep float4.  Bound of a group: (n+3)*4*P bytes over its P values,
// the same as its single launches (the trace at 8 ranks: 1.124 GB, 335.7 us
// at 3.35 TB/s).
//
// Cluster size.  One C per launch.  C = 1 reads no peer's shared memory,
// but holds only 57,344 values of a region on chip; a larger
// C holds more and walks a long region faster, at C times the barriers per
// SM of work.  The wrapper asks cudaOccupancyMaxActiveClusters
// (pstt_ring_int8_occupancy) how many clusters of each size run at once and
// picks the size with the least makespan of the rows' work, in bytes per
// CTA, assigned longest first to that many cluster slots (ring_collective.py
// int8_cost).  -Xptxas -v: the <4> instantiation takes 128 registers a
// thread, all __launch_bounds__(512, 1) allows, so one CTA runs per SM
// whatever its shared memory; the occupancy query sees that too.
//
// What still limits it.  A region's n+1 sweeps are separated by cluster
// barriers, and after each one a CTA has only the loads it issued before the
// barrier in flight: a short region (the trace's are 12K-65K values, a few
// thousand per CTA) spends a large share of its walk there, and one CTA per
// SM walks one region at a time.  The tail of the longest-first assignment
// leaves SMs idle at the end of a launch, and a scalar bucket (odd region
// starts) reads one float per load.  Carrying two regions per CTA, or the
// next region's first loads across the barrier, is what would hide the
// barriers; PERF.md records the measured share of the bound.
//
// Launch: cudaLaunchKernelEx with a cluster dimension; 9-16 CTAs are
// non-portable cluster sizes (cudaFuncAttributeNonPortableClusterSizeAllowed).
// A refused launch returns its error; nothing falls back.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

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
// its length, its rank count, and whether it takes float4 accesses.
// 48 bytes.
struct Bucket {
  const float* grads;  // [n, padded], row w = rank w
  float* store;        // [padded]
  float* pulled;       // [padded] or NULL
  float* scratch;      // [padded] or NULL (a region of it spills)
  long long padded;
  int n;
  int vec;
};

// Buckets per launch.  The table is passed by value as the kernel's
// parameter (8 + 48 * 48 = 2,312 bytes, inside the 4 KiB every CUDA 12
// driver takes), so no copy to the device precedes the launch; longer
// groups take several launches (ops/ring_collective.py INT8_MAX_GROUP).
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
};

// One CTA's part of the walk of one region of one bucket.  Partial sums of
// the slice's first smem_floats values live in `buf` (dynamic shared
// memory), the rest in the bucket's scratch.  A cluster of one CTA (C = 1)
// takes the same path: its barrier is the CTA's, its slot its own.
template <int V>
__device__ __forceinline__ void walk(const Bucket& bk, const Region& reg,
                                     int smem_floats, int handle, float lr,
                                     bool gather, bool kv_store) {
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
  const long long slice = ((reg.len + C - 1) / C + 3) / 4 * 4;
  const long long lo = min(static_cast<long long>(r) * slice, reg.len);
  const long long m = min(lo + slice, reg.len) - lo;  // values in this slice
  const long long nsm = min(m, static_cast<long long>(smem_floats));
  const long long base = reg.start + lo;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  auto row_of = [&](int k) {
    return bk.grads + ((reg.chunk + k * reg.step) % n) * padded + base;
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
  // Wait on the barrier, then every warp reads the C slots of the cluster.
  auto region_scale = [&](int par) {
    cluster_wait();
    float v = 0.f;
    if (lane < C) v = *cluster.map_shared_rank(&sh.cta[par], lane);
    return scale_of(warp_max(v));
  };

  float* spill = bk.scratch != nullptr ? bk.scratch + base : nullptr;
  float* st = bk.store + base;
  float* pl = bk.pulled != nullptr ? bk.pulled + base : nullptr;
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
    const float scale = region_scale(k & 1);
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
    const float scale = region_scale((n + 1) & 1);
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
template <int V>
__device__ __noinline__ void walk_call(const Bucket bk, const Region reg,
                                       int smem_floats, int handle, float lr,
                                       bool gather, bool kv_store) {
  walk<V>(bk, reg, smem_floats, handle, lr, gather, kv_store);
}

// One cluster of C CTAs per region row.  VM: 4 when every bucket of the
// launch takes float4, 1 when none does, 0 when the launch mixes both (each
// cluster branches on its bucket's flag).  ONE: a launch of one bucket,
// whose fields the kernel then reads at fixed offsets of its parameter
// (constant-bank operands, as plain kernel parameters); a table index
// known only at run time makes the compiler hold the bucket's fields in
// registers, and the float4 walk spills (24 bytes; the single int8 rows
// ran 2-6 % slower).
template <int VM, bool ONE>
__global__ void __launch_bounds__(kThreads, 1)
ring_int8_cluster(const BucketTable table, const Region* __restrict__ regions,
                  int smem_floats, int handle, float lr, bool gather,
                  bool store_takes_pulled) {
  const Region reg = regions[blockIdx.x / cg::this_cluster().num_blocks()];
  const Bucket& bk = table.b[ONE ? 0 : reg.bucket];
  if constexpr (VM == 0) {
    if (bk.vec) {
      walk_call<4>(bk, reg, smem_floats, handle, lr, gather,
                   store_takes_pulled);
    } else {
      walk_call<1>(bk, reg, smem_floats, handle, lr, gather,
                   store_takes_pulled);
    }
  } else {
    walk<VM>(bk, reg, smem_floats, handle, lr, gather, store_takes_pulled);
  }
  // No CTA may leave while a peer can still read its slots.
  cluster_arrive();
  cluster_wait();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Once per instantiation: allow the largest dynamic shared memory and the
// non-portable cluster sizes (outside any stream capture: the first call
// comes before).
template <int VM, bool ONE>
cudaError_t prepare() {
  static cudaError_t done = [] {
    cudaError_t e = cudaFuncSetAttribute(
        ring_int8_cluster<VM, ONE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmemFloats * static_cast<int>(sizeof(float)));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(ring_int8_cluster<VM, ONE>,
                                cudaFuncAttributeNonPortableClusterSizeAllowed,
                                1);
  }();
  return done;
}

void config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
            long long nregions, int cluster, int smem_floats,
            cudaStream_t st) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(static_cast<unsigned>(nregions * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_floats) * sizeof(float);
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(cluster);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

template <int VM, bool ONE>
cudaError_t run(const BucketTable& table, const Region* regions,
                long long nregions, int cluster, int smem_floats, int handle,
                float lr, bool gather, bool stp, cudaStream_t st) {
  cudaError_t err = prepare<VM, ONE>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  config(cfg, attr, nregions, cluster, smem_floats, st);
  err = cudaLaunchKernelEx(&cfg, ring_int8_cluster<VM, ONE>, table, regions,
                           smem_floats, handle, lr, gather, stp);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int VM, bool ONE>
cudaError_t occupancy(int cluster, int smem_floats, int* max_clusters) {
  cudaError_t err = prepare<VM, ONE>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  config(cfg, attr, 1, cluster, smem_floats, nullptr);
  return cudaOccupancyMaxActiveClusters(max_clusters,
                                        ring_int8_cluster<VM, ONE>, &cfg);
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

// Words per bucket of pstt_ring_int8's descriptor rows.
constexpr int kDescWords = 7;

}  // namespace

extern "C" {

// One launch over `count` (1..48) buckets.  desc: `count` rows of 7 int64
// words: grads ([n, padded] f32, row w = rank w), store ([padded] f32,
// updated in place), pulled ([padded] f32 or NULL), scratch ([padded] f32
// or NULL; needed when a slice of one of the bucket's regions is longer
// than smem_floats), padded, n (>= 2), and 1 when every region of the
// bucket starts and ends on a multiple of 4 (float4 accesses, taken when
// the pointers are 16-byte aligned too).  regions: nregions rows of int64
// (start, length, chunk, step, bucket), each a contiguous range of its
// bucket, in the order the clusters are launched.  cluster: CTAs per
// region (1..16); smem_floats: partial sums each CTA keeps in shared
// memory (a multiple of 4, at most 57,344).  gather runs the all-gather
// (pulled and/or store_takes_pulled).
int pstt_ring_int8(const long long* desc, int count, const void* regions,
                   long long nregions, int cluster, int smem_floats,
                   int handle, float lr, int gather, int store_takes_pulled,
                   void* stream) {
  if (nregions <= 0) return 0;
  if (count < 1 || count > kMaxGroup || cluster < 1 || cluster > 16 ||
      smem_floats < 4 || smem_floats > kMaxSmemFloats || smem_floats % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  BucketTable table{};
  table.count = count;
  int nvec = 0;
  for (int i = 0; i < count; ++i) {
    const long long* w = desc + static_cast<long long>(kDescWords) * i;
    Bucket& b = table.b[i];
    b.grads = reinterpret_cast<const float*>(w[0]);
    b.store = reinterpret_cast<float*>(w[1]);
    b.pulled = reinterpret_cast<float*>(w[2]);
    b.scratch = reinterpret_cast<float*>(w[3]);
    b.padded = w[4];
    b.n = static_cast<int>(w[5]);
    if (b.padded <= 0 || b.n < 2) return static_cast<int>(cudaErrorInvalidValue);
    b.vec = w[6] != 0 && aligned16(b.grads) && aligned16(b.store) &&
            (b.pulled == nullptr || aligned16(b.pulled)) &&
            (b.scratch == nullptr || aligned16(b.scratch)) &&
            b.padded % 4 == 0;
    nvec += b.vec;
  }
  const auto* rg = static_cast<const Region*>(regions);
  auto st = static_cast<cudaStream_t>(stream);
  const bool ga = gather != 0, stp = store_takes_pulled != 0;
  const int mode = nvec == count ? 4 : (nvec == 0 ? 1 : 0);
  return static_cast<int>(dispatch(mode, count, [&](auto vm, auto one) {
    return run<decltype(vm)::value, decltype(one)::value>(
        table, rg, nregions, cluster, smem_floats, handle, lr, ga, stp, st);
  }));
}

// How many clusters of `cluster` CTAs, each CTA with smem_floats of dynamic
// shared memory, the card can run at once (0: none), for the instantiation
// a launch of `count` buckets in `mode` runs (4: every bucket float4, 1:
// none, 0: mixed).
int pstt_ring_int8_occupancy(int cluster, int smem_floats, int mode,
                             int count, int* max_clusters) {
  *max_clusters = 0;
  if (cluster < 1 || cluster > 16 || smem_floats < 0 ||
      smem_floats > kMaxSmemFloats || count < 1 || count > kMaxGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(mode, count, [&](auto vm, auto one) {
    return occupancy<decltype(vm)::value, decltype(one)::value>(
        cluster, smem_floats, max_clusters);
  }));
}

}  // extern "C"
