// Row kernels of the sparse tables for Hopper: sum push (scatter-add),
// row-wise Adagrad push, and pull (row gather).
//
// Replace the XLA device programs of pslite_tpu/parallel/sparse.py:
// _scatter_rows (:137), _adagrad_sparse (:179) and _pull_rows (:246).  On
// one card the all-gather of every worker's (indices, rows) is the flat
// update list in worker order, and the pull's psum_scatter of one-hot rows
// is a gather.  The table is one [S * rps, dim] allocation; global row r
// lives at flat row (r % S) * rps + r / S, and an index is taken only if
// 0 <= r and r / S < rps (out of range: the push drops it, the pull gives
// zeros).
//
// Order of arithmetic.  XLA's CPU scatter adds the updates one after
// another in list order, rounding to the table's dtype after each add.  The
// push kernels do the same per row, so a sum push equals the JAX package
// bit for bit.  The wrapper computes each update's flat row
// (sparse_keys_kernel) and sorts them stably (torch.sort, the counterpart
// of jnp.argsort).  prepare_kernel then copies the update rows into sorted
// order (as f32, so each run of equal rows is contiguous) and lists the
// runs: up to kLong updates "short", more "long".  long_runs_kernel walks
// each long run with one CTA (one thread per column); beside it (a
// programmatic dependent launch), scatter_short_kernel adds each short run
// with one thread per 4 columns (adagrad_short_kernel: one warp per run).
// Each writes its row back once.
// Explicit _rn intrinsics keep nvcc from contracting what XLA keeps
// separate.  Row-wise Adagrad sums G*G over the row in a fixed order (per
// thread over its columns, a butterfly within each warp, then the warps in
// turn); XLA's reduction order is not reproduced, so it is held to rtol
// 1e-5.
//
// Bound.  Bytes: the push reads the update rows and indices once and reads
// and writes each touched row once (BASELINE config 5, 8 x 4,096 updates of
// dim 64 over 7,645 rows: ~12.4 MB, 3.7 us at 3.35 TB/s).  But a run is one
// dependent chain of f32 adds: the hottest row of config 5 takes 6,028
// updates, 6,028 x 4 cycles = 12.2 us at 1.98 GHz whatever the bytes, so
// the chain, not the bytes, is the floor.  Design against it: a long run's
// rows are contiguous after prepare_kernel, so the whole CTA copies the
// next kStages - 1 stages of them into a shared-memory ring with 16-byte
// cp.async (no registers held, no load for the compiler to sink) while the
// column threads add the current stage, eight shared-memory values read
// ahead of the adds: at dim 64, 7 x 64 rows in flight, one barrier per 64
// rows.  Two earlier designs were measured on the card: a ring of two
// 32-row batches in registers, read through the sort permutation, waited
// on each batch's loads (config 5's push 0.30 ms); each thread streaming
// its own column with 4-byte cp.async issued ~15 instructions per row
// (0.20 ms).  A short run needs no ring: its thread knows the run's
// length from the list, and a quarter of a million such threads cover
// each other's latency.
//
// The pull (gather_rows_kernel) is a copy: 16-byte loads and stores where
// the row's bytes and the pointers allow, narrower otherwise; bound by its
// bytes (config 5: the 7,645 distinct rows read once, 1.96 MB, the indices,
// and 8.4 MB written: 3.1 us).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLong = 32;    // runs of more updates take the staged walk
constexpr int kStages = 4;   // ring slots of a long run's walk
constexpr int kRingBytes = 128 * 1024;  // the ring, per long-run CTA
constexpr int kTile = 256;   // columns of a long run per pass

__device__ __forceinline__ int flat_row(int x, int S, int rps) {
  if (x < 0) return -1;
  const int local = x / S;  // x >= 0: truncation is floor
  if (local >= rps) return -1;
  return (x - local * S) * rps + local;
}

// Arithmetic in the table's dtype: values travel as float; a bf16 table
// rounds to bf16 after each add, as XLA's CPU backend does.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return round(__fadd_rn(a, b));
  }
};

// The flat row of every update (the sentinel S * rps, which sorts last,
// for a dropped one); thread 0 also zeroes the run counters of the push
// that follows (runs may be null).
__global__ void sparse_keys_kernel(const int* __restrict__ idx,
                                   int* __restrict__ keys, int m, int S,
                                   int rps, int* __restrict__ runs) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j == 0 && runs != nullptr) runs[0] = runs[1] = 0;
  if (j >= m) return;
  const int r = flat_row(idx[j], S, rps);
  keys[j] = r < 0 ? S * rps : r;
}

// The run lists: runs[0] = short runs, runs[1] = long runs (zeroed by
// sparse_keys_kernel); short run k as (first position, length, row) at
// runs[2 + 3k ...], long run k's first position at runs[2 + 3m - 1 - k]
// (each list in no particular order).
__device__ __forceinline__ int3 short_run(const int* runs, int k) {
  const int* e = runs + 2 + 3 * k;
  return make_int3(e[0], e[1], e[2]);
}
__device__ __forceinline__ int long_run(const int* runs, int m, int k) {
  return runs[2 + 3 * m - 1 - k];
}

// Four consecutive values of an update row as floats: one 16-byte (f32)
// or 8-byte (bf16) load when `vec` (rows of a multiple of 4 values from an
// aligned base), else one load each.
__device__ __forceinline__ void load4(const float* p, int n, bool vec,
                                      float (&v)[4]) {
  if (vec) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = e < n ? p[e] : 0.f;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, int n, bool vec,
                                      float (&v)[4]) {
  if (vec) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    v[0] = __low2float(lo); v[1] = __high2float(lo);
    v[2] = __low2float(hi); v[3] = __high2float(hi);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = e < n ? __bfloat162float(p[e]) : 0.f;
}

// The update rows in sorted order (as f32: exact for bf16 tables; rows ld =
// dim rounded up to 4 floats apart, so each starts 16-byte aligned for the
// bulk copies), and the run lists.  One thread per 4 columns of a taken
// update (a warp reads whole rows); the thread of a run's first position
// and columns 0-3 lists the run, a short one with its length (a binary
// search over the next kLong positions).
template <typename T>
__global__ void prepare_kernel(const T* __restrict__ rows,
                               const int* __restrict__ skeys,
                               const long long* __restrict__ perm,
                               float* __restrict__ srows,
                               int* __restrict__ runs, int m, int dim,
                               int ld, int nrows, bool vec) {
  const int quads = ld / 4;
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= static_cast<long long>(m) * quads) return;
  const int j = static_cast<int>(t / quads);
  const int c0 = static_cast<int>(t - static_cast<long long>(j) * quads) * 4;
  const int k = skeys[j];
  if (k >= nrows) return;  // dropped updates sort last
  float v[4];
  load4(rows + perm[j] * dim + c0, min(4, dim - c0), vec, v);
  *reinterpret_cast<float4*>(srows + static_cast<long long>(j) * ld + c0) =
      make_float4(v[0], v[1], v[2], v[3]);
  if (c0 != 0 || (j > 0 && skeys[j - 1] == k)) return;
  if (j + kLong < m && skeys[j + kLong] == k) {
    runs[2 + 3 * m - 1 - atomicAdd(runs + 1, 1)] = j;
    return;
  }
  int lo = j + 1, hi = min(m, j + kLong);  // the end lies in [lo, hi]
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (skeys[mid] == k) lo = mid + 1; else hi = mid;
  }
  int* e = runs + 2 + 3 * atomicAdd(runs, 1);
  e[0] = j;
  e[1] = lo - j;
  e[2] = k;
}

// Length of the run starting at position i of the sorted keys, found by the
// whole warp: 32 probes per round, first at strides 1, 32, 1024, ... until
// one lands past the run, then narrowing the bracket 32-fold per round.
// (key == k is true exactly on [i, i + len): the keys are sorted.)  The hot
// run of config 5 takes five rounds.
__device__ int run_length(const int* __restrict__ skeys, int i, int m) {
  const int lane = threadIdx.x & 31;
  const int k = skeys[i];
  long long a = i + 1;  // skeys[a - 1] == k
  long long b;          // first position past the run (or m)
  for (long long s = 1;; s *= 32) {
    const long long p = a + lane * s;
    const int t = __popc(__ballot_sync(kFull, p < m && skeys[p] == k));
    if (t < 32) {
      b = a + t * s;
      if (t > 0) a += (t - 1) * s + 1;
      break;
    }
    a += 31 * s + 1;
  }
  if (b > m) b = m;
  while (b > a) {
    const long long s = (b - a + 31) / 32;
    const long long p = a + lane * s;
    const int t = __popc(__ballot_sync(kFull, p < b && skeys[p] == k));
    const long long out = a + t * s;
    if (out < b) b = out;
    if (t > 0) a += (t - 1) * s + 1;
  }
  return static_cast<int>(a - i);
}

// -- long runs: one CTA each ----------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count));
}

// Arrive on `bar` and expect `bytes` more of bulk-copy completion.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni DONE;\nbra.uni WAIT;\nDONE:\n}" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One bulk copy (the Tensor Memory Accelerator) of `bytes` (a multiple of
// 16, both addresses 16-byte aligned) into shared memory, completing on
// `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The rows of one ring slot (stride ldt) added to x in order, eight at a
// time: eight loads, then eight adds.
template <typename T>
__device__ __forceinline__ float add_slot(float x,
                                          const float* __restrict__ slot,
                                          int cnt, int ldt) {
  int r0 = 0;
  for (; r0 + 8 <= cnt; r0 += 8) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = slot[(r0 + i) * ldt];
#pragma unroll
    for (int i = 0; i < 8; ++i) x = Elem<T>::add(x, v[i]);
  }
  for (; r0 < cnt; ++r0) x = Elem<T>::add(x, slot[r0 * ldt]);
  return x;
}

// The long runs: one CTA per run.  Warps 0..cw-1 add (one thread per
// column of a tile of up to kTile columns); warp cw produces: each stage,
// rb rows of the tile are bulk-copied (one copy when the tile is the whole
// padded row, else one per row) into ring slot it % kStages, `full[slot]`
// completing on their bytes; the consumers release the slot on
// `empty[slot]`.  `it` counts stages over every tile and run the CTA takes,
// so producer and consumers agree on slots and phases.  Dynamic shared
// memory: the ring (kStages * rb * ldt floats, ldt = the tile's padded
// width), then for row-wise Adagrad the run's G (dim floats).
template <typename T, bool ADAGRAD>
__global__ void long_runs_kernel(T* __restrict__ store, float* __restrict__ acc,
                                 const float* __restrict__ srows,
                                 const int* __restrict__ skeys,
                                 const int* __restrict__ runs, int m, int dim,
                                 int ld, int rb, float lr, float eps) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) unsigned long long full[kStages], empty[kStages];
  __shared__ float s_part[kTile / 32];
  const int cw = (min(dim, kTile) + 31) / 32;  // consumer warps
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ldt0 = (min(dim, kTile) + 3) & ~3;
  float* ring = smem;
  float* s_g = smem + kStages * rb * ldt0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], cw);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // The short runs' kernel, launched next, may start beside this one: it
  // touches other rows, and waits for this grid before it completes.
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int nruns = runs[1];
  unsigned it = 0;  // stages so far
  for (int h = blockIdx.x; h < nruns; h += gridDim.x) {
    const int start = long_run(runs, m, h);
    const int row = skeys[start];
    const int len = run_length(skeys, start, m);
    const int nb = (len + rb - 1) / rb;
    float sq = 0.f;
    for (int c0 = 0; c0 < dim; c0 += kTile) {
      const int tw = min(kTile, dim - c0);
      const int ldt = (tw + 3) & ~3;
      const float* src = srows + static_cast<long long>(start) * ld + c0;
      if (warp == cw) {  // the producer
        for (int b = 0; b < nb; ++b, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
          const int cnt = min(rb, len - b * rb);
          const float* g = src + static_cast<long long>(b) * rb * ld;
          float* slot = ring + s * rb * ldt;
          if (ldt == ld) {  // the stage is one contiguous block
            if (lane == 0) {
              mbar_expect(&full[s], cnt * ld * 4);
              bulk_copy(slot, g, cnt * ld * 4, &full[s]);
            }
          } else {
            if (lane == 0) mbar_expect(&full[s], cnt * ldt * 4);
            __syncwarp();
            for (int r = lane; r < cnt; r += 32)
              bulk_copy(slot + r * ldt, g + static_cast<long long>(r) * ld,
                        ldt * 4, &full[s]);
          }
          __syncwarp();
        }
      } else if (warp < cw) {  // the consumers
        const bool mine = static_cast<int>(threadIdx.x) < tw;
        T* dst = store + static_cast<long long>(row) * dim + c0 + threadIdx.x;
        float x = (!ADAGRAD && mine) ? Elem<T>::load(dst) : 0.f;
        for (int b = 0; b < nb; ++b, ++it) {
          const int s = it % kStages;
          mbar_wait(&full[s], (it / kStages) & 1);
          if (mine)
            x = add_slot<T>(x, ring + s * rb * ldt + threadIdx.x,
                            min(rb, len - b * rb), ldt);
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[s]);
        }
        if (mine) {
          if (ADAGRAD) {
            s_g[c0 + threadIdx.x] = x;
            sq = __fadd_rn(sq, __fmul_rn(x, x));
          } else {
            Elem<T>::store(dst, x);
          }
        }
      } else {
        it += nb;
      }
    }
    if (!ADAGRAD) continue;
    // All warps: the row's sum of squares in a fixed order, then the step.
    const float acc0 = acc[row];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sq = __fadd_rn(sq, __shfl_xor_sync(kFull, sq, o));
    if (lane == 0 && warp < cw) s_part[warp] = sq;
    __syncthreads();
    float total = s_part[0];
    for (int w = 1; w < cw; ++w) total = __fadd_rn(total, s_part[w]);
    const float a =
        __fadd_rn(acc0, __fdiv_rn(total, static_cast<float>(dim)));
    const float denom = __fadd_rn(__fsqrt_rn(a), eps);
    for (int c = threadIdx.x; c < dim; c += blockDim.x) {
      const float stp =
          Elem<T>::round(__fdiv_rn(__fmul_rn(lr, s_g[c]), denom));
      T* dst = store + static_cast<long long>(row) * dim + c;
      Elem<T>::store(dst, __fsub_rn(Elem<T>::load(dst), stp));
    }
    if (threadIdx.x == 0) acc[row] = a;
    __syncthreads();  // s_part and s_g are free for the next run
  }
}

// -- short runs -------------------------------------------------------------------

// Sum push of the short runs: one thread per (run, 4 columns), four
// in-order chains side by side.
template <typename T>
__global__ void scatter_short_kernel(T* __restrict__ store,
                                     const float* __restrict__ srows,
                                     const int* __restrict__ runs, int dim,
                                     int ld) {
  const int quads = (dim + 3) / 4;
  const long long work = static_cast<long long>(runs[0]) * quads;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       t < work; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int h = static_cast<int>(t / quads);
    const int c0 = static_cast<int>(t - static_cast<long long>(h) * quads) * 4;
    const int3 run = short_run(runs, h);  // (start, len, row)
    const int n = min(4, dim - c0);
    T* dst = store + static_cast<long long>(run.z) * dim + c0;
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = e < n ? Elem<T>::load(dst + e) : 0.f;
    const float* src = srows + static_cast<long long>(run.x) * ld + c0;
    for (int r = 0; r < run.y; ++r) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e < n)
          x[e] = Elem<T>::add(x[e], src[static_cast<long long>(r) * ld + e]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) Elem<T>::store(dst + e, x[e]);
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the long runs' grid
}

// Row-wise Adagrad of the short runs: one warp per run, lanes over columns
// in chunks of 32.  Pass 1 sums each column of G (from zero, in list
// order) and the squares; pass 2 sums G again, the same way, and steps the
// row.
template <typename T>
__global__ void adagrad_short_kernel(T* __restrict__ store,
                                     float* __restrict__ acc,
                                     const float* __restrict__ srows,
                                     const int* __restrict__ runs, int dim,
                                     int ld, float lr, float eps) {
  const int lane = threadIdx.x & 31;
  const int nruns = runs[0];
  const int step = gridDim.x * (blockDim.x >> 5);
  for (int h = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       h < nruns; h += step) {
    const int3 run = short_run(runs, h);  // (start, len, row)
    const float* src = srows + static_cast<long long>(run.x) * ld;
    float sq = 0.f;
    for (int c = lane; c - lane < dim; c += 32) {
      float g = 0.f;
      if (c < dim)
        for (int r = 0; r < run.y; ++r)
          g = Elem<T>::add(g, src[static_cast<long long>(r) * ld + c]);
      if (c < dim) sq = __fadd_rn(sq, __fmul_rn(g, g));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sq = __fadd_rn(sq, __shfl_xor_sync(kFull, sq, o));
    const float total = __shfl_sync(kFull, sq, 0);  // lane 0's order
    const float a =
        __fadd_rn(acc[run.z], __fdiv_rn(total, static_cast<float>(dim)));
    const float denom = __fadd_rn(__fsqrt_rn(a), eps);
    for (int c = lane; c < dim; c += 32) {
      float g = 0.f;
      for (int r = 0; r < run.y; ++r)
        g = Elem<T>::add(g, src[static_cast<long long>(r) * ld + c]);
      const float stp = Elem<T>::round(__fdiv_rn(__fmul_rn(lr, g), denom));
      T* dst = store + static_cast<long long>(run.z) * dim + c;
      Elem<T>::store(dst, __fsub_rn(Elem<T>::load(dst), stp));
    }
    __syncwarp();  // every lane has read acc[row]
    if (lane == 0) acc[run.z] = a;
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the long runs' grid
}

template <typename V>
__global__ void gather_rows_kernel(const V* __restrict__ store,
                                   const int* __restrict__ idx,
                                   V* __restrict__ out, long long m, int vpr,
                                   int S, int rps) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= m * vpr) return;
  const long long j = t / vpr;
  const int v = static_cast<int>(t - j * vpr);
  const int r = flat_row(idx[j], S, rps);
  out[t] = r >= 0 ? store[static_cast<long long>(r) * vpr + v] : V();
}

bool aligned(const void* p, unsigned long long n) {
  return (reinterpret_cast<unsigned long long>(p) % n) == 0;
}

unsigned int blocks_of(long long n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}

// CTAs a kernel keeps resident on the card: asked of the occupancy API
// once per kernel, block size, shared memory and device, then kept.  A
// kernel's dynamic shared memory limit is raised to the largest size it has
// been launched with (never lowered).  Pushes may launch from several host
// threads at once (ctypes drops the interpreter lock), hence the mutex.
struct Resident {
  const void* kernel;
  int device, threads;
  size_t smem;
  long long blocks;
};
Resident g_resident[64];
int g_nresident = 0;
std::mutex g_resident_mu;

template <typename K>
long long resident_blocks(K kernel, int threads, size_t smem) {
  std::lock_guard<std::mutex> hold(g_resident_mu);
  int dev = 0;
  cudaGetDevice(&dev);
  const void* key = reinterpret_cast<const void*>(kernel);
  size_t allowed = 48 * 1024;
  for (int i = 0; i < g_nresident; ++i) {
    const Resident& r = g_resident[i];
    if (r.kernel != key || r.device != dev) continue;
    if (r.smem == smem && r.threads == threads) return r.blocks;
    if (r.smem > allowed) allowed = r.smem;
  }
  if (smem > allowed)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  const long long n = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (g_nresident < 64)
    g_resident[g_nresident++] = {key, dev, threads, smem, n};
  return n;
}

unsigned int grid_of(long long resident, long long most) {
  return static_cast<unsigned int>(resident < most ? resident : most);
}

template <typename T>
int launch_push(void* store, void* acc, const void* rows, const void* skeys,
                const void* perm, void* srows, void* runs, long long m,
                int dim, int nrows, bool adagrad, float lr, float eps,
                cudaStream_t st) {
  auto* k = static_cast<const int*>(skeys);
  auto* r = static_cast<int*>(runs);
  auto* sr = static_cast<float*>(srows);
  auto* s = static_cast<T*>(store);
  auto* a = static_cast<float*>(acc);
  const int mi = static_cast<int>(m);
  const int ld = (dim + 3) & ~3;
  const bool vec = ld == dim && aligned(rows, 4 * sizeof(T));
  prepare_kernel<T><<<blocks_of(m * (ld / 4), 256), 256, 0, st>>>(
      static_cast<const T*>(rows), k, static_cast<const long long*>(perm), sr,
      r, mi, dim, ld, nrows, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // The long runs first: the hottest row's walk is the longest piece.
  const int tw = min(dim, kTile);
  const int ldt = (tw + 3) & ~3;
  const int rb = kRingBytes / (kStages * ldt * static_cast<int>(sizeof(float)));
  const int threads = ((tw + 31) / 32 + 1) * 32;
  const size_t smem = static_cast<size_t>(kStages) * rb * ldt * sizeof(float) +
                      (adagrad ? static_cast<size_t>(dim) * sizeof(float) : 0);
  auto lk = adagrad ? long_runs_kernel<T, true> : long_runs_kernel<T, false>;
  lk<<<grid_of(resident_blocks(lk, threads, smem), m / (kLong + 1) + 1),
       threads, smem, st>>>(s, a, sr, k, r, mi, dim, ld, rb, lr, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // The short runs beside the long ones: a programmatic dependent launch
  // starts once every long-run CTA has begun.
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute beside;
  beside.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  beside.val.programmaticStreamSerializationAllowed = 1;
  cfg.blockDim = dim3(256);
  cfg.stream = st;
  cfg.attrs = &beside;
  cfg.numAttrs = 1;
  if (adagrad) {
    auto sk = adagrad_short_kernel<T>;
    cfg.gridDim = dim3(grid_of(resident_blocks(sk, 256, 0), (m + 7) / 8));
    err = cudaLaunchKernelEx(&cfg, sk, s, a, static_cast<const float*>(sr),
                             static_cast<const int*>(r), dim, ld, lr, eps);
  } else {
    auto sk = scatter_short_kernel<T>;
    const long long work = m * ((dim + 3) / 4);
    cfg.gridDim =
        dim3(grid_of(resident_blocks(sk, 256, 0), (work + 255) / 256));
    err = cudaLaunchKernelEx(&cfg, sk, s, static_cast<const float*>(sr),
                             static_cast<const int*>(r), dim, ld);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int launch_gather(const void* store, const void* idx, void* out, long long m,
                  int row_bytes, int S, int rps, cudaStream_t st) {
  const int vpr = row_bytes / static_cast<int>(sizeof(V));
  gather_rows_kernel<V><<<blocks_of(m * vpr, 256), 256, 0, st>>>(
      static_cast<const V*>(store), static_cast<const int*>(idx),
      static_cast<V*>(out), m, vpr, S, rps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pstt_sparse_keys(const void* idx, void* keys, long long m, int S, int rps,
                     void* runs, void* stream) {
  if (m <= 0) return 0;
  sparse_keys_kernel<<<blocks_of(m, 256), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<int*>(keys),
      static_cast<int>(m), S, rps, static_cast<int*>(runs));
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 float32, 1 bfloat16.  srows: m x ((dim + 3) & ~3) floats of
// scratch; runs: 3m + 2 ints, counters zeroed by pstt_sparse_keys.
int pstt_sparse_scatter_add(void* store, const void* rows, const void* skeys,
                            const void* perm, void* srows, void* runs,
                            long long m, int dim, int nrows, int dtype,
                            void* stream) {
  if (m <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_push<__nv_bfloat16>(store, nullptr, rows, skeys, perm,
                                      srows, runs, m, dim, nrows, false, 0.f,
                                      0.f, st);
  return launch_push<float>(store, nullptr, rows, skeys, perm, srows, runs, m,
                            dim, nrows, false, 0.f, 0.f, st);
}

int pstt_sparse_row_adagrad(void* store, void* acc, const void* rows,
                            const void* skeys, const void* perm, void* srows,
                            void* runs, long long m, int dim, int nrows,
                            float lr, float eps, int dtype, void* stream) {
  if (m <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_push<__nv_bfloat16>(store, acc, rows, skeys, perm, srows,
                                      runs, m, dim, nrows, true, lr, eps, st);
  return launch_push<float>(store, acc, rows, skeys, perm, srows, runs, m,
                            dim, nrows, true, lr, eps, st);
}

int pstt_sparse_gather_rows(const void* store, const void* idx, void* out,
                            long long m, int row_bytes, int S, int rps,
                            void* stream) {
  if (m <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  for (int w = 16; w >= 2; w >>= 1) {
    if (row_bytes % w || !aligned(store, w) || !aligned(out, w)) continue;
    if (w == 16)
      return launch_gather<uint4>(store, idx, out, m, row_bytes, S, rps, st);
    if (w == 8)
      return launch_gather<uint2>(store, idx, out, m, row_bytes, S, rps, st);
    if (w == 4)
      return launch_gather<unsigned int>(store, idx, out, m, row_bytes, S,
                                         rps, st);
    return launch_gather<unsigned short>(store, idx, out, m, row_bytes, S,
                                         rps, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);  // rows of odd bytes
}

}  // extern "C"
