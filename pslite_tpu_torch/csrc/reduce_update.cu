// D1 and D2: the dense engine's reduce programs for Hopper.
//
// Replace the XLA programs of the JAX engine's dense data plane off the ring
// (pslite_tpu/parallel/engine.py): `_program` (:408, the default `xla` impl:
// `_push_pull`/`_push`/`_push_pull_zc` over `_rs_update_ag` :97-109, whose
// `_aggregate` :84 is psum_scatter, or on 2-D the psum over `worker_axis`),
// its group form `_group_program` (:1333, every bucket of a group in one
// program when they are off the ring), and `_stateful_program` (:754, the
// same reduction, then the K1/K2/K3 Pallas pass, then the gather, with the
// store and the state donated).
//
// D1 (modes sum, assign, sgd, none): each thread takes 16 bytes of each of
// the W worker rows at one position and adds them left to right in f32
// (acc = row0; acc += row1; ...: the order of the JAX CPU mesh's
// psum_scatter and of the plain version, ops/reduce_update.py), rounds once
// to the dtype (bf16, f16), applies the handle and writes the store and,
// when asked, the pulled copy (the all-gather: the n shards of a bucket are
// one tensor on this card, so the gather is that copy).  Mode none writes
// the reduction alone into an output, for a callable handle.  It is the
// plain version's arithmetic bit for bit: every add is __fadd_rn; sgd's
// `store.sub_(lr * agg)` is a rounded product, then a subtraction
// (__fmul_rn, __fsub_rn: nvcc's default --fmad=true would fuse them); a
// 2-byte store takes eager PyTorch's steps, each in f32 and rounded to the
// dtype.
//
// D2 (modes sgd_momentum, adagrad, adam; f32 and bf16): the same reduction,
// then the K1/K2/K3 arithmetic of fused_update.cuh on the rounded
// aggregate, writing the store, the state and, when asked, the pulled copy
// in one pass; adam reads alpha_t from a 1-element device tensor (the TPU
// kernel's scalar prefetch).  The bits of the reduction followed by a K1-K3
// launch, since the aggregate and each element's arithmetic are the same.
//
// Bound: HBM bytes.  Per element the W rows are read, the store read and
// written and the pulled copy written: (W+3)*b (a push W+2; assign reads no
// store); D2 reads and writes its state too (adam two tensors: (W+7)*b with
// the pull).  A few flops per row are far below the card's f32 rate.  At the
// 40 x 1 MB bucket (P = 10,240,000 f32, W = 8): D1 push_pull 450.6 MB,
// 134.5 us at 3.35 TB/s; D2 adam 614.4 MB, 183.4 us.
//
// Design: a streaming kernel, one thread per 16 bytes (4 f32, 8 bf16/f16
// values).  Each thread issues the loads of its store and state, then of its
// rows in batches (kBatch: 8 rows for f32, 4 or 2 for 2-byte dtypes), before
// the adds, so it keeps up to 11 16-byte loads in flight.  A launch takes a
// table of segments by value (a kernel parameter, which a captured CUDA
// graph replays as it is): each segment a length, its store, pulled and
// state pointers, and its W rows as a base and a byte stride (a [W, padded]
// tensor) or as W addresses in the table (the peers' rows mapped through
// CUDA IPC, on a group spanning processes).  The engine passes one segment
// for a bucket, one per bucket of a group (one launch), or one per piece a
// process owns.  Blocks find their segment by binary search, as
// ring_group_kernel's do.  A segment whose pointers are all 16-byte aligned
// takes vectors; its ragged tail, and every element of an unaligned segment
// (peer rows at odd offsets), take a scalar path.
//
// Aliasing: a grads row may be the store itself (a stale zero-copy handle
// passed back as grads), so no pointer that may alias is __restrict__, and
// each thread reads every input of its elements before it writes any.
//
// TMA and shared-memory staging are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "fused_update.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSegs = 40;    // segments per launch
constexpr int kMaxAddrs = 128;  // row addresses per launch

enum Mode {
  kSum = 0,
  kAssign = 1,
  kSgd = 2,
  kNone = 3,
  kSgdMomentum = 4,
  kAdagrad = 5,
  kAdam = 6,
};

// Rows loaded before their adds.  An f32 thread takes 8 rows at a time in
// 56-74 registers.  A 2-byte thread holds 8 values of each row, so it takes
// fewer at a time, to keep to 64 registers and 4 blocks of 256 threads a SM
// (its launch bounds): 4 rows for D1, 2 for D2, whose state takes the rest.
// With 8 rows a 2-byte launch ran 2 blocks a SM at 0.55-0.63 of its bound;
// the launch bounds alone spill (tools/reduce_variants.py).
template <typename T, int MODE>
constexpr int kBatch = sizeof(T) == 4 ? 8 : (MODE >= kSgdMomentum ? 2 : 4);
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 1 : 4;

// One segment of a launch.  72 bytes.
struct Seg {
  const char* row0;        // row 0 at the segment's first element
  long long stride;        // bytes from one row to the next
  long long len;           // elements
  long long first_block;   // the launch's first block on this segment
  void* store;             // the store at the first element (mode none: unused)
  void* pulled;            // the pulled copy, or NULL
  void* aux0;              // mode none: the reduction; D2: the state (adam: m)
  void* aux1;              // adam: v
  int addr_at;             // >= 0: the rows are addr[addr_at .. addr_at + rows)
  short rows;              // W
  short vec;               // 1: every pointer 16-byte aligned
};

// The table, passed by value: 8 + 40 * 72 + 128 * 8 = 3,912 bytes, inside
// the 4 KiB of kernel parameters that every CUDA 12 release takes, so no
// copy to the device precedes the launch.  The wrapper splits a longer
// table into launches.
struct Table {
  int nseg;
  Seg seg[kMaxSegs];
  const void* addr[kMaxAddrs];
};
static_assert(sizeof(Seg) == 72, "segment layout");
static_assert(sizeof(Table) <= 4096, "kernel parameter size");

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to T's precision (identity for f32).
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f<T>(from_f<T>(x));
}

template <typename T, int V>
struct alignas(16) Pack {
  T v[V];
};

// The m (<= V) values at p: one 16-byte load, or m scalar loads.
template <typename T, int V, bool VEC>
__device__ __forceinline__ Pack<T, V> load(const T* p, int m) {
  Pack<T, V> r;
  if (VEC) {
    r = *reinterpret_cast<const Pack<T, V>*>(p);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) r.v[e] = e < m ? p[e] : from_f<T>(0.f);
  }
  return r;
}

template <typename T, int V, bool VEC>
__device__ __forceinline__ void store(T* p, const Pack<T, V>& x, int m) {
  if (VEC) {
    *reinterpret_cast<Pack<T, V>*>(p) = x;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (e < m) p[e] = x.v[e];
  }
}

template <typename T>
__device__ __forceinline__ const T* row_at(const Table& t, const Seg& s, int w) {
  if (s.addr_at >= 0) return static_cast<const T*>(t.addr[s.addr_at + w]);
  return reinterpret_cast<const T*>(s.row0 + w * s.stride);
}

// One thread's m values at element i0 of segment s: every input read, then
// the reduction, the handle and the writes.
template <typename T, int V, int MODE, bool VEC>
__device__ __forceinline__ void reduce_apply(const Table& t, const Seg& s,
                                             long long i0, int m,
                                             const float (&p)[5],
                                             float alpha_t) {
  constexpr bool kReadsStore = MODE == kSum || MODE == kSgd || MODE >= kSgdMomentum;
  T* st_p = static_cast<T*>(s.store) + i0;
  T* a0_p = static_cast<T*>(s.aux0) + i0;
  T* a1_p = static_cast<T*>(s.aux1) + i0;
  Pack<T, V> st, a0, a1;
  if (kReadsStore) st = load<T, V, VEC>(st_p, m);
  if (MODE >= kSgdMomentum) a0 = load<T, V, VEC>(a0_p, m);
  if (MODE == kAdam) a1 = load<T, V, VEC>(a1_p, m);

  float acc[V];
  const int W = s.rows;
  constexpr int B = kBatch<T, MODE>;
  for (int w0 = 0; w0 < W; w0 += B) {
    Pack<T, V> x[B];
#pragma unroll
    for (int k = 0; k < B; ++k)
      if (w0 + k < W) x[k] = load<T, V, VEC>(row_at<T>(t, s, w0 + k) + i0, m);
#pragma unroll
    for (int k = 0; k < B; ++k) {
      if (w0 + k >= W) break;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xv = to_f<T>(x[k].v[e]);
        acc[e] = w0 + k == 0 ? xv : __fadd_rn(acc[e], xv);
      }
    }
  }

  Pack<T, V> out;
  if (MODE == kNone) {
#pragma unroll
    for (int e = 0; e < V; ++e) out.v[e] = from_f<T>(acc[e]);
    store<T, V, VEC>(a0_p, out, m);
    return;
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float agg = rnd<T>(acc[e]);  // the reduction, rounded once
    float sv = kReadsStore ? to_f<T>(st.v[e]) : 0.f;
    if (MODE == kSum) {
      sv = __fadd_rn(sv, agg);
    } else if (MODE == kAssign) {
      sv = agg;
    } else if (MODE == kSgd) {
      sv = __fsub_rn(sv, rnd<T>(__fmul_rn(agg, p[0])));
    } else if constexpr (MODE >= kSgdMomentum) {
      float s0 = to_f<T>(a0.v[e]);
      float s1 = MODE == kAdam ? to_f<T>(a1.v[e]) : 0.f;
      if constexpr (std::is_same<T, float>::value) {
        if (MODE == kSgdMomentum) pstt::sgd_f32(sv, s0, agg, p[0], p[1]);
        if (MODE == kAdagrad) pstt::adagrad_f32(sv, s0, agg, p[0], p[1]);
        if (MODE == kAdam)
          pstt::adam_f32(sv, s0, s1, agg, alpha_t, p[0], p[1], p[2], p[3], p[4]);
      } else {
        if (MODE == kSgdMomentum) pstt::sgd_bf16(sv, s0, agg, p[0], p[1]);
        if (MODE == kAdagrad) pstt::adagrad_bf16(sv, s0, agg, p[0], p[1]);
        if (MODE == kAdam)
          pstt::adam_bf16(sv, s0, s1, agg, alpha_t, p[0], p[1], p[2], p[3], p[4]);
      }
      a0.v[e] = from_f<T>(s0);
      if (MODE == kAdam) a1.v[e] = from_f<T>(s1);
    }
    out.v[e] = from_f<T>(sv);
  }
  if (MODE >= kSgdMomentum) store<T, V, VEC>(a0_p, a0, m);
  if (MODE == kAdam) store<T, V, VEC>(a1_p, a1, m);
  store<T, V, VEC>(st_p, out, m);
  if (s.pulled != nullptr) store<T, V, VEC>(static_cast<T*>(s.pulled) + i0, out, m);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
    reduce_kernel(const Table table, float p0, float p1, float p2, float p3,
                  float p4, const float* alpha) {
  // The block's segment: the last one whose first block is <= blockIdx.x.
  const long long blk = blockIdx.x;
  int lo = 0;
  int hi = table.nseg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table.seg[mid].first_block <= blk) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const Seg& s = table.seg[lo];
  constexpr int V = 16 / sizeof(T);
  const long long i0 = ((blk - s.first_block) * kThreads + threadIdx.x) * V;
  if (i0 >= s.len) return;
  const int m = s.len - i0 < V ? static_cast<int>(s.len - i0) : V;
  const float alpha_t = MODE == kAdam ? __ldg(alpha) : 0.f;
  const float p[5] = {p0, p1, p2, p3, p4};
  if (s.vec && m == V) {
    reduce_apply<T, V, MODE, true>(table, s, i0, m, p, alpha_t);
  } else {
    reduce_apply<T, V, MODE, false>(table, s, i0, m, p, alpha_t);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

template <typename T, int MODE>
cudaError_t launch(Table& table, const float* p, const float* alpha,
                   cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  long long blocks = 0;
  for (int i = 0; i < table.nseg; ++i) {
    table.seg[i].first_block = blocks;
    blocks += ((table.seg[i].len + V - 1) / V + kThreads - 1) / kThreads;
  }
  if (blocks == 0) return cudaSuccess;
  if (blocks >= (1ll << 31)) return cudaErrorInvalidValue;
  reduce_kernel<T, MODE><<<static_cast<unsigned int>(blocks), kThreads, 0,
                           stream>>>(table, p[0], p[1], p[2], p[3], p[4], alpha);
  return cudaGetLastError();
}

// D1's modes for every dtype; D2's for f32 and bf16.
template <typename T>
cudaError_t launch_mode(Table& table, int mode, const float* p,
                        const float* alpha, cudaStream_t stream) {
  switch (mode) {
    case kSum: return launch<T, kSum>(table, p, alpha, stream);
    case kAssign: return launch<T, kAssign>(table, p, alpha, stream);
    case kSgd: return launch<T, kSgd>(table, p, alpha, stream);
    case kNone: return launch<T, kNone>(table, p, alpha, stream);
    default: break;
  }
  if constexpr (!std::is_same<T, __half>::value) {
    switch (mode) {
      case kSgdMomentum: return launch<T, kSgdMomentum>(table, p, alpha, stream);
      case kAdagrad: return launch<T, kAdagrad>(table, p, alpha, stream);
      case kAdam: return launch<T, kAdam>(table, p, alpha, stream);
      default: break;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// D1/D2 over `nseg` (<= 40) segments, rows of 9 int64 words: (row 0's
// address, bytes between rows, length, store, pulled or 0, aux0, aux1,
// rows W, index of the first of its W addresses in `addrs` or -1 for the
// base-and-stride rows).  `addrs` holds `naddr` (<= 128) row addresses.
// dtype: 0 f32, 1 bf16, 2 f16; mode: 0 sum, 1 assign, 2 sgd (p0 = lr),
// 3 none (the reduction into aux0), 4 sgd_momentum (p0 = lr, p1 =
// momentum; aux0 the momentum), 5 adagrad (p0 = lr, p1 = eps; aux0 the
// accumulator), 6 adam (p0..p4 = beta1, beta2, 1 - beta1, 1 - beta2, eps;
// aux0 m, aux1 v; alpha_t at `alpha`).  One launch; returns its CUDA error.
int pstt_reduce_update(const long long* segs, int nseg, const long long* addrs,
                       int naddr, int dtype, int mode, float p0, float p1,
                       float p2, float p3, float p4, const void* alpha,
                       void* stream) {
  if (nseg < 0 || nseg > kMaxSegs || naddr < 0 || naddr > kMaxAddrs ||
      mode < kSum || mode > kAdam || dtype < 0 || dtype > 2 ||
      (mode == kAdam && alpha == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Table table{};
  for (int i = 0; i < naddr; ++i)
    table.addr[i] = reinterpret_cast<const void*>(addrs[i]);
  for (int i = 0; i < nseg; ++i) {
    const long long* w = segs + 9ll * i;
    Seg s{};
    s.row0 = reinterpret_cast<const char*>(w[0]);
    s.stride = w[1];
    s.len = w[2];
    s.store = reinterpret_cast<void*>(w[3]);
    s.pulled = reinterpret_cast<void*>(w[4]);
    s.aux0 = reinterpret_cast<void*>(w[5]);
    s.aux1 = reinterpret_cast<void*>(w[6]);
    const long long rows = w[7];
    const long long at = w[8];
    if (s.len < 0 || rows < 1 || rows > 32767 || at < -1 ||
        (at >= 0 && at + rows > naddr) || (at < 0 && s.row0 == nullptr) ||
        (mode != kNone && s.store == nullptr) ||
        ((mode == kNone || mode >= kSgdMomentum) && s.aux0 == nullptr) ||
        (mode == kAdam && s.aux1 == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    if (s.len == 0) continue;
    s.rows = static_cast<short>(rows);
    s.addr_at = static_cast<int>(at);
    bool vec = aligned16(s.store) && aligned16(s.pulled) &&
               aligned16(s.aux0) && aligned16(s.aux1);
    for (long long r = 0; r < rows && vec; ++r)
      vec = aligned16(at >= 0 ? table.addr[at + r] : s.row0 + r * s.stride);
    s.vec = vec ? 1 : 0;
    table.seg[table.nseg++] = s;
  }
  const float p[5] = {p0, p1, p2, p3, p4};
  const auto* al = static_cast<const float*>(alpha);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_mode<float>(table, mode, p, al, st));
    case 1:
      return static_cast<int>(launch_mode<__nv_bfloat16>(table, mode, p, al, st));
    default:
      return static_cast<int>(launch_mode<__half>(table, mode, p, al, st));
  }
}

}  // extern "C"
