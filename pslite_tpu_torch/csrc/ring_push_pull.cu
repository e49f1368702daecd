// Fused ring push_pull / push for n virtual ranks on one Hopper card.
//
// Replaces the Pallas TPU kernel of pslite_tpu/ops/ring_collective.py
// (_ring_call :389, pallas_call :445, body _kernel_body :98-386), reached by
// ring_push_pull (:468, with the all-gather) and ring_push (:497, without).
// The TPU kernel runs one bidirectional ring per device: a reduce-scatter over
// n-1 hops, the elementwise server handle on the owned chunk, then an
// all-gather over n-1 hops, with remote DMAs and credit semaphores between
// neighbours.  On one card every rank's grads row is already in the same
// device memory, so the hops need no messages: each output element is
// computed directly by one thread.
//
// What must match the TPU kernel is the ORDER of addition, which fixes the
// bits.  Chunk c (elements [c*chunk0, (c+1)*chunk0)) is split at `split`
// (half the tile-padded chunk, ring_chunk_len, when bidirectional): the first
// part travels direction 0 and sums ranks c+1, c+2, ..., c+n-1, c (mod n)
// left to right; the second travels direction 1 and sums c-1, c-2, ..., c.
// Each hop rounds to the working dtype (f32 arithmetic, rounded with
// __float2bfloat16_rn / __float2half_rn for 2-byte types), exactly as each
// hop of the TPU ring stores its partial sum in the dtype.  The handle then
// updates the store in place (0 = sum, 1 = assign, 2 = sgd:lr) and, for
// push_pull, the updated value is written to `pulled` (the all-gather).
//
// The (dp, kv) sub-rings of the 2-D data plane (pslite_tpu/parallel/
// engine.py:713-752, the kernel's `mesh_axes`, :160-175) use the same kernel:
// the grads rows are the A worker ranks, every kv shard runs its own A-rank
// ring over sub-chunks of `ksub` elements, and the padding sits at the end of
// each shard (ring_geometry.cuh).  The TPU runs the B sub-rings in one launch;
// here one launch covers all of them too.  The 1-D ring is the KV = false
// instantiation, which skips the shard division.
//
// Bound: HBM bandwidth.  Per element it reads n grads and the store and
// writes the store and (push_pull) pulled: (n+3)*P*bytes, (n+2)*P*bytes for
// push.  Design: one thread per 16-byte vector of outputs; the vector path
// needs the shard, chunk and split lengths to be multiples of the vector
// width (so a vector never straddles a boundary) and 16-byte aligned
// pointers, otherwise a scalar instantiation runs.  Neighbouring threads read
// neighbouring addresses of each rank row, so every row streams coalesced.
//
// Grouped launch (pstt_ring_group, ring_group_kernel): the counterpart of
// the JAX engine's push_pull_group program (pslite_tpu/parallel/engine.py:
// 1333-1433), which dispatches k ring kernels as one program.  Here one
// launch walks a table of up to 48 buckets of one dtype (the
// multi_tensor_apply pattern): each bucket's descriptor holds its pointers,
// its geometry, whether it takes vectors, and its first block; a block finds
// its bucket by binary search over the first blocks.  The table travels by
// value as the kernel's parameter, so nothing is copied to the device before
// the launch.  Every element runs the same ring_vector as the single launch,
// so a grouped bucket is bit-identical to its own pstt_ring_push_pull.
// A bucket that cannot take vectors (misaligned pointers, a geometry whose
// boundaries cut a vector) takes the scalar path inside the same launch.
// Bound: the same bytes as the k single launches, (n+3)*P*bytes for P
// elements over all buckets (the ResNet-50 trace, 8 ranks, f32: 1.124 GB,
// 335.7 us at 3.35 TB/s); what it saves is k-1 launches and their host cost.
// No PyTorch call walks a ring, so it has no library yardstick.  Faster
// later: buckets far below one wave (1,024 values) leave their SMs idle
// at the end of the launch; a persistent grid-stride form would keep every
// SM streaming across the bucket boundaries.
//
// Replay (pstt_ring_replay): T launches of ring_kernel from one C call, one
// per step of engine.replay; a persistent T-step kernel that keeps the store
// in registers between steps is later work.
//
// Later slice: ranks on several cards, where the TPU kernel's peer slots and
// credits become stores into NVLink peer pointers plus release/acquire flags.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "ring_geometry.cuh"

namespace {

constexpr int kThreads = 256;

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

// Round an f32 value to T's precision (identity for f32).
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f<T>(from_f<T>(x));
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// One thread's V consecutive outputs at element i0: the ring walk, the
// handle, the store and pulled writes.  Shared by ring_kernel and
// ring_group_kernel, so a bucket of a group gets the bits of its own launch.
template <typename T, int V, bool KV>
__device__ __forceinline__ void ring_vector(const T* __restrict__ grads,
                                            T* __restrict__ store,
                                            T* __restrict__ pulled,
                                            const RingGeo& geo,
                                            long long padded, long long i0,
                                            int handle, float lr) {
  const int n = geo.n;
  const RingPos pos = ring_pos<KV>(geo, i0);
  // Direction 0 walks c+1, c+2, ...; direction 1 walks c-1, c-2, ...
  const int step = pos.step;
  int r = ring_rank(pos, 1, n);

  float acc[V];
  {
    const Pack<T, V> g = *reinterpret_cast<const Pack<T, V>*>(grads + r * padded + i0);
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = to_f<T>(g.v[e]);
  }
  for (int k = 2; k <= n; ++k) {
    r += step;
    if (r >= n) r -= n;
    const Pack<T, V> g = *reinterpret_cast<const Pack<T, V>*>(grads + r * padded + i0);
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = rnd<T>(acc[e] + to_f<T>(g.v[e]));
  }

  Pack<T, V> s = *reinterpret_cast<const Pack<T, V>*>(store + i0);
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float sv = to_f<T>(s.v[e]);
    float out;
    if (handle == 0) {
      out = sv + acc[e];
    } else if (handle == 1) {
      out = acc[e];
    } else {
      out = sv - rnd<T>(lr * acc[e]);
    }
    s.v[e] = from_f<T>(out);
  }
  *reinterpret_cast<Pack<T, V>*>(store + i0) = s;
  if (pulled != nullptr) *reinterpret_cast<Pack<T, V>*>(pulled + i0) = s;
}

template <typename T, int V, bool KV>
__global__ void ring_kernel(const T* __restrict__ grads, T* __restrict__ store,
                            T* __restrict__ pulled, RingGeo geo,
                            long long padded, long long nvec, int handle,
                            float lr) {
  const long long vi = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (vi >= nvec) return;
  ring_vector<T, V, KV>(grads, store, pulled, geo, padded, vi * V, handle, lr);
}

// One bucket of a grouped launch (pstt_ring_group).  80 bytes.
struct GroupBucket {
  const void* grads;
  void* store;
  void* pulled;
  long long padded;
  long long period;
  long long sub;
  long long split;
  long long first_block;  // the launch's first block on this bucket
  int n;
  int kv;   // 1: kv shards of `period` (the 2-D sub-rings)
  int vec;  // 1: 16-byte vectors; 0: one element per thread
  int unused;
};

// Buckets per launch.  The table is passed by value as a kernel parameter:
// 8 + 48 * 80 = 3,848 bytes, inside the 4 KiB that every CUDA 12 driver
// takes, so no copy to the device precedes the launch.  Longer groups
// take several launches.
constexpr int kMaxGroup = 48;

struct GroupTable {
  int count;
  GroupBucket b[kMaxGroup];
};

template <typename T>
__global__ void ring_group_kernel(const GroupTable table, int handle, float lr) {
  // The block's bucket: the last one whose first block is <= blockIdx.x.
  const long long blk = blockIdx.x;
  int lo = 0;
  int hi = table.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table.b[mid].first_block <= blk) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const GroupBucket& d = table.b[lo];
  const RingGeo geo{d.period, d.sub, d.split, d.n};
  const long long padded = d.padded;
  const long long vi = (blk - d.first_block) * blockDim.x + threadIdx.x;
  const auto* g = static_cast<const T*>(d.grads);
  auto* s = static_cast<T*>(d.store);
  auto* p = static_cast<T*>(d.pulled);
  constexpr int V = 16 / sizeof(T);
  if (d.vec) {
    if (vi >= padded / V) return;
    if (d.kv) {
      ring_vector<T, V, true>(g, s, p, geo, padded, vi * V, handle, lr);
    } else {
      ring_vector<T, V, false>(g, s, p, geo, padded, vi * V, handle, lr);
    }
  } else {
    if (vi >= padded) return;
    if (d.kv) {
      ring_vector<T, 1, true>(g, s, p, geo, padded, vi, handle, lr);
    } else {
      ring_vector<T, 1, false>(g, s, p, geo, padded, vi, handle, lr);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

template <typename T, int V>
void launch_geo(const T* g, T* s, T* p, const RingGeo& geo, bool kv,
                long long padded, int handle, float lr, cudaStream_t stream) {
  const long long nvec = padded / V;
  const auto blocks = static_cast<unsigned int>((nvec + kThreads - 1) / kThreads);
  if (kv) {
    ring_kernel<T, V, true><<<blocks, kThreads, 0, stream>>>(
        g, s, p, geo, padded, nvec, handle, lr);
  } else {
    ring_kernel<T, V, false><<<blocks, kThreads, 0, stream>>>(
        g, s, p, geo, padded, nvec, handle, lr);
  }
}

// Whether a bucket takes 16-byte vectors: a vector never straddles a shard,
// chunk or direction boundary, and every pointer is 16-byte aligned.
template <typename T>
bool use_vectors(const void* grads, const void* store, const void* pulled,
                 const RingGeo& geo, bool kv) {
  constexpr int V = 16 / sizeof(T);
  return (!kv || geo.period % V == 0) && geo.sub % V == 0 &&
         (geo.split >= geo.sub || geo.split % V == 0) && aligned16(grads) &&
         aligned16(store) && (pulled == nullptr || aligned16(pulled));
}

template <typename T>
cudaError_t launch(const void* grads, void* store, void* pulled,
                   const RingGeo& geo, bool kv, long long padded, int handle,
                   float lr, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const auto* g = static_cast<const T*>(grads);
  auto* s = static_cast<T*>(store);
  auto* p = static_cast<T*>(pulled);
  if (use_vectors<T>(grads, store, pulled, geo, kv)) {
    launch_geo<T, V>(g, s, p, geo, kv, padded, handle, lr, stream);
  } else {
    launch_geo<T, 1>(g, s, p, geo, kv, padded, handle, lr, stream);
  }
  return cudaGetLastError();
}

bool valid_geo(int n, long long period, long long sub, long long padded) {
  return n >= 1 && period > 0 && sub > 0 && padded % period == 0;
}

// kDescWords int64 words per bucket of pstt_ring_group's table.
constexpr int kDescWords = 9;

template <typename T>
cudaError_t launch_group(const long long* desc, int count, int handle,
                         float lr, cudaStream_t stream, int* launched) {
  constexpr int V = 16 / sizeof(T);
  for (int first = 0; first < count; first += kMaxGroup) {
    GroupTable table{};
    long long blocks = 0;
    for (int i = first; i < count && i < first + kMaxGroup; ++i) {
      const long long* r = desc + static_cast<long long>(kDescWords) * i;
      GroupBucket& b = table.b[table.count++];
      b.grads = reinterpret_cast<const void*>(r[0]);
      b.store = reinterpret_cast<void*>(r[1]);
      b.pulled = reinterpret_cast<void*>(r[2]);
      b.padded = r[3];
      b.period = r[4];
      b.sub = r[5];
      b.split = r[6];
      b.n = static_cast<int>(r[7]);
      b.kv = r[8] != 0;
      b.unused = 0;
      if (b.padded <= 0 || !valid_geo(b.n, b.period, b.sub, b.padded))
        return cudaErrorInvalidValue;
      const RingGeo geo{b.period, b.sub, b.split, b.n};
      b.vec = use_vectors<T>(b.grads, b.store, b.pulled, geo, b.kv != 0);
      b.first_block = blocks;
      const long long nvec = b.vec ? b.padded / V : b.padded;
      blocks += (nvec + kThreads - 1) / kThreads;
    }
    if (blocks >= (1ll << 31)) return cudaErrorInvalidValue;
    ring_group_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                           stream>>>(table, handle, lr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  grads is [n, padded]
// row-major (row w = rank w's whole bucket), store is [padded] and is
// updated in place, pulled is [padded] or NULL for push-only.  The geometry
// (period, sub, split) is that of ring_geometry.cuh; kv = 0 is the 1-D ring
// (period must then equal padded).
int pstt_ring_push_pull(const void* grads, void* store, void* pulled,
                        int dtype, int n, long long period, long long sub,
                        long long split, int kv, long long padded, int handle,
                        float lr, void* stream) {
  if (padded <= 0) return 0;
  if (!valid_geo(n, period, sub, padded))
    return static_cast<int>(cudaErrorInvalidValue);
  const RingGeo geo{period, sub, split, n};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch<float>(grads, store, pulled, geo, kv != 0, padded, handle,
                          lr, st);
      break;
    case 1:
      err = launch<__nv_bfloat16>(grads, store, pulled, geo, kv != 0, padded,
                                  handle, lr, st);
      break;
    case 2:
      err = launch<__half>(grads, store, pulled, geo, kv != 0, padded, handle,
                           lr, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// push_pull over `count` buckets of one dtype in ceil(count / 48) launches
// of ring_group_kernel.  desc is `count` rows of 9 int64 words: grads,
// store and pulled pointers, padded, period, sub, split, n, kv (each as in
// pstt_ring_push_pull; pulled must not be NULL).  *launched counts the
// launches made.
int pstt_ring_group(const long long* desc, int count, int dtype, int handle,
                    float lr, void* stream, int* launched) {
  *launched = 0;
  if (count <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_group<float>(desc, count, handle, lr, st, launched);
      break;
    case 1:
      err = launch_group<__nv_bfloat16>(desc, count, handle, lr, st, launched);
      break;
    case 2:
      err = launch_group<__half>(desc, count, handle, lr, st, launched);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// `steps` consecutive pstt_ring_push_pull launches on one store: grads is
// [steps, n, padded], and pulled is [steps, padded] (step t's all-gather in
// row t) or NULL for push-only steps.  One C call per replay, so the
// Python wrapper's cost is paid once, not once per step.
int pstt_ring_replay(const void* grads, void* store, void* pulled, int dtype,
                     int n, long long period, long long sub, long long split,
                     int kv, long long padded, int handle, float lr, int steps,
                     void* stream) {
  if (dtype < 0 || dtype > 2) return static_cast<int>(cudaErrorInvalidValue);
  const long long bytes = dtype == 0 ? 4 : 2;
  for (int t = 0; t < steps; ++t) {
    const auto* g = static_cast<const char*>(grads) +
                    static_cast<long long>(t) * n * padded * bytes;
    auto* p = pulled == nullptr
                  ? nullptr
                  : static_cast<char*>(pulled) +
                        static_cast<long long>(t) * padded * bytes;
    const int err = pstt_ring_push_pull(g, store, p, dtype, n, period, sub,
                                        split, kv, padded, handle, lr, stream);
    if (err != 0) return err;
  }
  return 0;
}

}  // extern "C"
