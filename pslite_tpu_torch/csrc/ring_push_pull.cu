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

template <typename T, int V, bool KV>
__global__ void ring_kernel(const T* __restrict__ grads, T* __restrict__ store,
                            T* __restrict__ pulled, RingGeo geo,
                            long long padded, long long nvec, int handle,
                            float lr) {
  const long long vi = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (vi >= nvec) return;
  const long long i0 = vi * V;
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

template <typename T>
cudaError_t launch(const void* grads, void* store, void* pulled,
                   const RingGeo& geo, bool kv, long long padded, int handle,
                   float lr, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  // A vector never straddles a shard, chunk or direction boundary.
  const bool vec = (!kv || geo.period % V == 0) && geo.sub % V == 0 &&
                   (geo.split >= geo.sub || geo.split % V == 0) &&
                   aligned16(grads) && aligned16(store) &&
                   (pulled == nullptr || aligned16(pulled));
  const auto* g = static_cast<const T*>(grads);
  auto* s = static_cast<T*>(store);
  auto* p = static_cast<T*>(pulled);
  if (vec) {
    launch_geo<T, V>(g, s, p, geo, kv, padded, handle, lr, stream);
  } else {
    launch_geo<T, 1>(g, s, p, geo, kv, padded, handle, lr, stream);
  }
  return cudaGetLastError();
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
  if (n < 1 || period <= 0 || sub <= 0 || padded % period != 0)
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

}  // extern "C"
