// The int8 wire-compressed ring push_pull / push on one Hopper card.
//
// Replaces the compressed variant of the Pallas TPU ring kernel of
// pslite_tpu/ops/ring_collective.py (_ring_call :389, pallas_call :445, with
// compress=True: quantize_to_send :251-262, dequant_recv :268-271, the
// reduce-scatter :285-297, the owner's sum :307-310, the all-gather
// :343-378), for the 1-D ring and for the (dp, kv) sub-rings of the 2-D data
// plane (geometry in ring_geometry.cuh).
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
// back.  fmaf and the reciprocal are written out because XLA contracts the
// TPU kernel's `q * scale + g` into one FMA and compiles `amax / 127.0` as a
// multiplication by the f32 reciprocal.
//
// Why one thread per output cannot do this: a hop needs the absmax of its
// whole region (up to 643,072 values at the main path's shapes) before the
// next hop can quantize.  Design (simple, right first): n+1 stream-ordered
// launches over the whole bucket.  Pass 0 reduces |g| of each region's first
// rank; pass k (k = 1..n-1) re-quantizes the previous partial sum from the
// region's absmax, adds rank k+1's grads with fmaf and writes the f32 partial
// sum to a scratch tensor (the owner's pass updates the store instead); the
// gather pass quantizes the updated store and writes the pulled values.  Each
// pass reduces |value| over its block and does one atomicMax of the float's
// bits into the region's slot (non-negative floats order as unsigned ints;
// blocks that straddle two regions fall back to one atomic per thread); two
// slot arrays alternate, and a cudaMemsetAsync clears the next one before each
// pass.
//
// Bound: HBM bandwidth.  The function must read n grads rows and the store and
// write the store and pulled: (n+3)*4*P bytes, as the uncompressed ring (on
// one card the int8 payload never crosses a link).  The passes move about
// (12n+4)*P bytes (every partial sum goes through device memory), so this
// design can reach at most (4n+12)/(12n+4) of the bound: 0.44 at n = 8.  A
// design that keeps each region on chip (thread block clusters, or a
// cooperative grid with a grid-wide barrier per hop) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ring_geometry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kAmax = 0, kHop = 1, kGather = 2 };

__device__ __forceinline__ float scale_of(unsigned slot) {
  return fmaxf(__uint_as_float(slot) * (1.0f / 127.0f), 1e-30f);
}

__device__ __forceinline__ float quant(float x, float scale) {
  return fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -127.f), 127.f);
}

template <int V>
__device__ __forceinline__ void load_v(const float* __restrict__ p, long long i,
                                       float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p + i);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
    x[0] = p[i];
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* __restrict__ p, long long i,
                                        const float (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p + i) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    p[i] = x[0];
  }
}

// Max of `v` (>= 0) into slots[region] over the block.  Regions are
// contiguous ranges of elements, so the block is in one region iff its first
// and last elements are.
template <bool KV>
__device__ __forceinline__ void region_max(unsigned* __restrict__ slots,
                                           const RingGeo& geo, long long first,
                                           long long last, bool active,
                                           long long region, float v) {
  __shared__ float warp_max[kWarps];
  const long long r0 = ring_pos<KV>(geo, first).region;
  if (r0 != ring_pos<KV>(geo, last).region) {
    if (active) atomicMax(slots + region, __float_as_uint(v));
    return;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, warp_max[w]);
    atomicMax(slots + r0, __float_as_uint(m));
  }
}

// One pass.  kAmax: |g| of each region's first rank -> slot_out.  kHop (hop
// k = 1..n-1): partial = fmaf(q(prev), scale_in, g[rank k+1]) with prev =
// g[first rank] (k = 1) or scratch; k < n-1 writes scratch and |partial| ->
// slot_out; k = n-1 is the owner: the handle updates the store, and |updated|
// -> slot_out when a gather follows.  kGather: q(store) * scale_in -> pulled
// (if any) and, with store_takes_pulled, back into the store.
template <int MODE, bool KV, int V>
__global__ void int8_pass(const float* __restrict__ grads,
                          float* __restrict__ store, float* __restrict__ pulled,
                          float* __restrict__ scratch,
                          const unsigned* __restrict__ slot_in,
                          unsigned* __restrict__ slot_out, RingGeo geo,
                          long long padded, int k, int handle, float lr,
                          bool gather, bool store_takes_pulled) {
  const long long nvec = padded / V;
  const long long vi = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool active = vi < nvec;
  const long long i0 = (active ? vi : nvec - 1) * V;
  const int n = geo.n;
  const RingPos pos = ring_pos<KV>(geo, i0);
  float amax = 0.f;

  if (active) {
    if (MODE == kAmax) {
      float g[V];
      load_v<V>(grads + ring_rank(pos, 1, n) * padded, i0, g);
#pragma unroll
      for (int e = 0; e < V; ++e) amax = fmaxf(amax, fabsf(g[e]));
    } else if (MODE == kHop) {
      const float scale = scale_of(slot_in[pos.region]);
      float prev[V], g[V];
      if (k == 1) {
        load_v<V>(grads + ring_rank(pos, 1, n) * padded, i0, prev);
      } else {
        load_v<V>(scratch, i0, prev);
      }
      load_v<V>(grads + ring_rank(pos, k + 1, n) * padded, i0, g);
      float v[V];
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = fmaf(quant(prev[e], scale), scale, g[e]);
      if (k < n - 1) {
        store_v<V>(scratch, i0, v);
      } else {
        float s[V];
        load_v<V>(store, i0, s);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if (handle == 0) {
            s[e] = s[e] + v[e];
          } else if (handle == 1) {
            s[e] = v[e];
          } else {
            s[e] = s[e] - lr * v[e];
          }
        }
        store_v<V>(store, i0, s);
#pragma unroll
        for (int e = 0; e < V; ++e) v[e] = s[e];
      }
#pragma unroll
      for (int e = 0; e < V; ++e) amax = fmaxf(amax, fabsf(v[e]));
    } else {
      const float scale = scale_of(slot_in[pos.region]);
      float s[V];
      load_v<V>(store, i0, s);
#pragma unroll
      for (int e = 0; e < V; ++e) s[e] = __fmul_rn(quant(s[e], scale), scale);
      if (pulled != nullptr) store_v<V>(pulled, i0, s);
      if (store_takes_pulled) store_v<V>(store, i0, s);
    }
  }
  // The gather pass and a push's owner pass feed no later pass.  The
  // condition is uniform over the grid: every thread takes the branch.
  if (MODE != kGather && !(MODE == kHop && k == n - 1 && !gather)) {
    const long long first = static_cast<long long>(blockIdx.x) * blockDim.x * V;
    const long long last = min(first + static_cast<long long>(blockDim.x) * V,
                               padded) - 1;
    region_max<KV>(slot_out, geo, first, last, active, pos.region, amax);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <bool KV, int V>
cudaError_t run(const float* g, float* s, float* p, float* scratch,
                unsigned* slots, long long nregions, const RingGeo& geo,
                long long padded, int handle, float lr, bool gather,
                bool store_takes_pulled, cudaStream_t st) {
  const long long nvec = padded / V;
  const auto blocks = static_cast<unsigned int>((nvec + kThreads - 1) / kThreads);
  const int n = geo.n;
  const size_t slot_bytes = static_cast<size_t>(nregions) * sizeof(unsigned);
  unsigned* slot[2] = {slots, slots + nregions};
  cudaError_t err = cudaMemsetAsync(slot[0], 0, slot_bytes, st);
  if (err != cudaSuccess) return err;
  int8_pass<kAmax, KV, V><<<blocks, kThreads, 0, st>>>(
      g, s, p, scratch, nullptr, slot[0], geo, padded, 0, handle, lr, gather,
      store_takes_pulled);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (int k = 1; k < n; ++k) {
    unsigned* in = slot[(k - 1) & 1];
    unsigned* out = slot[k & 1];
    if (k < n - 1 || gather) {
      if ((err = cudaMemsetAsync(out, 0, slot_bytes, st)) != cudaSuccess)
        return err;
    }
    int8_pass<kHop, KV, V><<<blocks, kThreads, 0, st>>>(
        g, s, p, scratch, in, out, geo, padded, k, handle, lr, gather,
        store_takes_pulled);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (gather) {
    int8_pass<kGather, KV, V><<<blocks, kThreads, 0, st>>>(
        g, s, p, scratch, slot[(n - 1) & 1], nullptr, geo, padded, 0, handle,
        lr, gather, store_takes_pulled);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

extern "C" {

// grads [n, padded] f32 (row w = rank w), store [padded] f32 (updated in
// place), pulled [padded] f32 or NULL, scratch [padded] f32 (unused when
// n = 2), slots: 2 * nregions uint32 with nregions = (padded / period) * n * 2.
// gather runs the all-gather pass (pulled and/or store_takes_pulled).  The
// geometry is that of ring_geometry.cuh; kv = 0 is the 1-D ring.
int pstt_ring_int8(const void* grads, void* store, void* pulled,
                   void* scratch, void* slots, int n, long long period,
                   long long sub, long long split, int kv, long long padded,
                   int handle, float lr, int gather, int store_takes_pulled,
                   void* stream) {
  if (padded <= 0) return 0;
  if (n < 2 || period <= 0 || sub <= 0 || padded % period != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const RingGeo geo{period, sub, split, n};
  const long long nregions = (padded / period) * n * 2;
  const auto* g = static_cast<const float*>(grads);
  auto* s = static_cast<float*>(store);
  auto* p = static_cast<float*>(pulled);
  auto* sc = static_cast<float*>(scratch);
  auto* sl = static_cast<unsigned*>(slots);
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec = (kv == 0 || period % 4 == 0) && sub % 4 == 0 &&
                   (split >= sub || split % 4 == 0) && aligned16(grads) &&
                   aligned16(store) && (p == nullptr || aligned16(p)) &&
                   (sc == nullptr || aligned16(sc));
  const bool ga = gather != 0, stp = store_takes_pulled != 0;
  cudaError_t err;
  if (kv) {
    err = vec ? run<true, 4>(g, s, p, sc, sl, nregions, geo, padded, handle,
                             lr, ga, stp, st)
              : run<true, 1>(g, s, p, sc, sl, nregions, geo, padded, handle,
                             lr, ga, stp, st);
  } else {
    err = vec ? run<false, 4>(g, s, p, sc, sl, nregions, geo, padded, handle,
                              lr, ga, stp, st)
              : run<false, 1>(g, s, p, sc, sl, nregions, geo, padded, handle,
                              lr, ga, stp, st);
  }
  return static_cast<int>(err);
}

}  // extern "C"
