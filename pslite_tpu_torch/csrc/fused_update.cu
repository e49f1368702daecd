// Fused optimizer updates (SGD with momentum, Adagrad, Adam) for Hopper.
//
// Replaces the Pallas TPU kernels of pslite_tpu/ops/fused_update.py
// (sgd_update :51, adagrad_update :86, adam_update :128).  Each applies the
// whole optimizer step to the store and its state in ONE pass over device
// memory, updating both in place (the TPU kernels alias their outputs to
// their inputs the same way).
//
// Bound: pure streaming, so HBM bandwidth.  Per element SGD and Adagrad read
// store, state and grad and write store and state (5 x 4 B); Adam reads
// store, m, v and grad and writes store, m, v (7 x 4 B).  A few flops per
// element are far below the card's f32 rate.  Design: one thread per 16-byte
// float4 of every array (the TPU kernel's (512, 128) block tiling has no use
// here), vector loads when every pointer is 16-byte aligned, a scalar path for
// the ragged tail and for unaligned views.  One launch covers the whole padded
// store of the device, i.e. all n shards at once: the update is elementwise,
// so per shard and whole give the same result.
//
// Arithmetic follows the JAX kernels term by term; nvcc contracts a*b + c
// into one FMA as XLA does, so results may differ from an eager PyTorch
// evaluation of the same formula in the last bit.
//
// The per-element arithmetic is in fused_update.cuh, shared with D2
// (csrc/reduce_update.cu), which fuses the worker reduction in front of it.
//
// Adam's bias-corrected step size alpha_t is read from a 1-element device
// tensor (the TPU kernel's scalar prefetch), so the step counter never
// leaves the device.
//
// bf16 buckets (the *_bf16 entries): store and state in bf16, as the JAX
// engine keeps them, adam's step counter and alpha_t in f32.  XLA's CPU
// backend evaluates the Pallas kernels' bf16 expressions one operation at a
// time, each in f32 and rounded to bf16, with the Python constants rounded
// to bf16 first (the wrapper passes them so): the kernels do the same, a
// round-to-nearest-even after every operation (so nvcc has no product to
// contract into an FMA), which makes them bit-exact with the JAX package's
// sgd_momentum and adagrad and with their plain versions.  adam: JAX's
// kernel refuses a bf16 store (its alpha_t * m is f32 and the store ref is
// bf16), so the port defines it by the same expression, the f32 quotient
// alpha_t * m / (sqrt(v) + eps) subtracted in f32 and rounded once into the
// store.  Bound: bytes, half of the f32 kernels' per element; one thread
// per 16 bytes of each array (8 values).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fused_update.cuh"

namespace {

constexpr int kThreads = 256;

template <bool VEC>
__device__ __forceinline__ void load4(const float* __restrict__ p,
                                      long long i, long long n, float (&x)[4]) {
  if (VEC && i + 4 <= n) {
    const float4 t = *reinterpret_cast<const float4*>(p + i);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = (i + e < n) ? p[i + e] : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(float* __restrict__ p, long long i,
                                       long long n, const float (&x)[4]) {
  if (VEC && i + 4 <= n) {
    *reinterpret_cast<float4*>(p + i) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (i + e < n) p[i + e] = x[e];
  }
}

__device__ __forceinline__ long long first_elem() {
  return (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
}

template <bool VEC>
__global__ void sgd_kernel(float* __restrict__ store, float* __restrict__ mom,
                           const float* __restrict__ agg, long long n,
                           float lr, float momentum) {
  const long long i = first_elem();
  if (i >= n) return;
  float s[4], m[4], g[4];
  load4<VEC>(store, i, n, s);
  load4<VEC>(mom, i, n, m);
  load4<VEC>(agg, i, n, g);
#pragma unroll
  for (int e = 0; e < 4; ++e) pstt::sgd_f32(s[e], m[e], g[e], lr, momentum);
  store4<VEC>(mom, i, n, m);
  store4<VEC>(store, i, n, s);
}

template <bool VEC>
__global__ void adagrad_kernel(float* __restrict__ store,
                               float* __restrict__ acc,
                               const float* __restrict__ agg, long long n,
                               float lr, float eps) {
  const long long i = first_elem();
  if (i >= n) return;
  float s[4], a[4], g[4];
  load4<VEC>(store, i, n, s);
  load4<VEC>(acc, i, n, a);
  load4<VEC>(agg, i, n, g);
#pragma unroll
  for (int e = 0; e < 4; ++e) pstt::adagrad_f32(s[e], a[e], g[e], lr, eps);
  store4<VEC>(acc, i, n, a);
  store4<VEC>(store, i, n, s);
}

template <bool VEC>
__global__ void adam_kernel(float* __restrict__ store, float* __restrict__ m,
                            float* __restrict__ v,
                            const float* __restrict__ agg,
                            const float* __restrict__ alpha, long long n,
                            float beta1, float beta2, float c1, float c2,
                            float eps) {
  const long long i = first_elem();
  if (i >= n) return;
  const float alpha_t = __ldg(alpha);
  float s[4], mm[4], vv[4], g[4];
  load4<VEC>(store, i, n, s);
  load4<VEC>(m, i, n, mm);
  load4<VEC>(v, i, n, vv);
  load4<VEC>(agg, i, n, g);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    pstt::adam_f32(s[e], mm[e], vv[e], g[e], alpha_t, beta1, beta2, c1, c2,
                   eps);
  store4<VEC>(m, i, n, mm);
  store4<VEC>(v, i, n, vv);
  store4<VEC>(store, i, n, s);
}

// -- bf16 ---------------------------------------------------------------------

template <bool VEC>
__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ p,
                                      long long i, long long n, float (&x)[8]) {
  if (VEC && i + 8 <= n) {
    const uint4 t = *reinterpret_cast<const uint4*>(p + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      x[2 * e] = f.x;
      x[2 * e + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      x[e] = (i + e < n) ? __bfloat162float(p[i + e]) : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void store8(__nv_bfloat16* __restrict__ p,
                                       long long i, long long n,
                                       const float (&x)[8]) {
  if (VEC && i + 8 <= n) {
    uint4 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      h[e] = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
    *reinterpret_cast<uint4*>(p + i) = t;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (i + e < n) p[i + e] = __float2bfloat16_rn(x[e]);
  }
}

__device__ __forceinline__ long long first_elem8() {
  return (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 8;
}

// The constants (lr, momentum, eps, betas) arrive rounded to bf16.
template <bool VEC>
__global__ void sgd_bf16_kernel(__nv_bfloat16* __restrict__ store,
                                __nv_bfloat16* __restrict__ mom,
                                const __nv_bfloat16* __restrict__ agg,
                                long long n, float lr, float momentum) {
  const long long i = first_elem8();
  if (i >= n) return;
  float s[8], m[8], g[8];
  load8<VEC>(store, i, n, s);
  load8<VEC>(mom, i, n, m);
  load8<VEC>(agg, i, n, g);
#pragma unroll
  for (int e = 0; e < 8; ++e) pstt::sgd_bf16(s[e], m[e], g[e], lr, momentum);
  store8<VEC>(mom, i, n, m);
  store8<VEC>(store, i, n, s);
}

template <bool VEC>
__global__ void adagrad_bf16_kernel(__nv_bfloat16* __restrict__ store,
                                    __nv_bfloat16* __restrict__ acc,
                                    const __nv_bfloat16* __restrict__ agg,
                                    long long n, float lr, float eps) {
  const long long i = first_elem8();
  if (i >= n) return;
  float s[8], a[8], g[8];
  load8<VEC>(store, i, n, s);
  load8<VEC>(acc, i, n, a);
  load8<VEC>(agg, i, n, g);
#pragma unroll
  for (int e = 0; e < 8; ++e) pstt::adagrad_bf16(s[e], a[e], g[e], lr, eps);
  store8<VEC>(acc, i, n, a);
  store8<VEC>(store, i, n, s);
}

template <bool VEC>
__global__ void adam_bf16_kernel(__nv_bfloat16* __restrict__ store,
                                 __nv_bfloat16* __restrict__ m,
                                 __nv_bfloat16* __restrict__ v,
                                 const __nv_bfloat16* __restrict__ agg,
                                 const float* __restrict__ alpha, long long n,
                                 float beta1, float beta2, float c1, float c2,
                                 float eps) {
  const long long i = first_elem8();
  if (i >= n) return;
  const float alpha_t = __ldg(alpha);
  float s[8], mm[8], vv[8], g[8];
  load8<VEC>(store, i, n, s);
  load8<VEC>(m, i, n, mm);
  load8<VEC>(v, i, n, vv);
  load8<VEC>(agg, i, n, g);
#pragma unroll
  for (int e = 0; e < 8; ++e)  // the store rounded once by store8
    pstt::adam_bf16(s[e], mm[e], vv[e], g[e], alpha_t, beta1, beta2, c1, c2,
                    eps);
  store8<VEC>(m, i, n, mm);
  store8<VEC>(v, i, n, vv);
  store8<VEC>(store, i, n, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + 4LL * kThreads - 1) / (4LL * kThreads));
}

unsigned int blocks_for8(long long n) {
  return static_cast<unsigned int>((n + 8LL * kThreads - 1) / (8LL * kThreads));
}

}  // namespace

extern "C" {

// The message of a failed entry's error.  A runtime call that failed also
// left its error in this thread's last-error slot, where the next launch's
// cudaGetLastError() would report it as its own: taken off here.
const char* pstt_error_string(int err) {
  cudaGetLastError();
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int pstt_sgd_update(void* store, void* mom, const void* agg, long long n,
                    float lr, float momentum, void* stream) {
  if (n <= 0) return 0;
  auto* s = static_cast<float*>(store);
  auto* m = static_cast<float*>(mom);
  auto* g = static_cast<const float*>(agg);
  auto st = static_cast<cudaStream_t>(stream);
  if (aligned16(s) && aligned16(m) && aligned16(g))
    sgd_kernel<true><<<blocks_for(n), kThreads, 0, st>>>(s, m, g, n, lr,
                                                          momentum);
  else
    sgd_kernel<false><<<blocks_for(n), kThreads, 0, st>>>(s, m, g, n, lr,
                                                           momentum);
  return static_cast<int>(cudaGetLastError());
}

int pstt_adagrad_update(void* store, void* acc, const void* agg, long long n,
                        float lr, float eps, void* stream) {
  if (n <= 0) return 0;
  auto* s = static_cast<float*>(store);
  auto* a = static_cast<float*>(acc);
  auto* g = static_cast<const float*>(agg);
  auto st = static_cast<cudaStream_t>(stream);
  if (aligned16(s) && aligned16(a) && aligned16(g))
    adagrad_kernel<true><<<blocks_for(n), kThreads, 0, st>>>(s, a, g, n, lr,
                                                              eps);
  else
    adagrad_kernel<false><<<blocks_for(n), kThreads, 0, st>>>(s, a, g, n, lr,
                                                               eps);
  return static_cast<int>(cudaGetLastError());
}

int pstt_adam_update(void* store, void* m, void* v, const void* agg,
                     const void* alpha, long long n, float beta1, float beta2,
                     float c1, float c2, float eps, void* stream) {
  if (n <= 0) return 0;
  auto* s = static_cast<float*>(store);
  auto* mm = static_cast<float*>(m);
  auto* vv = static_cast<float*>(v);
  auto* g = static_cast<const float*>(agg);
  auto* al = static_cast<const float*>(alpha);
  auto st = static_cast<cudaStream_t>(stream);
  if (aligned16(s) && aligned16(mm) && aligned16(vv) && aligned16(g))
    adam_kernel<true><<<blocks_for(n), kThreads, 0, st>>>(
        s, mm, vv, g, al, n, beta1, beta2, c1, c2, eps);
  else
    adam_kernel<false><<<blocks_for(n), kThreads, 0, st>>>(
        s, mm, vv, g, al, n, beta1, beta2, c1, c2, eps);
  return static_cast<int>(cudaGetLastError());
}

int pstt_sgd_update_bf16(void* store, void* mom, const void* agg, long long n,
                         float lr, float momentum, void* stream) {
  if (n <= 0) return 0;
  auto* s = static_cast<__nv_bfloat16*>(store);
  auto* m = static_cast<__nv_bfloat16*>(mom);
  auto* g = static_cast<const __nv_bfloat16*>(agg);
  auto st = static_cast<cudaStream_t>(stream);
  if (aligned16(s) && aligned16(m) && aligned16(g))
    sgd_bf16_kernel<true><<<blocks_for8(n), kThreads, 0, st>>>(s, m, g, n, lr,
                                                                momentum);
  else
    sgd_bf16_kernel<false><<<blocks_for8(n), kThreads, 0, st>>>(s, m, g, n,
                                                                 lr, momentum);
  return static_cast<int>(cudaGetLastError());
}

int pstt_adagrad_update_bf16(void* store, void* acc, const void* agg,
                             long long n, float lr, float eps, void* stream) {
  if (n <= 0) return 0;
  auto* s = static_cast<__nv_bfloat16*>(store);
  auto* a = static_cast<__nv_bfloat16*>(acc);
  auto* g = static_cast<const __nv_bfloat16*>(agg);
  auto st = static_cast<cudaStream_t>(stream);
  if (aligned16(s) && aligned16(a) && aligned16(g))
    adagrad_bf16_kernel<true><<<blocks_for8(n), kThreads, 0, st>>>(s, a, g, n,
                                                                    lr, eps);
  else
    adagrad_bf16_kernel<false><<<blocks_for8(n), kThreads, 0, st>>>(
        s, a, g, n, lr, eps);
  return static_cast<int>(cudaGetLastError());
}

int pstt_adam_update_bf16(void* store, void* m, void* v, const void* agg,
                          const void* alpha, long long n, float beta1,
                          float beta2, float c1, float c2, float eps,
                          void* stream) {
  if (n <= 0) return 0;
  auto* s = static_cast<__nv_bfloat16*>(store);
  auto* mm = static_cast<__nv_bfloat16*>(m);
  auto* vv = static_cast<__nv_bfloat16*>(v);
  auto* g = static_cast<const __nv_bfloat16*>(agg);
  auto* al = static_cast<const float*>(alpha);
  auto st = static_cast<cudaStream_t>(stream);
  if (aligned16(s) && aligned16(mm) && aligned16(vv) && aligned16(g))
    adam_bf16_kernel<true><<<blocks_for8(n), kThreads, 0, st>>>(
        s, mm, vv, g, al, n, beta1, beta2, c1, c2, eps);
  else
    adam_bf16_kernel<false><<<blocks_for8(n), kThreads, 0, st>>>(
        s, mm, vv, g, al, n, beta1, beta2, c1, c2, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
