// The per-element arithmetic of the fused optimizer updates (K1-K3), shared
// by csrc/fused_update.cu (the updates alone) and csrc/reduce_update.cu (D2:
// the worker reduction fused with them), so the two cannot drift apart and
// give the same bits on the same aggregate.
//
// f32: written as the JAX kernels write them; nvcc contracts a*b + c into one
// FMA as XLA does, the same way wherever a function is inlined (the card tests
// hold D2 against the reduction followed by a K1-K3 launch, 0 differing
// elements).
//
// bf16: every operation rounds to bf16 (rb), with the constants rounded to
// bf16 by the caller, as XLA's CPU backend evaluates the Pallas kernels'
// bf16 expressions; adam's last subtraction stays in f32 and the caller
// rounds it once into the bf16 store.

#pragma once

#include <cuda_bf16.h>

namespace pstt {

__device__ __forceinline__ float rb(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// -- f32 ------------------------------------------------------------------------

// K1: mom = momentum*mom + g; s -= lr*mom.
__device__ __forceinline__ void sgd_f32(float& s, float& m, float g, float lr,
                                        float momentum) {
  m = momentum * m + g;
  s = s - lr * m;
}

// K2: acc += g*g; s -= lr*g / (sqrt(acc) + eps).
__device__ __forceinline__ void adagrad_f32(float& s, float& a, float g,
                                            float lr, float eps) {
  a = a + g * g;
  s = s - lr * g / (sqrtf(a) + eps);
}

// K3 with the bias-corrected step size alpha_t.
__device__ __forceinline__ void adam_f32(float& s, float& m, float& v, float g,
                                         float alpha_t, float beta1,
                                         float beta2, float c1, float c2,
                                         float eps) {
  m = beta1 * m + c1 * g;
  v = beta2 * v + c2 * g * g;
  s = s - alpha_t * m / (sqrtf(v) + eps);
}

// -- bf16 (values held in f32, each already a bf16 value) -------------------------

__device__ __forceinline__ void sgd_bf16(float& s, float& m, float g, float lr,
                                         float momentum) {
  m = rb(rb(momentum * m) + g);
  s = rb(s - rb(lr * m));
}

__device__ __forceinline__ void adagrad_bf16(float& s, float& a, float g,
                                             float lr, float eps) {
  a = rb(a + rb(g * g));
  const float den = rb(rb(sqrtf(a)) + eps);
  s = rb(s - rb(rb(lr * g) / den));
}

// The store's new value is left in f32: the caller rounds it once.
__device__ __forceinline__ void adam_bf16(float& s, float& m, float& v, float g,
                                          float alpha_t, float beta1,
                                          float beta2, float c1, float c2,
                                          float eps) {
  m = rb(rb(beta1 * m) + rb(c1 * g));
  v = rb(rb(beta2 * v) + rb(rb(c2 * g) * g));
  const float den = rb(rb(sqrtf(v)) + eps);
  const float num = alpha_t * m;
  s = s - num / den;
}

}  // namespace pstt
