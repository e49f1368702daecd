// Blockwise int8 quantize / dequantize (one absmax scale per 128 values).
//
// Replaces the Pallas TPU kernels of pslite_tpu/ops/quantize.py:
// quantize_int8 (:71, pallas_call :97) and dequantize_int8 (:111,
// pallas_call :129).  The TPU kernels walk (32, 128) tiles of the row-major
// [R, 128] layout; each row of 128 values has its own scale.
//
// Quantize, per row: scale = max(amax * (1/127), 1e-12), q = clip(rint(x /
// scale), -127, 127), and the scale is written lane-replicated into [R, 128]
// as the TPU kernel writes it.  `amax * (1.0f/127.0f)` is written out because
// XLA compiles the JAX `amax / 127.0` as a multiplication by the f32
// reciprocal, while nvcc keeps a division as an IEEE division; x / scale is a
// true division on both.  rintf rounds half to even, as jnp.round does.
// Values past N (the tile padding) read as 0, so padding rows get q = 0 and
// scale 1e-12.
//
// Dequantize: x = q * scale, written only for the first N values (the JAX
// function slices [:N] after the kernel).  [R, 128] scales are read value by
// value, as the TPU kernel multiplies q_ref * s_ref; a compact [R] / [R, 1]
// scale is read once per row (the row's threads load one address).
//
// Bound: HBM bandwidth.  Quantize reads 4 B and writes 1 B + 4 B of
// lane-replicated scale per value (9 B); dequantize reads 1 B + 4 B and writes
// 4 B with [R, 128] scales (9 B), about 5 B with compact ones.  Design: one
// warp per 128-value row, one float4 (4 values) per lane, so each warp reads
// 512 contiguous bytes per row; the row's absmax is a __shfl_xor_sync max
// over the 32 lanes.  Each warp walks 4 rows and issues all their loads
// first, so that enough bytes are in flight (with one row per warp,
// dequantize with compact scales reached 0.37 of its bound on an H100, 700
// W).  Ragged tails and unaligned pointers take guarded scalar accesses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;  // rows a warp walks, one after another
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr unsigned kFull = 0xffffffffu;

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// clip(rint(v / scale), -127, 127) as an int8 code.
__device__ __forceinline__ signed char q8(float v, float scale) {
  return static_cast<signed char>(
      fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f));
}

// Each warp quantizes kRowsPerWarp consecutive rows: lane l holds values
// 4l..4l+3 of every row, all rows' loads are issued before the first
// reduction, then each row is reduced and written as one warp.
__global__ void quantize_kernel(const float* __restrict__ x,
                                int8_t* __restrict__ q,
                                float* __restrict__ scales, long long n,
                                long long rows, bool vec) {
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
      kRowsPerWarp;
  if (row0 >= rows) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  float v[kRowsPerWarp][4];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const long long i = (row0 + r) * 128 + lane * 4;
    if (vec && i + 4 <= n) {
      const float4 t = *reinterpret_cast<const float4*>(x + i);
      v[r][0] = t.x; v[r][1] = t.y; v[r][2] = t.z; v[r][3] = t.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[r][e] = (i + e < n) ? x[i + e] : 0.f;
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (row0 + r >= rows) break;  // uniform over the warp
    const long long i = (row0 + r) * 128 + lane * 4;
    float amax = fmaxf(fmaxf(fabsf(v[r][0]), fabsf(v[r][1])),
                       fmaxf(fabsf(v[r][2]), fabsf(v[r][3])));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, off));
    const float scale = fmaxf(amax * (1.0f / 127.0f), 1e-12f);
    const char4 c = make_char4(q8(v[r][0], scale), q8(v[r][1], scale),
                               q8(v[r][2], scale), q8(v[r][3], scale));
    // q and scales are fresh [rows, 128] tensors: always 16-byte aligned.
    *reinterpret_cast<char4*>(q + i) = c;
    *reinterpret_cast<float4*>(scales + i) =
        make_float4(scale, scale, scale, scale);
  }
}

// Each warp dequantizes kRowsPerWarp consecutive rows: lane l handles
// values 4l..4l+3 of every row, so every load and store instruction of the
// warp touches one contiguous span.
template <bool PER_VALUE>
__global__ void dequantize_kernel(const int8_t* __restrict__ q,
                                  const float* __restrict__ scales,
                                  long long scale_stride,
                                  float* __restrict__ out, long long n,
                                  bool vec) {
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
      kRowsPerWarp;
  const int lane = threadIdx.x & 31;
  float v[kRowsPerWarp][4];
  float s[kRowsPerWarp][4];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const long long i = (row0 + r) * 128 + lane * 4;
    if (i >= n) continue;  // q and scales hold whole rows past n
    if (vec) {
      const char4 c = *reinterpret_cast<const char4*>(q + i);
      v[r][0] = c.x; v[r][1] = c.y; v[r][2] = c.z; v[r][3] = c.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[r][e] = q[i + e];
    }
    if (PER_VALUE) {
      if (vec) {
        const float4 t = *reinterpret_cast<const float4*>(scales + i);
        s[r][0] = t.x; s[r][1] = t.y; s[r][2] = t.z; s[r][3] = t.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[r][e] = scales[i + e];
      }
    } else {
      // The row's 32 lanes read one address: one transaction per row.
      const float t = scales[(row0 + r) * scale_stride];
      s[r][0] = s[r][1] = s[r][2] = s[r][3] = t;
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const long long i = (row0 + r) * 128 + lane * 4;
    if (i >= n) continue;
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = __fmul_rn(v[r][e], s[r][e]);
    if (vec && i + 4 <= n) {
      *reinterpret_cast<float4*>(out + i) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (i + e < n) out[i + e] = o[e];
    }
  }
}

}  // namespace

extern "C" {

// x: [n] f32; q: [rows, 128] int8; scales: [rows, 128] f32 (both fresh,
// contiguous); rows = ceil(n / 4096) * 32.
int pstt_quantize_int8(const void* x, void* q, void* scales, long long n,
                       long long rows, void* stream) {
  if (rows <= 0) return 0;
  const auto blocks =
      static_cast<unsigned int>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  quantize_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scales), n, rows, aligned16(x));
  return static_cast<int>(cudaGetLastError());
}

// q: [rows, 128] int8, contiguous, rows >= ceil(n / 128); scales: [rows, 128]
// f32 contiguous when per_value, else one f32 per row at
// scales[row * scale_stride]; out: [n] f32.
int pstt_dequantize_int8(const void* q, const void* scales,
                         long long scale_stride, int per_value, void* out,
                         long long n, void* stream) {
  if (n <= 0) return 0;
  const long long rows = (n + 127) / 128;
  const auto blocks =
      static_cast<unsigned int>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  // Vector accesses need 4-byte aligned codes and 16-byte aligned scales
  // (per value) and output; other views take scalar accesses.
  const bool vec = aligned16(out) &&
                   (reinterpret_cast<uintptr_t>(q) & 3u) == 0 &&
                   (!per_value || aligned16(scales));
  auto st = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const int8_t*>(q);
  const auto* ss = static_cast<const float*>(scales);
  auto* oo = static_cast<float*>(out);
  if (per_value) {
    dequantize_kernel<true><<<blocks, kThreads, 0, st>>>(qq, ss, scale_stride,
                                                         oo, n, vec);
  } else {
    dequantize_kernel<false><<<blocks, kThreads, 0, st>>>(qq, ss, scale_stride,
                                                          oo, n, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
