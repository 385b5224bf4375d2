// Helpers shared by the kernels: f32/bf16 conversion, 16-byte vector
// loads and stores of eight elements as f32, and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hvd {

// Element type codes passed across the C interface.
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// Eight consecutive elements at a 16-byte aligned address, as f32.
__device__ __forceinline__ void load8(const float* __restrict__ p,
                                      float* __restrict__ dst) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ p,
                                      float* __restrict__ dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// Eight f32 values to eight consecutive elements at a 16-byte aligned
// address (bf16: rounded to nearest even, as from_float).
__device__ __forceinline__ void store8(float* __restrict__ p,
                                       const float* __restrict__ src) {
  reinterpret_cast<float4*>(p)[0] =
      make_float4(src[0], src[1], src[2], src[3]);
  reinterpret_cast<float4*>(p)[1] =
      make_float4(src[4], src[5], src[6], src[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* __restrict__ p,
                                       const float* __restrict__ src) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(src[2 * i], src[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void zero8(float* dst) {
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = 0.f;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace hvd
