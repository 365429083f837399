// Shared helpers of the kernels: element conversion and warp reductions.
// Every kernel computes in f32 whatever its element type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace prema {

// Masked scores take -1e30 rather than -inf, as the TPU kernels do, so
// exp(m_prev - m_new) stays finite while a row has seen no live key.
constexpr float kNegInf = -1e30f;

// Element types, as the Python wrappers encode them.
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

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
  return __float2bfloat16(x);
}

// Reductions over `width` consecutive lanes (a power of two <= 32).
template <int width>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = width / 2; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <int width>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = width / 2; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace prema
