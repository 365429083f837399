// Shared helpers of the kernels: element conversion, asynchronous copies
// and warp reductions.
// Every kernel computes in f32 whatever its element type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Asynchronous copies from global to shared memory (cp.async): 16 bytes,
// or `bytes` < 16 of them with the rest of the 16 filled with zeros (0
// reads nothing; `src` must still be a valid address), or one 4-byte
// element likewise.  A thread's copies are grouped by commit; wait<N>
// returns when at most N of its groups are still in flight.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
