// Hopper primitives of the tensor-core kernels (sm_90a): TMA tensor maps
// and loads, mbarriers, wgmma shared-memory descriptors for the 128-byte
// swizzle, and the m64n128k16 bf16 -> f32 products in both forms (A from
// shared memory, A from registers).
//
// Layout conventions, shared by the TMA maps and the descriptors:
//
// * Every tile in shared memory is made of boxes whose rows are 64 bf16
//   values (128 bytes) long, written by TMA with CU_TENSOR_MAP_SWIZZLE_128B
//   into buffers aligned to 1024 bytes (one swizzle atom: 8 rows).
// * A K-major operand (K contiguous: x in the GEMM, Q and K in attention)
//   has one row per M or N index; a k16 step is the next 32 bytes of the
//   row, so its descriptor starts 32 bytes further on.  SBO is the 1024
//   bytes between 8-row groups; LBO is unused by the swizzled K-major form.
// * An MN-major B (N contiguous: y in the GEMM, V in attention) has one
//   row per K index; N runs over boxes of 64 columns, LBO bytes apart, and
//   a k16 step is 16 rows (2048 bytes) further on.  SBO is again the 1024
//   bytes between 8-row groups.
// * The f32 accumulator of m64nNk16 in a warpgroup: thread t (warp w =
//   t / 32, lane l = t % 32) holds d[4j + 2h + e] = D[16w + l/4 + 8h]
//   [8j + 2(l%4) + e] for h, e in {0, 1}.  The A operand of the register
//   form takes the same positions, so a score accumulator turns into the
//   A fragments of P @ V with no data movement.
#pragma once

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace prema {
namespace hopper {

// --------------------------------------------------------------------------
// host: tensor maps
// --------------------------------------------------------------------------
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver that the runtime already loaded,
// so the library links against nothing beyond the runtime.
inline cudaError_t encode_tiled(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiledFn>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// A bf16 tensor map with the 128-byte swizzle.  dims and box innermost
// first; strides in elements for dims 1..rank-1 (dim 0 has stride 1).
// Reads past a dim's extent fill the box with zeros.
inline cudaError_t make_bf16_map(CUtensorMap* map, const void* base, int rank,
                                 const long long* dims,
                                 const long long* strides,
                                 const int* box) {
  EncodeTiledFn encode;
  cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t bdim[5], estride[5];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = static_cast<cuuint64_t>(dims[i]);
    bdim[i] = static_cast<cuuint32_t>(box[i]);
    estride[i] = 1;
    if (i > 0) gstride[i - 1] = static_cast<cuuint64_t>(strides[i - 1]) * 2;
  }
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, static_cast<cuuint32_t>(rank),
      const_cast<void*>(base), gdim, gstride, bdim, estride,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// --------------------------------------------------------------------------
// device: shared memory, mbarriers, TMA
// --------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the dynamic shared memory rounded up to the 1024 bytes of a swizzle atom
// (the launcher asks for 1024 bytes more than it uses)
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the other threads and to TMA
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// one arrival that also announces `bytes` of TMA traffic for this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A phase that never completes is a fault of the kernel; after this long
// the wait traps, so the launch fails instead of hanging the card.
constexpr uint64_t kWaitLimitNs = 4000000000ull;

// Wait until the phase of parity `parity` has completed.  A fresh barrier
// is in phase 0, so waiting on parity 1 returns at once.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(addr, parity))
    if (global_ns() - t0 > kWaitLimitNs) __trap();
}

// TMA: one box of a tensor map into shared memory; completes `bytes` of the
// barrier's announced traffic.  Coordinates in elements, innermost first.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The warpgroup of this thread, as a value the compiler knows to be uniform
// across the warp, so the producer and consumer branches are compiled as
// warp-uniform code.
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
}

// a barrier of the 128 threads of one warpgroup (ids 1.. ; 0 is
// __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// --------------------------------------------------------------------------
// device: wgmma
// --------------------------------------------------------------------------
// Shared-memory matrix descriptor, 128-byte swizzle: start address, LBO and
// SBO in 16-byte units, layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t desc_128b(const void* smem,
                                              uint32_t lbo_bytes,
                                              uint32_t sbo_bytes) {
  return static_cast<uint64_t>((smem_u32(smem) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo_bytes & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo_bytes & 0x3FFFF) >> 4) << 32 |
         1ull << 62;
}

__device__ __forceinline__ uint64_t desc_k_major(const void* smem) {
  return desc_128b(smem, 16, 1024);
}

__device__ __forceinline__ uint64_t desc_mn_major(const void* smem,
                                                  uint32_t box_bytes) {
  return desc_128b(smem, box_bytes, 1024);
}

// Orders the accumulator's registers with respect to the asynchronous
// products, so the compiler neither reads them early nor moves writes late.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Before a wgmma that reads registers or shared memory written by ordinary
// instructions (a seeded accumulator, the P fragments).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// wait until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

#define PREMA_ACC_REGS                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"
#define PREMA_ACC8(b)                                                        \
  "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),                \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])
#define PREMA_ACC64                                                          \
  PREMA_ACC8(0), PREMA_ACC8(8), PREMA_ACC8(16), PREMA_ACC8(24),              \
      PREMA_ACC8(32), PREMA_ACC8(40), PREMA_ACC8(48), PREMA_ACC8(56)

// d (64 x 128, f32) = A (64 x 16) @ B (16 x 128) + (accumulate ? d : 0),
// A and B bf16 in shared memory.  A is K-major; B is K-major (TransB 0) or
// MN-major (TransB 1).
template <int TransB>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b,
                                                    int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PREMA_ACC_REGS
      ", %64, %65, p, 1, 1, 0, %67;\n}\n"
      : PREMA_ACC64
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TransB));
}

// The same with A from registers: four 32-bit registers of bf16 pairs in
// the accumulator's positions (a[0]: row l/4, columns 2(l%4) + {0,1};
// a[1]: row + 8; a[2], a[3]: the same, columns + 8).
template <int TransB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t desc_b,
                                                    int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PREMA_ACC_REGS
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : PREMA_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate), "n"(TransB));
}

#undef PREMA_ACC64
#undef PREMA_ACC8
#undef PREMA_ACC_REGS

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace hopper
}  // namespace prema
