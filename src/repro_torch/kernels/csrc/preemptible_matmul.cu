// Preemptible GEMM for Hopper: the paper's GEMM_OP preemption point.
//
// Replaces the TPU Pallas kernel
// src/repro/kernels/preemptible_matmul/kernel.py (_matmul_kernel, launched
// by matmul_resumable_raw).  Same function: run reduction rows [lo, hi) of
// x @ y into an f32 accumulator that the previous launch left behind,
//   acc_out[i, j] = acc_in[i, j] + sum_{k in [lo, hi)} x[i, k] * y[k, j],
// with the sum in f32.  A checkpoint is (accumulator, next K tile): the
// analogue of the paper's ACCQ, saved between launches in device memory.
// The accumulator may be larger than M x N (the checkpoint keeps the
// reference's padded shape); its extra rows and columns pass through.
//
// The resume contract is bitwise: any split of [0, K) into launches gives
// the accumulator of one uninterrupted launch, bit for bit.  So each output
// element is one f32 register, seeded from acc_in and updated by the same
// sequence of steps wherever a launch starts or stops, and a stored and
// reloaded f32 is exact.  No split-K, no atomics.
//
// What bounds it on the card: operations.  At qwen3-8b's down projection of
// a 2048-token prefill (2048 x 12288 x 4096) the GEMM is 2.06e11 FLOP over
// 150 MB of bf16 inputs, far above the ~295 FLOP/byte balance point; each
// launch also reads and writes the whole accumulator (64 MB at that shape),
// which is what a preemption point costs.
//
// Two kernels, chosen by the wrapper by dtype alone:
//
// * bf16, gemm_resume_wgmma_kernel: the tensor cores.  One block owns a
//   128 x 128 output tile: a producer warp whose one thread keeps TMA
//   loads in flight (stages of 64 reduction rows: x 128 x 64 K-major, y
//   64 x 128 MN-major as two 64-column boxes; a ring of 4 stages of 32 KB,
//   one full and one empty mbarrier each), and two consumer warpgroups of
//   64 rows each that run wgmma m64n128k16 from shared memory into f32
//   registers seeded from acc_in.  Every output element sees the same k16
//   steps, at the same absolute K positions, however the range is split,
//   because launches start on a multiple of 64 (the wrapper raises for a
//   bf16 bk that is not a multiple of 64).  Ragged M, N and K come from
//   TMA's zero fill past each map's extent; stores are masked.
// * f32, gemm_resume_simt_kernel: the f32 CUDA cores, fmaf per product in
//   ascending k (TF32 products would miss the f32 tolerance).  8 x 8
//   registers per thread, 16-row tiles staged through shared memory with
//   the next tile prefetched into registers; ragged edges masked; x and y
//   read through any strides.
#include <cuda.h>

#include "common.cuh"
#include "hopper.cuh"

namespace prema {
namespace {

struct GemmParams {
  const void* x;
  const void* y;
  const float* acc_in;
  float* acc_out;
  int m, n;            // rows of x, columns of y
  int acc_m, acc_n;    // accumulator shape (>= m, n)
  int lo, hi;          // reduction rows [lo, hi)
  long long sx[2], sy[2], sa[2], so[2];  // element strides
};

// --------------------------------------------------------------------------
// f32: the CUDA cores
// --------------------------------------------------------------------------
namespace simt {

constexpr int BM = 128;       // output rows per block
constexpr int BN = 128;       // output columns per block
constexpr int BK = 16;        // reduction rows per shared tile
constexpr int NT = 256;       // threads: 16 x 16, each an 8 x 8 micro-tile
constexpr int PAD = 4;        // keeps float4 alignment, spreads the stores
constexpr int LX = BM * BK / NT;  // x elements each thread stages per tile
constexpr int LY = BK * BN / NT;  // y elements each thread stages per tile
static_assert(BM == BN && BM == 128 && NT == 256, "sub() assumes this tiling");

// Row (or column) of micro-tile entry i for thread coordinate t: 4 rows at
// 4t and 4 at 64 + 4t, so both halves are read as aligned float4s.
__device__ __forceinline__ int sub(int t, int i) {
  return (i < 4 ? 0 : 60) + 4 * t + i;
}

__global__ void __launch_bounds__(NT) gemm_resume_simt_kernel(
    const GemmParams p) {
  __shared__ __align__(16) float Xs[BK][BM + PAD];  // x tile, transposed
  __shared__ __align__(16) float Ys[BK][BN + PAD];
  const float* x = static_cast<const float*>(p.x);
  const float* y = static_cast<const float*>(p.y);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + sub(ty, i);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + sub(tx, j);
      acc[i][j] = (r < p.acc_m && c < p.acc_n)
                      ? p.acc_in[r * p.sa[0] + c * p.sa[1]] : 0.f;
    }
  }

  // staged in registers while the products of the current tile run
  float xr[LX], yr[LY];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < LX; ++i) {
      const int e = tid + NT * i, r = row0 + e / BK, k = k0 + e % BK;
      xr[i] = (r < p.m && k < p.hi) ? x[r * p.sx[0] + k * p.sx[1]] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < LY; ++i) {
      const int e = tid + NT * i, k = k0 + e / BN, c = col0 + e % BN;
      yr[i] = (k < p.hi && c < p.n) ? y[k * p.sy[0] + c * p.sy[1]] : 0.f;
    }
  };

  load(p.lo);
  for (int k0 = p.lo; k0 < p.hi; k0 += BK) {
    __syncthreads();  // every thread is done reading the previous tile
#pragma unroll
    for (int i = 0; i < LX; ++i) {
      const int e = tid + NT * i;
      Xs[e % BK][e / BK] = xr[i];
    }
#pragma unroll
    for (int i = 0; i < LY; ++i) {
      const int e = tid + NT * i;
      Ys[e / BN][e % BN] = yr[i];
    }
    __syncthreads();
    if (k0 + BK < p.hi) load(k0 + BK);  // in flight during the products
    // rows past hi were staged as zeros: fmaf(0, 0, a) == a
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&Xs[kk][4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&Xs[kk][BM / 2 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Ys[kk][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Ys[kk][BN / 2 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + sub(ty, i);
    if (r >= p.acc_m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + sub(tx, j);
      if (c < p.acc_n) p.acc_out[r * p.so[0] + c * p.so[1]] = acc[i][j];
    }
  }
}

cudaError_t launch(const GemmParams& p, cudaStream_t stream) {
  const dim3 grid((p.acc_n + BN - 1) / BN, (p.acc_m + BM - 1) / BM);
  gemm_resume_simt_kernel<<<grid, NT, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace simt

// --------------------------------------------------------------------------
// bf16: wgmma fed by TMA
// --------------------------------------------------------------------------
namespace wg {

using namespace hopper;

constexpr int BM = 128, BN = 128;
constexpr int BK = 64;                       // reduction rows per stage
constexpr int STAGES = 4;
constexpr int NT = 288;                      // 2 consumer groups + producer
constexpr int X_BYTES = BM * BK * 2;         // 16 KB, K-major
constexpr int Y_BOX_BYTES = BK * 64 * 2;     // 8 KB: 64 columns of y
constexpr int STAGE_BYTES = X_BYTES + 2 * Y_BOX_BYTES;
constexpr int CONSUMER_WARPS = 8;            // each frees a stage once
constexpr size_t SMEM_BYTES =
    STAGES * STAGE_BYTES + 2 * STAGES * sizeof(uint64_t) + 1024;

__global__ void __launch_bounds__(NT, 1) gemm_resume_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_y, const GemmParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int group = warpgroup_index();
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int steps = (p.hi - p.lo + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (group == 2) {  // producer warp: one thread issues every load
    if (threadIdx.x == 256) {
      for (int it = 0; it < steps; ++it) {
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        uint8_t* st = smem + s * STAGE_BYTES;
        const int k0 = p.lo + it * BK;
        mbar_expect_tx(&full[s], STAGE_BYTES);
        tma_load_2d(st, &map_x, &full[s], k0, row0);
        tma_load_2d(st + X_BYTES, &map_y, &full[s], col0, k0);
        tma_load_2d(st + X_BYTES + Y_BOX_BYTES, &map_y, &full[s], col0 + 64,
                    k0);
      }
    }
    return;
  }

  // consumers: warpgroup w owns rows [64w, 64w + 64) of the tile
  const int w = group, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int r0 = row0 + 64 * w + 16 * warp + lane / 4;  // and r0 + 8
  const int c0 = col0 + 2 * (lane % 4);                  // + 8j, and + 1
  float d[64];

  // seed from acc_in in the accumulator's fragment layout: pairs of
  // neighbouring columns, read as 8 bytes where the layout allows
  const bool vec_in = p.sa[1] == 1 && p.sa[0] % 2 == 0 &&
                      reinterpret_cast<uintptr_t>(p.acc_in) % 8 == 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h, c = c0 + 8 * j;
      float a = 0.f, b = 0.f;
      if (r < p.acc_m) {
        const float* src = p.acc_in + r * p.sa[0] + c * p.sa[1];
        if (vec_in && c + 1 < p.acc_n) {
          const float2 v = *reinterpret_cast<const float2*>(src);
          a = v.x;
          b = v.y;
        } else {
          if (c < p.acc_n) a = src[0];
          if (c + 1 < p.acc_n) b = src[p.sa[1]];
        }
      }
      d[4 * j + 2 * h] = a;
      d[4 * j + 2 * h + 1] = b;
    }
  }

  // the seeded registers are complete before the first product; inside
  // the loop only the products touch them, so they stay in flight
  fence_regs(d);
  for (int it = 0; it < steps; ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    const uint8_t* st = smem + s * STAGE_BYTES;
    const uint64_t da = desc_k_major(st + w * 64 * 128);
    const uint64_t db = desc_mn_major(st + X_BYTES, Y_BOX_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      // A: 32 bytes further along each row; B: 16 rows of 128 bytes further
      wgmma_m64n128k16_ss<1>(d, da + 2 * kk, db + 128 * kk, 1);
    wgmma_commit();
    // the previous stage's products are done: give its buffers back
    wgmma_wait<1>();
    if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(d);

  const bool vec_out = p.so[1] == 1 && p.so[0] % 2 == 0 &&
                       reinterpret_cast<uintptr_t>(p.acc_out) % 8 == 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h, c = c0 + 8 * j;
      if (r >= p.acc_m) continue;
      float* dst = p.acc_out + r * p.so[0] + c * p.so[1];
      const float a = d[4 * j + 2 * h], b = d[4 * j + 2 * h + 1];
      if (vec_out && c + 1 < p.acc_n) {
        *reinterpret_cast<float2*>(dst) = make_float2(a, b);
      } else {
        if (c < p.acc_n) dst[0] = a;
        if (c + 1 < p.acc_n) dst[p.so[1]] = b;
      }
    }
  }
}

cudaError_t launch(const GemmParams& p, int K, cudaStream_t stream) {
  if (p.sx[1] != 1 || p.sy[1] != 1 || p.lo % BK != 0)
    return cudaErrorInvalidValue;
  CUtensorMap map_x, map_y;
  const long long dx[2] = {K, p.m}, dy[2] = {p.n, K};
  const int bx[2] = {BK, BM}, by[2] = {64, BK};
  cudaError_t err = make_bf16_map(&map_x, p.x, 2, dx, &p.sx[0], bx);
  if (err != cudaSuccess) return err;
  err = make_bf16_map(&map_y, p.y, 2, dy, &p.sy[0], by);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gemm_resume_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.acc_n + BN - 1) / BN, (p.acc_m + BM - 1) / BM);
  gemm_resume_wgmma_kernel<<<grid, NT, SMEM_BYTES, stream>>>(map_x, map_y,
                                                             p);
  return cudaGetLastError();
}

}  // namespace wg

GemmParams make_params(const void* x, const void* y, const float* acc_in,
                       float* acc_out, int M, int N, int accM, int accN,
                       int lo, int hi, const long long* strides) {
  GemmParams p;
  p.x = x;
  p.y = y;
  p.acc_in = acc_in;
  p.acc_out = acc_out;
  p.m = M;
  p.n = N;
  p.acc_m = accM;
  p.acc_n = accN;
  p.lo = lo;
  p.hi = hi;
  for (int i = 0; i < 2; ++i) {
    p.sx[i] = strides[i];
    p.sy[i] = strides[2 + i];
    p.sa[i] = strides[4 + i];
    p.so[i] = strides[6 + i];
  }
  return p;
}

}  // namespace
}  // namespace prema

// x (M,K), y (K,N); acc_in, acc_out (accM, accN) f32 with accM >= M, accN
// >= N, and acc_out either acc_in itself or a tensor that does not overlap
// it.  `strides` holds x, y, acc_in, acc_out as (row, column), 8 values.
// Adds reduction rows [lo, hi) (0 <= lo < hi <= K) into the accumulator.
// Launches on `stream`; returns cudaGetLastError().
//
// f32 x and y, any strides: the CUDA-core kernel.
extern "C" int prema_matmul_resumable(int dtype, const void* x, const void* y,
                                      const float* acc_in, float* acc_out,
                                      int M, int N, int accM, int accN, int lo,
                                      int hi, const long long* strides,
                                      void* stream) {
  using namespace prema;
  if (dtype != kFloat32) return static_cast<int>(cudaErrorInvalidValue);
  const GemmParams p = make_params(x, y, acc_in, acc_out, M, N, accM, accN,
                                   lo, hi, strides);
  return static_cast<int>(simt::launch(p, static_cast<cudaStream_t>(stream)));
}

// bf16 x and y with unit column strides, row strides of a multiple of 16
// bytes and 16-byte aligned bases (what TMA reads), lo a multiple of 64:
// the wgmma kernel.
extern "C" int prema_matmul_resumable_wgmma(const void* x, const void* y,
                                            const float* acc_in,
                                            float* acc_out, int M, int N,
                                            int K, int accM, int accN, int lo,
                                            int hi, const long long* strides,
                                            void* stream) {
  using namespace prema;
  const GemmParams p = make_params(x, y, acc_in, acc_out, M, N, accM, accN,
                                   lo, hi, strides);
  return static_cast<int>(wg::launch(p, K, static_cast<cudaStream_t>(stream)));
}
