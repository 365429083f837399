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
//   ascending k (TF32 products would miss the f32 tolerance), so the bound
//   is the 67 TFLOP/s of f32 FMA.  One block of 256 threads owns a 128 x
//   128 tile, each thread an 8 x 8 micro-tile of registers fed by 16-byte
//   shared reads (8 of x along k and 8 of y for every 4 x 64 products).
//   Stages of 64 reduction rows (x row-major, rows padded by 16 bytes; y
//   row-major) are filled by cp.async into a ring of 3, two in flight
//   while one is used, with one barrier per stage: deep stages, because
//   with one block of 8 warps per SM (200 KB of shared memory, up to 255
//   registers, so no spills) every barrier stalls the whole SM.  The 512
//   tiles of qwen3-8b's 2048 x 4096 output take 3.88 waves of 132 SMs.  x
//   and y with unit column strides and 16-byte aligned rows, in launches
//   that start on a multiple of 4 rows, are copied 16 bytes at a time,
//   zeros filled past M, N and hi; any other launch copies one element at
//   a time through the strides into the same ring.  A zero-filled row adds
//   fmaf(0, 0, a) == a, so only an accumulator of -0 can differ between
//   splits of the range (it may leave as +0).
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

constexpr int TX = 16;        // threads along the columns of a block
constexpr int TY = 16;        // threads along the rows
constexpr int TN = 8;         // a thread's columns, in groups of 4
constexpr int NT = TX * TY;
constexpr int BM = 8 * TY;    // output rows per block: 8 per thread
constexpr int BN = TN * TX;   // output columns per block
constexpr int BK = 64;        // reduction rows per stage
constexpr int STAGES = 3;     // stages in the shared-memory ring
constexpr int XP = BK + 4;    // x row pitch: neighbouring rows in other banks
constexpr int X_FLOATS = BM * XP;   // x stage, row-major [BM][XP]
constexpr int Y_FLOATS = BK * BN;   // y stage, row-major [BK][BN]
constexpr size_t SMEM_BYTES =
    STAGES * (X_FLOATS + Y_FLOATS) * sizeof(float);
static_assert(TN % 4 == 0 && BM * BK % (4 * NT) == 0 &&
              BK * BN % (4 * NT) == 0, "whole 16-byte copies per thread");
static_assert(BK % 4 == 0, "x is staged and read in 16-byte pieces of 4 k");

// Stage reduction rows [k0, k0 + BK) of x (rows row0..) and y (columns
// col0..) by cp.async, zeros past m, n and hi.  VEC: 16-byte copies, for
// unit column strides, 16-byte aligned rows and k0 a multiple of 4; else
// one 4-byte copy per element, through any strides.
template <bool VEC>
__device__ __forceinline__ void load_stage(const GemmParams& p, float* xs,
                                           float* ys, int k0, int row0,
                                           int col0) {
  const float* x = static_cast<const float*>(p.x);
  const float* y = static_cast<const float*>(p.y);
  const int tid = threadIdx.x;
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < BM * BK / 4 / NT; ++i) {
      const int e = tid + NT * i, r = e / (BK / 4), c = 4 * (e % (BK / 4));
      const int gr = row0 + r, k = k0 + c;
      const int live = gr < p.m ? min(max(p.hi - k, 0), 4) : 0;
      cp_async16(xs + r * XP + c, live ? x + gr * p.sx[0] + k : x, 4 * live);
    }
#pragma unroll
    for (int i = 0; i < BK * BN / 4 / NT; ++i) {
      const int e = tid + NT * i, r = e / (BN / 4), c = 4 * (e % (BN / 4));
      const int k = k0 + r, gc = col0 + c;
      const int live = k < p.hi ? min(max(p.n - gc, 0), 4) : 0;
      cp_async16(ys + r * BN + c, live ? y + k * p.sy[0] + gc : y, 4 * live);
    }
  } else {   // a slow path: not unrolled, to keep registers for the sums
#pragma unroll 1
    for (int i = 0; i < BM * BK / NT; ++i) {
      const int e = tid + NT * i, r = e / BK, c = e % BK;
      const int gr = row0 + r, k = k0 + c;
      const bool live = gr < p.m && k < p.hi;
      cp_async4(xs + r * XP + c, live ? x + gr * p.sx[0] + k * p.sx[1] : x,
                live ? 4 : 0);
    }
#pragma unroll 1
    for (int i = 0; i < BK * BN / NT; ++i) {
      const int e = tid + NT * i, r = e / BN, c = e % BN;
      const int k = k0 + r, gc = col0 + c;
      const bool live = k < p.hi && gc < p.n;
      cp_async4(ys + r * BN + c, live ? y + k * p.sy[0] + gc * p.sy[1] : y,
                live ? 4 : 0);
    }
  }
}

// Whether the accumulator entries at a..a+3 (columns c..c+3) are one
// aligned float4.
__device__ __forceinline__ bool acc_vec(const float* a, const long long* s,
                                        int c, int acc_n) {
  return s[1] == 1 && c + 4 <= acc_n &&
         reinterpret_cast<uintptr_t>(a) % 16 == 0;
}

// Thread (tx, ty) = (tid % TX, tid / TX) owns rows ty + TY i, i < 8, and
// columns 4 (tx + TX g) + e, g < TN / 4, e < 4, of the block's tile: per
// reduction row 8 values of x and TN of y feed 8 TN products, read as
// 16-byte broadcasts (x, along k) and 16-byte reads of consecutive
// columns (y).
template <bool VEC>
__global__ void __launch_bounds__(NT, 1) gemm_resume_simt_kernel(
    const GemmParams p) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                        // [STAGES][BM][XP]
  float* ys = smem + STAGES * X_FLOATS;    // [STAGES][BK][BN]
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int n_tiles = (p.hi - p.lo + BK - 1) / BK;

  // the first STAGES - 1 tiles go in flight before acc_in is read
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles)
      load_stage<VEC>(p, xs + s * X_FLOATS, ys + s * Y_FLOATS,
                      p.lo + s * BK, row0, col0);
    cp_async_commit();
  }

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + ty + TY * i;
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const int c = col0 + 4 * (tx + TX * g);
      const float* src = p.acc_in + r * p.sa[0] + c * p.sa[1];
      if (r < p.acc_m && acc_vec(src, p.sa, c, p.acc_n)) {
        const float4 v = *reinterpret_cast<const float4*>(src);
        acc[i][4 * g] = v.x;
        acc[i][4 * g + 1] = v.y;
        acc[i][4 * g + 2] = v.z;
        acc[i][4 * g + 3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][4 * g + e] =
              (r < p.acc_m && c + e < p.acc_n) ? src[e * p.sa[1]] : 0.f;
      }
    }
  }

  // One barrier per stage: after it, tile t has landed for every thread
  // and every thread is done with tile t - 1, whose slot is refilled.
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = t + STAGES - 1;
    if (next < n_tiles)
      load_stage<VEC>(p, xs + (next % STAGES) * X_FLOATS,
                      ys + (next % STAGES) * Y_FLOATS, p.lo + next * BK,
                      row0, col0);
    cp_async_commit();
    const float* xt = xs + (t % STAGES) * X_FLOATS;
    const float* yt = ys + (t % STAGES) * Y_FLOATS;
    // rows past hi were staged as zeros: fmaf(0, 0, a) == a
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float a[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(
            &xt[(ty + TY * i) * XP + kq]);
        a[i][0] = v.x;
        a[i][1] = v.y;
        a[i][2] = v.z;
        a[i][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* yr = yt + (kq + kk) * BN + 4 * tx;
        float b[TN];
#pragma unroll
        for (int g = 0; g < TN / 4; ++g) {
          const float4 v = *reinterpret_cast<const float4*>(&yr[4 * TX * g]);
          b[4 * g] = v.x;
          b[4 * g + 1] = v.y;
          b[4 * g + 2] = v.z;
          b[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + ty + TY * i;
    if (r >= p.acc_m) continue;
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const int c = col0 + 4 * (tx + TX * g);
      float* dst = p.acc_out + r * p.so[0] + c * p.so[1];
      if (acc_vec(dst, p.so, c, p.acc_n)) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                        acc[i][4 * g + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < p.acc_n) dst[e * p.so[1]] = acc[i][4 * g + e];
      }
    }
  }
}

template <bool VEC>
cudaError_t launch_as(const GemmParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_resume_simt_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.acc_n + BN - 1) / BN, (p.acc_m + BM - 1) / BM);
  gemm_resume_simt_kernel<VEC><<<grid, NT, SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch(const GemmParams& p, cudaStream_t stream) {
  const bool vec = p.sx[1] == 1 && p.sy[1] == 1 && p.sx[0] % 4 == 0 &&
                   p.sy[0] % 4 == 0 && p.lo % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(p.x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.y) % 16 == 0;
  return vec ? launch_as<true>(p, stream) : launch_as<false>(p, stream);
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
