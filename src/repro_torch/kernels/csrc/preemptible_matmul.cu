// Preemptible GEMM for Hopper: the paper's GEMM_OP preemption point.
//
// Replaces the TPU Pallas kernel
// src/repro/kernels/preemptible_matmul/kernel.py (_matmul_kernel, launched
// by matmul_resumable_raw).  Same function: run reduction rows [lo, hi) of
// x @ y into an f32 accumulator that the previous launch left behind,
//   acc_out[i, j] = acc_in[i, j] + sum_{k in [lo, hi)} x[i, k] * y[k, j],
// with x and y f32 or bf16 (widened exactly) and the sum in f32.  A
// checkpoint is (accumulator, next K tile): the analogue of the paper's
// ACCQ, saved between launches in device memory.
//
// The resume contract is bitwise: any split of [0, K) into launches gives
// the accumulator of one uninterrupted launch, bit for bit.  So each output
// element is one f32 register, seeded from acc_in and updated by fmaf in
// ascending k, the same sequence wherever a launch starts or stops; a
// stored and reloaded f32 is exact.  No split-K, no atomics, no TF32.
//
// What bounds it on the card: operations.  At qwen3-8b's down projection of
// a 2048-token prefill (2048 x 12288 x 4096) the GEMM is 2.06e11 FLOP over
// 150 MB of bf16 inputs, far above the ~295 FLOP/byte balance point.  This
// first version keeps every product on the f32 CUDA cores (67 TFLOP/s, not
// the tensor cores' 989), so it is far from that bound; wgmma and TMA come
// later.  Each launch also reads and writes the whole accumulator, which
// is what a preemption point costs: at that shape 64 MB per launch.
//
// Design against that bound: one block owns a 128 x 128 output tile and
// keeps it in registers (8 x 8 per thread) for its whole K loop, so each
// x and y element is read from memory once per 128 outputs.  Tiles of 16
// reduction rows are staged through shared memory, x transposed, and the
// next tile is loaded into registers while the current one is used.  The
// TPU kernel's sequential K grid dimension is that loop here.  Ragged M, N
// and K are masked in the kernel and x, y are read through their strides,
// so the wrapper never pads or copies them.  The accumulator may be larger
// than M x N (the checkpoint keeps the reference's padded shape); its extra
// rows and columns pass through unchanged.
#include "common.cuh"

namespace prema {
namespace {

constexpr int BM = 128;       // output rows per block
constexpr int BN = 128;       // output columns per block
constexpr int BK = 16;        // reduction rows per shared tile
constexpr int NT = 256;       // threads: 16 x 16, each an 8 x 8 micro-tile
constexpr int PAD = 4;        // keeps float4 alignment, spreads the stores
constexpr int LX = BM * BK / NT;  // x elements each thread stages per tile
constexpr int LY = BK * BN / NT;  // y elements each thread stages per tile
static_assert(BM == BN && BM == 128 && NT == 256, "sub() assumes this tiling");

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

// Row (or column) of micro-tile entry i for thread coordinate t: 4 rows at
// 4t and 4 at 64 + 4t, so both halves are read as aligned float4s.
__device__ __forceinline__ int sub(int t, int i) {
  return (i < 4 ? 0 : 60) + 4 * t + i;
}

template <typename T>
__global__ void __launch_bounds__(NT) gemm_resume_kernel(const GemmParams p) {
  __shared__ __align__(16) float Xs[BK][BM + PAD];  // x tile, transposed
  __shared__ __align__(16) float Ys[BK][BN + PAD];
  const T* x = static_cast<const T*>(p.x);
  const T* y = static_cast<const T*>(p.y);
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

  // raw elements, widened only when stored to shared memory, so the
  // products never wait for the next tile's loads
  T xr[LX], yr[LY];
  const T zero = from_float<T>(0.f);
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < LX; ++i) {
      const int e = tid + NT * i, r = row0 + e / BK, k = k0 + e % BK;
      xr[i] = (r < p.m && k < p.hi) ? x[r * p.sx[0] + k * p.sx[1]] : zero;
    }
#pragma unroll
    for (int i = 0; i < LY; ++i) {
      const int e = tid + NT * i, k = k0 + e / BN, c = col0 + e % BN;
      yr[i] = (k < p.hi && c < p.n) ? y[k * p.sy[0] + c * p.sy[1]] : zero;
    }
  };

  load(p.lo);
  for (int k0 = p.lo; k0 < p.hi; k0 += BK) {
    __syncthreads();  // every thread is done reading the previous tile
#pragma unroll
    for (int i = 0; i < LX; ++i) {
      const int e = tid + NT * i;
      Xs[e % BK][e / BK] = to_float(xr[i]);
    }
#pragma unroll
    for (int i = 0; i < LY; ++i) {
      const int e = tid + NT * i;
      Ys[e / BN][e % BN] = to_float(yr[i]);
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

template <typename T>
cudaError_t launch(const GemmParams& p, cudaStream_t stream) {
  const dim3 grid((p.acc_n + BN - 1) / BN, (p.acc_m + BM - 1) / BM);
  gemm_resume_kernel<T><<<grid, NT, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace prema

// x (M,K), y (K,N) of one element type; acc_in, acc_out (accM, accN) f32
// with accM >= M, accN >= N, and acc_out either acc_in itself or a tensor
// that does not overlap it.  All with arbitrary strides: `strides` holds
// x, y, acc_in, acc_out as (row, column), 8 values.  Adds reduction rows
// [lo, hi) (0 <= lo < hi <= K) into the accumulator.  Launches on `stream`;
// returns cudaGetLastError().
extern "C" int prema_matmul_resumable(int dtype, const void* x, const void* y,
                                      const float* acc_in, float* acc_out,
                                      int M, int N, int accM, int accN, int lo,
                                      int hi, const long long* strides,
                                      void* stream) {
  using namespace prema;
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kFloat32)
    err = launch<float>(p, st);
  else if (dtype == kBFloat16)
    err = launch<__nv_bfloat16>(p, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
