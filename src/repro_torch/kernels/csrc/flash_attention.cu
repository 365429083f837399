// Prefill (flash) attention for Hopper, forward only.
//
// Replaces the TPU Pallas kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, launched by flash_attention_raw).  Same function: query
// head h reads KV head h / (Hq / Hkv); scores in f32 scaled by D^-0.5;
// running max, normaliser and accumulator in f32; masked scores -1e30;
// causal mode (key <= query row) skips the tiles past the diagonal; ragged
// keys past t_len masked; output acc / max(l, 1e-30) in q's type.  The
// tensors are read and written through their strides, so the model's
// (B,S,H,D) tensors need no transpose copy.  The TPU kernel's sequential
// grid carried m, l, acc from one KV step to the next; here the KV loop
// runs inside the block, and with the causal mask the heaviest query tiles
// are scheduled first.
//
// What bounds it on the card: operations.  At the serving path's shapes
// (S = T = 2048, 32 query heads, D = 128, causal) it does 4*Hq*D*S(S+1)/2
// = 34 GFLOP over 42 MB of inputs and output, far above the H100's
// ~295 FLOP/byte balance point.
//
// Two kernels, chosen by the wrapper by dtype and head width:
//
// * bf16 with D = 128, flash_fwd_wgmma_kernel: the tensor cores, in the
//   outline of FlashAttention-3.  A block owns 128 query rows of one head:
//   TMA loads over 4-D maps (D, S, H, B) of the strided tensors (Q once;
//   K and V tiles of 128 keys into a ring of 2 stages, each row as two
//   64-column boxes of the 128-byte swizzle), and two warpgroups of 64 rows
//   that run
//   S = Q K^T as wgmma m64n128k16 from shared memory (K as a K-major B),
//   the online softmax on the f32 accumulator (a row lives in the 4 lanes
//   of a quad), and O += P V as wgmma m64n128k16 with P from registers in
//   bf16 (V as an MN-major B).  P is rounded to bf16 for that product, as
//   the JAX model rounds it to q's type; l sums the f32 P.  The output goes
//   through shared memory and leaves in 16-byte stores.  There is no
//   producer warp: thread 0 refills a stage as soon as both warpgroups are
//   done with it.  A ninth warp would put three warps on one of the SM's
//   four register files and cap every thread at 168 registers, fewer than
//   the two accumulators (S and O, 64 each), the P fragments and the
//   addressing want; with 8 warps a thread may hold 255.
// * f32, and bf16 at other head widths, flash_fwd_simt_kernel: the f32
//   CUDA cores.  A block owns 64 query rows of one head, loops over 32-key
//   tiles widened to f32 in shared memory (rows padded by one float against
//   bank conflicts), and keeps a 4 x 4 score micro-tile and a 4 x D/8 slice
//   of the accumulator per thread.
#include <cuda.h>

#include "common.cuh"
#include "hopper.cuh"

namespace prema {
namespace {

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int s_len, t_len, group, causal;
  long long sq[4], sk[4], sv[4], so[4];  // (b, h, s, d) strides in elements
  float scale;
};

// --------------------------------------------------------------------------
// f32 (any head width) and bf16 at head widths other than 128: CUDA cores
// --------------------------------------------------------------------------
namespace simt {

constexpr int BQ = 64;        // query rows per block
constexpr int BT = 32;        // keys per tile
constexpr int NT = 128;       // threads: 16 row groups x 8 column lanes
constexpr int RQ = BQ / 16;   // query rows per thread
constexpr int CK = BT / 8;    // score columns per thread

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BT * (D + 1) + BT * D + BQ * (BT + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_simt_kernel(
    const FlashParams p) {
  constexpr int DC = D / 8;            // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][D + 1]
  float* Ks = Qs + BQ * (D + 1);       // [BT][D + 1]
  float* Vs = Ks + BT * (D + 1);       // [BT][D]
  float* Ps = Vs + BT * D;             // [BQ][BT + 1]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.group;
  const T* q = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const T* k = static_cast<const T*>(p.k) + b * p.sk[0] + hk * p.sk[1];
  const T* v = static_cast<const T*>(p.v) + b * p.sv[0] + hk * p.sv[1];
  T* o = static_cast<T*>(p.o) + b * p.so[0] + h * p.so[1];
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D, row = q0 + r;
    Qs[r * (D + 1) + d] =
        row < p.s_len ? to_float(q[row * p.sq[2] + d * p.sq[3]]) : 0.f;
  }

  float m[RQ], l[RQ], acc[RQ][DC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (p.t_len + BT - 1) / BT;
  if (p.causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BT + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // Q is loaded; the previous tile's Ks/Vs/Ps are used
    for (int i = tid; i < BT * D; i += NT) {
      const int r = i / D, d = i % D, t = k0 + r;
      const bool live = t < p.t_len;
      Ks[r * (D + 1) + d] = live ? to_float(k[t * p.sk[2] + d * p.sk[3]]) : 0.f;
      Vs[r * D + d] = live ? to_float(v[t * p.sv[2] + d * p.sv[3]]) : 0.f;
    }
    __syncthreads();

    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = Ks[(tx + 8 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax; the 8 lanes tx = 0..7 of a row are consecutive lanes
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int col = k0 + tx + 8 * j;
        const bool live = col < p.t_len && (!p.causal || col <= row);
        s[i][j] = live ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = group_max<8>(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float e = expf(s[i][j] - m_new);
        Ps[r * (BT + 1) + tx + 8 * j] = e;
        rs += e;
      }
      rs = group_sum<8>(rs);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < BT; ++t) {
      float pv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = Ps[(ty + 16 * i) * (BT + 1) + t];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = Vs[t * D + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < RQ; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.s_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      o[row * p.so[2] + (tx + 8 * c) * p.so[3]] = from_float<T>(acc[i][c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const FlashParams& p, int B, int Hq, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_simt_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.s_len + BQ - 1) / BQ, Hq, B);
  flash_fwd_simt_kernel<T, D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const FlashParams& p, int B, int Hq, int D,
                     cudaStream_t stream) {
  switch (D) {
    case 8: return launch<T, 8>(p, B, Hq, stream);
    case 16: return launch<T, 16>(p, B, Hq, stream);
    case 32: return launch<T, 32>(p, B, Hq, stream);
    case 64: return launch<T, 64>(p, B, Hq, stream);
    case 128: return launch<T, 128>(p, B, Hq, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace simt

// --------------------------------------------------------------------------
// bf16, D = 128: wgmma fed by TMA
// --------------------------------------------------------------------------
namespace wg {

using namespace hopper;

constexpr int D = 128;
constexpr int BQ = 128;                     // query rows per block
constexpr int BT = 128;                     // keys per tile
constexpr int NT = 256;                     // 2 warpgroups
constexpr int BOX_BYTES = 128 * 64 * 2;     // 128 rows of 64 columns
constexpr int TILE_BYTES = 2 * BOX_BYTES;   // 128 rows of D = 128
constexpr int OS_STRIDE = D + 8;            // output staging row, elements
constexpr int OS_BYTES = 64 * OS_STRIDE * 2;   // one warpgroup's 64 rows
constexpr int WARPS = NT / 32;              // each frees a stage once
// Q | K0 | V0 | K1 | V1 | output staging x 2 | barriers
constexpr size_t BAR_OFFSET = 5 * TILE_BYTES + 2 * OS_BYTES;
constexpr size_t SMEM_BYTES = BAR_OFFSET + 7 * sizeof(uint64_t) + 1024;
constexpr float kLog2e = 1.4426950408889634f;

__global__ void __launch_bounds__(NT, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, const FlashParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* q_tile = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + BAR_OFFSET);
  uint64_t* q_full = bars;           // [1]
  uint64_t* k_full = bars + 1;       // [2]
  uint64_t* v_full = bars + 3;       // [2]
  uint64_t* empty = bars + 5;        // [2]: K and V of a stage are used

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.group;
  int n_tiles = (p.t_len + BT - 1) / BT;
  if (p.causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BT + 1);
  const int w = warpgroup_index();

  // thread 0 issues every load: K and V of tile `it` into stage it % 2
  auto load_tile = [&](int it) {
    uint8_t* kt = smem + (1 + 2 * (it % 2)) * TILE_BYTES;
    uint8_t* vt = kt + TILE_BYTES;
    uint64_t* kf = &k_full[it % 2];
    uint64_t* vf = &v_full[it % 2];
    const int k0 = it * BT;
    mbar_expect_tx(kf, TILE_BYTES);
    tma_load_4d(kt, &map_k, kf, 0, k0, hk, b);
    tma_load_4d(kt + BOX_BYTES, &map_k, kf, 64, k0, hk, b);
    mbar_expect_tx(vf, TILE_BYTES);
    tma_load_4d(vt, &map_v, vf, 0, k0, hk, b);
    tma_load_4d(vt + BOX_BYTES, &map_v, vf, 64, k0, hk, b);
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, TILE_BYTES);
    tma_load_4d(q_tile, &map_q, q_full, 0, q0, h, b);
    tma_load_4d(q_tile + BOX_BYTES, &map_q, q_full, 64, q0, h, b);
    for (int it = 0; it < min(2, n_tiles); ++it) load_tile(it);
  }
  __syncwarp();

  // warpgroup w owns query rows [64w, 64w + 64) of the block; this thread
  // holds rows lr0 and lr0 + 8, columns 8j + 2(l%4) + e
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int lr0 = 64 * w + 16 * warp + lane / 4;
  const int rows[2] = {q0 + lr0, q0 + lr0 + 8};
  const float scale = p.scale * kLog2e;     // scores in log2 units
  float o[64], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % 2;
    const uint32_t parity = (it / 2) & 1;
    const uint8_t* kt = smem + (1 + 2 * s) * TILE_BYTES;
    const uint8_t* vt = kt + TILE_BYTES;

    // S = Q K^T: D = 128 in 8 k16 steps, 4 per 64-column box
    float sc[64];
    mbar_wait(&k_full[s], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      wgmma_m64n128k16_ss<0>(sc, desc_k_major(q_tile + off + w * 64 * 128),
                             desc_k_major(kt + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // online softmax on the accumulator; mask only where a tile needs it
    const int k0 = it * BT;
    const bool masked = k0 + BT > p.t_len ||
                        (p.causal && k0 + BT - 1 > q0 + 64 * w);
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hh + e;
          float x = sc[i] * scale;
          if (masked) {
            const int key = k0 + 8 * j + 2 * (lane % 4) + e;
            if (key >= p.t_len || (p.causal && key > rows[hh])) x = kNegInf;
          }
          sc[i] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      alpha[hh] = exp2f(m[hh] - m_new);
      m[hh] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hh + e;
          sc[i] = exp2f(sc[i] - m_new);
          rs += sc[i];
        }
      }
      l[hh] = alpha[hh] * l[hh] + rs;   // this thread's columns only
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }

    // P in bf16 as the A operand: key step kk covers accumulator columns
    // 16kk .. 16kk + 15, that is sc[8kk .. 8kk + 7]
    uint32_t pa[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);

    // O += P V: 128 keys in 8 k16 steps of 16 rows of V
    mbar_wait(&v_full[s], parity);
    wgmma_fence();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                             pa[4 * kk + 3]};
      wgmma_m64n128k16_rs<1>(o, a, desc_mn_major(vt + kk * 2048, BOX_BYTES),
                             1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(&empty[s]);
    // both warpgroups are done with this stage: refill it two tiles on
    if (threadIdx.x == 0 && it + 2 < n_tiles) {
      mbar_wait(&empty[s], parity);
      load_tile(it + 2);
    }
    __syncwarp();
  }

  // epilogue: normalise, stage the warpgroup's 64 rows in shared memory,
  // leave in 16-byte stores masked on ragged S
  __nv_bfloat16* os =
      reinterpret_cast<__nv_bfloat16*>(smem + 5 * TILE_BYTES + w * OS_BYTES);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const float denom = fmaxf(l[hh], 1e-30f);
    const int r = 16 * warp + lane / 4 + 8 * hh;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(&os[r * OS_STRIDE + c]) =
          __floats2bfloat162_rn(o[4 * j + 2 * hh] / denom,
                                o[4 * j + 2 * hh + 1] / denom);
    }
  }
  warpgroup_sync(1 + w);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + b * p.so[0] +
                       h * p.so[1];
#pragma unroll
  for (int i = 0; i < 64 * D / 8 / 128; ++i) {
    const int chunk = t + 128 * i, r = chunk / (D / 8);
    const int c = 8 * (chunk % (D / 8)), row = q0 + 64 * w + r;
    if (row < p.s_len)
      *reinterpret_cast<uint4*>(out + row * p.so[2] + c) =
          *reinterpret_cast<const uint4*>(&os[r * OS_STRIDE + c]);
  }
}

cudaError_t launch(const FlashParams& p, int B, int Hq, int Hkv,
                   cudaStream_t stream) {
  if (p.sq[3] != 1 || p.sk[3] != 1 || p.sv[3] != 1 || p.so[3] != 1)
    return cudaErrorInvalidValue;
  CUtensorMap map_q, map_k, map_v;
  // dims (D, S, H, B); strides of S, H, B
  const long long dq[4] = {D, p.s_len, Hq, B}, dk[4] = {D, p.t_len, Hkv, B};
  const long long st_q[3] = {p.sq[2], p.sq[1], p.sq[0]},
                  st_k[3] = {p.sk[2], p.sk[1], p.sk[0]},
                  st_v[3] = {p.sv[2], p.sv[1], p.sv[0]};
  const int box[4] = {64, 128, 1, 1};
  cudaError_t err = make_bf16_map(&map_q, p.q, 4, dq, st_q, box);
  if (err == cudaSuccess) err = make_bf16_map(&map_k, p.k, 4, dk, st_k, box);
  if (err == cudaSuccess) err = make_bf16_map(&map_v, p.v, 4, dk, st_v, box);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.s_len + BQ - 1) / BQ, Hq, B);
  flash_fwd_wgmma_kernel<<<grid, NT, SMEM_BYTES, stream>>>(map_q, map_k,
                                                           map_v, p);
  return cudaGetLastError();
}

}  // namespace wg

FlashParams make_params(const void* q, const void* k, const void* v, void* o,
                        int Hq, int Hkv, int S, int T,
                        const long long* strides, float scale, int causal) {
  FlashParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.s_len = S;
  p.t_len = T;
  p.group = Hq / Hkv;
  p.causal = causal;
  for (int i = 0; i < 4; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[4 + i];
    p.sv[i] = strides[8 + i];
    p.so[i] = strides[12 + i];
  }
  p.scale = scale;
  return p;
}

}  // namespace
}  // namespace prema

// q (B,Hq,S,D), k/v (B,Hkv,T,D), o (B,Hq,S,D), all of one element type and
// with arbitrary strides: `strides` holds 16 values, (b, h, s, d) for q, k,
// v and o in that order.  Launches on `stream`; returns cudaGetLastError().
//
// The CUDA-core kernel: f32 or bf16, D in {8, 16, 32, 64, 128}.
extern "C" int prema_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* o, int B, int Hq,
                                     int Hkv, int S, int T, int D,
                                     const long long* strides, float scale,
                                     int causal, void* stream) {
  using namespace prema;
  const FlashParams p =
      make_params(q, k, v, o, Hq, Hkv, S, T, strides, scale, causal);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kFloat32)
    err = simt::launch_d<float>(p, B, Hq, D, st);
  else if (dtype == kBFloat16)
    err = simt::launch_d<__nv_bfloat16>(p, B, Hq, D, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The wgmma kernel: bf16, D = 128, unit innermost strides, the other
// strides multiples of 8 elements and 16-byte aligned bases (what TMA reads
// and the epilogue's 16-byte stores write).
extern "C" int prema_flash_attention_wgmma(const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int Hq, int Hkv, int S, int T,
                                           const long long* strides,
                                           float scale, int causal,
                                           void* stream) {
  using namespace prema;
  const FlashParams p =
      make_params(q, k, v, o, Hq, Hkv, S, T, strides, scale, causal);
  return static_cast<int>(
      wg::launch(p, B, Hq, Hkv, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* prema_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
