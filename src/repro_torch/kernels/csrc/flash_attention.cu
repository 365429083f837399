// Prefill (flash) attention for Hopper, forward only.
//
// Replaces the TPU Pallas kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, launched by flash_attention_raw).  Same function: query
// head h reads KV head h / (Hq / Hkv); scores in f32 scaled by D^-0.5;
// running max, normaliser and accumulator in f32; masked scores -1e30;
// causal mode (key <= query row + q_offset, where the rows are a block of
// the sequence that starts at q_offset) skips the tiles past the diagonal;
// ragged
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
// * bf16 with D in {64, 80, 128}, flash_fwd_wgmma_kernel<D>: the tensor
//   cores, in the outline of FlashAttention-3.  A block owns 128 query rows
//   of one head: TMA loads over 4-D maps (D, S, H, B) of the strided
//   tensors (Q once; K and V tiles of 128 keys into a ring of 2 stages,
//   each row as two 64-column boxes of the 128-byte swizzle), and two
//   warpgroups of 64 rows that run
//   S = Q K^T as D / 16 steps of wgmma m64n128k16 from shared memory (K as
//   a K-major B),
//   the online softmax on the f32 accumulator (a row lives in the 4 lanes
//   of a quad), and O += P V as wgmma m64nDk16 with P from registers in
//   bf16 (V as an MN-major B).  P is rounded to bf16 for that product, as
//   the JAX model rounds it to q's type; l sums the f32 P.  The output goes
//   through shared memory and leaves in 16-byte stores.  There is no
//   producer warp: thread 0 refills a stage as soon as both warpgroups are
//   done with it.  A ninth warp would put three warps on one of the SM's
//   four register files and cap every thread at 168 registers, fewer than
//   the two accumulators (S and O, 64 each at D = 128), the P fragments
//   and the addressing want; with 8 warps a thread may hold 255.
//   The narrower widths keep D = 128's shared-memory layout: the maps'
//   innermost extent is D, so at D = 80 TMA fills columns 80..127 of the
//   second box with zeros (and reads nothing past D from memory), and the
//   products never read them: S takes 5 k16 steps, the fifth at the start
//   of the second box, and P V at N = 80 reads that box's first 16
//   columns.  D = 64 loads the first box alone.  The products then do
//   exactly D's work; O holds D / 2 registers a thread.
// * f32 at every width, and bf16 at D 8, 16 and 32 (the tiny configs),
//   flash_fwd_simt_kernel: the f32 CUDA cores, one fmaf per product (TF32
//   would miss the f32 tolerance), so the bound is the 67 TFLOP/s of f32
//   FMA and the design feeds the FMA units.  A block of 8 warps owns 128
//   query rows of one head, in f32 at D = 128 one per SM with 227 KB of
//   shared memory.  Q is staged once; K and V tiles of 64 keys are staged
//   raw (bf16 widened when read) by 16-byte cp.async into two slots, the
//   next tile in flight while the current one is used, with one barrier
//   per tile.  Each thread holds an 8 x 4 tile of scores (8 rows, 4 keys)
//   and an 8 x 8 tile of the accumulator (8 rows, 8 columns at D = 128),
//   both fed by 16-byte shared reads.  A warp's 16 rows never need another
//   warp: row maxima and sums are shuffles within a half-warp, and P goes
//   through the warp's own rows of shared memory behind a __syncwarp.  The
//   f32 Q alone takes 64 KB at 128 rows, so more rows per SM, and with
//   them more warps, do not fit beside double-buffered 64-key K and V
//   tiles; each warp instead keeps 32 independent sums in flight.
#include <cuda.h>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace prema {
namespace {

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // causal: key j is visible to query row i iff j <= i + q_offset (the rows
  // are a block of a longer sequence that starts at q_offset)
  int s_len, t_len, group, causal, q_offset;
  long long sq[4], sk[4], sv[4], so[4];  // (b, h, s, d) strides in elements
  float scale;
};

// --------------------------------------------------------------------------
// f32, and bf16 at D 8, 16, 32: the CUDA cores
// --------------------------------------------------------------------------
namespace simt {

constexpr int BQ = 128;       // query rows per block: 8 warps of 16
constexpr int BT = 64;        // keys per tile
constexpr int NT = 256;
constexpr int RQ = 8;         // query rows per thread
constexpr int CK = BT / 16;   // keys per thread in S: c, c + 16, ...
constexpr float kLog2e = 1.4426950408889634f;

// One block's shared memory.  Q: BQ rows of D elements of T, 16 bytes more
// after every 8 rows; K: 2 slots of BT rows of D + 16 bytes; V: 2 slots of
// BT rows of D; P (f32): BQ rows of BT, 16 bytes more after every 8 rows.
// The 16 bytes after 8 rows put the two 8-row groups of a warp, which read
// one row each at the same column, into different banks; K's padded rows
// put the 16 keys that a half-warp reads into as few passes as 16-byte
// reads allow.
template <typename T, int D>
struct Smem {
  static constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte copy
  static constexpr int KP = D + VEC;           // K row pitch
  static constexpr size_t Q = (BQ * D + BQ / 8 * VEC) * sizeof(T);
  static constexpr size_t K = BT * KP * sizeof(T);
  static constexpr size_t V = BT * D * sizeof(T);
  static constexpr size_t P = (BQ * BT + BQ / 8 * 4) * sizeof(float);
  static constexpr size_t BYTES = Q + 2 * (K + V) + P;
  __device__ static int q_row(int r) { return r * D + (r >> 3) * VEC; }
  __device__ static int p_row(int r) { return r * BT + (r >> 3) * 4; }
};

// 4 consecutive elements of shared memory (16 bytes of f32, 8 of bf16)
// widened to f32, and 4 f32 values stored as 4 elements
__device__ __forceinline__ void ld4(const float* s, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ void ld4(const __nv_bfloat16* s, float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(s);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.y));
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}

__device__ __forceinline__ void st4(float* d, const float (&x)[4]) {
  *reinterpret_cast<float4*>(d) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void st4(__nv_bfloat16* d, const float (&x)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
  *reinterpret_cast<uint2*>(d) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                 *reinterpret_cast<const uint32_t*>(&b));
}

// Warp w owns query rows [16w, 16w + 16) of the block; lane l takes the 8
// rows r0 = 16w + 8(l / 16) .. r0 + 7 with c = l % 16.  In S = Q K^T it
// holds keys c + 16j (j < 4) of each row, so a row's maximum and sum are
// reductions over the 16 lanes of a half-warp and P never leaves the warp;
// in O += P V it holds columns 4(c + 16g) .. + 3 (g < DG).
template <typename T, int D>
__global__ void __launch_bounds__(NT, 1) flash_fwd_simt_kernel(
    const FlashParams p) {
  using S = Smem<T, D>;
  constexpr int VEC = S::VEC, KP = S::KP;
  constexpr int CH = D / VEC;               // 16-byte copies per row
  constexpr int DG = (D / 4 + 15) / 16;     // 4-column groups of O per lane
  extern __shared__ __align__(16) uint8_t smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = reinterpret_cast<T*>(smem + S::Q);
  T* vs = reinterpret_cast<T*>(smem + S::Q + 2 * S::K);
  float* ps = reinterpret_cast<float*>(smem + S::Q + 2 * (S::K + S::V));

  const int h = blockIdx.x, b = blockIdx.z, hk = h / p.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const T* q = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const T* k = static_cast<const T*>(p.k) + b * p.sk[0] + hk * p.sk[1];
  const T* v = static_cast<const T*>(p.v) + b * p.sv[0] + hk * p.sv[1];
  T* o = static_cast<T*>(p.o) + b * p.so[0] + h * p.so[1];
  const int tid = threadIdx.x, lane = tid % 32, c = lane % 16;
  const int r0 = (tid / 32) * 16 + (lane / 16) * 8;

  int n_tiles = (p.t_len + BT - 1) / BT;
  if (p.causal) n_tiles = min(n_tiles, (q0 + BQ - 1 + p.q_offset) / BT + 1);

  // K and V rows of tile `it` into slot it % 2, by 16-byte cp.async,
  // zeros past t_len
  auto load_kv = [&](int it) {
    T* kd = ks + (it % 2) * BT * KP;
    T* vd = vs + (it % 2) * BT * D;
#pragma unroll
    for (int i = 0; i < (BT * CH + NT - 1) / NT; ++i) {
      const int e = tid + NT * i;
      if (BT * CH % NT != 0 && e >= BT * CH) break;
      const int r = e / CH, cc = (e % CH) * VEC, t = it * BT + r;
      const bool live = t < p.t_len;
      cp_async16(kd + r * KP + cc, live ? k + t * p.sk[2] + cc : k,
                 live ? 16 : 0);
      cp_async16(vd + r * D + cc, live ? v + t * p.sv[2] + cc : v,
                 live ? 16 : 0);
    }
  };
#pragma unroll
  for (int i = 0; i < (BQ * CH + NT - 1) / NT; ++i) {
    const int e = tid + NT * i;
    if (BQ * CH % NT != 0 && e >= BQ * CH) break;
    const int r = e / CH, cc = (e % CH) * VEC, row = q0 + r;
    const bool live = row < p.s_len;
    cp_async16(qs + S::q_row(r) + cc, live ? q + row * p.sq[2] + cc : q,
               live ? 16 : 0);
  }
  load_kv(0);
  cp_async_commit();

  const T* qr = qs + S::q_row(r0);          // this lane's rows, D apart
  float* pr = ps + S::p_row(r0);            // and its rows of P, BT apart
  const float scale = p.scale * kLog2e;     // scores in log2 units
  float m[RQ], l[RQ], acc[RQ][DG][4];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < DG; ++g)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[i][g][x] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    // one barrier per tile: tile it has landed for every thread, and every
    // thread is done with tile it - 1, whose slot now takes tile it + 1
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_tiles) load_kv(it + 1);
    cp_async_commit();
    const T* kt = ks + (it % 2) * BT * KP;
    const T* vt = vs + (it % 2) * BT * D;

    // S = Q K^T, each score summed over d in ascending order
    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float kv[CK][4];
#pragma unroll
      for (int j = 0; j < CK; ++j) ld4(kt + (c + 16 * j) * KP + d, kv[j]);
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        float qv[4];
        ld4(qr + i * D + d, qv);
#pragma unroll
        for (int j = 0; j < CK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][j] = fmaf(qv[e], kv[j][e], s[i][j]);
      }
    }

    // online softmax; masks only where the tile needs them
    const int k0 = it * BT;
    const bool masked =
        k0 + BT > p.t_len || (p.causal && k0 + BT - 1 > q0 + r0 + p.q_offset);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = q0 + r0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        float x = s[i][j] * scale;
        if (masked) {
          const int key = k0 + c + 16 * j;
          if (key >= p.t_len || (p.causal && key > row + p.q_offset))
            x = kNegInf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = group_max<16>(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      m[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float e = exp2f(s[i][j] - m_new);
        pr[i * BT + c + 16 * j] = e;
        rs += e;
      }
      l[i] = alpha * l[i] + rs;   // this lane's keys; lanes summed at the end
#pragma unroll
      for (int g = 0; g < DG; ++g)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[i][g][x] *= alpha;
    }
    __syncwarp();   // the warp's rows of P are written

    // O += P V, each output summed over the keys in ascending order
#pragma unroll 2
    for (int t = 0; t < BT; t += 4) {
      float pv[RQ][4];
#pragma unroll
      for (int i = 0; i < RQ; ++i) ld4(pr + i * BT + t, pv[i]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float vv[DG][4];
#pragma unroll
        for (int g = 0; g < DG; ++g) {
          const int col = 4 * (c + 16 * g);
          if (D % 64 == 0 || col < D) {
            ld4(vt + (t + e) * D + col, vv[g]);
          } else {
#pragma unroll
            for (int x = 0; x < 4; ++x) vv[g][x] = 0.f;
          }
        }
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int g = 0; g < DG; ++g)
#pragma unroll
            for (int x = 0; x < 4; ++x)
              acc[i][g][x] = fmaf(pv[i][e], vv[g][x], acc[i][g][x]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const float denom = fmaxf(group_sum<16>(l[i]), 1e-30f);
    const int row = q0 + r0 + i;
    if (row >= p.s_len) continue;
#pragma unroll
    for (int g = 0; g < DG; ++g) {
      const int col = 4 * (c + 16 * g);
      if (D % 64 != 0 && col >= D) continue;
      float out[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) out[x] = acc[i][g][x] / denom;
      st4(o + row * p.so[2] + col, out);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const FlashParams& p, int B, int Hq, cudaStream_t stream) {
  constexpr size_t smem = Smem<T, D>::BYTES;
  static_assert(smem <= 232448, "more shared memory than a block may use");
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_simt_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(Hq, (p.s_len + BQ - 1) / BQ, B);
  flash_fwd_simt_kernel<T, D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

// rows of 16-byte pieces: unit innermost stride, the other strides and the
// base multiples of 16 bytes
template <typename T>
bool rows16(const void* base, const long long* s) {
  constexpr int VEC = 16 / sizeof(T);
  return s[3] == 1 && s[0] % VEC == 0 && s[1] % VEC == 0 && s[2] % VEC == 0 &&
         reinterpret_cast<uintptr_t>(base) % 16 == 0;
}

template <typename T>
cudaError_t launch_d(const FlashParams& p, int B, int Hq, int D,
                     cudaStream_t stream) {
  if (!rows16<T>(p.q, p.sq) || !rows16<T>(p.k, p.sk) ||
      !rows16<T>(p.v, p.sv) || !rows16<T>(p.o, p.so))
    return cudaErrorInvalidValue;
  switch (D) {
    case 8: return launch<T, 8>(p, B, Hq, stream);
    case 16: return launch<T, 16>(p, B, Hq, stream);
    case 32: return launch<T, 32>(p, B, Hq, stream);
  }
  // bf16 at the wider widths runs the wgmma kernel
  if constexpr (std::is_same_v<T, float>) {
    switch (D) {
      case 64: return launch<T, 64>(p, B, Hq, stream);
      case 80: return launch<T, 80>(p, B, Hq, stream);
      case 128: return launch<T, 128>(p, B, Hq, stream);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace simt

// --------------------------------------------------------------------------
// bf16, D in {64, 80, 128}: wgmma fed by TMA
// --------------------------------------------------------------------------
namespace wg {

using namespace hopper;

constexpr int BQ = 128;                     // query rows per block
constexpr int BT = 128;                     // keys per tile
constexpr int NT = 256;                     // 2 warpgroups
constexpr int BOX_BYTES = 128 * 64 * 2;     // 128 rows of 64 columns
constexpr int TILE_BYTES = 2 * BOX_BYTES;   // 128 rows of 128 columns
constexpr int WARPS = NT / 32;              // each frees a stage once
constexpr float kLog2e = 1.4426950408889634f;

// The shared-memory layout is that of D = 128 at every width: a tile's row
// is two 64-column boxes, of which D = 80 fills 80 columns (TMA writes
// zeros past D) and D = 64 loads the first box alone.
template <int D>
struct Shape {
  static_assert(D == 64 || D == 80 || D == 128, "no wgmma flash at this D");
  static constexpr int BOXES = (D + 63) / 64;   // boxes a row loads
  // bytes a tile's loads complete on its barrier: whole boxes, their
  // zero-filled columns included
  static constexpr int LOAD_BYTES = BOXES * BOX_BYTES;
  static constexpr int OS_STRIDE = D + 8;       // output staging row
  static constexpr int OS_BYTES = 64 * OS_STRIDE * 2;   // a warpgroup's
  // Q | K0 | V0 | K1 | V1 | output staging x 2 | barriers
  static constexpr size_t BAR_OFFSET = 5 * TILE_BYTES + 2 * OS_BYTES;
  static constexpr size_t SMEM_BYTES = BAR_OFFSET + 7 * sizeof(uint64_t) +
                                       1024;
};

template <int D>
__global__ void __launch_bounds__(NT, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, const FlashParams p) {
  using Sh = Shape<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* q_tile = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Sh::BAR_OFFSET);
  uint64_t* q_full = bars;           // [1]
  uint64_t* k_full = bars + 1;       // [2]
  uint64_t* v_full = bars + 3;       // [2]
  uint64_t* empty = bars + 5;        // [2]: K and V of a stage are used

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.group;
  int n_tiles = (p.t_len + BT - 1) / BT;
  if (p.causal) n_tiles = min(n_tiles, (q0 + BQ - 1 + p.q_offset) / BT + 1);
  const int w = warpgroup_index();

  // thread 0 issues every load: K and V of tile `it` into stage it % 2
  auto load_tile = [&](int it) {
    uint8_t* kt = smem + (1 + 2 * (it % 2)) * TILE_BYTES;
    uint8_t* vt = kt + TILE_BYTES;
    uint64_t* kf = &k_full[it % 2];
    uint64_t* vf = &v_full[it % 2];
    const int k0 = it * BT;
    mbar_expect_tx(kf, Sh::LOAD_BYTES);
#pragma unroll
    for (int x = 0; x < Sh::BOXES; ++x)
      tma_load_4d(kt + x * BOX_BYTES, &map_k, kf, 64 * x, k0, hk, b);
    mbar_expect_tx(vf, Sh::LOAD_BYTES);
#pragma unroll
    for (int x = 0; x < Sh::BOXES; ++x)
      tma_load_4d(vt + x * BOX_BYTES, &map_v, vf, 64 * x, k0, hk, b);
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
    mbar_expect_tx(q_full, Sh::LOAD_BYTES);
#pragma unroll
    for (int x = 0; x < Sh::BOXES; ++x)
      tma_load_4d(q_tile + x * BOX_BYTES, &map_q, q_full, 64 * x, q0, h, b);
    for (int it = 0; it < min(2, n_tiles); ++it) load_tile(it);
  }
  __syncwarp();

  // warpgroup w owns query rows [64w, 64w + 64) of the block; this thread
  // holds rows lr0 and lr0 + 8, columns 8j + 2(l%4) + e
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int lr0 = 64 * w + 16 * warp + lane / 4;
  // causal bounds: the last key each of the thread's two rows sees
  const int rows[2] = {q0 + lr0 + p.q_offset, q0 + lr0 + 8 + p.q_offset};
  const float scale = p.scale * kLog2e;     // scores in log2 units
  float o[D / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % 2;
    const uint32_t parity = (it / 2) & 1;
    const uint8_t* kt = smem + (1 + 2 * s) * TILE_BYTES;
    const uint8_t* vt = kt + TILE_BYTES;

    // S = Q K^T: D / 16 k16 steps, 4 per 64-column box; at D = 80 step 4
    // reads the second box's first 16 columns, never its zeros
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
                        (p.causal && k0 + BT - 1 > q0 + 64 * w + p.q_offset);
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
    for (int j = 0; j < D / 8; ++j) {
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

    // O += P V at N = D: 128 keys in 8 k16 steps of 16 rows of V; at D = 80
    // the product reads the first box's 64 columns and the second's 16
    mbar_wait(&v_full[s], parity);
    wgmma_fence();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                             pa[4 * kk + 3]};
      wgmma_m64nNk16_rs<D, 1>(o, a, desc_mn_major(vt + kk * 2048, BOX_BYTES),
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
  constexpr int OS_STRIDE = Sh::OS_STRIDE;
  __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(
      smem + 5 * TILE_BYTES + w * Sh::OS_BYTES);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const float denom = fmaxf(l[hh], 1e-30f);
    const int r = 16 * warp + lane / 4 + 8 * hh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(&os[r * OS_STRIDE + c]) =
          __floats2bfloat162_rn(o[4 * j + 2 * hh] / denom,
                                o[4 * j + 2 * hh + 1] / denom);
    }
  }
  warpgroup_sync(1 + w);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + b * p.so[0] +
                       h * p.so[1];
  // 64 rows of D / 8 16-byte chunks: 5 a thread at D = 80
  static_assert(64 * D / 8 % 128 == 0, "chunks do not split evenly");
#pragma unroll
  for (int i = 0; i < 64 * D / 8 / 128; ++i) {
    const int chunk = t + 128 * i, r = chunk / (D / 8);
    const int c = 8 * (chunk % (D / 8)), row = q0 + 64 * w + r;
    if (row < p.s_len)
      *reinterpret_cast<uint4*>(out + row * p.so[2] + c) =
          *reinterpret_cast<const uint4*>(&os[r * OS_STRIDE + c]);
  }
}

template <int D>
cudaError_t launch(const FlashParams& p, int B, int Hq, int Hkv,
                   cudaStream_t stream) {
  constexpr size_t smem = Shape<D>::SMEM_BYTES;
  static_assert(smem <= 232448, "more shared memory than a block may use");
  CUtensorMap map_q, map_k, map_v;
  // dims (D, S, H, B); strides of S, H, B.  A box of 64 columns that runs
  // past D (the second at D = 80) is filled with zeros past it.
  const long long dq[4] = {D, p.s_len, Hq, B}, dk[4] = {D, p.t_len, Hkv, B};
  const long long st_q[3] = {p.sq[2], p.sq[1], p.sq[0]},
                  st_k[3] = {p.sk[2], p.sk[1], p.sk[0]},
                  st_v[3] = {p.sv[2], p.sv[1], p.sv[0]};
  const int box[4] = {64, 128, 1, 1};
  cudaError_t err = make_bf16_map(&map_q, p.q, 4, dq, st_q, box);
  if (err == cudaSuccess) err = make_bf16_map(&map_k, p.k, 4, dk, st_k, box);
  if (err == cudaSuccess) err = make_bf16_map(&map_v, p.v, 4, dk, st_v, box);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.s_len + BQ - 1) / BQ, Hq, B);
  flash_fwd_wgmma_kernel<D><<<grid, NT, smem, stream>>>(map_q, map_k, map_v,
                                                        p);
  return cudaGetLastError();
}

cudaError_t launch_d(const FlashParams& p, int B, int Hq, int Hkv, int D,
                     cudaStream_t stream) {
  if (p.sq[3] != 1 || p.sk[3] != 1 || p.sv[3] != 1 || p.so[3] != 1)
    return cudaErrorInvalidValue;
  switch (D) {
    case 64: return launch<64>(p, B, Hq, Hkv, stream);
    case 80: return launch<80>(p, B, Hq, Hkv, stream);
    case 128: return launch<128>(p, B, Hq, Hkv, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wg

FlashParams make_params(const void* q, const void* k, const void* v, void* o,
                        int Hq, int Hkv, int S, int T,
                        const long long* strides, float scale, int causal,
                        int q_offset) {
  FlashParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.s_len = S;
  p.t_len = T;
  p.group = Hq / Hkv;
  p.causal = causal;
  p.q_offset = q_offset;
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
// v and o in that order.  With `causal`, key j is visible to query row i iff
// j <= i + q_offset (q_offset >= 0; 0 for a whole sequence).  Launches on
// `stream`; returns cudaGetLastError().
//
// The CUDA-core kernel: f32 with D in {8, 16, 32, 64, 80, 128}, or bf16
// with D in {8, 16, 32} (any other is refused with cudaErrorInvalidValue),
// unit innermost strides, the other strides multiples of 16 bytes and
// 16-byte aligned bases (its rows are read and written in 16-byte pieces).
extern "C" int prema_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* o, int B, int Hq,
                                     int Hkv, int S, int T, int D,
                                     const long long* strides, float scale,
                                     int causal, int q_offset, void* stream) {
  using namespace prema;
  const FlashParams p =
      make_params(q, k, v, o, Hq, Hkv, S, T, strides, scale, causal, q_offset);
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

// The wgmma kernel: bf16, D in {64, 80, 128} (any other D is refused with
// cudaErrorInvalidValue), unit innermost strides, the other strides
// multiples of 8 elements and 16-byte aligned bases (what TMA reads and the
// epilogue's 16-byte stores write).
extern "C" int prema_flash_attention_wgmma(const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int Hq, int Hkv, int S, int T,
                                           int D, const long long* strides,
                                           float scale, int causal,
                                           int q_offset, void* stream) {
  using namespace prema;
  const FlashParams p =
      make_params(q, k, v, o, Hq, Hkv, S, T, strides, scale, causal, q_offset);
  return static_cast<int>(
      wg::launch_d(p, B, Hq, Hkv, D, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* prema_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
