// Prefill (flash) attention for Hopper, forward only.
//
// Replaces the TPU Pallas kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, launched by flash_attention_raw).  Same function: query
// head h reads KV head h / (Hq / Hkv); running max, normaliser and
// accumulator in f32; masked scores -1e30; causal mode (key <= query row)
// skips the tiles past the diagonal; output acc / max(l, 1e-30).
//
// What bounds it on the card: operations.  At the serving path's shapes
// (S = T = 2048, 32 query heads, D = 128, causal) it does 4*Hq*D*S(S+1)/2
// = 34 GFLOP over 42 MB of inputs and output, far above the H100's
// ~295 FLOP/byte balance point.  This first version keeps every product on
// the f32 CUDA cores (exactly the f32 arithmetic of the reference, for bf16
// inputs too); tensor cores (wgmma) and TMA come later.
//
// Design against that bound: a block owns 64 query rows of one head and
// keeps them in shared memory for its whole loop over 32-key tiles, so each
// K/V tile is loaded once per 64 queries; each thread holds a 4x4 score
// micro-tile and a 4 x D/8 slice of the accumulator in registers; rows of
// the shared tiles are padded by one float so the inner loops are free of
// bank conflicts.  The TPU kernel's sequential grid carried m, l, acc from
// one KV step to the next; here the KV loop runs inside the block instead.
// Ragged S and T are masked in the kernel (no padding copies), and with the
// causal mask the heaviest query tiles are scheduled first.
#include "common.cuh"

namespace prema {
namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BT = 32;        // keys per tile
constexpr int NT = 128;       // threads: 16 row groups x 8 column lanes
constexpr int RQ = BQ / 16;   // query rows per thread
constexpr int CK = BT / 8;    // score columns per thread

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int s_len, t_len, group, causal;
  long long sq[4], sk[4], sv[4], so[4];  // (b, h, s, d) strides in elements
  float scale;
};

template <int D>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BT * (D + 1) + BT * D + BQ * (BT + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const FlashParams p) {
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
  constexpr size_t smem = flash_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.s_len + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(p);
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

}  // namespace
}  // namespace prema

// q (B,Hq,S,D), k/v (B,Hkv,T,D), o (B,Hq,S,D), all of one element type and
// with arbitrary strides: `strides` holds 16 values, (b, h, s, d) for q, k,
// v and o in that order.  Launches on `stream`; returns cudaGetLastError().
extern "C" int prema_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* o, int B, int Hq,
                                     int Hkv, int S, int T, int D,
                                     const long long* strides, float scale,
                                     int causal, void* stream) {
  using namespace prema;
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kFloat32)
    err = launch_d<float>(p, B, Hq, D, st);
  else if (dtype == kBFloat16)
    err = launch_d<__nv_bfloat16>(p, B, Hq, D, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* prema_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
