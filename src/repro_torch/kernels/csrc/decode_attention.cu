// Single-token GQA decode attention (flash-decoding) for Hopper.
//
// Replaces the TPU Pallas kernel src/repro/kernels/decode_attention/kernel.py
// (_decode_kernel, launched by decode_attention_raw).  Same function: the
// g = Hq / Hkv query heads that share a KV head attend together over
// cache[0..pos]; scores and softmax in f32; keys past pos are never read;
// output acc / max(l, 1e-30).
//
// What bounds it on the card: bytes.  Each KV entry is used by g query
// heads only (4 on qwen3-8b), about 2g FLOP per byte read, so the time is
// the cache read: at pos = 2048 with 8 KV heads of 128 in bf16 that is
// 8.4 MB per layer, 2.5 us at 3.35 TB/s.
//
// Design against that bound: B * Hkv (8 on the serving path) blocks cannot
// keep 132 SMs reading, so the key range [0, pos] is split into chunks of
// 64 keys, one block per (chunk, KV head, batch); the whole query group is
// one block's work, so each KV entry is read from memory exactly once.  A
// warp reads one key row with consecutive lanes on consecutive elements.
// Each block writes its unnormalised partial output with its max and
// normaliser; a second small kernel combines the chunks of a head in a fixed
// order without atomics, so results are bitwise equal from run to run.
// The TPU kernel's sequential grid carried m, l, acc across KV tiles; here
// the chunks run in parallel and the combine takes that role.
#include "common.cuh"

namespace prema {
namespace {

constexpr int CHUNK = 64;    // keys per block
constexpr int NT = 128;      // threads per block
constexpr int NW = NT / 32;  // warps per block
constexpr int MAXG = 8;      // largest query group a block takes

struct DecodeParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* o_part;  // (B, Hq, n_splits, D) unnormalised partial outputs
  float* m_part;  // (B, Hq, n_splits) partial max
  float* l_part;  // (B, Hq, n_splits) partial normaliser
  int Hq, group, pos, n_splits;
  long long sq[3], so[3];         // (b, h, d) strides in elements
  long long sk[4], sv[4];         // (b, h, t, d) strides in elements
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(NT) decode_split_kernel(const DecodeParams p) {
  __shared__ float qs[MAXG][D];
  __shared__ float ps[MAXG][CHUNK];
  __shared__ float ms[MAXG], ls[MAXG];
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int g = p.group, t0 = split * CHUNK;
  const int t1 = min(t0 + CHUNK, p.pos + 1);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* q = static_cast<const T*>(p.q) + b * p.sq[0];
  const T* k = static_cast<const T*>(p.k) + b * p.sk[0] + hk * p.sk[1];
  const T* v = static_cast<const T*>(p.v) + b * p.sv[0] + hk * p.sv[1];

  for (int i = tid; i < g * D; i += NT) {
    const int gi = i / D, d = i % D;
    qs[gi][d] = to_float(q[(hk * g + gi) * p.sq[1] + d * p.sq[2]]);
  }
  __syncthreads();

  // scores: one warp per key, lanes across D
  for (int j = warp; j < CHUNK; j += NW) {
    const int t = t0 + j;
    if (t < t1) {
      float dot[MAXG];
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi) dot[gi] = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float kv = to_float(k[t * p.sk[2] + d * p.sk[3]]);
#pragma unroll
        for (int gi = 0; gi < MAXG; ++gi)
          if (gi < g) dot[gi] = fmaf(qs[gi][d], kv, dot[gi]);
      }
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi) {
        if (gi < g) {
          const float x = group_sum<32>(dot[gi]);
          if (lane == 0) ps[gi][j] = x * p.scale;
        }
      }
    } else if (lane < g) {
      ps[lane][j] = kNegInf;
    }
  }
  __syncthreads();

  // softmax statistics of this chunk, one warp per query head
  for (int gi = warp; gi < g; gi += NW) {
    float mx = kNegInf;
    for (int j = lane; j < CHUNK; j += 32) mx = fmaxf(mx, ps[gi][j]);
    mx = group_max<32>(mx);
    float sum = 0.f;
    for (int j = lane; j < CHUNK; j += 32) {
      const float e = expf(ps[gi][j] - mx);
      ps[gi][j] = e;
      sum += e;
    }
    sum = group_sum<32>(sum);
    if (lane == 0) {
      ms[gi] = mx;
      ls[gi] = sum;
    }
  }
  __syncthreads();

  // unnormalised P V over the live keys, one thread per output column
  for (int d = tid; d < D; d += NT) {
    float acc[MAXG];
#pragma unroll
    for (int gi = 0; gi < MAXG; ++gi) acc[gi] = 0.f;
    for (int t = t0; t < t1; ++t) {
      const float vv = to_float(v[t * p.sv[2] + d * p.sv[3]]);
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi)
        if (gi < g) acc[gi] = fmaf(ps[gi][t - t0], vv, acc[gi]);
    }
#pragma unroll
    for (int gi = 0; gi < MAXG; ++gi) {
      if (gi < g) {
        const long long row = (long long)(b * p.Hq + hk * g + gi) * p.n_splits + split;
        p.o_part[row * D + d] = acc[gi];
      }
    }
  }
  if (tid < g) {
    const long long row = (long long)(b * p.Hq + hk * g + tid) * p.n_splits + split;
    p.m_part[row] = ms[tid];
    p.l_part[row] = ls[tid];
  }
}

// One block per (query head, batch): merge the chunks in index order.
template <typename T>
__global__ void __launch_bounds__(NT) decode_combine_kernel(const DecodeParams p,
                                                            int D) {
  const int h = blockIdx.x, b = blockIdx.y;
  const long long base = (long long)(b * p.Hq + h) * p.n_splits;
  float mx = kNegInf;
  for (int s = 0; s < p.n_splits; ++s) mx = fmaxf(mx, p.m_part[base + s]);
  T* o = static_cast<T*>(p.o) + b * p.so[0] + h * p.so[1];
  for (int d = threadIdx.x; d < D; d += NT) {
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < p.n_splits; ++s) {
      const float w = expf(p.m_part[base + s] - mx);
      l = fmaf(w, p.l_part[base + s], l);
      acc = fmaf(w, p.o_part[(base + s) * D + d], acc);
    }
    o[d * p.so[2]] = from_float<T>(acc / fmaxf(l, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const DecodeParams& p, int B, int Hkv, cudaStream_t stream) {
  decode_split_kernel<T, D><<<dim3(p.n_splits, Hkv, B), NT, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<dim3(p.Hq, B), NT, 0, stream>>>(p, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const DecodeParams& p, int B, int Hkv, int D,
                     cudaStream_t stream) {
  switch (D) {
    case 8: return launch<T, 8>(p, B, Hkv, stream);
    case 16: return launch<T, 16>(p, B, Hkv, stream);
    case 32: return launch<T, 32>(p, B, Hkv, stream);
    case 64: return launch<T, 64>(p, B, Hkv, stream);
    case 128: return launch<T, 128>(p, B, Hkv, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace prema

// Keys per block; the wrapper sizes the partial buffers with it.
extern "C" int prema_decode_chunk() { return prema::CHUNK; }

// Largest query group (Hq / Hkv) the kernel takes; the wrapper checks it.
extern "C" int prema_decode_max_group() { return prema::MAXG; }

// q (B,Hq,D), k/v (B,Hkv,T,D), o (B,Hq,D), all of one element type and with
// arbitrary strides: `strides` holds q (b,h,d), k (b,h,t,d), v (b,h,t,d),
// o (b,h,d), 14 values.  o_part/m_part/l_part are f32 scratch of
// (B, Hq, n_splits[, D]) with n_splits = pos / CHUNK + 1.  Attends over
// cache[0..pos].  Launches two kernels on `stream`; returns
// cudaGetLastError().
extern "C" int prema_decode_attention(int dtype, const void* q, const void* k,
                                      const void* v, void* o, float* o_part,
                                      float* m_part, float* l_part, int B,
                                      int Hq, int Hkv, int D, int pos,
                                      const long long* strides, float scale,
                                      void* stream) {
  using namespace prema;
  DecodeParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.o_part = o_part;
  p.m_part = m_part;
  p.l_part = l_part;
  p.Hq = Hq;
  p.group = Hq / Hkv;
  p.pos = pos;
  p.n_splits = pos / CHUNK + 1;
  for (int i = 0; i < 3; ++i) {
    p.sq[i] = strides[i];
    p.so[i] = strides[11 + i];
  }
  for (int i = 0; i < 4; ++i) {
    p.sk[i] = strides[3 + i];
    p.sv[i] = strides[7 + i];
  }
  p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.group > MAXG) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == kFloat32)
    err = launch_d<float>(p, B, Hkv, D, st);
  else if (dtype == kBFloat16)
    err = launch_d<__nv_bfloat16>(p, B, Hkv, D, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
