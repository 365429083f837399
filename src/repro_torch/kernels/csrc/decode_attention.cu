// Single-token GQA decode attention (flash-decoding) for Hopper.
//
// Replaces the TPU Pallas kernel src/repro/kernels/decode_attention/kernel.py
// (_decode_kernel, launched by decode_attention_raw).  Same function: the
// g = Hq / Hkv query heads that share a KV head attend together over
// cache[0..pos]; scores and softmax in f32, P kept in f32 for P V; keys past
// pos are never read; output acc / max(l, 1e-30) in q's type.
//
// What bounds it on the card: bytes.  Each KV entry is used by g query
// heads only (4 on qwen3-8b), about 4 FLOP per byte read, against a ridge
// near 295, so the time is the cache read: at pos = 2048 with 8 KV heads of
// 128 in bf16 that is 8.4 MB per layer, 2.5 us at 3.35 TB/s.
//
// Design against that bound:
// - Split KV.  B * Hkv (8 on the serving path) blocks cannot keep 132 SMs
//   reading, so each block takes one chunk of CHUNK keys of one KV head.
//   The chunk is fixed, so a result's bits depend on pos and the data and
//   not on the capacity T (the serving executor grows T mid-request).  At
//   pos 2048 that is 33 x 8 = 264 live blocks, two per SM.
// - Bytes in flight.  A block requests its whole chunk at once with 16-byte
//   cp.async copies (8 bf16 or 4 f32 per lane, two 256-byte bf16 rows per
//   warp instruction): its K rows as one group, its V rows as a second, so
//   V streams in while the scores are computed.  Rows are read through the
//   caller's strides: the model's (B,T,Hkv,D) cache seen as (B,Hkv,T,D) puts
//   consecutive keys Hkv * D elements apart.  The wrapper guarantees a unit
//   inner stride and 16-byte rows (it copies a tensor that breaks that).
// - Arithmetic on the CUDA cores.  Scores: LPR = D * sizeof(T) / 16 lanes
//   per key row, each dotting its 16-byte slice with the g query heads held
//   in registers; the row's lanes reduce by halving exchanges
//   (row_sum_step).
//   P V: a thread per (16-byte column slice, key phase) accumulates from
//   shared memory; the key phases are summed by shuffles inside a warp and
//   through shared memory across warps, in a fixed order.
// - pos from device memory.  The launcher takes a host pos or a pointer to
//   one int32 on the card (the TPU kernel's scalar prefetch).  The grid is
//   sized from T; blocks whose chunk starts past pos return at once, and
//   pos is clamped to [-1, T) so no value reads outside the cache.  One
//   launch therefore serves every decode step and can be replayed from a
//   CUDA graph.  pos = -1 means the cache holds no key for this token (a
//   block of a cache split over several processes, past the token): then
//   every block returns at once but the first of each (batch, KV head),
//   which writes out = 0 and lse = -1e30, a partial that weighs nothing
//   when the processes' partials are merged.
// - The merge, in the same launch.  The TPU kernel's sequential grid carried
//   m, l, acc across KV tiles; here chunks run in parallel, and the last
//   block of each (batch, KV head) to finish (an atomic ticket after a
//   __threadfence) merges them and resets the ticket for the next launch.
//   It stages the partials in shared memory by cp.async, all in flight at
//   once, and sums them in a fixed order without atomics on values, so
//   results are bitwise equal from run to run.  On request it also writes
//   each query head's log-sum-exp of its scores, lse = m + log l, which
//   weighs this output against those of other blocks of the cache.
#include "common.cuh"

#include <cstdint>

namespace prema {
namespace {

constexpr int CHUNK = 64;          // keys per block (split)
constexpr int NT = 256;            // threads per block
constexpr int NW = NT / 32;        // warps per block
constexpr int MAXG = 8;            // largest query group a block takes
constexpr int MERGE_SPLITS = 40;   // chunks one merge round holds (g <= 4)

struct DecodeParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // f32 scratch: o_part (B, Hkv, n_splits, g, D) unnormalised partial
  // outputs, then m_part and l_part (B, Hkv, n_splits, g)
  float* part;
  int* tickets;        // (B, Hkv), zero between launches
  float* lse;          // (B, Hq) contiguous, or null: not written
  const int* pos_ptr;  // pos on the card, or null: then `pos`
  int pos;
  int B, Hkv, group, T, n_splits;
  long long sq[3], so[3];  // (b, h, d) strides in elements
  long long sk[4], sv[4];  // (b, h, t, d) strides in elements
  float scale;
};

__device__ __forceinline__ int live_pos(const DecodeParams& p) {
  const int pos = p.pos_ptr ? *p.pos_ptr : p.pos;
  return min(max(pos, -1), p.T - 1);
}

// 16 bytes of shared memory as f32 values
__device__ __forceinline__ void load16(const float* src, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(src);
  x[0] = t.x;
  x[1] = t.y;
  x[2] = t.z;
  x[3] = t.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src,
                                       float (&x)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// Sum each of the G values in v over the OFF * 2 lanes of a key row.  Each
// step sends the half of the values still held that the partner lane keeps,
// so a row costs about G + log2(lanes) shuffles instead of G log2(lanes).
// Afterwards lane li holds in v[0, N) the sums of heads (li / LPH) * N + i,
// N = max(1, G / lanes), LPH = max(1, lanes / G).
template <int OFF, int N, int G>
__device__ __forceinline__ void row_sum_step(float (&v)[G], int li) {
  if constexpr (OFF > 0) {
    if constexpr (N > 1) {
      const bool up = li & OFF;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = up ? v[i] : v[i + N / 2];
        const float keep = up ? v[i + N / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      row_sum_step<OFF / 2, N / 2, G>(v, li);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
      row_sum_step<OFF / 2, 1, G>(v, li);
    }
  }
}

template <typename T, int D, int G>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int split = 2 * CHUNK * D * int(sizeof(T)) + CHUNK * G * 4 +
                        NW * G * D * 4 + G * D * 4;
  constexpr int merge = G <= 4 ? MERGE_SPLITS * (G * D + 2 * G) * 4 : 0;
  return split > merge ? split : merge;
}

// Merge the n_live chunks of (b, hk) and write the output.  Rounds of as
// many chunks as the block's shared memory `sm` holds: a round's partial
// outputs are staged by 16-byte cp.async copies, all in flight at once; a
// running maximum rescales the earlier rounds.  Each output element sums
// the chunks in index order and l sums over a fixed shuffle tree.
template <typename T, int D, int G>
__device__ void merge(const DecodeParams& p, int b, int hk, int n_live,
                      float* sm) {
  constexpr int CAP = smem_bytes<T, D, G>() / 4;
  __shared__ float m_run[G], l_run[G], rescale[G];
  const int g = p.group, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rs = CAP / (g * D + 2 * g);  // chunks per round
  float* ob = sm;                        // [rs][g][D]
  float* mb = ob + rs * g * D;           // [rs][g]: m, then the weight
  float* lb = mb + rs * g;               // [rs][g]
  const long long row = (long long)(b * p.Hkv + hk) * p.n_splits;
  const long long n_rows = (long long)p.B * p.Hkv * p.n_splits * g;
  const float* o_part = p.part + row * g * D;
  const float* m_part = p.part + n_rows * D + row * g;
  const float* l_part = m_part + n_rows;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid < g) {
    m_run[tid] = kNegInf;
    l_run[tid] = 0.f;
  }
  for (int s0 = 0; s0 < n_live; s0 += rs) {
    const int cnt = min(rs, n_live - s0);
    const float* src = o_part + (long long)s0 * g * D;
    for (int i = tid; i < cnt * g * D / 4; i += NT)
      cp_async16(ob + 4 * i, src + 4 * i);
    cp_async_commit();
    for (int i = tid; i < cnt * g; i += NT) {
      mb[i] = __ldcg(m_part + s0 * g + i);
      lb[i] = __ldcg(l_part + s0 * g + i);
    }
    __syncthreads();
    // per head (a warp each): the new running maximum, then the weights
    for (int gi = warp; gi < g; gi += NW) {
      float mr = m_run[gi];
      for (int s = lane; s < cnt; s += 32) mr = fmaxf(mr, mb[s * g + gi]);
      mr = group_max<32>(mr);
      float l = 0.f;
      for (int s = lane; s < cnt; s += 32) {
        const float w = expf(mb[s * g + gi] - mr);
        mb[s * g + gi] = w;
        l = fmaf(w, lb[s * g + gi], l);
      }
      l = group_sum<32>(l);
      if (lane == 0) {
        const float r = expf(m_run[gi] - mr);
        rescale[gi] = r;
        l_run[gi] = fmaf(l_run[gi], r, l);
        m_run[gi] = mr;
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    // a thread per 4 output columns: its chunks in index order
    if (tid < g * D / 4) {
      const int gi = 4 * tid / D;
      const float r = rescale[gi];
      float4 a = make_float4(acc.x * r, acc.y * r, acc.z * r, acc.w * r);
      const float4* ob4 = reinterpret_cast<const float4*>(ob) + tid;
#pragma unroll 8
      for (int s = 0; s < cnt; ++s) {
        const float w = mb[s * g + gi];
        const float4 x = ob4[s * (g * D / 4)];
        a.x = fmaf(w, x.x, a.x);
        a.y = fmaf(w, x.y, a.y);
        a.z = fmaf(w, x.z, a.z);
        a.w = fmaf(w, x.w, a.w);
      }
      acc = a;
    }
    __syncthreads();
  }
  if (p.lse && tid < g)
    p.lse[(long long)(b * p.Hkv + hk) * g + tid] =
        m_run[tid] + logf(l_run[tid]);
  if (tid < g * D / 4) {
    const int gi = 4 * tid / D, d = 4 * tid % D;
    const float denom = fmaxf(l_run[gi], 1e-30f);
    T* o = static_cast<T*>(p.o) + b * p.so[0] +
           (long long)(hk * g + gi) * p.so[1];
    o[d * p.so[2]] = from_float<T>(acc.x / denom);
    o[(d + 1) * p.so[2]] = from_float<T>(acc.y / denom);
    o[(d + 2) * p.so[2]] = from_float<T>(acc.z / denom);
    o[(d + 3) * p.so[2]] = from_float<T>(acc.w / denom);
  }
}

// One block per (chunk, KV head, batch); G >= the query group.
template <typename T, int D, int G>
__global__ void __launch_bounds__(NT, G <= 4 ? 2 : 1)
    decode_split_kernel(const DecodeParams p) {
  constexpr int VEC = 16 / int(sizeof(T));  // elements per 16-byte copy
  constexpr int LPR = D / VEC;              // lanes per key row
  constexpr int RPP = NT / LPR;             // key rows per pass of the block
  constexpr int NF = G > LPR ? G / LPR : 1;   // row sums a lane ends with
  constexpr int LPH = LPR > G ? LPR / G : 1;  // lanes per row sum
  static_assert(LPR >= 1 && LPR <= 32 && (LPR & (LPR - 1)) == 0, "LPR");
  static_assert(RPP >= CHUNK || CHUNK % RPP == 0, "rows per pass");
  static_assert(G % 4 == 0, "P is read as float4");
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);                     // [CHUNK][D]
  T* vs = ks + CHUNK * D;                                 // [CHUNK][D]
  float* sc = reinterpret_cast<float*>(vs + CHUNK * D);   // [CHUNK][G]
  float* red = sc + CHUNK * G;                            // [NW][G][D]
  float* qs = red + NW * G * D;                           // [G][D]
  __shared__ float ms[G], ls[G];
  __shared__ int last;

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int pos = live_pos(p);
  const int g = p.group, tid = threadIdx.x;
  if (pos < 0) {  // no key: an output of zeros that weighs nothing
    if (split != 0) return;
    T* o = static_cast<T*>(p.o) + b * p.so[0] + (long long)hk * g * p.so[1];
    for (int i = tid; i < g * D; i += NT)
      o[(i / D) * p.so[1] + (i % D) * p.so[2]] = from_float<T>(0.f);
    if (p.lse && tid < g)
      p.lse[(long long)(b * p.Hkv + hk) * g + tid] = kNegInf;
    return;
  }
  const int n_live = pos / CHUNK + 1;
  if (split >= n_live) return;
  const int t0 = split * CHUNK;
  const int n_keys = min(CHUNK, pos + 1 - t0);
  const int warp = tid / 32, lane = tid % 32;
  const int li = tid % LPR, rg = tid / LPR;  // lane in its row, row group

  // the query group, requested before the cache, parked in shared memory
  constexpr int QPT = (G * D + NT - 1) / NT;
  const T* q = static_cast<const T*>(p.q) + b * p.sq[0] +
               (long long)hk * g * p.sq[1];
  float qv[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int i = tid + j * NT, gi = i / D, d = i % D;
    qv[j] = i < G * D && gi < g ? to_float(q[gi * p.sq[1] + d * p.sq[2]])
                                : 0.f;
  }

  // 1. the chunk's live K rows, then its V rows, all in flight at once
  const T* k = static_cast<const T*>(p.k) + b * p.sk[0] + hk * p.sk[1] +
               t0 * p.sk[2];
  const T* v = static_cast<const T*>(p.v) + b * p.sv[0] + hk * p.sv[1] +
               t0 * p.sv[2];
  for (int i = tid; i < n_keys * LPR; i += NT) {
    const int r = i / LPR, c = (i % LPR) * VEC;
    cp_async16(ks + r * D + c, k + r * p.sk[2] + c);
  }
  cp_async_commit();
  for (int i = tid; i < n_keys * LPR; i += NT) {
    const int r = i / LPR, c = (i % LPR) * VEC;
    cp_async16(vs + r * D + c, v + r * p.sv[2] + c);
  }
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < QPT; ++j)
    if (tid + j * NT < G * D) qs[tid + j * NT] = qv[j];

  // 2. scores: LPR lanes per key row, each with the group's q at its
  // 16-byte column slice
  cp_async_wait<1>();
  __syncthreads();
  float qr[G][VEC];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      const float4 t =
          *reinterpret_cast<const float4*>(qs + gi * D + li * VEC + e);
      qr[gi][e] = t.x;
      qr[gi][e + 1] = t.y;
      qr[gi][e + 2] = t.z;
      qr[gi][e + 3] = t.w;
    }
  for (int r = rg; r < CHUNK; r += RPP) {
    float dot[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) dot[gi] = 0.f;
    if (r < n_keys) {
      float kx[VEC];
      load16(ks + r * D + li * VEC, kx);
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          dot[gi] = fmaf(qr[gi][e], kx[e], dot[gi]);
    }
    row_sum_step<LPR / 2, G, G>(dot, li);
    if (li % LPH == 0) {
#pragma unroll
      for (int i = 0; i < NF; ++i) {
        const int gi = (li / LPH) * NF + i;
        if (gi < g) sc[r * G + gi] = r < n_keys ? dot[i] * p.scale : kNegInf;
      }
    }
  }
  __syncthreads();

  // 3. softmax statistics of the chunk, one warp per query head
  for (int gi = warp; gi < g; gi += NW) {
    float mx = kNegInf;
    for (int j = lane; j < CHUNK; j += 32) mx = fmaxf(mx, sc[j * G + gi]);
    mx = group_max<32>(mx);
    float sum = 0.f;
    for (int j = lane; j < CHUNK; j += 32) {
      const float e = expf(sc[j * G + gi] - mx);
      sc[j * G + gi] = e;
      sum += e;
    }
    sum = group_sum<32>(sum);
    if (lane == 0) {
      ms[gi] = mx;
      ls[gi] = sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 4. unnormalised P V: a thread per (column slice li, key phase rg)
  float acc[G][VEC];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[gi][e] = 0.f;
  for (int r = rg; r < n_keys; r += RPP) {
    float vx[VEC], pr[G];
    load16(vs + r * D + li * VEC, vx);
#pragma unroll
    for (int gi = 0; gi < G; gi += 4) {
      const float4 t = *reinterpret_cast<const float4*>(sc + r * G + gi);
      pr[gi] = t.x;
      pr[gi + 1] = t.y;
      pr[gi + 2] = t.z;
      pr[gi + 3] = t.w;
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[gi][e] = fmaf(pr[gi], vx[e], acc[gi][e]);
  }

  // key phases of one warp by shuffles, then the warps in order
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
#pragma unroll
      for (int off = LPR; off < 32; off *= 2)
        acc[gi][e] += __shfl_xor_sync(0xffffffffu, acc[gi][e], off);
  if (lane < LPR) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
      if (gi < g)
#pragma unroll
        for (int e = 0; e < VEC; e += 4)
          *reinterpret_cast<float4*>(red + (warp * G + gi) * D + li * VEC + e) =
              make_float4(acc[gi][e], acc[gi][e + 1], acc[gi][e + 2],
                          acc[gi][e + 3]);
  }
  __syncthreads();

  const long long row = (long long)(b * p.Hkv + hk) * p.n_splits + split;
  const long long n_rows = (long long)p.B * p.Hkv * p.n_splits * g;
  float* o_part = p.part + row * g * D;
  for (int i = tid; i < g * D; i += NT) {
    const int gi = i / D, d = i % D;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) s += red[(w * G + gi) * D + d];
    o_part[i] = s;
  }
  if (tid < g) {
    p.part[n_rows * D + row * g + tid] = ms[tid];
    p.part[n_rows * D + n_rows + row * g + tid] = ls[tid];
  }

  // 5. the last block of (b, hk) to finish merges the chunks
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ticket = p.tickets + b * p.Hkv + hk;
    last = atomicAdd(ticket, 1) == n_live - 1;
    if (last) *ticket = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  merge<T, D, G>(p, b, hk, n_live, reinterpret_cast<float*>(smem));
}

template <typename T, int D, int G>
cudaError_t launch(const DecodeParams& p, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T, D, G>();
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_split_kernel<T, D, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  decode_split_kernel<T, D, G>
      <<<dim3(p.n_splits, p.Hkv, p.B), NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_g(const DecodeParams& p, cudaStream_t stream) {
  return p.group <= 4 ? launch<T, D, 4>(p, stream)
                      : launch<T, D, MAXG>(p, stream);
}

template <typename T>
cudaError_t launch_d(const DecodeParams& p, int D, cudaStream_t stream) {
  switch (D) {
    case 8: return launch_g<T, 8>(p, stream);
    case 16: return launch_g<T, 16>(p, stream);
    case 32: return launch_g<T, 32>(p, stream);
    case 64: return launch_g<T, 64>(p, stream);
    case 128: return launch_g<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace prema

// Keys per block; the wrapper sizes the scratch with it.
extern "C" int prema_decode_chunk() { return prema::CHUNK; }

// Largest query group (Hq / Hkv) the kernel takes; the wrapper checks it.
extern "C" int prema_decode_max_group() { return prema::MAXG; }

// q (B,Hq,D), k/v (B,Hkv,T,D), o (B,Hq,D), all of one element type; strides
// in `strides`: q (b,h,d), k (b,h,t,d), v (b,h,t,d), o (b,h,d), 14 values.
// k and v need a unit inner stride and 16-byte aligned rows.  `part` is f32
// scratch of B * Hkv * n_splits * g * (D + 2) values with n_splits =
// ceil(T / CHUNK); `tickets` B * Hkv int32 zeros (left zero).  Attends over
// cache[0..pos] with pos = *pos_ptr if pos_ptr is not null, else `pos`,
// clamped to [-1, T); at pos = -1 it writes o = 0 (and lse = -1e30).  `lse`,
// if not null, receives (B, Hq) contiguous f32 log-sum-exps of the scaled
// scores.  One launch on `stream`; returns cudaGetLastError().
extern "C" int prema_decode_attention(int dtype, const void* q, const void* k,
                                      const void* v, void* o, float* part,
                                      int* tickets, float* lse,
                                      const int* pos_ptr,
                                      int pos, int B, int Hq, int Hkv, int T,
                                      int D, const long long* strides,
                                      float scale, void* stream) {
  using namespace prema;
  DecodeParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.part = part;
  p.tickets = tickets;
  p.lse = lse;
  p.pos_ptr = pos_ptr;
  p.pos = pos;
  p.B = B;
  p.Hkv = Hkv;
  p.group = Hq / Hkv;
  p.T = T;
  p.n_splits = (T + CHUNK - 1) / CHUNK;
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
  if (p.group > MAXG || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == kFloat32)
    err = launch_d<float>(p, D, st);
  else if (dtype == kBFloat16)
    err = launch_d<__nv_bfloat16>(p, D, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
