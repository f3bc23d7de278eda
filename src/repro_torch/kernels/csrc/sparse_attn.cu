// sparse_attention: LPSA sink + window attention with an online softmax.
//
// Replaces src/repro/kernels/sparse_attn.py::_attn_kernel (a flash pass per
// (head, query tile) over key tiles, scores kept in VMEM).
//
// q: (B, Lq, Hq, D); k, v: (B, Lk, Hkv, D); q_pos: (B, Lq); k_pos: (B, Lk)
// int32 absolute positions, k_pos < 0 marks an empty slot.  Query i attends
// key j iff  k_pos <= q_pos  &  (k_pos < sink | q_pos - k_pos < window)  &
// k_pos >= 0.  GQA: q head h reads kv head h / (Hq / Hkv).  Scores are
// rounded to T first when round_scores is set (the JAX package's streaming
// prefill takes q.k as a T einsum, core/lpsa.py::_softmax_attend), scaled by
// `scale` (1/sqrt(D)), soft-capped by tanh when softcap > 0, and a row with
// no allowed key outputs 0.  out: (B, Lq, Hq, D) in q's dtype.
//
// One block per (query, q head, batch row); its threads stride over the keys
// (thread t takes keys t, t + blockDim, ...), each keeping a running max,
// denominator and D-wide accumulator in float32 registers; the block then
// merges them in a fixed order (xor butterflies inside a warp, warps in
// index order), so the result does not depend on the other rows.
//
// What bounds it on the H100: bytes.  At decode (Lq = 1 over the 1024-slot
// ring) every allowed key's K and V rows are read once per q head: 1024 x 32
// x 64 x 2 x 2 B = 8.4 MB per layer per slot in bf16, the largest traffic of
// a decode step.  Scores and softmax state never leave registers.
#include "common.cuh"

namespace tenet {

constexpr int kAttnThreads = 128;
constexpr int kAttnWarps = kAttnThreads / 32;

// 16 bytes of a row as float32: 4 floats or 8 bf16 values
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ void load(const float* __restrict__ p, float (&o)[4]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    o[0] = t.x;
    o[1] = t.y;
    o[2] = t.z;
    o[3] = t.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ p,
                                              float (&o)[8]) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      o[2 * j] = f.x;
      o[2 * j + 1] = f.y;
    }
  }
};

template <int D, typename T>
__global__ void __launch_bounds__(kAttnThreads)
sparse_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                   T* __restrict__ out, int Lq, int Lk, int Hq, int Hkv, int sink, int window,
                   float softcap, float scale, bool round_scores) {
  __shared__ float s_m[kAttnWarps], s_l[kAttnWarps], s_acc[kAttnWarps][D];
  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t qoff = (((size_t)b * Lq + iq) * Hq + h) * D;
  constexpr int V = Vec<T>::n;
  float t[V];
  float qv[D];
#pragma unroll
  for (int i = 0; i < D / V; ++i) {
    Vec<T>::load(q + qoff + i * V, t);
#pragma unroll
    for (int e = 0; e < V; ++e) qv[i * V + e] = t[e];
  }
  const int qp = q_pos[(size_t)b * Lq + iq];

  float m = -INFINITY, l = 0.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  for (int j = threadIdx.x; j < Lk; j += kAttnThreads) {
    const int kp = k_pos[(size_t)b * Lk + j];
    if (kp < 0 || kp > qp || !(kp < sink || qp - kp < window)) continue;
    const size_t koff = (((size_t)b * Lk + j) * Hkv + hk) * D;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < D / V; ++i) {
      Vec<T>::load(k + koff + i * V, t);
#pragma unroll
      for (int e = 0; e < V; ++e) s += qv[i * V + e] * t[e];
    }
    if (round_scores) s = to_f32(from_f32<T>(s));
    s *= scale;
    if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);  // 0 while m is -inf
    const float p = expf(s - m_new);
    l = l * alpha + p;
#pragma unroll
    for (int i = 0; i < D / V; ++i) {
      Vec<T>::load(v + koff + i * V, t);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[i * V + e] = acc[i * V + e] * alpha + p * t[e];
    }
    m = m_new;
  }

  // merge the threads' states: warp max, rescale, xor-butterfly sums
  const unsigned full = 0xffffffffu;
  float mw = m;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mw = fmaxf(mw, __shfl_xor_sync(full, mw, o));
  const float f = (m == -INFINITY) ? 0.f : expf(m - mw);
  l *= f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(full, l, o);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float a = acc[d] * f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(full, a, o);
    acc[d] = a;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_m[warp] = mw;
    s_l[warp] = l;
#pragma unroll
    for (int d = 0; d < D; ++d) s_acc[warp][d] = acc[d];
  }
  __syncthreads();
  if (threadIdx.x < D) {
    const int d = threadIdx.x;
    float mb = -INFINITY;
#pragma unroll
    for (int w = 0; w < kAttnWarps; ++w) mb = fmaxf(mb, s_m[w]);
    float lb = 0.f, ab = 0.f;
#pragma unroll
    for (int w = 0; w < kAttnWarps; ++w) {
      const float fw = (s_m[w] == -INFINITY) ? 0.f : expf(s_m[w] - mb);
      lb += s_l[w] * fw;
      ab += s_acc[w][d] * fw;
    }
    out[qoff + d] = from_f32<T>(lb == 0.f ? 0.f : ab / lb);
  }
}

template <int D, typename T>
static void launch(const void* q, const void* k, const void* v, const int* q_pos,
                   const int* k_pos, void* out, int B, int Lq, int Lk, int Hq, int Hkv,
                   int sink, int window, float softcap, float scale, bool round_scores,
                   cudaStream_t stream) {
  dim3 grid(Lq, Hq, B);
  sparse_attn_kernel<D, T><<<grid, kAttnThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), q_pos,
      k_pos, static_cast<T*>(out), Lq, Lk, Hq, Hkv, sink, window, softcap, scale,
      round_scores);
}

template <typename T>
static int dispatch_d(int D, const void* q, const void* k, const void* v, const int* q_pos,
                      const int* k_pos, void* out, int B, int Lq, int Lk, int Hq, int Hkv,
                      int sink, int window, float softcap, float scale, bool rs,
                      cudaStream_t s) {
  switch (D) {
    case 16:
      launch<16, T>(q, k, v, q_pos, k_pos, out, B, Lq, Lk, Hq, Hkv, sink, window, softcap,
                    scale, rs, s);
      return 0;
    case 32:
      launch<32, T>(q, k, v, q_pos, k_pos, out, B, Lq, Lk, Hq, Hkv, sink, window, softcap,
                    scale, rs, s);
      return 0;
    case 64:
      launch<64, T>(q, k, v, q_pos, k_pos, out, B, Lq, Lk, Hq, Hkv, sink, window, softcap,
                    scale, rs, s);
      return 0;
    case 80:
      launch<80, T>(q, k, v, q_pos, k_pos, out, B, Lq, Lk, Hq, Hkv, sink, window, softcap,
                    scale, rs, s);
      return 0;
    default:
      return -1;
  }
}

}  // namespace tenet

extern "C" int tenet_sparse_attention(const void* q, const void* k, const void* v,
                                      const void* q_pos, const void* k_pos, void* out,
                                      int dtype, int B, int Lq, int Lk, int Hq, int Hkv,
                                      int D, int sink, int window, float softcap,
                                      float scale, int round_scores, void* stream) {
  using namespace tenet;
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(k_pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int bad = -1;
  if (dtype == kF32)
    bad = dispatch_d<float>(D, q, k, v, qp, kp, out, B, Lq, Lk, Hq, Hkv, sink, window,
                            softcap, scale, round_scores != 0, s);
  else if (dtype == kBF16)
    bad = dispatch_d<__nv_bfloat16>(D, q, k, v, qp, kp, out, B, Lq, Lk, Hq, Hkv, sink,
                                    window, softcap, scale, round_scores != 0, s);
  if (bad) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
