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
// The prefill class: one block per (query, q head, batch row); its threads
// stride over the keys (thread t takes keys t, t + blockDim, ...), each
// keeping a running max, denominator and D-wide accumulator in float32
// registers; the block then merges them in a fixed order (xor butterflies
// inside a warp, warps in index order), so the result does not depend on
// the other rows.  The decode class is below.
//
// What bounds it on the H100: bytes.  At decode (Lq = 1 over the 1024-slot
// ring) every allowed key's K and V rows are read once per q head: 1024 x 32
// x 64 x 2 x 2 B = 8.4 MB per layer per slot in bf16, the largest traffic of
// a decode step.  Scores and softmax state never leave the chip.
//
// Two classes:
//  * decode (Lq == 1): split_decode_kernel, flash-decoding in one launch.
//    The keys are split over the S blocks of a thread-block cluster, one
//    cluster per (q head, batch row); S and each block's key range are a
//    function of Lk alone (split_keys: 256 keys a block, at most 16 blocks,
//    beyond that the chunks grow; 4 blocks at Lk = 1024, so that all of a
//    decode step's 512 blocks are resident at once).  A block walks its
//    chunk in tiles of 64 keys (32 for rows over 160 bytes): it reads a
//    tile's k_pos, then copies only the allowed rows' K and V into shared
//    memory with 16-byte cp.async (neighbouring threads on neighbouring
//    bytes of a row, K and V both in flight before the first score; a tile
//    with no allowed key loads nothing), two tiles in flight.  Each group of
//    8 lanes takes every 16th key of a tile, scores it (lanes on
//    neighbouring 16 bytes of the row) and folds it into the group's own
//    running (max, denominator, accumulator), one exp a key, with no
//    barrier between keys; the 16 groups merge in order at the end.  The
//    blocks merge their states in block order through distributed shared
//    memory: no atomics, no second pass, and the order depends on Lk, D and
//    the dtype only.
//  * prefill (Lq > 1): sparse_attn_kernel, as above.
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

// --- decode class: the keys of one (q head, batch row) split over a cluster

constexpr int kSplitThreads = 128;
constexpr int kSplitKeys = 256;                // keys a block, up to 16 blocks

// the blocks of a cluster for Lk keys, and the keys of each block
__host__ __forceinline__ void split_keys(int Lk, int& S, int& chunk) {
  S = (Lk + kSplitKeys - 1) / kSplitKeys;
  S = S < 1 ? 1 : S > kMaxCluster ? kMaxCluster : S;
  chunk = (Lk + S - 1) / S;
}

template <int D, typename T>
__global__ void __launch_bounds__(kSplitThreads)
split_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                    T* __restrict__ out, int Lk, int Hq, int Hkv, int chunk, int sink,
                    int window, float softcap, float scale, bool round_scores) {
  constexpr int VE = Vec<T>::n;                          // values in 16 bytes
  constexpr int CPR = D / VE;                            // 16-byte chunks a row
  constexpr int TILE = D * (int)sizeof(T) <= 160 ? 64 : 32;   // keys of a tile
  constexpr int NGRP = kSplitThreads / 8;                // key groups of 8 lanes
  constexpr int QC = (CPR + 7) / 8;                      // chunks of a lane
  constexpr int kTileBytes = TILE * D * (int)sizeof(T);
  // two stages of K and V tiles; after the last tile stage 0 holds the
  // groups' states and stage 1 the cluster's merge slots (block 0's)
  __shared__ __align__(16) unsigned char kv[2][2 * kTileBytes];
  __shared__ int sok[2][TILE];                           // allowed keys of a stage
  static_assert(NGRP * (D + 2) * sizeof(float) <= sizeof(kv[0]), "group states fit");
  static_assert(kMaxCluster * (D + 2) * sizeof(float) <= sizeof(kv[1]), "merge slots fit");
  static_assert(TILE <= kSplitThreads && TILE % NGRP == 0, "a thread a key's flag");
  const int S = gridDim.x, s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32;
  const int hk = h / (Hq / Hkv);
  const size_t qoff = ((size_t)b * Hq + h) * D;
  const size_t row = (size_t)Hkv * D;                    // elements from key j to j + 1
  const T* kb = k + (size_t)b * Lk * row + (size_t)hk * D;
  const T* vb = v + (size_t)b * Lk * row + (size_t)hk * D;
  const int qp = q_pos[b];
  const int j0 = s * chunk, j1 = min(Lk, j0 + chunk);
  const int tiles = j1 > j0 ? (j1 - j0 + TILE - 1) / TILE : 0;
  auto ks = [&](int buf) { return reinterpret_cast<T*>(kv[buf]); };
  auto vs = [&](int buf) { return reinterpret_cast<T*>(kv[buf] + kTileBytes); };

  // whether this thread's key of tile t is allowed (0 past the chunk)
  auto allowed = [&](int t) {
    const int j = j0 + t * TILE + tid;
    if (tid >= TILE || t >= tiles || j >= j1) return 0;
    const int kp = k_pos[(size_t)b * Lk + j];
    return (int)(kp >= 0 && kp <= qp && (kp < sink || qp - kp < window));
  };
  // copy tile t's allowed rows of K and V into stage buf: 16 bytes a copy,
  // neighbouring threads on neighbouring bytes of a row
  auto issue = [&](int t, int buf) {
    const int t0 = j0 + t * TILE;
    for (int i = tid; i < 2 * TILE * CPR; i += kSplitThreads) {
      const int which = i / (TILE * CPR), r = i / CPR % TILE, c = i % CPR;
      if (sok[buf][r]) {
        const T* src = (which ? vb : kb) + (size_t)(t0 + r) * row + c * VE;
        cp_async((which ? vs(buf) : ks(buf)) + r * D + c * VE, src, 16, 16);
      }
    }
  };

  // key groups: the 8 lanes of group grp take keys grp, grp + NGRP, ... of
  // every tile with their own running state; lane li holds chunks li, li +
  // 8, ... of q and of the group's accumulator
  const int grp = tid / 8, li = lane % 8;
  const unsigned gmask = 0xFFu << (lane / 8 * 8);
  float qv[QC][VE], acc[QC][VE];
#pragma unroll
  for (int c = 0; c < QC; ++c) {
    if (li + 8 * c < CPR) Vec<T>::load(q + qoff + (li + 8 * c) * VE, qv[c]);
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[c][e] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  // two stages in flight: tile t + 1's copies (and tile t + 2's k_pos) are
  // issued before tile t is used; a tile with no allowed key loads nothing
  int ok = allowed(0);
  if (tid < TILE) sok[0][tid] = ok;
  int any = __syncthreads_or(ok);
  if (any) issue(0, 0);
  cp_async_commit();
  ok = allowed(1);
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (tid < TILE) sok[buf ^ 1][tid] = ok;
    const int any_next = __syncthreads_or(ok);
    if (any_next) issue(t + 1, buf ^ 1);
    cp_async_commit();
    ok = allowed(t + 2);
    cp_async_wait<1>();                                  // tile t has landed
    __syncthreads();
    if (any) {
      const int n = min(TILE, j1 - (j0 + t * TILE));
      const T* kt = ks(buf);
      const T* vt = vs(buf);
      for (int r = grp; r < n; r += NGRP) {
        if (!sok[buf][r]) continue;                      // the same for the group's lanes
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < QC; ++c) {
          if (li + 8 * c < CPR) {
            float x[VE];
            Vec<T>::load(kt + r * D + (li + 8 * c) * VE, x);
#pragma unroll
            for (int e = 0; e < VE; ++e) part += qv[c][e] * x[e];
          }
        }
        part += __shfl_xor_sync(gmask, part, 4);
        part += __shfl_xor_sync(gmask, part, 2);
        part += __shfl_xor_sync(gmask, part, 1);
        float sv = part;
        if (round_scores) sv = to_f32(from_f32<T>(sv));
        sv *= scale;
        if (softcap > 0.f) sv = tanhf(sv / softcap) * softcap;
        // online softmax, one exp a key: the larger of (m, sv) is the new max
        float alpha = 1.f, p = 1.f;
        if (sv > m) {
          alpha = expf(m - sv);                          // 0 while m is -inf
          m = sv;
        } else {
          p = expf(sv - m);
        }
        l = l * alpha + p;
#pragma unroll
        for (int c = 0; c < QC; ++c) {
          if (li + 8 * c < CPR) {
            float x[VE];
            Vec<T>::load(vt + r * D + (li + 8 * c) * VE, x);
#pragma unroll
            for (int e = 0; e < VE; ++e) acc[c][e] = acc[c][e] * alpha + p * x[e];
          }
        }
      }
    }
    __syncthreads();                                     // stage buf consumed
    any = any_next;
  }
  cp_async_wait<0>();

  // the block's state: the groups' merged in order
  float* gst = reinterpret_cast<float*>(kv[0]);          // [NGRP][D + 2]
#pragma unroll
  for (int c = 0; c < QC; ++c) {
    if (li + 8 * c < CPR) {
#pragma unroll
      for (int e = 0; e < VE; ++e) gst[grp * (D + 2) + (li + 8 * c) * VE + e] = acc[c][e];
    }
  }
  if (li == 0) {
    gst[grp * (D + 2) + D] = m;
    gst[grp * (D + 2) + D + 1] = l;
  }
  __syncthreads();
  auto merge = [&](const float* st, int n, int d, float& mo, float& lo) {
    mo = -INFINITY;
    for (int i = 0; i < n; ++i) mo = fmaxf(mo, st[i * (D + 2) + D]);
    float lb = 0.f, ab = 0.f;
    for (int i = 0; i < n; ++i) {
      const float mi = st[i * (D + 2) + D];
      const float f = mi == -INFINITY ? 0.f : expf(mi - mo);
      lb += st[i * (D + 2) + D + 1] * f;
      ab += st[i * (D + 2) + d] * f;
    }
    lo = lb;
    return ab;
  };
  float a = 0.f;
  if (tid < D) a = merge(gst, NGRP, tid, m, l);
  if (S == 1) {
    if (tid < D) out[qoff + tid] = from_f32<T>(l == 0.f ? 0.f : a / l);
    return;
  }
  // merge the cluster's blocks in order into block 0's slots [S][D + 2]
  cg::cluster_group cluster = cg::this_cluster();
  float* slots = reinterpret_cast<float*>(kv[1]);
  cluster.sync();                                        // block 0 is done with its tiles
  float* dst = cluster.map_shared_rank(slots + s * (D + 2), 0);
  if (tid < D) dst[tid] = a;
  if (tid == 0) {
    dst[D] = m;
    dst[D + 1] = l;
  }
  cluster.sync();
  if (s != 0 || tid >= D) return;
  a = merge(slots, S, tid, m, l);
  out[qoff + tid] = from_f32<T>(l == 0.f ? 0.f : a / l);
}

template <int D, typename T>
static cudaError_t launch_split(const T* q, const T* k, const T* v, const int* q_pos,
                                const int* k_pos, T* out, int B, int Lk, int Hq, int Hkv,
                                int sink, int window, float softcap, float scale,
                                bool round_scores, cudaStream_t stream) {
  int S, chunk;
  split_keys(Lk, S, chunk);
  auto kernel = split_decode_kernel<D, T>;
  if (S > 8) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, Hq, B);
  cfg.blockDim = dim3(kSplitThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, q, k, v, q_pos, k_pos, out, Lk, Hq, Hkv, chunk, sink,
                            window, softcap, scale, round_scores);
}

// Lq == 1: the split-key decode class; Lq > 1: a block per query
template <int D, typename T>
static cudaError_t launch(const void* q, const void* k, const void* v, const int* q_pos,
                          const int* k_pos, void* out, int B, int Lq, int Lk, int Hq, int Hkv,
                          int sink, int window, float softcap, float scale, bool round_scores,
                          cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if (Lq == 1) {
    return launch_split<D, T>(qt, kt, vt, q_pos, k_pos, ot, B, Lk, Hq, Hkv, sink, window,
                              softcap, scale, round_scores, stream);
  }
  dim3 grid(Lq, Hq, B);
  sparse_attn_kernel<D, T><<<grid, kAttnThreads, 0, stream>>>(
      qt, kt, vt, q_pos, k_pos, ot, Lq, Lk, Hq, Hkv, sink, window, softcap, scale,
      round_scores);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                              const int* q_pos, const int* k_pos, void* out, int B, int Lq,
                              int Lk, int Hq, int Hkv, int sink, int window, float softcap,
                              float scale, bool rs, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<16, T>(q, k, v, q_pos, k_pos, out, B, Lq, Lk, Hq, Hkv, sink, window,
                           softcap, scale, rs, s);
    case 32:
      return launch<32, T>(q, k, v, q_pos, k_pos, out, B, Lq, Lk, Hq, Hkv, sink, window,
                           softcap, scale, rs, s);
    case 64:
      return launch<64, T>(q, k, v, q_pos, k_pos, out, B, Lq, Lk, Hq, Hkv, sink, window,
                           softcap, scale, rs, s);
    case 80:
      return launch<80, T>(q, k, v, q_pos, k_pos, out, B, Lq, Lk, Hq, Hkv, sink, window,
                           softcap, scale, rs, s);
    default:
      return cudaErrorInvalidValue;
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
  if (dtype == kF32)
    return (int)dispatch_d<float>(D, q, k, v, qp, kp, out, B, Lq, Lk, Hq, Hkv, sink, window,
                                  softcap, scale, round_scores != 0, s);
  if (dtype == kBF16)
    return (int)dispatch_d<__nv_bfloat16>(D, q, k, v, qp, kp, out, B, Lq, Lk, Hq, Hkv, sink,
                                          window, softcap, scale, round_scores != 0, s);
  return (int)cudaErrorInvalidValue;
}
