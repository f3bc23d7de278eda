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
// Head sizes D = 16, 32, 64, 80, 100, 160 and 256.  Rows move in vectors of
// 16 bytes where the row size allows, else 8 (a bf16 row of D = 100 is 200
// bytes, so its heads start 8 bytes past a 16-byte boundary).
//
// Three classes, chosen by Lq and the dtypes alone (launch, at the end):
//
//  * decode (Lq == 1): split_decode_kernel, flash-decoding in one launch.
//    Bound on the H100 by bytes: every allowed key's K and V rows are read
//    once per q head (1024 x 32 x 64 x 2 x 2 B = 8.4 MB per layer per slot
//    over the full ring in bf16), and the rows are 128 bytes at a 4 KB
//    stride.  The keys are split over the S blocks of a thread-block
//    cluster, one cluster per (q head, batch row); S and each block's key
//    range are a function of Lk alone (split_keys: 256 keys a block, at
//    most 16 blocks, beyond that the chunks grow; 4 blocks at Lk = 1024, so
//    that all of a decode step's 512 blocks are resident at once).  A block
//    walks its chunk in tiles of 64 keys (32 for rows over 160 bytes), held
//    in dynamic shared memory (64 KB at D = 256 in bf16): it reads a tile's
//    k_pos, then copies only the allowed rows' K and V into shared memory
//    with cp.async of the row's vector size, two tiles in flight; a tile with
//    no allowed key loads nothing.  Each group of 8 lanes takes every 16th
//    key of a tile and folds it into the group's own running (max,
//    denominator, accumulator), one exp a key; the groups merge in order,
//    then the blocks in block order through distributed shared memory: no
//    atomics, no second pass.
//    The same kernel takes float32 q over bfloat16 K and V (the
//    stub-frontend models' float32 stream reading its bfloat16 ring): the
//    rows are copied and staged as bfloat16, converted in registers (exact),
//    and everything after is float32, with a float32 output.  That is the
//    plain version's function (it upcasts K and V first), without a float32
//    copy of the ring: 1024 x 8 x 160 x 2 x 4 B = 10.5 MB a layer a slot at
//    pixtral-12b's shape.
//
//  * bf16 prefill (Lq > 1): attn_prefill_kernel, flash attention on the
//    tensor cores.  A prefill pack (256 queries x 32 heads over 1280 keys)
//    reads 12.6 MB and does 2.1 GFLOP of allowed products: 3.8 us by bytes,
//    2.2 by operations at the bf16 peak.  One block per query (8192 blocks
//    on FMAs, every K and V row read once per query) is two orders of
//    magnitude off that; what bounds this class on the H100 is instruction
//    issue and latency in its tile loop, not bytes or the tensor cores.
//    - Rows are staged zero-padded to a multiple of 16 columns (D = 100 ->
//      112: the zero columns add exact zeros to q.k, and the output's padding
//      columns are not stored); three stages where they fit the card's 227
//      KB, two at D = 256.
//    - A block takes 64 queries of one q head, 4 warps of 16 rows.  S = Q K^T
//      and O += P V run on mma.sync m16n8k16 with float32 accumulators; Q
//      and K fragments by ldmatrix, V by ldmatrix.trans, from tiles of 64
//      keys staged by 16-byte cp.async (rows padded by 16 bytes: no bank
//      conflicts), three stages and one barrier a tile, each tile's k_pos
//      loaded a tile ahead.  Each K and V row is read once per query tile.
//    - A tile in which no (query, key) pair of the block's position range
//      can be allowed loads and computes nothing (most sink and window slots
//      of a young stream are empty, and a pack's own keys are causal); a
//      tile in which every pair is allowed skips the mask.
//    - Per element the scalar work is what costs: scores are rounded to
//      bf16 (round_scores) on the integer pipe, the scale is folded into a
//      base-2 exponent, and P goes to the tensor cores as hi + lo bf16
//      halves cut by truncation and paired by byte permutes, which keeps p
//      to 2^-15 of itself (a single bf16 P keeps it to 2^-8, visibly off the
//      float32 softmax of the plain version at short rows).
//    - A pack gives only 4 x 32 query tiles, so the keys of each (query
//      tile, head) are split over a cluster (split_prefill: blocks of at
//      least 9 tiles, 2 of 640 keys at Lk = 1280, none below 1152).  Each
//      block pushes its rows' states into the block that owns them
//      (distributed shared memory, stores only), and each owner merges its
//      share of the rows over the S states in block order.
//
//  * float32 prefill (Lq > 1): attn_prefill_f32_kernel, one block per
//    (query, q head, batch row), its threads striding over the
//    keys on FMAs with a float32 state each, merged in a fixed order.
//    mma.sync takes no float32 operands and TF32 would miss the 3e-4
//    attention tolerance.  It serves the reduced models' parity checks and
//    the stub-frontend models' admissions at width (musicgen-medium at D =
//    64, pixtral-12b at D = 160: their residual stream is float32), where
//    a thread's q and accumulator rows spill at D = 160 and 256.
//
// Batch invariance, in every class: the order in which a query's terms are
// summed depends on (Lk, D, dtype, class) only -- never on B, on Lq, on the
// other queries of a tile, or on timing.  Each row keeps its own max,
// denominator and accumulator; the key split is a function of Lk; a skipped
// tile leaves a row's state bit for bit as computing it would (its scores
// are all -inf there: the max stays, the rescale is exactly 1, P is exact
// zeros), so whether another query of the tile needed it does not matter.
#include <climits>

#include "common.cuh"

namespace tenet {

constexpr int kAttnThreads = 128;
constexpr int kAttnWarps = kAttnThreads / 32;

// the bytes of a vector load of a row of D values of T: 16 where the row
// size allows, else 8 or 4.  Every row of q, k, v starts at a multiple of
// the row size (its head's offset, its token's, its batch row's), so this
// is the alignment every row has: 16 at D = 64, 8 for a bf16 row of D = 100
// (200 bytes), whose head rows start 8 bytes past a 16-byte boundary
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

template <typename T, int D> __host__ __device__ constexpr int vec_bytes() {
  return D * (int)sizeof(T) % 16 == 0 ? 16 : D * (int)sizeof(T) % 8 == 0 ? 8 : 4;
}

// NB bytes of a row as float32 (NB = 16, 8 or 4)
template <typename T, int NB> struct Vec {
  static constexpr int n = NB / (int)sizeof(T);
  using Raw = typename std::conditional<NB == 16, uint4,
                                        typename std::conditional<NB == 8, uint2,
                                                                  unsigned>::type>::type;
  static __device__ __forceinline__ void load(const T* __restrict__ p, float (&o)[n]) {
    const Raw raw = *reinterpret_cast<const Raw*>(p);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < n; ++e) o[e] = to_f32(v[e]);
  }
};

// N values of T from p as float32, in 16-byte loads where N values of T
// take more (float32 q beside bfloat16 K rows: 8 values, 32 bytes)
template <typename T, int N>
__device__ __forceinline__ void load_vals(const T* __restrict__ p, float (&o)[N]) {
  constexpr int NB = N * (int)sizeof(T);
  if constexpr (NB <= 16) {
    Vec<T, NB>::load(p, o);
  } else {
    static_assert(NB % 16 == 0, "whole 16-byte loads");
    constexpr int M = 16 / (int)sizeof(T);
#pragma unroll
    for (int i = 0; i < N / M; ++i) {
      float t[M];
      Vec<T, 16>::load(p + i * M, t);
#pragma unroll
      for (int e = 0; e < M; ++e) o[i * M + e] = t[e];
    }
  }
}

// --- float32 prefill class: a block per (query, q head, batch row) ----------

template <int D, typename T>
__global__ void __launch_bounds__(kAttnThreads)
attn_prefill_f32_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                   T* __restrict__ out, int Lq, int Lk, int Hq, int Hkv, int sink, int window,
                   float softcap, float scale, bool round_scores) {
  __shared__ float s_m[kAttnWarps], s_l[kAttnWarps], s_acc[kAttnWarps][D];
  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t qoff = (((size_t)b * Lq + iq) * Hq + h) * D;
  using VL = Vec<T, vec_bytes<T, D>()>;
  constexpr int V = VL::n;
  float t[V];
  float qv[D];
#pragma unroll
  for (int i = 0; i < D / V; ++i) {
    VL::load(q + qoff + i * V, t);
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
      VL::load(k + koff + i * V, t);
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
      VL::load(v + koff + i * V, t);
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
  for (int d = threadIdx.x; d < D; d += kAttnThreads) {
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

// a cluster kernel's dynamic shared memory and clusters of up to 16 blocks
template <typename K>
static cudaError_t set_attributes(K kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// the blocks of a cluster for Lk keys, and the keys of each block
__host__ __forceinline__ void split_keys(int Lk, int& S, int& chunk) {
  S = (Lk + kSplitKeys - 1) / kSplitKeys;
  S = S < 1 ? 1 : S > kMaxCluster ? kMaxCluster : S;
  chunk = (Lk + S - 1) / S;
}

// the split decode class's tiles and its dynamic shared memory: two stages
// of K and V tiles; after the last tile stage 0 holds the key groups'
// states and stage 1 the cluster's merge slots (block 0's)
template <int D, typename T> struct SplitSmem {
  static constexpr int kTile = D * (int)sizeof(T) <= 160 ? 64 : 32;   // keys of a tile
  static constexpr int kTileBytes = kTile * D * (int)sizeof(T);
  static constexpr int kGroups = kSplitThreads / 8;                  // key groups of 8 lanes
  static constexpr int kStage =
      (imax(2 * kTileBytes, imax(kGroups, kMaxCluster) * (D + 2) * 4) + 15) / 16 * 16;
  static constexpr int kBytes = 2 * kStage;
};

// TQ: q and out; T: K and V (TQ == T, or float32 q over bfloat16 K/V)
template <int D, typename TQ, typename T>
__global__ void __launch_bounds__(kSplitThreads)
split_decode_kernel(const TQ* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                    TQ* __restrict__ out, int Lk, int Hq, int Hkv, int chunk, int sink,
                    int window, float softcap, float scale, bool round_scores) {
  using Sm = SplitSmem<D, T>;
  constexpr int VB = vec_bytes<T, D>();                  // bytes of a K/V copy and load
  using VL = Vec<T, VB>;
  constexpr int VE = VL::n;                              // values of a vector
  constexpr int CPR = D / VE;                            // vectors a row
  constexpr int TILE = Sm::kTile;
  constexpr int NGRP = Sm::kGroups;
  constexpr int QC = (CPR + 7) / 8;                      // vectors of a lane
  constexpr int kTileBytes = Sm::kTileBytes;
  constexpr int DPT = (D + kSplitThreads - 1) / kSplitThreads;   // output columns a thread
  extern __shared__ __align__(16) unsigned char kv_smem[];
  unsigned char* kv[2] = {kv_smem, kv_smem + Sm::kStage};
  __shared__ int sok[2][TILE];                           // allowed keys of a stage
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
        cp_async((which ? vs(buf) : ks(buf)) + r * D + c * VE, src, VB, VB);
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
    if (li + 8 * c < CPR) load_vals<TQ, VE>(q + qoff + (li + 8 * c) * VE, qv[c]);
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
            VL::load(kt + r * D + (li + 8 * c) * VE, x);
#pragma unroll
            for (int e = 0; e < VE; ++e) part += qv[c][e] * x[e];
          }
        }
        part += __shfl_xor_sync(gmask, part, 4);
        part += __shfl_xor_sync(gmask, part, 2);
        part += __shfl_xor_sync(gmask, part, 1);
        float sv = part;
        if (round_scores) sv = to_f32(from_f32<TQ>(sv));
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
            VL::load(vt + r * D + (li + 8 * c) * VE, x);
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
  // thread tid takes columns tid, tid + kSplitThreads, ... (every thread
  // merges column tid < D, so thread 0 holds the merged m and l)
  float a[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int d = tid + i * kSplitThreads;
    a[i] = d < D ? merge(gst, NGRP, d, m, l) : 0.f;
  }
  if (S == 1) {
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = tid + i * kSplitThreads;
      if (d < D) out[qoff + d] = from_f32<TQ>(l == 0.f ? 0.f : a[i] / l);
    }
    return;
  }
  // merge the cluster's blocks in order into block 0's slots [S][D + 2]
  cg::cluster_group cluster = cg::this_cluster();
  float* slots = reinterpret_cast<float*>(kv[1]);
  cluster.sync();                                        // block 0 is done with its tiles
  float* dst = cluster.map_shared_rank(slots + s * (D + 2), 0);
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int d = tid + i * kSplitThreads;
    if (d < D) dst[d] = a[i];
  }
  if (tid == 0) {
    dst[D] = m;
    dst[D + 1] = l;
  }
  cluster.sync();
  if (s != 0) return;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int d = tid + i * kSplitThreads;
    if (d < D) {
      const float ad = merge(slots, S, d, m, l);
      out[qoff + d] = from_f32<TQ>(l == 0.f ? 0.f : ad / l);
    }
  }
}

template <int D, typename TQ, typename T>
static cudaError_t launch_split(const TQ* q, const T* k, const T* v, const int* q_pos,
                                const int* k_pos, TQ* out, int B, int Lk, int Hq, int Hkv,
                                int sink, int window, float softcap, float scale,
                                bool round_scores, cudaStream_t stream) {
  int S, chunk;
  split_keys(Lk, S, chunk);
  constexpr int smem = SplitSmem<D, T>::kBytes;
  auto kernel = split_decode_kernel<D, TQ, T>;
  // the attributes once per instantiation (its first launch, before any
  // graph capture of the engine, which warms up first)
  static const cudaError_t attr_err = set_attributes(kernel, smem);
  if (attr_err != cudaSuccess) return attr_err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, Hq, B);
  cfg.blockDim = dim3(kSplitThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, q, k, v, q_pos, k_pos, out, Lk, Hq, Hkv, chunk, sink,
                            window, softcap, scale, round_scores);
}

// --- bf16 prefill class: query tiles on the tensor cores ------------------------

using bf16 = __nv_bfloat16;

constexpr int kPfWarps = 4;                    // 16 query rows a warp
constexpr int kPfKeys = 64;                    // keys of a tile
constexpr int kPfStages = 3;                   // key tiles in flight
constexpr int kPfMinKeys = 9 * kPfKeys;       // keys of a block of the cluster, at least
constexpr float kLog2e = 1.4426950408889634f;

// the blocks of a (query tile, head)'s cluster for Lk keys and the keys of
// each, whole tiles: a function of Lk alone.  Each block takes at least 9
// tiles, so that its fixed cost (the Q tile, the cluster merge) stays a
// small part of its work: 2 blocks of 640 keys at Lk = 1280, one block up
// to Lk = 1151
__host__ __forceinline__ void split_prefill(int Lk, int& S, int& chunk) {
  S = Lk / kPfMinKeys;
  S = S < 1 ? 1 : S > kMaxCluster ? kMaxCluster : S;
  chunk = ((Lk + S - 1) / S + kPfKeys - 1) / kPfKeys * kPfKeys;
  S = (Lk + chunk - 1) / chunk;
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; 2^-inf == 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a block's dynamic shared memory: the Q tile, kNS stages of K and V tiles
// with their k_pos and flags; after the last tile the stages take the
// cluster's row states (S blocks x the block's share of rows).  Rows are
// staged zero-padded to DP, a multiple of 16 (whole mma k-steps: D = 100
// takes 112, whose 12 zero columns add exact zeros to q.k and give output
// columns that are not stored).  Three stages where they fit the card's 227
// KB, else two (D = 256: 3 would take 232 KB)
constexpr int kSmemOptIn = 227 * 1024;
template <int D, int NW> struct PfSmem {
  static constexpr int kDP = (D + 15) / 16 * 16;
  static constexpr int kRow = kDP + 8;         // bf16 of a staged row: +16 B, no bank conflicts
  static constexpr int kRows = 16 * NW;        // queries of a tile
  static constexpr int kQ = kRows * kRow * 2;
  static constexpr int kKV = kPfKeys * kRow * 2;
  static constexpr int kNS =
      kQ + kPfStages * 2 * kKV + (kPfStages + 1) * (kPfKeys + 2) * 4 <= kSmemOptIn ? kPfStages
                                                                                   : 2;
  static constexpr int kStages = kNS * 2 * kKV;
  static constexpr int kBytes = kQ + kStages + (kNS + 1) * (kPfKeys + 2) * 4;
  static_assert(kBytes <= kSmemOptIn, "a block's shared memory fits the card");
  static_assert((kRows + kMaxCluster) * (kDP + 2) * 4 <= kStages, "row states fit the stages");
};

template <int D, int NW>
__global__ void __launch_bounds__(NW * 32)
attn_prefill_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ q_pos,
                    const int* __restrict__ k_pos, bf16* __restrict__ out, int Lq, int Lk,
                    int Hq, int Hkv, int S, int chunk, int sink, int window, float softcap,
                    float scale, bool round_scores) {
  using Sm = PfSmem<D, NW>;
  constexpr int NT = NW * 32, BQ = Sm::kRows, BK = kPfKeys, RS = Sm::kRow, NS = Sm::kNS;
  constexpr int DP = Sm::kDP;                  // staged columns: D, zero-padded to 16
  constexpr int NP = NS + 1;                   // k_pos slots: one more than the stages
  constexpr int VB = vec_bytes<bf16, D>();     // bytes of a copy
  constexpr int VE = VB / 2;                   // values of a copy
  constexpr int CPG = D / VE;                  // copies of a row in global memory
  constexpr int CPR = DP / VE;                 // copies of a staged row (zeros past CPG)
  constexpr int KS = DP / 16;                  // k-steps of q.k
  constexpr int ND = DP / 8;                   // 8-column tiles of the output
  constexpr int ST = DP + 2;                   // floats of a row's state: acc, m, l
  constexpr int CPT = 2 * BK * CPR / NT;       // copies of a thread per tile
  static_assert(BK == 64 && NT >= BK && 2 * BK * CPR % NT == 0 && D % 2 == 0,
                "two warps a tile's keys; whole copies; column pairs");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_qlo, s_qhi;
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* skv = reinterpret_cast<bf16*>(smem + Sm::kQ);          // [stage][K | V][BK][RS]
  int* skp = reinterpret_cast<int*>(smem + Sm::kQ + Sm::kStages);   // [slot][BK]
  int* sfl = skp + NP * BK;                                         // [slot][2 warps]

  const int s = blockIdx.x % S, q0 = blockIdx.x / S * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tg = lane % 4;       // the fragments' row and column lanes
  const int hk = h / (Hq / Hkv);
  const size_t krow = (size_t)Hkv * D, qrow = (size_t)Hq * D;
  const bf16* kb = k + (size_t)b * Lk * krow + (size_t)hk * D;
  const bf16* vb = v + (size_t)b * Lk * krow + (size_t)hk * D;
  const bf16* qb = q + ((size_t)b * Lq + q0) * qrow + (size_t)h * D;
  const int j0 = s * chunk, j1 = min(Lk, j0 + chunk);
  const int tiles = j1 > j0 ? (j1 - j0 + BK - 1) / BK : 0;
  // scores to base-2 logits: exp(x * scale - m) == 2^(x * c - m'), c = scale * log2(e),
  // with x rounded to bf16 first under round_scores; the soft-cap applies its
  // tanh to x * scale, so with it c = log2(e)
  const bool cap = softcap > 0.f;
  const float c2 = (cap ? 1.f : scale) * kLog2e;

  // the Q tile (rows past Lq and columns past D as zeros) and the range of
  // its positions
  for (int i = tid; i < BQ * CPR; i += NT) {
    const int r = i / CPR, c = i % CPR;
    const bool in = q0 + r < Lq && c < CPG;
    cp_async(sq + r * RS + c * VE, in ? qb + (size_t)r * qrow + c * VE : qb, VB, in ? VB : 0);
  }
  if (tid == 0) {
    s_qlo = INT_MAX;
    s_qhi = INT_MIN;
  }
  __syncthreads();
  if (tid < BQ && q0 + tid < Lq) {
    const int p = q_pos[(size_t)b * Lq + q0 + tid];
    atomicMin(&s_qlo, p);
    atomicMax(&s_qhi, p);
  }
  int qp[2];                                   // rows r0 and r0 + 8; -1 past Lq: nothing allowed
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + r0 + 8 * i;
    qp[i] = r < Lq ? q_pos[(size_t)b * Lq + r] : -1;
  }
  __syncthreads();
  const int qlo = s_qlo, qhi = s_qhi;

  // this thread's key of tile t (-1 past the chunk)
  auto key_pos = [&](int t) {
    const int j = j0 + t * BK + tid;
    return tid < BK && t < tiles && j < j1 ? k_pos[(size_t)b * Lk + j] : -1;
  };
  // tile t's positions into slot t % NP with its flags: bit 0, some query
  // of the block may attend some key (a superset of the allowed pairs); bit
  // 1, every query may attend every key (no mask)
  auto publish = [&](int t, int kp) {
    if (tid < BK) {
      skp[t % NP * BK + tid] = kp;
      const bool some = kp >= 0 && kp <= qhi && (kp < sink || qlo - kp < window);
      const bool all = kp >= 0 && kp <= qlo && (kp < sink || qhi - kp < window);
      const unsigned bs = __ballot_sync(0xffffffffu, some), ba = __ballot_sync(0xffffffffu, all);
      if (lane == 0) sfl[t % NP * 2 + warp] = (bs != 0u) | (ba == 0xffffffffu) << 1;
    }
  };
  auto flags = [&](int t) {
    const int a = sfl[t % NP * 2], c = sfl[t % NP * 2 + 1];
    return ((a | c) & 1) | (a & c & 2);
  };
  auto stage_k = [&](int t) { return skv + (size_t)(2 * (t % NS)) * BK * RS; };
  auto stage_v = [&](int t) { return skv + (size_t)(2 * (t % NS) + 1) * BK * RS; };
  // tile t's K and V rows into its stage when some query may attend it, VB
  // bytes a copy, neighbouring threads on neighbouring bytes of a row;
  // empty slots, keys past the chunk and columns past D as zeros
  auto issue = [&](int t) {
    if (t >= tiles || !(flags(t) & 1)) return;
    const int t0 = j0 + t * BK;
    const int* kpt = skp + t % NP * BK;
    bf16* ks = stage_k(t);
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      const int i = tid + u * NT;
      const int which = i / (BK * CPR), r = i / CPR % BK, c = i % CPR;
      const bool live = kpt[r] >= 0 && c < CPG;
      const bf16* src = (which ? vb : kb) + (live ? (size_t)(t0 + r) * krow + c * VE : 0);
      cp_async(ks + which * BK * RS + r * RS + c * VE, src, VB, live ? VB : 0);
    }
  };

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // per row: running max of the base-2 logits, denominator
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // NS - 1 tiles in flight while one is used; one barrier a tile: tile t + NS
  // - 1 goes into the stage that tile t - 1 used, and tile t + NS's
  // positions (loaded a tile ahead) into the slot of tile t - 1
#pragma unroll
  for (int t = 0; t < NS; ++t) publish(t, key_pos(t));
  int kp = key_pos(NS);
  __syncthreads();
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {
    issue(t);
    cp_async_commit();                         // the first with the Q tile
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<NS - 2>();                   // tile t (and the Q tile) have landed
    __syncthreads();
    issue(t + NS - 1);
    cp_async_commit();
    publish(t + NS, kp);
    kp = key_pos(t + NS + 1);
    const int fl = flags(t);
    if (!(fl & 1)) continue;
    const bf16* kt = stage_k(t);
    const bf16* vt = stage_v(t);
    const int* kpt = skp + t % NP * BK;
    // S = Q K^T: 16 rows x 64 keys a warp, 8 tiles of 8 keys
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      unsigned qf[4];                          // the warp's 16 rows of Q, k-step ks
      ldmatrix_x4(qf, sq + (warp * 16 + lane % 16) * RS + ks * 16 + lane / 16 * 8);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        unsigned bm[4];
        ldmatrix_x4(bm, kt + (p * 16 + lane % 8 + lane / 16 * 8) * RS + ks * 16 +
                            (lane / 8 % 2) * 8);
        mma_bf16(sc[2 * p], qf, bm[0], bm[1]);
        mma_bf16(sc[2 * p + 1], qf, bm[2], bm[3]);
      }
    }
    // element e of tile n: row r0 + 8 (e / 2), key 8n + 2 tg + e % 2.
    // round_scores: to bf16, nearest even, on the integer pipe
    if (round_scores) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const unsigned u = __float_as_uint(sc[n][e]);
          sc[n][e] = __uint_as_float((u + 0x7fffu + (u >> 16 & 1u)) & 0xffff0000u);
        }
      }
    }
    if (cap) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = tanhf(sc[n][e] * scale / softcap) * softcap;
      }
    }
    if (!(fl & 2)) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int2 kp2 = *reinterpret_cast<const int2*>(kpt + n * 8 + 2 * tg);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = e & 1 ? kp2.y : kp2.x, qi = qp[e >> 1];
          if (!(kj >= 0 && kj <= qi && (kj < sink || qi - kj < window))) sc[n][e] = -INFINITY;
        }
      }
    }
    // online softmax per row in base 2: a row with no allowed key so far
    // keeps a zero state; a tile that does not raise the max rescales by
    // exactly 1 (and skips the multiply)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
    }
    float mu[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float mn = fmaxf(m[i], mx[i] * c2);
      mu[i] = mn == -INFINITY ? 0.f : mn;
      alpha[i] = mn == m[i] ? 1.f : ex2(m[i] - mu[i]);
      m[i] = mn;
      l[i] *= alpha[i];
    }
    if (alpha[0] != 1.f || alpha[1] != 1.f) {
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = ex2(sc[n][e] * c2 - mu[e >> 1]);
        l[e >> 1] += sc[n][e];
      }
    }
    // O += P V, 16 keys a k-step: P's accumulator layout is the A
    // fragment's, split as p = hi + lo with hi the top 8 bits of p's
    // significand (exact remainder) and lo the top 8 of the rest, both
    // paired by a byte permute: p to about 2^-15 of itself
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned ph[4], pl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* pv = &sc[2 * kk + i / 2][(i % 2) * 2];
        const unsigned u0 = __float_as_uint(pv[0]), u1 = __float_as_uint(pv[1]);
        ph[i] = __byte_perm(u0, u1, 0x7632);
        const float r0f = pv[0] - __uint_as_float(u0 & 0xffff0000u);
        const float r1f = pv[1] - __uint_as_float(u1 & 0xffff0000u);
        pl[i] = __byte_perm(__float_as_uint(r0f), __float_as_uint(r1f), 0x7632);
      }
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        unsigned bm[4];
        ldmatrix_x4_trans(bm, vt + (kk * 16 + lane % 8 + (lane / 8 % 2) * 8) * RS + dp * 16 +
                                  lane / 16 * 8);
        mma_bf16(acc[2 * dp], ph, bm[0], bm[1]);
        mma_bf16(acc[2 * dp + 1], ph, bm[2], bm[3]);
        mma_bf16(acc[2 * dp], pl, bm[0], bm[1]);
        mma_bf16(acc[2 * dp + 1], pl, bm[2], bm[3]);
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  auto store = [&](int row, int col, float a0, float a1, float lr) {
    if (q0 + row >= Lq || col >= D) return;    // padding columns are not stored
    const float o0 = lr == 0.f ? 0.f : a0 / lr, o1 = lr == 0.f ? 0.f : a1 / lr;
    *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * Lq + q0 + row) * qrow +
                                       (size_t)h * D + col) = __floats2bfloat162_rn(o0, o1);
  };
  if (S == 1) {                                // the block's own rows: out = acc / l
#pragma unroll
    for (int n = 0; n < ND; ++n) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        store(r0 + 8 * i, n * 8 + 2 * tg, acc[n][2 * i], acc[n][2 * i + 1], l[i]);
    }
    return;
  }

  // the cluster's merge: block s owns rows [s * share, (s + 1) * share) of
  // the tile; every block pushes its state of each row into the owner's
  // slots [S][share][acc | m | l] (remote stores), and each owner merges
  // its rows over the S states in block order
  cg::cluster_group cluster = cg::this_cluster();
  const int share = (BQ + S - 1) / S;
  float* slots = reinterpret_cast<float*>(skv);
  cluster.sync();                              // every block is done with its stages
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i, owner = row / share;
    float* dst = cluster.map_shared_rank(slots, owner) + (s * share + row % share) * ST;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(dst + n * 8 + 2 * tg) = make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
    if (tg == 0) *reinterpret_cast<float2*>(dst + DP) = make_float2(m[i], l[i]);
  }
  cluster.sync();
  const int ra = s * share, rows = max(0, min(BQ, ra + share) - ra);
  float* sf = reinterpret_cast<float*>(sq);    // [share][S factors | denominator]
  for (int r = tid; r < rows; r += NT) {
    float mo = -INFINITY;
    for (int i = 0; i < S; ++i) mo = fmaxf(mo, slots[(i * share + r) * ST + DP]);
    float lb = 0.f;
    for (int i = 0; i < S; ++i) {
      const float* si = slots + (i * share + r) * ST;
      const float f = si[DP] == -INFINITY ? 0.f : ex2(si[DP] - mo);
      sf[r * (S + 1) + i] = f;
      lb += si[DP + 1] * f;
    }
    sf[r * (S + 1) + S] = lb;
  }
  __syncthreads();
  for (int i = tid; i < rows * (D / 2); i += NT) {
    const int r = i / (D / 2), c = i % (D / 2) * 2;
    const float* f = sf + r * (S + 1);
    float a0 = 0.f, a1 = 0.f;
    for (int j = 0; j < S; ++j) {
      const float2 a = *reinterpret_cast<const float2*>(slots + (j * share + r) * ST + c);
      a0 += a.x * f[j];
      a1 += a.y * f[j];
    }
    store(ra + r, c, a0, a1, f[S]);
  }
}

template <int D>
static cudaError_t launch_prefill(const bf16* q, const bf16* k, const bf16* v, const int* q_pos,
                                  const int* k_pos, bf16* out, int B, int Lq, int Lk, int Hq,
                                  int Hkv, int sink, int window, float softcap, float scale,
                                  bool round_scores, cudaStream_t stream) {
  constexpr int NW = kPfWarps, smem = PfSmem<D, NW>::kBytes;
  int S, chunk;
  split_prefill(Lk, S, chunk);
  auto kernel = attn_prefill_kernel<D, NW>;
  static const cudaError_t attr_err = set_attributes(kernel, smem);
  if (attr_err != cudaSuccess) return attr_err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S * ((Lq + 16 * NW - 1) / (16 * NW)), Hq, B);
  cfg.blockDim = dim3(NW * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, q, k, v, q_pos, k_pos, out, Lq, Lk, Hq, Hkv, S, chunk,
                            sink, window, softcap, scale, round_scores);
}

// the class by Lq and the dtype: Lq == 1 the split-key decode; Lq > 1 the
// tensor-core prefill in bf16, a block per query in float32
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
    return launch_split<D, T, T>(qt, kt, vt, q_pos, k_pos, ot, B, Lk, Hq, Hkv, sink, window,
                                 softcap, scale, round_scores, stream);
  }
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_prefill<D>(qt, kt, vt, q_pos, k_pos, ot, B, Lq, Lk, Hq, Hkv, sink, window,
                             softcap, scale, round_scores, stream);
  } else {
    attn_prefill_f32_kernel<D, T><<<dim3(Lq, Hq, B), kAttnThreads, 0, stream>>>(
        qt, kt, vt, q_pos, k_pos, ot, Lq, Lk, Hq, Hkv, sink, window, softcap, scale,
        round_scores);
    return cudaGetLastError();
  }
}

// float32 q over bfloat16 K/V: the decode class only
template <int D>
static cudaError_t launch_mixed(const void* q, const void* k, const void* v, const int* q_pos,
                                const int* k_pos, void* out, int B, int Lq, int Lk, int Hq,
                                int Hkv, int sink, int window, float softcap, float scale,
                                bool round_scores, cudaStream_t stream) {
  if (Lq != 1) return cudaErrorInvalidValue;
  return launch_split<D, float, bf16>(static_cast<const float*>(q), static_cast<const bf16*>(k),
                                      static_cast<const bf16*>(v), q_pos, k_pos,
                                      static_cast<float*>(out), B, Lk, Hq, Hkv, sink, window,
                                      softcap, scale, round_scores, stream);
}

// the class of q's and K/V's dtypes, one instantiation a head size
template <typename T>
struct ByDtype {
  template <int D>
  static cudaError_t go(const void* q, const void* k, const void* v, const int* q_pos,
                        const int* k_pos, void* out, int B, int Lq, int Lk, int Hq, int Hkv,
                        int sink, int window, float softcap, float scale, bool rs,
                        cudaStream_t s) {
    return launch<D, T>(q, k, v, q_pos, k_pos, out, B, Lq, Lk, Hq, Hkv, sink, window, softcap,
                        scale, rs, s);
  }
};
struct Mixed {
  template <int D>
  static cudaError_t go(const void* q, const void* k, const void* v, const int* q_pos,
                        const int* k_pos, void* out, int B, int Lq, int Lk, int Hq, int Hkv,
                        int sink, int window, float softcap, float scale, bool rs,
                        cudaStream_t s) {
    return launch_mixed<D>(q, k, v, q_pos, k_pos, out, B, Lq, Lk, Hq, Hkv, sink, window,
                           softcap, scale, rs, s);
  }
};

template <typename C>
static cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                              const int* q_pos, const int* k_pos, void* out, int B, int Lq,
                              int Lk, int Hq, int Hkv, int sink, int window, float softcap,
                              float scale, bool rs, cudaStream_t s) {
  switch (D) {
#define TENET_ATTN_CASE(DV)                                                                  \
  case DV:                                                                                   \
    return C::template go<DV>(q, k, v, q_pos, k_pos, out, B, Lq, Lk, Hq, Hkv, sink, window, \
                              softcap, scale, rs, s);
    TENET_ATTN_CASE(16)
    TENET_ATTN_CASE(32)
    TENET_ATTN_CASE(64)
    TENET_ATTN_CASE(80)
    TENET_ATTN_CASE(100)
    TENET_ATTN_CASE(160)
    TENET_ATTN_CASE(256)
#undef TENET_ATTN_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tenet

// dtype: q's (and out's); kv_dtype: K's and V's, q's own or, with float32
// q at Lq == 1, bfloat16
extern "C" int tenet_sparse_attention(const void* q, const void* k, const void* v,
                                      const void* q_pos, const void* k_pos, void* out,
                                      int dtype, int kv_dtype, int B, int Lq, int Lk, int Hq,
                                      int Hkv, int D, int sink, int window, float softcap,
                                      float scale, int round_scores, void* stream) {
  using namespace tenet;
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(k_pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rs = round_scores != 0;
  if (dtype == kF32 && kv_dtype == kF32)
    return (int)dispatch_d<ByDtype<float>>(D, q, k, v, qp, kp, out, B, Lq, Lk, Hq, Hkv, sink,
                                           window, softcap, scale, rs, s);
  if (dtype == kBF16 && kv_dtype == kBF16)
    return (int)dispatch_d<ByDtype<bf16>>(D, q, k, v, qp, kp, out, B, Lq, Lk, Hq, Hkv, sink,
                                          window, softcap, scale, rs, s);
  if (dtype == kF32 && kv_dtype == kBF16)
    return (int)dispatch_d<Mixed>(D, q, k, v, qp, kp, out, B, Lq, Lk, Hq, Hkv, sink, window,
                                  softcap, scale, rs, s);
  return (int)cudaErrorInvalidValue;
}
