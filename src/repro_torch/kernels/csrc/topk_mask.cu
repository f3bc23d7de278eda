// das_topk: DAS per-32-lane top-k, compaction and masked dense copy, with an
// optional rmsnorm prologue.
//
// Replaces src/repro/kernels/topk_mask.py::_topk_mask_kernel (a 32x32
// broadcast compare on the TPU's vector unit) and the JAX model's
// das_compact / das_mask steps before every projection; with a norm scale
// also the rmsnorm that feeds the q/k/v and gate/up projections
// (models/layers.py::rmsnorm):
//
//   y = to_dtype((f32(x) * rsqrt(mean(f32(x)^2) + eps)) * (1 + f32(scale)))
//
// Lane i of a 32-lane block of y survives iff
//   #{ |y_j| > |y_i| } + #{ j < i : |y_j| == |y_i| } < keep,
// a strict total order, so exactly `keep` lanes of a full block survive.  A
// partial last block (K % 32 != 0, bitnet-1.3b's d_ff = 5460) keeps its
// lanes dense.
//
// Outputs (each may be null; the wrapper passes values and indices when 32
// divides K, else dense): mask (M, K) int8; values (M, K/32*keep) in x's
// dtype and indices (M, K/32*keep) int32, block b's survivors at [b*keep,
// (b+1)*keep) in ascending lane order; dense (M, K), y with dropped lanes
// zeroed (their sign kept, as y * 0); normed (M, K), y itself.
//
// Design.  A block of 128 threads takes 1024 lanes of a row (K = 2048: two
// blocks a row, 5460: six), so that a decode step's 4 rows spread over 8-24
// SMs; each thread owns 8 consecutive lanes (a 32-lane block is 4
// neighbouring threads of a warp), loaded and stored as vectors of A lanes,
// A the largest of 8, 4, 2, 1 that divides K (every tensor starts 16-byte
// aligned, so a row starts at a multiple of A lanes: bf16 d_ff = 5460 rows go
// as 8-byte vectors).  With the norm, every block of a row sums the squares
// of the whole row (its own lanes already in registers, the rest from L2) in
// one order that depends on K alone, so all blocks of the row, and the row at
// any M, get the same rsqrt bit for bit.  Ranking: a lane's key is |y|'s bits
// (bf16 & 0x7fff, f32 & 0x7fffffff: for finite values they order as |y|)
// above its reversed position in the block, unique within the block and
// ordered as the survival rule ranks; a bitonic network sorts the block's 32
// keys over its 4 threads (steps across threads by shuffles), and a lane
// survives iff its key is at least the keep-th largest: ~190 integer
// min/max a thread, against ~520 instructions to compare all pairs (the
// packed 16-bit compares of __vcmpgtu2 are not native on sm_90).  Survivors take
// their slot by a popcount of the block's kept mask, gathered by 2
// shuffles; a warp stages its 8 blocks' survivors in shared memory and
// stores them with 16-byte vectors.
//
// Contract: finite inputs.  A NaN orders above inf here; the plain version's
// float compare counts it as never greater.
//
// What bounds it on the H100: bytes (x, the scale and the outputs, once),
// and at decode (M = 4) the latency of a launch, a load and the network.
#include "common.cuh"

namespace tenet {

constexpr int kTopkThreads = 128;      // a block of threads takes 1024 lanes of a row
constexpr int kTopkChunk = 8 * kTopkThreads;
// a warp's 8 blocks of at most 32 survivors of 4 bytes, and 16 bytes of slack
// to co-align the staging with its destination
constexpr int kStageBytes = 16 + 8 * 32 * 4;
constexpr unsigned kAll = 0xffffffffu;

template <int P> struct Piece;
template <> struct Piece<1> { using type = uint8_t; };
template <> struct Piece<2> { using type = uint16_t; };
template <> struct Piece<4> { using type = uint32_t; };
template <> struct Piece<8> { using type = uint2; };
template <> struct Piece<16> { using type = uint4; };

// A thread's 8 lanes of E-byte elements (8E bytes, in the words w) moved
// between registers and memory in pieces of P = min(A * E, 16) bytes.  A
// piece lies wholly inside the row or wholly past its end (A divides K), so
// its first lane decides; lanes past the end load as 0 and are not stored.
template <int E, int A>
struct Lanes8 {
  static constexpr int P = A * E < 16 ? A * E : 16;
  static constexpr int kWords = 2 * E;
  static constexpr int kPieces = 8 * E / P;
  using V = typename Piece<P>::type;

  __device__ __forceinline__ static void load(const void* g, int lane0, int K,
                                              uint32_t (&w)[kWords]) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0u;
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      if (lane0 + i * P / E >= K) continue;
      const V v = __ldg(reinterpret_cast<const V*>(g) + i);
      if constexpr (P == 16) {
        w[4 * i] = v.x; w[4 * i + 1] = v.y; w[4 * i + 2] = v.z; w[4 * i + 3] = v.w;
      } else if constexpr (P == 8) {
        w[2 * i] = v.x; w[2 * i + 1] = v.y;
      } else if constexpr (P == 4) {
        w[i] = v;
      } else {  // 1 or 2 bytes
        w[i * P / 4] |= (uint32_t)v << (8 * ((i * P) % 4));
      }
    }
  }

  __device__ __forceinline__ static void store(void* g, int lane0, int K,
                                               const uint32_t (&w)[kWords]) {
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      if (lane0 + i * P / E >= K) continue;
      V v;
      if constexpr (P == 16) {
        v = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
      } else if constexpr (P == 8) {
        v = make_uint2(w[2 * i], w[2 * i + 1]);
      } else if constexpr (P == 4) {
        v = w[i];
      } else {
        v = (V)(w[i * P / 4] >> (8 * ((i * P) % 4)));
      }
      reinterpret_cast<V*>(g)[i] = v;
    }
  }
};

// lane u (0..7) of 8 lanes of T held as words
template <typename T> struct LaneBits;
template <> struct LaneBits<float> {
  using U = uint32_t;
  using Key = uint64_t;               // 31 bits of |y| and 5 of position
  static constexpr uint32_t kMag = 0x7fffffffu;
  __device__ __forceinline__ static uint32_t get(const uint32_t (&w)[8], int u) { return w[u]; }
  __device__ __forceinline__ static void set(uint32_t (&w)[8], int u, uint32_t b) { w[u] = b; }
  __device__ __forceinline__ static float to_f(uint32_t b) { return __uint_as_float(b); }
  __device__ __forceinline__ static uint32_t from_f(float f) { return __float_as_uint(f); }
};
template <> struct LaneBits<__nv_bfloat16> {
  using U = uint16_t;
  using Key = uint32_t;
  static constexpr uint32_t kMag = 0x7fffu;
  __device__ __forceinline__ static uint32_t get(const uint32_t (&w)[4], int u) {
    return (w[u >> 1] >> (16 * (u & 1))) & 0xffffu;
  }
  __device__ __forceinline__ static void set(uint32_t (&w)[4], int u, uint32_t b) {
    const int s = 16 * (u & 1);
    w[u >> 1] = (w[u >> 1] & ~(0xffffu << s)) | (b << s);
  }
  __device__ __forceinline__ static float to_f(uint32_t b) { return __uint_as_float(b << 16); }
  __device__ __forceinline__ static uint32_t from_f(float f) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(f));
  }
};

// The warp stores n bytes staged at stage + (dst & 15) (stage 16-byte
// aligned) to dst: 16-byte stores where an aligned chunk lies inside, U-sized
// ones at the ragged ends.
template <typename U>
__device__ __forceinline__ void warp_flush(char* dst, const char* stage, int n, int lane) {
  const int mis = (int)((uintptr_t)dst & 15u);
  char* base = dst - mis;
  const int chunks = (mis + n + 15) / 16;
  for (int c = lane; c < chunks; c += 32) {
    const int lo = 16 * c, hi = lo + 16;
    if (lo >= mis && hi <= mis + n) {
      *reinterpret_cast<uint4*>(base + lo) = *reinterpret_cast<const uint4*>(stage + lo);
    } else {
      const int end = hi < mis + n ? hi : mis + n;
      for (int o = lo > mis ? lo : mis; o < end; o += (int)sizeof(U))
        *reinterpret_cast<U*>(base + o) = *reinterpret_cast<const U*>(stage + o);
    }
  }
}

// Sorts the 32 keys of a 32-lane block ascending, 8 a thread (thread q of
// the block holds positions 8q .. 8q+7): a bitonic network in the form whose
// comparators all point one way (each merge starts by comparing position i
// with its mirror in the merged run), so no step picks a direction; steps
// across threads go by shuffles, the lower position keeping the minimum.
template <typename Key>
__device__ __forceinline__ void sort32(Key (&a)[8], int q, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int flip = j == k >> 1 ? k - 1 : j;   // the partner of i is i ^ flip
      if (flip >= 8) {
        const int pq = q ^ (flip >> 3);
        const bool lower = q < pq;
        Key o[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          o[u] = __shfl_sync(kAll, a[u ^ (flip & 7)], (lane & ~3) | pq);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const Key lo = o[u] < a[u] ? o[u] : a[u], hi = o[u] < a[u] ? a[u] : o[u];
          a[u] = lower ? lo : hi;
        }
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int l = u ^ flip;
          if (l > u) {
            const Key lo = a[l] < a[u] ? a[l] : a[u], hi = a[l] < a[u] ? a[u] : a[l];
            a[u] = lo;
            a[l] = hi;
          }
        }
      }
    }
  }
}

template <typename T, int A>
__global__ void __launch_bounds__(kTopkThreads)
das_topk_kernel(const T* __restrict__ x, const T* __restrict__ scale, float eps, int K,
                int keep, int8_t* __restrict__ mask, T* __restrict__ values,
                int* __restrict__ indices, T* __restrict__ dense, T* __restrict__ normed) {
  using LX = Lanes8<(int)sizeof(T), A>;
  using LM = Lanes8<1, A>;
  using LB = LaneBits<T>;
  using Key = typename LB::Key;
  constexpr int W = LX::kWords;
  __shared__ __align__(16) char stage[kTopkThreads / 32][2][kStageBytes];
  __shared__ float red[kTopkThreads / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = tid & 3;              // the thread's quarter of its 32-lane block
  const int chunks = (K + kTopkChunk - 1) / kTopkChunk;
  const int row = blockIdx.x / chunks, chunk = blockIdx.x % chunks;
  const int nfull = K / 32, kc = nfull * keep;
  const int g = chunk * kTopkThreads + tid, l0 = 8 * g, b = g >> 2;
  const size_t roff = (size_t)row * K;
  const T* xr = x + roff;

  uint32_t w[W], s[W];
  LX::load(xr + l0, l0, K, w);
  if (scale != nullptr) {
    LX::load(scale + l0, l0, K, s);
    // the row's sum of squares, in the same order in every block of the
    // row: thread t over its lanes of chunks 0, 1, ..., a warp's threads by
    // a butterfly, then the warps in turn
    float ss = 0.f;
    for (int c0 = 0; c0 < chunks; c0 += 4) {
      uint32_t v[4][W];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = c0 + i, m0 = 8 * (c * kTopkThreads + tid);
        if (c == chunk) {
#pragma unroll
          for (int e = 0; e < W; ++e) v[i][e] = w[e];
        } else if (c < chunks) {
          LX::load(xr + m0, m0, K, v[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (c0 + i >= chunks) break;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float f = LB::to_f(LB::get(v[i], u));
          ss = __fmaf_rn(f, f, ss);
        }
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(kAll, ss, o));
    if (lane == 0) red[warp] = ss;
    __syncthreads();
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kTopkThreads / 32; ++i) t = __fadd_rn(t, red[i]);
    const float inv = __frsqrt_rn(__fadd_rn(__fdiv_rn(t, (float)K), eps));
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float y = __fmul_rn(__fmul_rn(LB::to_f(LB::get(w, u)), inv),
                                __fadd_rn(1.f, LB::to_f(LB::get(s, u))));
      LB::set(w, u, LB::from_f(y));
    }
  }

  // keys: |y|'s bits above the lane's reversed position, so that a larger
  // key ranks higher and equal magnitudes rank by lower lane; the block keeps
  // the keys at or above its keep-th largest
  Key key[8], srt[8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
    srt[u] = key[u] = ((Key)(LB::get(w, u) & LB::kMag) << 5) | (Key)(31 - (8 * q + u));
  sort32(srt, q, lane);
  const int at = 32 - keep;           // ascending position of the keep-th largest
  Key mine = srt[0];
#pragma unroll
  for (int u = 1; u < 8; ++u)
    if (u == (at & 7)) mine = srt[u];
  const Key thr = __shfl_sync(kAll, mine, (lane & ~3) | (at >> 3));

  const bool full = b < nfull;
  unsigned kept8 = 0;
#pragma unroll
  for (int u = 0; u < 8; ++u)
    if (full ? key[u] >= thr : l0 + u < K) kept8 |= 1u << u;
  unsigned bm = kept8 << (8 * q);     // the block's kept lanes
  bm |= __shfl_xor_sync(kAll, bm, 1);
  bm |= __shfl_xor_sync(kAll, bm, 2);

  if (normed != nullptr) LX::store(normed + roff + l0, l0, K, w);
  if (mask != nullptr) {
    uint32_t mw[2] = {0u, 0u};
#pragma unroll
    for (int u = 0; u < 8; ++u) mw[u >> 2] |= ((kept8 >> u) & 1u) << (8 * (u & 3));
    LM::store(mask + roff + l0, l0, K, mw);
  }
  if (dense != nullptr) {
    uint32_t dw[W];
#pragma unroll
    for (int i = 0; i < W; ++i) dw[i] = w[i];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (!((kept8 >> u) & 1u)) LB::set(dw, u, LB::get(w, u) & ~LB::kMag);
    LX::store(dense + roff + l0, l0, K, dw);
  }
  if (values != nullptr) {            // 32 | K: the warp's blocks b0 .. b0+7
    const int b0 = (chunk * kTopkThreads + warp * 32) >> 2;
    const int nb = min(max(nfull - b0, 0), 8);
    if (nb > 0) {                     // warp-uniform
      char* dv = reinterpret_cast<char*>(values + (size_t)row * kc + (size_t)b0 * keep);
      char* di = reinterpret_cast<char*>(indices + (size_t)row * kc + (size_t)b0 * keep);
      char* sv = stage[warp][0];
      char* si = stage[warp][1];
      const int mv = (int)((uintptr_t)dv & 15u), mi = (int)((uintptr_t)di & 15u);
      if (full) {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (!((kept8 >> u) & 1u)) continue;
          const int e = (b - b0) * keep + __popc(bm & ((1u << (8 * q + u)) - 1u));
          *reinterpret_cast<typename LB::U*>(sv + mv + e * (int)sizeof(T)) =
              (typename LB::U)LB::get(w, u);
          *reinterpret_cast<int*>(si + mi + 4 * e) = l0 + u;
        }
      }
      __syncwarp();
      warp_flush<typename LB::U>(dv, sv, nb * keep * (int)sizeof(T), lane);
      warp_flush<uint32_t>(di, si, nb * keep * 4, lane);
    }
  }
}

template <typename T, int A>
static void launch(const void* x, const void* scale, float eps, int M, int K, int keep,
                   void* mask, void* values, void* indices, void* dense, void* normed,
                   cudaStream_t stream) {
  const long long blocks = (long long)M * ((K + kTopkChunk - 1) / kTopkChunk);
  das_topk_kernel<T, A><<<(unsigned)blocks, kTopkThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), eps, K, keep,
      static_cast<int8_t*>(mask), static_cast<T*>(values), static_cast<int*>(indices),
      static_cast<T*>(dense), static_cast<T*>(normed));
}

template <typename T>
static void launch_aligned(const void* x, const void* scale, float eps, int M, int K,
                           int keep, void* mask, void* values, void* indices, void* dense,
                           void* normed, cudaStream_t s) {
  if (K % 8 == 0)
    launch<T, 8>(x, scale, eps, M, K, keep, mask, values, indices, dense, normed, s);
  else if (K % 4 == 0)
    launch<T, 4>(x, scale, eps, M, K, keep, mask, values, indices, dense, normed, s);
  else if (K % 2 == 0)
    launch<T, 2>(x, scale, eps, M, K, keep, mask, values, indices, dense, normed, s);
  else
    launch<T, 1>(x, scale, eps, M, K, keep, mask, values, indices, dense, normed, s);
}

}  // namespace tenet

// x (M, K) and scale (K,) (or null: no norm) 16-byte aligned; outputs as in
// the header, each may be null
extern "C" int tenet_das_topk(const void* x, int dtype, int M, int K, int keep,
                              const void* scale, float eps, void* mask, void* values,
                              void* indices, void* dense, void* normed, void* stream) {
  using namespace tenet;
  if (M < 1 || K < 1 || keep < 1 || keep > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      launch_aligned<float>(x, scale, eps, M, K, keep, mask, values, indices, dense, normed, s);
      break;
    case kBF16:
      launch_aligned<__nv_bfloat16>(x, scale, eps, M, K, keep, mask, values, indices, dense,
                                    normed, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
