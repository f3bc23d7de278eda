// Shared device code of the TENET kernels for Hopper (sm_90a).
//
// Every launcher is a plain C function: it takes raw device pointers, the
// shapes, a dtype code and the CUDA stream, launches on that stream without
// synchronising, and returns cudaGetLastError() so that the Python wrapper
// can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <type_traits>

namespace tenet {

namespace cg = cooperative_groups;

// dtype codes shared with kernels/build.py
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// activation -> accumulator type: float for f32/bf16, exact int for int8
template <typename Acc, typename T>
__device__ __forceinline__ Acc convert(T v) { return static_cast<Acc>(to_f32(v)); }
template <>
__device__ __forceinline__ int convert<int, int8_t>(int8_t v) { return static_cast<int>(v); }

// One base-3 digit of a packed byte, least significant first: the trit of
// digit {0,1,2} -> {-1,0,+1}; v moves on to the next digit.  The padding
// byte 121 (digits 1,1,1,1,1) gives five zero trits.
__device__ __forceinline__ int next_trit(unsigned& v) {
  const int t = (int)(v % 3u) - 1;
  v /= 3u;
  return t;
}

// The packed GEMMs' digit steps, without division or int-to-float
// conversion (a quarter-rate instruction): for v < 256, v / 3 ==
// (v * 171) >> 9, and the float of digit u is the float with bits
// 0x4B000000 | u (2^23 + u) less 2^23 + 1, which is the trit u - 1 exactly.
__device__ __forceinline__ unsigned next_digit(unsigned& v) {
  const unsigned q = (v * 171u) >> 9;
  const unsigned u = v - 3u * q;
  v = q;
  return u;
}
template <typename Acc> __device__ __forceinline__ Acc trit_of(unsigned u);
template <> __device__ __forceinline__ float trit_of<float>(unsigned u) {
  return __int_as_float(0x4B000000u | u) - 8388609.0f;
}
template <> __device__ __forceinline__ int trit_of<int>(unsigned u) { return (int)u - 1; }

// The digits of the four bytes of a word, one step at a time, two bytes per
// 16-bit lane: bytes 0 and 2 in lo, 1 and 3 in hi (v * 171 < 2^16).
struct Digits4 {
  unsigned lo, hi;
  __device__ __forceinline__ explicit Digits4(unsigned w)
      : lo(w & 0x00FF00FFu), hi((w >> 8) & 0x00FF00FFu) {}
  // the next digit of bytes 0 and 2 (ul) and of bytes 1 and 3 (uh)
  __device__ __forceinline__ void next_digits(unsigned& ul, unsigned& uh) {
    const unsigned ql = ((lo * 171u) >> 9) & 0x007F007Fu;
    const unsigned qh = ((hi * 171u) >> 9) & 0x007F007Fu;
    ul = lo - 3u * ql;
    uh = hi - 3u * qh;
    lo = ql;
    hi = qh;
  }
  // the trits of the next digit of bytes 0..3
  template <typename Acc> __device__ __forceinline__ void next(Acc (&t)[4]) {
    unsigned ul, uh;
    next_digits(ul, uh);
    t[0] = trit_at<Acc>(ul, 0);
    t[1] = trit_at<Acc>(uh, 0);
    t[2] = trit_at<Acc>(ul, 2);
    t[3] = trit_at<Acc>(uh, 2);
  }
  // the digit at byte b (0 or 2) of a lane word as a trit: for float, one
  // byte permute builds 0x4B0000uu
  template <typename Acc> static __device__ __forceinline__ Acc trit_at(unsigned u, int b);
};
template <>
__device__ __forceinline__ float Digits4::trit_at<float>(unsigned u, int b) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | (unsigned)b)) - 8388609.0f;
}
template <>
__device__ __forceinline__ int Digits4::trit_at<int>(unsigned u, int b) {
  return (int)((u >> (8 * b)) & 0xffu) - 1;
}

// ---------------------------------------------------------------------------
// Ternary GEMM core, shared by ternary_gemm, das_ternary_gemm and das_gemv.
//
//   out[m, n] = epilogue(sum_lane act(m, lane) * trit(lane, n), m)
//
// A weight source (below) gives the trits of K lanes in groups of five, one
// group a packed row r (lanes 5r..5r+4), R groups in all:
//  * PackedW (ternary_gemm, das_ternary_gemm): base-3 packed (R, N) uint8,
//    byte (r, n) holds trits 5r..5r+4 of column n, least significant digit
//    first, digit {0,1,2} -> {-1,0,+1}; the padding byte 121 decodes to
//    five zero trits.  Trits are decoded in registers and never reach
//    device memory.
//  * TritsW (das_gemv): int8-resident trits (K, N), one byte a lane, R =
//    ceil(K / 5); lanes at or past K read as zero trits, as the padding byte
//    does.  A trit becomes a digit by one per-byte add (t + 1), so both
//    sources feed the same digit code.
// K is cut into fixed windows of kWinRows = 32 groups (kWinLanes = 160
// lanes: five DAS blocks of 32), and a block stages only its window's
// activations in shared memory, so K is not bounded by shared memory.  A
// row source (rows.cuh: DenseRows, CompactRows) puts a window's
// activations.
//
// Two tile classes, chosen by M:
//  * decode (M <= 4): a block takes 128 columns and 1, 2, 4 or 8 windows
//    (dec_subs, from R and N), so that the grid fills the card whatever M
//    is: 208 blocks for bitnet-1.3b's q/k/v/o (13 of one window a column
//    tile), 301 for gate/up (7 of 2), 144 for down (9 of 4) — packed or
//    trits alike.  Every weight load of a thread (4 neighbouring columns a
//    group: a warp 32 or 128 contiguous bytes a row) is issued before the
//    window's activations are staged.  bf16 rows run on the tensor cores
//    (decode_mma_kernel: the digits of 4 columns turned at once into bf16
//    B fragments, the M rows in A rows 0..3); f32 and int8 rows on FMAs
//    (decode_kernel).  The blocks of a column tile are one thread-block
//    cluster (at most 16, so R <= 4096, K <= 20480) and add their sums in
//    block order through distributed shared memory.  One launch, no
//    atomics.
//  * prefill (M > 4): bf16 activations run on the tensor cores (mma.sync
//    m16n8k16, f32 accumulate) in 64 x 64 tiles, K split into parts of
//    about 8 windows that reduce through a cluster (mma_parts, a function
//    of R alone): activation and weight tiles of the next windows are
//    copied with cp.async (a ring of 3 windows for dense rows, 2 for
//    compacted ones) while the current one is multiplied.  A window's 160
//    lanes are laid out in 10 k-steps so that each thread takes 40 whole
//    lanes of one column (8 packed bytes, or 40 trit bytes) into its B
//    fragments, and reads its A fragment as 8 contiguous bytes (mma_lane).
//    f32 and int8 activations (and shapes the bf16 path cannot take) run on
//    FMAs: a thread owns one column and 8 rows and sums its lanes in
//    ascending order, the next window's weights loaded ahead.
//
// What bounds it on the H100: at decode the weight bytes over the 3.35 TB/s
// of HBM (packed: R*N; trits: K*N, five times as many, which the rows'
// kept lanes nearly all touch at M = 4); at a prefill pack the bf16
// tensor-core rate.
//
// Batch invariance: the order in which an output's terms are summed depends
// on (K, N, dtype, tile class) only — never on M within a class, on the
// values of other rows, or on timing.  The engine runs every decode step at
// M = max_slots and prefills one request at a time, so a request's tokens
// do not depend on its batch-mates.
// ---------------------------------------------------------------------------

constexpr int kMaxSmem = 232448;               // an H100 block's shared memory
constexpr unsigned kZeroByte = 121;            // digits 1,1,1,1,1: five zero trits
constexpr int kWinRows = 32;                   // packed rows of a K window
constexpr int kWinLanes = 5 * kWinRows;        // its lanes

__host__ __device__ __forceinline__ int windows(int R) { return (R + kWinRows - 1) / kWinRows; }

template <typename Acc> __device__ __forceinline__ Acc zero_acc() { return (Acc)0; }

// one tensor-core step: c += a (16 x 16 bf16, row) x b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; r[i] is matrix i as a fragment (trans: of its
// transpose)
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// --- the prefill tile and asynchronous copies -----------------------------------

constexpr int kMmaThreads = 128;               // 4 warps, each 64 rows x 16 columns
constexpr int kMmaRows = 64;
constexpr int kMmaCols = 64;
constexpr int kAStride = 176;                  // bf16 of a staged row: 160 + 16 (conflict-free)
constexpr int kPStride = kMmaCols + 4;         // bytes of a staged weight row (+4: no conflicts)

// Where lane l of a window sits in a staged activation row.  Thread q of a
// quad decodes packed rows 8q..8q+7 of its column (lanes 40q..40q+39) and
// feeds them to k-steps 0..9 four lanes at a time; its A fragment of k-step
// j is then lanes 40q+4j..40q+4j+3, stored contiguously at 16j + 4q.
__host__ __device__ __forceinline__ int mma_lane(int l) {
  return (l % 40) / 4 * 16 + l / 40 * 4 + l % 4;
}

__device__ __forceinline__ void cp_async(void* smem, const void* gmem, int bytes, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(src_bytes));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// --- decode class ------------------------------------------------------------

constexpr int kDecRows = 4;                    // M <= 4
constexpr int kDecCols = 128;                  // columns of a block
constexpr int kMaxCluster = 16;                // the H100's largest (non-portable) cluster

// packed row r, columns c..c+3, as one little-endian word; padding bytes
// past R or N.  vec: N % 4 == 0 (and a 4-byte aligned base): one load
__device__ __forceinline__ unsigned packed_word(const uint8_t* __restrict__ packed, int r,
                                                int c, int R, int N, bool vec) {
  constexpr unsigned kZeroWord = kZeroByte * 0x01010101u;
  if (r >= R || c >= N) return kZeroWord;
  const uint8_t* p = packed + (size_t)r * N + c;
  if (vec) return __ldg(reinterpret_cast<const unsigned*>(p));
  unsigned w = 0u;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    w |= (c + b < N ? (unsigned)__ldg(p + b) : kZeroByte) << (8 * b);
  return w;
}

// --- weight sources ------------------------------------------------------------
//
// Each gives the core: word(r, c), group r of columns c..c+3 for the decode
// class, read as Digits (5 steps of 4 digits); group(r, col), group r of one
// column as a base-3 byte, for the FMA prefill; and a window's tile for the
// tensor-core prefill: kTileRows rows x 64 columns copied by issue_tile,
// then digits40, the 40 digits of one column that a quad thread's B
// fragments take (lanes 40q..40q+39 of the window).

// base-3 packed (R, N) uint8
struct PackedW {
  const uint8_t* __restrict__ p;
  int R, N;
  bool vec;                                    // N % 4 == 0 and a 4-byte aligned base
  using Word = unsigned;
  using Digits = Digits4;
  static constexpr int kTileRows = kWinRows;   // a window's packed rows

  __device__ __forceinline__ Word word(int r, int c) const {
    return packed_word(p, r, c, R, N, vec);
  }
  __device__ __forceinline__ unsigned group(int r, int col) const {
    return r < R && col < N ? (unsigned)__ldg(p + (size_t)r * N + col) : kZeroByte;
  }
  // packed rows s*32.., columns n0..n0+63: 512 words, 4 a thread (N % 4 == 0)
  template <int NT>
  __device__ __forceinline__ void issue_tile(uint8_t* tile, int s, int n0) const {
#pragma unroll
    for (int k = 0; k < kTileRows * kMmaCols / 4 / NT; ++k) {
      const int i = threadIdx.x + k * NT;
      const int r = i / (kMmaCols / 4), c = i % (kMmaCols / 4) * 4;
      const int row = s * kWinRows + r, col = n0 + c;
      const bool ok = row < R && col < N;
      cp_async(tile + r * kPStride + c, ok ? p + (size_t)row * N + col : p, 4, ok ? 4 : 0);
    }
  }
  // the copy zero-fills rows past R: those read as the padding byte
  __device__ __forceinline__ void digits40(const uint8_t* tile, int s, int c, int q,
                                           unsigned (&u)[40]) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = 8 * q + i;
      unsigned v = s * kWinRows + r < R ? (unsigned)tile[r * kPStride + c] : kZeroByte;
#pragma unroll
      for (int d = 0; d < 5; ++d) u[5 * i + d] = next_digit(v);
    }
  }
};

// five lanes of 4 columns: the int8 trits of lanes 5r..5r+4
struct TritWord {
  unsigned w[5];
};

// Digits of a TritWord: trit t -> digit t + 1, one per-byte add a lane
struct Digits5 {
  unsigned w[5];
  int k = 0;
  __device__ __forceinline__ explicit Digits5(const TritWord& x) {
#pragma unroll
    for (int d = 0; d < 5; ++d) w[d] = x.w[d];
  }
  __device__ __forceinline__ void next_digits(unsigned& ul, unsigned& uh) {
    const unsigned v = __vadd4(w[k++], 0x01010101u);
    ul = v & 0x00FF00FFu;
    uh = (v >> 8) & 0x00FF00FFu;
  }
  template <typename Acc> __device__ __forceinline__ void next(Acc (&t)[4]) {
    unsigned ul, uh;
    next_digits(ul, uh);
    t[0] = Digits4::trit_at<Acc>(ul, 0);
    t[1] = Digits4::trit_at<Acc>(uh, 0);
    t[2] = Digits4::trit_at<Acc>(ul, 2);
    t[3] = Digits4::trit_at<Acc>(uh, 2);
  }
};

// int8-resident trits (K, N), R = ceil(K / 5) groups; zero past K and N
struct TritsW {
  const int8_t* __restrict__ t;
  int K, R, N;
  bool vec;                                    // N % 4 == 0 and a 4-byte aligned base
  using Word = TritWord;
  using Digits = Digits5;
  static constexpr int kTileRows = kWinLanes;  // a window's lanes

  // lane l, columns c..c+3, as one little-endian word
  __device__ __forceinline__ unsigned lane_word(int l, int c) const {
    if (l >= K || c >= N) return 0u;
    const int8_t* q = t + (size_t)l * N + c;
    if (vec) return __ldg(reinterpret_cast<const unsigned*>(q));
    unsigned w = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (c + b < N) w |= (unsigned)(uint8_t)__ldg(q + b) << (8 * b);
    return w;
  }
  __device__ __forceinline__ Word word(int r, int c) const {
    Word o;
#pragma unroll
    for (int d = 0; d < 5; ++d) o.w[d] = lane_word(5 * r + d, c);
    return o;
  }
  __device__ __forceinline__ unsigned group(int r, int col) const {
    int v[5];
#pragma unroll
    for (int d = 0; d < 5; ++d) {
      const int l = 5 * r + d;
      v[d] = l < K && col < N ? (int)__ldg(t + (size_t)l * N + col) : 0;
    }
    return (unsigned)(v[0] + 1 + 3 * (v[1] + 1) + 9 * (v[2] + 1) + 27 * (v[3] + 1) +
                      81 * (v[4] + 1));
  }
  // lanes s*160.., columns n0..n0+63: 2560 words, 20 a thread (N % 4 == 0);
  // lanes past K are zero-filled, zero trits
  template <int NT>
  __device__ __forceinline__ void issue_tile(uint8_t* tile, int s, int n0) const {
#pragma unroll
    for (int k = 0; k < kTileRows * kMmaCols / 4 / NT; ++k) {
      const int i = threadIdx.x + k * NT;
      const int r = i / (kMmaCols / 4), c = i % (kMmaCols / 4) * 4;
      const int lane = s * kWinLanes + r, col = n0 + c;
      const bool ok = lane < K && col < N;
      cp_async(tile + r * kPStride + c, ok ? t + (size_t)lane * N + col : t, 4, ok ? 4 : 0);
    }
  }
  __device__ __forceinline__ void digits40(const uint8_t* tile, int, int c, int q,
                                           unsigned (&u)[40]) const {
#pragma unroll
    for (int i = 0; i < 40; ++i) u[i] = ((unsigned)tile[(40 * q + i) * kPStride + c] + 1u) & 0xFFu;
  }
};

// A decode block of a cluster arrives at the cluster barrier when it starts
// and waits on it before its first store to another block's shared memory,
// which must have started by then.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The end of a decode block: `bsum` holds the block's sum of each of its
// kDecRows x kDecCols outputs.  The S blocks of a column tile are one
// cluster, and block s owns outputs [s * share, (s + 1) * share): every
// block stores its sums of them into the owner's slots, one barrier, and
// the owner adds slots 0..S-1 in order from its own shared memory.
template <typename Acc, int NT, class Epi>
__device__ __forceinline__ void finish_windows(const Acc* bsum, int M, int N, int c0, Epi epi,
                                               float* __restrict__ out) {
  constexpr int kOut = kDecRows * kDecCols;
  __shared__ __align__(16) Acc slots[kOut + kMaxCluster];   // S * share <= kOut + S
  const int S = gridDim.y, s = blockIdx.y;
  cg::cluster_group cluster = cg::this_cluster();
  const int share = (kOut + S - 1) / S;
  cluster_wait();                    // every block of the cluster has started
  for (int o = threadIdx.x; o < kOut; o += NT) {
    const int owner = o / share;
    *cluster.map_shared_rank(slots + s * share + (o - owner * share), owner) = bsum[o];
  }
  cluster.sync();
  for (int i = threadIdx.x; i < share; i += NT) {
    const int o = s * share + i, m = o / kDecCols, col = c0 + o % kDecCols;
    if (o >= kOut || m >= M || col >= N) continue;
    Acc v = slots[i];
    for (int k = 1; k < S; ++k) v += slots[k * share + i];
    out[(size_t)m * N + col] = epi(v, m);
  }
}

// Windows a decode block takes for (R, N): the fewest of 1, 2, 4, 8 that
// keep a column tile's blocks in one cluster and the grid within about 2.5
// blocks an SM, so that every cluster is resident at once (bitnet-1.3b's
// q/k/v/o: 13 blocks of one window a column tile; gate/up 7 of 2; down 9
// of 4).  Beyond 8 x 16 windows (R > 4096) the decode class refuses.
constexpr int kDecMaxSubs = 8, kDecMaxBlocks = 330;
__host__ __device__ __forceinline__ int dec_subs(int R, int N) {
  const int tiles = (N + kDecCols - 1) / kDecCols;
  int subs = 1;
  for (; subs < kDecMaxSubs; subs *= 2) {
    const int S = (windows(R) + subs - 1) / subs;
    if (S <= kMaxCluster && tiles * S <= kDecMaxBlocks) break;
  }
  return subs;
}

// FMA route (f32 and int8 activations): a block takes kSubs windows of 32
// packed rows and 128 columns; 8 warps take 4 rows of each window, a thread
// 4 neighbouring columns (one 4-byte load a row, a warp 128 contiguous
// bytes), all loads in flight before the activations are staged.  Each
// output sums windows in order, then the warps in order.
constexpr int kDecThreads = 256;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kRowsPerWarp = kWinRows / kDecWarps;

template <typename Acc, int kSubs, class Rows, class W, class Epi>
__global__ void __launch_bounds__(kDecThreads)
decode_kernel(Rows rows, W wt, Epi epi, float* __restrict__ out) {
  constexpr int kLanes = kSubs * kWinLanes;
  epi.load();
  __shared__ __align__(16) Acc sx[kLanes][kDecRows];
  __shared__ __align__(16) Acc red[kDecWarps][kDecRows][kDecCols];
  __shared__ __align__(16) Acc bsum[kDecRows * kDecCols];
  const int s = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.x * kDecCols;
  const int wr = warp * kRowsPerWarp;            // the warp's first row in a window
  cluster_arrive_relaxed();
  typename W::Word w[kSubs][kRowsPerWarp];
#pragma unroll
  for (int u = 0; u < kSubs; ++u)
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
      w[u][i] = wt.word((s * kSubs + u) * kWinRows + wr + i, c0 + lane * 4);
  if (Rows::kScatter) {
    for (int i = threadIdx.x; i < kLanes * kDecRows; i += kDecThreads)
      (&sx[0][0])[i] = zero_acc<Acc>();
    __syncthreads();
  }
  rows.template stage<kDecRows, kDecThreads, Acc, kLanes>(
      0, s * kLanes, [&](int mi, int li, Acc v) { sx[li][mi] = v; });
  __syncthreads();

  Acc acc[kDecRows][4];
#pragma unroll
  for (int m = 0; m < kDecRows; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = zero_acc<Acc>();
#pragma unroll
  for (int u = 0; u < kSubs; ++u)
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      typename W::Digits dg(w[u][i]);
#pragma unroll
      for (int d = 0; d < 5; ++d) {
        const Acc* x = sx[(kWinRows * u + wr + i) * 5 + d];
        Acc xv[kDecRows], t[4];
#pragma unroll
        for (int m = 0; m < kDecRows; ++m) xv[m] = x[m];
        dg.next(t);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int m = 0; m < kDecRows; ++m) acc[m][j] += t[j] * xv[m];
      }
    }
#pragma unroll
  for (int m = 0; m < kDecRows; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp][m][lane * 4 + j] = acc[m][j];
  __syncthreads();
  for (int o = threadIdx.x; o < kDecRows * kDecCols; o += kDecThreads) {
    const int m = o / kDecCols, c = o % kDecCols;
    Acc v = red[0][m][c];
#pragma unroll
    for (int k = 1; k < kDecWarps; ++k) v += red[k][m][c];
    bsum[o] = v;
  }
  __syncthreads();
  finish_windows<Acc, kDecThreads>(bsum, rows.M, wt.N, c0, epi, out);
}

// Tensor-core route (bf16 activations): a block takes kSubs windows of 32
// packed rows (dec_subs) and 128 columns; 8 warps, 4 column groups of 32 x
// 2 halves of each
// window (16 packed rows).  Thread (g, q) of a warp (g = lane / 4, q =
// lane % 4) loads packed rows 4q..4q+3 of its halves, columns 4g..4g+3 (a
// warp 32 contiguous bytes a row), all kSubs x 4 loads at once, and decodes
// them into the B fragments of 4 m16n8k16 tiles: tile t's column g is column
// 4g + t, and k-step d of a half takes digit d of the thread's 4 rows
// (dec_lane).  The activation rows 0..3 sit in the A fragment's rows 0..3
// (rows 4..15 are zero).  Each output sums windows in order, halves in
// order, then the blocks of its column tile in order.
constexpr int kDecMmaThreads = 256;
constexpr int kHalfRows = kWinRows / 2;

// digit pair -> bf16 pair by one byte permute: bf16 trits of digit u are
// hi byte {BF, 00, 3F}[u], lo byte {80, 00, 80}[u]
constexpr unsigned kTritHi = 0x003F00BFu, kTritLo = 0x00800080u;
// the bf16x2 of digits (u_a, u_b) held as u_a | u_b << 8 in the low 16 bits of v
__device__ __forceinline__ unsigned trit_pair_bf16(unsigned v) {
  return __byte_perm(kTritHi, kTritLo, (v & 0xFFFFu) * 0x11u + 0x0404u);
}

// Where lane L of a window sits in a staged activation row of the
// tensor-core decode: packed row r = L / 5 is row i = r % 4 of quad thread
// q = r % 16 / 4 in half h = r / 16; its digit d = L % 5 is k-step d of the
// half, so a thread's A fragment of a k-step is 4 contiguous values.
__host__ __device__ __forceinline__ int dec_lane(int L) {
  const int r = L / 5;
  return 80 * (r / kHalfRows) + 16 * (L % 5) + 4 * (r % kHalfRows / 4) + r % 4;
}

template <int kSubs, class Rows, class W, class Epi>
__global__ void __launch_bounds__(kDecMmaThreads)
decode_mma_kernel(Rows rows, W wt, Epi epi, float* __restrict__ out) {
  epi.load();
  constexpr int kLanes = kSubs * kWinLanes;
  __shared__ __align__(16) __nv_bfloat16 at[kDecRows][kLanes];
  __shared__ __align__(16) float red[2][kDecRows * kDecCols];
  __shared__ __align__(16) float bsum[kDecRows * kDecCols];
  const int s = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp % 4, h = warp / 4;
  const int g = lane / 4, q = lane % 4;
  const int c0 = blockIdx.x * kDecCols;
  const int cw = c0 + 32 * grp + 4 * g;          // the thread's 4 columns
  const int r0 = s * kSubs * kWinRows + kHalfRows * h + 4 * q;
  cluster_arrive_relaxed();
  typename W::Word w[kSubs][4];
#pragma unroll
  for (int u = 0; u < kSubs; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i) w[u][i] = wt.word(r0 + kWinRows * u + i, cw);
  if (Rows::kScatter) {
    for (int i = threadIdx.x; i < kDecRows * kLanes / 2; i += kDecMmaThreads)
      reinterpret_cast<unsigned*>(&at[0][0])[i] = 0u;
    __syncthreads();
  }
  rows.template stage<kDecRows, kDecMmaThreads, float, kLanes>(
      0, s * kLanes, [&](int mi, int li, float v) {
        at[mi][li / kWinLanes * kWinLanes + dec_lane(li % kWinLanes)] = __float2bfloat16(v);
      });
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll
  for (int u = 0; u < kSubs; ++u) {
    using Dg = typename W::Digits;
    Dg dg[4] = {Dg(w[u][0]), Dg(w[u][1]), Dg(w[u][2]), Dg(w[u][3])};
#pragma unroll
    for (int d = 0; d < 5; ++d) {
      unsigned ul[4], uh[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dg[i].next_digits(ul[i], uh[i]);
      unsigned a[4] = {0u, 0u, 0u, 0u};
      if (g < kDecRows) {
        const uint2 v =
            *reinterpret_cast<const uint2*>(&at[g][kWinLanes * u + 80 * h + 16 * d + 4 * q]);
        a[0] = v.x;
        a[2] = v.y;
      }
      const unsigned vl0 = ul[0] | ul[1] << 8, vl1 = ul[2] | ul[3] << 8;
      const unsigned vh0 = uh[0] | uh[1] << 8, vh1 = uh[2] | uh[3] << 8;
      mma_bf16(acc[0], a, trit_pair_bf16(vl0), trit_pair_bf16(vl1));
      mma_bf16(acc[1], a, trit_pair_bf16(vh0), trit_pair_bf16(vh1));
      mma_bf16(acc[2], a, trit_pair_bf16(vl0 >> 16), trit_pair_bf16(vl1 >> 16));
      mma_bf16(acc[3], a, trit_pair_bf16(vh0 >> 16), trit_pair_bf16(vh1 >> 16));
    }
  }
  // C rows g < 4 are the outputs: tile t, columns 2q + e -> column 4(2q + e) + t
  if (g < kDecRows) {
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        red[h][g * kDecCols + 32 * grp + 8 * q + 4 * e + t] = acc[t][e];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < kDecRows * kDecCols; o += kDecMmaThreads)
    bsum[o] = red[0][o] + red[1][o];
  __syncthreads();
  finish_windows<float, kDecMmaThreads>(bsum, rows.M, wt.N, c0, epi, out);
}

// --- prefill class, FMA route (f32, int8, and what the bf16 route cannot take)

constexpr int kFmaThreads = 128;               // one column a thread
constexpr int kFmaRows = 8;

template <typename Acc, class Rows, class W, class Epi>
__global__ void __launch_bounds__(kFmaThreads)
prefill_fma_kernel(Rows rows, W wt, Epi epi, float* __restrict__ out) {
  epi.load();
  __shared__ __align__(16) Acc sx[kWinLanes][kFmaRows];
  const int M = rows.M, N = wt.N, S = windows(wt.R);
  const int col = blockIdx.x * kFmaThreads + threadIdx.x;
  const int m0 = blockIdx.y * kFmaRows;
  unsigned b[kWinRows];
  auto load = [&](int s) {
#pragma unroll
    for (int i = 0; i < kWinRows; ++i) b[i] = wt.group(s * kWinRows + i, col);
  };
  Acc acc[kFmaRows];
#pragma unroll
  for (int m = 0; m < kFmaRows; ++m) acc[m] = zero_acc<Acc>();
  load(0);
  for (int s = 0; s < S; ++s) {
    __syncthreads();                 // the previous window consumed
    if (Rows::kScatter) {
      for (int i = threadIdx.x; i < kWinLanes * kFmaRows; i += kFmaThreads)
        (&sx[0][0])[i] = zero_acc<Acc>();
      __syncthreads();
    }
    rows.template stage<kFmaRows, kFmaThreads, Acc>(
        m0, s * kWinLanes, [&](int mi, int li, Acc v) { sx[li][mi] = v; });
    __syncthreads();
    unsigned cur[kWinRows];
#pragma unroll
    for (int i = 0; i < kWinRows; ++i) cur[i] = b[i];
    if (s + 1 < S) load(s + 1);      // in flight during the sums
#pragma unroll
    for (int i = 0; i < kWinRows; ++i) {
      unsigned v = cur[i];
#pragma unroll
      for (int d = 0; d < 5; ++d) {
        const Acc t = trit_of<Acc>(next_digit(v));
        const Acc* x = sx[i * 5 + d];
#pragma unroll
        for (int m = 0; m < kFmaRows; ++m) acc[m] += t * x[m];
      }
    }
  }
  if (col >= N) return;
#pragma unroll
  for (int m = 0; m < kFmaRows; ++m)
    if (m0 + m < M) out[(size_t)(m0 + m) * N + col] = epi(acc[m], m0 + m);
}

// --- prefill class, tensor-core route (bf16) -----------------------------------

// Dynamic shared memory of the tensor-core route: a ring of Rows::kStages
// staging buffers of the row source, its extra tile, then as many packed
// tiles of 32 rows x 64 columns.
template <class Rows, class W>
__host__ __forceinline__ size_t mma_smem(const Rows& rows) {
  return Rows::kStages * (rows.mma_stage_bytes() + W::kTileRows * kPStride) +
         rows.mma_extra_bytes();
}

template <class Rows, class W, class Epi>
__global__ void __launch_bounds__(kMmaThreads)
prefill_mma_kernel(Rows rows, W wt, Epi epi, float* __restrict__ out) {
  epi.load();
  extern __shared__ __align__(16) unsigned char smem[];
  // this block's windows: part blockIdx.z of gridDim.z (mma_parts)
  const int M = rows.M, N = wt.N, P = gridDim.z, p = blockIdx.z;
  const int per = (windows(wt.R) + P - 1) / P;
  const int w0 = p * per, w1 = min(windows(wt.R), w0 + per);
  const int m0 = blockIdx.y * kMmaRows, n0 = blockIdx.x * kMmaCols;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  constexpr int kStages = Rows::kStages;
  const size_t stage_bytes = rows.mma_stage_bytes();
  unsigned char* extra = smem + kStages * stage_bytes;
  auto stage = [&](int buf) { return smem + buf * stage_bytes; };
  auto ptile = [&](int buf) {
    return extra + rows.mma_extra_bytes() + buf * W::kTileRows * kPStride;
  };

  auto issue = [&](int s, int buf) {
    rows.mma_issue(stage(buf), m0, s);
    wt.template issue_tile<kMmaThreads>(ptile(buf), s, n0);
    cp_async_commit();
  };

  float acc[4][2][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // a ring of kStages windows in flight: one commit group a window (empty
  // past the block's last), window s has landed once kStages - 1 are pending
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (w0 + k < w1)
      issue(w0 + k, k);
    else
      cp_async_commit();
  }
  for (int s = w0; s < w1; ++s) {
    const int buf = (s - w0) % kStages, next = s + kStages - 1;
    if (next < w1)                   // into the buffer consumed last trip
      issue(next, (next - w0) % kStages);
    else
      cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const __nv_bfloat16* at = rows.mma_tile(stage(buf), extra, s);   // [64][kAStride]

    // B fragments: column n0 + 16 warp + 8 nt + g, lanes 40q..40q+39 of
    // the window -> 40 digits, k-step j taking lanes 4j..4j+3
    unsigned bfrag[2][20];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      unsigned u[40];
      wt.digits40(ptile(buf), s, warp * 16 + nt * 8 + g, q, u);
#pragma unroll
      for (int h = 0; h < 20; ++h) bfrag[nt][h] = trit_pair_bf16(u[2 * h] | u[2 * h + 1] << 8);
    }
#pragma unroll
    for (int j = 0; j < 10; ++j) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const __nv_bfloat16* ar = at + (mt * 16 + g) * kAStride + 16 * j + 4 * q;
        const uint2 lo = *reinterpret_cast<const uint2*>(ar);
        const uint2 hi = *reinterpret_cast<const uint2*>(ar + 8 * kAStride);
        const unsigned a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          mma_bf16(acc[mt][nt], a, bfrag[nt][2 * j], bfrag[nt][2 * j + 1]);
      }
    }
    __syncthreads();                 // buffer `buf` consumed before its refill
  }

  if (P > 1) {
    // the parts of a tile are one cluster: part k owns tile rows
    // [ceil(64k / P), ceil(64(k + 1) / P)); every part stores its sums of
    // them into the owner's (now idle) staging memory, and the owner adds
    // parts 0..P-1 in order
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();                  // every part is done with its staging memory
    float* slots = reinterpret_cast<float*>(smem);   // [P][band][kMmaCols]
    const int band = (kMmaRows + P - 1) / P;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = mt * 16 + g + (e >= 2 ? 8 : 0);
          const int c = warp * 16 + nt * 8 + 2 * q + (e & 1);
          const int owner = r * P / kMmaRows, b0 = (kMmaRows * owner + P - 1) / P;
          *cluster.map_shared_rank(slots + (p * band + r - b0) * kMmaCols + c, owner) =
              acc[mt][nt][e];
        }
    cluster.sync();
    const int b0 = (kMmaRows * p + P - 1) / P, b1 = (kMmaRows * (p + 1) + P - 1) / P;
    for (int i = threadIdx.x; i < (b1 - b0) * kMmaCols; i += kMmaThreads) {
      const int row = m0 + b0 + i / kMmaCols, col = n0 + i % kMmaCols;
      if (row >= M || col >= N) continue;
      float v = slots[i];
      for (int k = 1; k < P; ++k) v += slots[k * band * kMmaCols + i];
      out[(size_t)row * N + col] = epi(v, row);
    }
    return;
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + mt * 16 + g + (e >= 2 ? 8 : 0);
        const int col = n0 + warp * 16 + nt * 8 + 2 * q + (e & 1);
        if (row < M && col < N) out[(size_t)row * N + col] = epi(acc[mt][nt][e], row);
      }
}

// The K parts of a tensor-core prefill tile: about 8 windows a part, at
// most 8 parts (one cluster); a function of R alone, so that a row's sums
// never depend on M.  bitnet-1.3b: K = 2048 in 2 parts, K = 5460 in 5.
__host__ __forceinline__ int mma_parts(int R) {
  const int P = (windows(R) + 7) / 8;
  return P < 1 ? 1 : P > 8 ? 8 : P;
}

// launch the tensor-core prefill, its K parts as one cluster: `parts` of
// them (1..8, at most the windows; the tuned config), or mma_parts(R) at 0
template <class Rows, class W, class Epi>
static cudaError_t launch_prefill_mma(const Rows& rows, const W& wt, Epi epi, float* out,
                                      cudaStream_t stream, int parts = 0) {
  const int P = parts > 0 ? parts : mma_parts(wt.R), N = wt.N;
  if (P < 1 || P > 8 || P > windows(wt.R)) return cudaErrorInvalidValue;
  auto kernel = prefill_mma_kernel<Rows, W, Epi>;
  const size_t smem = mma_smem<Rows, W>(rows);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = P;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kMmaCols - 1) / kMmaCols, (rows.M + kMmaRows - 1) / kMmaRows, P);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, rows, wt, epi, out);
}

// The decode class: bf16 activations on the tensor-core route, f32 and
// int8 on the FMA route; the S blocks of a column tile are one cluster.
template <typename Acc, bool kMma, int kSubs, class Rows, class W, class Epi>
static cudaError_t launch_decode_subs(const Rows& rows, const W& wt, Epi epi, float* out,
                                     cudaStream_t stream) {
  const dim3 grid((wt.N + kDecCols - 1) / kDecCols, (windows(wt.R) + kSubs - 1) / kSubs);
  if (grid.y > (unsigned)kMaxCluster) return cudaErrorInvalidValue;
  void (*kernel)(Rows, W, Epi, float*);
  int threads;
  if constexpr (kMma) {
    kernel = decode_mma_kernel<kSubs, Rows, W, Epi>;
    threads = kDecMmaThreads;
  } else {
    kernel = decode_kernel<Acc, kSubs, Rows, W, Epi>;
    threads = kDecThreads;
  }
  if (grid.y > 8) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = grid.y;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, rows, wt, epi, out);
}

// `subs` windows a block (1, 2, 4 or 8, the tuned config; a column tile's
// blocks must fit one cluster), or dec_subs(R, N) at 0
template <typename Acc, bool kMma, class Rows, class W, class Epi>
static cudaError_t launch_decode(const Rows& rows, const W& wt, Epi epi, float* out,
                                 cudaStream_t stream, int subs = 0) {
  switch (subs > 0 ? subs : dec_subs(wt.R, wt.N)) {
    case 1:
      return launch_decode_subs<Acc, kMma, 1>(rows, wt, epi, out, stream);
    case 2:
      return launch_decode_subs<Acc, kMma, 2>(rows, wt, epi, out, stream);
    case 4:
      return launch_decode_subs<Acc, kMma, 4>(rows, wt, epi, out, stream);
    case 8:
      return launch_decode_subs<Acc, kMma, 8>(rows, wt, epi, out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// the FMA prefill: one column a thread, 8 rows a block
template <typename Acc, class Rows, class W, class Epi>
static cudaError_t launch_prefill_fma(const Rows& rows, const W& wt, Epi epi, float* out,
                                      cudaStream_t stream) {
  const dim3 grid((wt.N + kFmaThreads - 1) / kFmaThreads, (rows.M + kFmaRows - 1) / kFmaRows);
  prefill_fma_kernel<Acc><<<grid, kFmaThreads, 0, stream>>>(rows, wt, epi, out);
  return cudaGetLastError();
}

// opt a kernel into `smem` bytes of dynamic shared memory
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace tenet
