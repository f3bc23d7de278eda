// twd_decode: base-3 packed bytes -> int8 trits (the TWD decompressor).
//
// Replaces src/repro/kernels/ternary_gemm.py::_twd_decode_kernel (the TPU
// kernel expands a (512, 256) tile of bytes to (2560, 256) trits in VMEM;
// its wrapper then slices the first k rows).
//
//   out[5r + d, n] = digit d of packed[r, n], {0,1,2} -> {-1,0,+1}, for 5r + d < K
//
// packed: (R, N) uint8; out: (K, N) int8 with K <= 5R.  Trits past K (the
// export's padding rows) are not written.
//
// Design: the paper's LUT decompressor.  A 256-entry table in shared memory
// gives a byte's five trits (digits 0-3 as the bytes of one word, digit 4 in
// a second), and byte permutes transpose four columns' entries into one word
// per trit row.  A block of 128 threads takes 2048 columns of one packed
// row, 16 a thread, read as vectors of A bytes, A the largest power of two
// up to 16 that divides N (the tensors start 16-byte aligned).  When 16
// divides N every trit row starts aligned and a thread stores its 16 bytes
// of each straight away; otherwise (gate/up's N = 5460: trit rows start 0,
// 4, 8 or 12 bytes past a 16-byte boundary) the block stages the five trit
// rows in shared memory, each at its destination's offset from a boundary,
// and stores them with 16-byte vectors all the same.
//
// What bounds it on the H100: bytes — R*N read and K*N written, six bytes
// moved per packed byte; a table read and ~2 permutes per byte.
#include "common.cuh"

namespace tenet {

constexpr int kDecodeThreads = 128;
constexpr int kTileCols = 16 * kDecodeThreads;   // columns a block of threads decodes
constexpr int kMaxDecodeBlocks = 132 * 16;       // a block-stride loop takes the rest

template <int A> struct Bytes;
template <> struct Bytes<1> { using type = uint8_t; };
template <> struct Bytes<2> { using type = uint16_t; };
template <> struct Bytes<4> { using type = uint32_t; };
template <> struct Bytes<8> { using type = uint2; };
template <> struct Bytes<16> { using type = uint4; };

// 16 bytes, as the words w, to or from p in pieces of A bytes (p A-aligned);
// a piece at or past `limit` bytes is skipped
template <int A>
__device__ __forceinline__ void load16(const uint8_t* p, int limit, uint32_t (&w)[4]) {
  using V = typename Bytes<A>::type;
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = 0u;
#pragma unroll
  for (int i = 0; i < 16 / A; ++i) {
    if (i * A >= limit) continue;
    const V v = __ldg(reinterpret_cast<const V*>(p) + i);
    if constexpr (A == 16) {
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (A == 8) {
      w[2 * i] = v.x; w[2 * i + 1] = v.y;
    } else if constexpr (A == 4) {
      w[i] = v;
    } else {
      w[i * A / 4] |= (uint32_t)v << (8 * ((i * A) % 4));
    }
  }
}

template <int A>
__device__ __forceinline__ void store16(uint8_t* p, const uint32_t (&w)[4]) {
  using V = typename Bytes<A>::type;
#pragma unroll
  for (int i = 0; i < 16 / A; ++i) {
    V v;
    if constexpr (A == 16) {
      v = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (A == 8) {
      v = make_uint2(w[2 * i], w[2 * i + 1]);
    } else if constexpr (A == 4) {
      v = w[i];
    } else {
      v = (V)(w[i * A / 4] >> (8 * ((i * A) % 4)));
    }
    reinterpret_cast<V*>(p)[i] = v;
  }
}

template <int A>
__global__ void __launch_bounds__(kDecodeThreads)
twd_decode_kernel(const uint8_t* __restrict__ packed, int8_t* __restrict__ out, int R, int K,
                  int N) {
  using V = typename Bytes<A>::type;
  constexpr int kStage = A == 16 ? 16 : kTileCols + 16;   // A == 16 stores directly
  __shared__ uint2 lut[256];
  __shared__ __align__(16) uint8_t stage[5][kStage];
  for (int v = threadIdx.x; v < 256; v += kDecodeThreads) {
    unsigned u = (unsigned)v;
    uint32_t lo = 0u;
#pragma unroll
    for (int d = 0; d < 4; ++d) lo |= (uint32_t)(uint8_t)(int8_t)next_trit(u) << (8 * d);
    lut[v] = make_uint2(lo, (uint32_t)(uint8_t)(int8_t)next_trit(u));
  }
  __syncthreads();

  const int tid = threadIdx.x;
  const int tiles = (N + kTileCols - 1) / kTileCols;
  const long long tasks = (long long)R * tiles;
  for (long long t = blockIdx.x; t < tasks; t += gridDim.x) {   // block-uniform
    const int r = (int)(t / tiles);
    const int c0 = (int)(t % tiles) * kTileCols;
    const int rows = min(5, K - 5 * r);  // the trit rows of packed row r inside K
    if (rows <= 0) continue;            // a padding row of the export
    const int ncols = min(kTileCols, N - c0);
    int8_t* dst = out + (size_t)5 * r * N + c0;
    const int col = 16 * tid;
    uint32_t o[5][4];
    if (col < ncols) {                  // decode 16 columns a thread
      uint32_t pw[4];
      load16<A>(packed + (size_t)r * N + c0 + col, ncols - col, pw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {     // four columns a word
        const uint2 e0 = lut[pw[i] & 0xffu], e1 = lut[(pw[i] >> 8) & 0xffu];
        const uint2 e2 = lut[(pw[i] >> 16) & 0xffu], e3 = lut[pw[i] >> 24];
        const uint32_t a_lo = __byte_perm(e0.x, e1.x, 0x5140);
        const uint32_t a_hi = __byte_perm(e0.x, e1.x, 0x7362);
        const uint32_t b_lo = __byte_perm(e2.x, e3.x, 0x5140);
        const uint32_t b_hi = __byte_perm(e2.x, e3.x, 0x7362);
        o[0][i] = __byte_perm(a_lo, b_lo, 0x5410);
        o[1][i] = __byte_perm(a_lo, b_lo, 0x7632);
        o[2][i] = __byte_perm(a_hi, b_hi, 0x5410);
        o[3][i] = __byte_perm(a_hi, b_hi, 0x7632);
        o[4][i] = __byte_perm(__byte_perm(e0.y, e1.y, 0x5140), __byte_perm(e2.y, e3.y, 0x5140),
                              0x5410);
      }
    }
    if constexpr (A == 16) {            // every trit row starts 16-byte aligned
      if (col < ncols) {
#pragma unroll
        for (int d = 0; d < 5; ++d)
          if (d < rows) store16<16>(reinterpret_cast<uint8_t*>(dst + (size_t)d * N + col), o[d]);
      }
    } else {
      // stage each trit row at its destination's offset from 16 bytes, then
      // store it with 16-byte vectors, A-byte ones at its ragged ends
      if (col < ncols) {
#pragma unroll
        for (int d = 0; d < 5; ++d) {
          if (d >= rows) break;
          const int mis = (int)((uintptr_t)(dst + (size_t)d * N) & 15u);
          store16<A>(stage[d] + mis + col, o[d]);
        }
      }
      __syncthreads();
      for (int d = 0; d < rows; ++d) {
        int8_t* row = dst + (size_t)d * N;
        const int mis = (int)((uintptr_t)row & 15u);
        int8_t* base = row - mis;
        const int chunks = (mis + ncols + 15) / 16;
        for (int c = tid; c < chunks; c += kDecodeThreads) {
          const int lo = 16 * c, hi = lo + 16;
          if (lo >= mis && hi <= mis + ncols) {
            *reinterpret_cast<uint4*>(base + lo) = *reinterpret_cast<const uint4*>(stage[d] + lo);
          } else {
            const int end = hi < mis + ncols ? hi : mis + ncols;
            for (int b = lo > mis ? lo : mis; b < end; b += A)
              *reinterpret_cast<V*>(base + b) = *reinterpret_cast<const V*>(stage[d] + b);
          }
        }
      }
      __syncthreads();                  // the stores read the stage before the next tile
    }
  }
}

template <int A>
static void launch(const void* packed, void* out, int R, int K, int N, cudaStream_t s) {
  long long blocks = (long long)R * ((N + kTileCols - 1) / kTileCols);
  if (blocks > kMaxDecodeBlocks) blocks = kMaxDecodeBlocks;
  twd_decode_kernel<A><<<(unsigned)blocks, kDecodeThreads, 0, s>>>(
      static_cast<const uint8_t*>(packed), static_cast<int8_t*>(out), R, K, N);
}

}  // namespace tenet

// packed (R, N) and out (K, N) 16-byte aligned
extern "C" int tenet_twd_decode(const void* packed, void* out, int R, int K, int N,
                                void* stream) {
  using namespace tenet;
  if (R < 1 || N < 1 || K < 1 || K > 5 * R) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N % 16 == 0)
    launch<16>(packed, out, R, K, N, s);
  else if (N % 8 == 0)
    launch<8>(packed, out, R, K, N, s);
  else if (N % 4 == 0)
    launch<4>(packed, out, R, K, N, s);
  else if (N % 2 == 0)
    launch<2>(packed, out, R, K, N, s);
  else
    launch<1>(packed, out, R, K, N, s);
  return (int)cudaGetLastError();
}
