// das_gemv: DAS-compacted (or dense) activations x int8-resident trits.
//
// Replaces src/repro/kernels/das_gemm.py::_das_gemv_kernel (the TPU kernel
// takes one token: per 512-lane K tile it scatters the compacted values to
// their dense lanes with a one-hot matmul and dots them with the (512, bn)
// int8 trit tile; its caller vmaps over batch rows).
//
//   out[m, n] = (sum_j values[m, j] * trits[lane(m, j), n]) * w_scale
//
// values: (M, Kc) f32 / bf16; indices: (M, Kc) int32 distinct absolute
// lanes in [0, K), ascending per row (core.das.das_compact), or null for
// dense rows (Kc == K, lane(m, j) = j: a DAS-masked row with a dense tail, or
// DAS off); trits: (K, N) int8 in {-1, 0, +1}; w_scale: one f32; out: (M, N)
// f32.  Lanes outside [0, K) are dropped.
//
// What bounds it on the H100: at decode (M = max_slots) the trit bytes that
// the rows' kept lanes touch — with 4 rows nearly all K*N of them: 4.2 MB for
// q/k/v/o and 11.2 MB for gate/up and down of bitnet-1.3b, five times the
// packed path's bytes — over the 3.35 TB/s of HBM.  The design is the packed
// GEMMs' (common.cuh) with int8 trits in place of packed bytes: a block owns
// BM rows and kCols columns, and first stages its rows' activations for all
// K lanes in shared memory as dense[lane][m] (the butterfly router: the
// compacted values scattered to their lanes, zeros elsewhere) behind one
// barrier.  It then walks K in tiles of kTileK lanes: the block copies the
// kTileK x kCols trit tile to shared memory with 4-byte loads (16 a thread,
// the next tile's issued before the current one is consumed), so one read
// of a trit row serves every row of the block, and each thread accumulates
// its column over the tile's lanes.  Each output is one thread's sum over
// lanes 0..K-1 in ascending order, whatever the other rows hold: no split-K
// and no atomics, as the engine's batch invariance needs.
#include "common.cuh"

namespace tenet {

constexpr int kTileBytes = 8192;                                 // trits staged per K tile
constexpr int kTileWords = kTileBytes / 4 / kGemmThreads;        // 4-byte loads a thread

// lanes staged for K: whole K tiles of `tile_k` lanes
__host__ __device__ __forceinline__ int gemv_lanes(int K, int tile_k) {
  return (K + tile_k - 1) / tile_k * tile_k;
}

// four trits of row k, columns c..c+3, as one little-endian word (0 past
// the edges).  kVec: N % 4 == 0 and a 4-byte aligned base, so one load.
template <bool kVec>
__device__ __forceinline__ unsigned trit_word(const int8_t* __restrict__ trits, int k, int c,
                                              int K, int N) {
  if (k >= K) return 0u;
  const int8_t* p = trits + (size_t)k * N + c;
  if (kVec) return c < N ? __ldg(reinterpret_cast<const unsigned*>(p)) : 0u;
  unsigned w = 0u;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (c + b < N) w |= (unsigned)(uint8_t)__ldg(p + b) << (8 * b);
  return w;
}

template <int BM, int RPT, bool kVec, typename T>
__global__ void __launch_bounds__(kGemmThreads)
das_gemv_kernel(const T* __restrict__ values, const int* __restrict__ indices,
                const int8_t* __restrict__ trits, const float* __restrict__ w_scale,
                float* __restrict__ out, int M, int Kc, int K, int N) {
  constexpr int kCols = kGemmThreads / (BM / RPT);   // columns of a block
  constexpr int kTileK = kTileBytes / kCols;         // lanes of a K tile
  constexpr int kRowWords = kCols / 4;               // words of a tile row
  extern __shared__ __align__(16) unsigned char smem[];
  const int lanes = gemv_lanes(K, kTileK);
  float* dense = reinterpret_cast<float*>(smem);                        // [lanes][BM]
  unsigned* tile = reinterpret_cast<unsigned*>(dense + (size_t)lanes * BM);  // [kTileK][kRowWords]
  const int m0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * kCols;
  const int cl = threadIdx.x % kCols;
  // the thread's first row; 0 when one thread owns all BM rows (a constant,
  // which keeps the BM-wide shared-memory reads vectorised)
  const int r0 = RPT == BM ? 0 : threadIdx.x / kCols * RPT;

  if (indices == nullptr) {          // dense rows: lane j holds values[m, j]
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      const int row = m0 + m;
      for (int lane = threadIdx.x; lane < lanes; lane += kGemmThreads)
        dense[lane * BM + m] =
            row < M && lane < K ? to_f32(values[(size_t)row * Kc + lane]) : 0.f;
    }
  } else {                           // compacted rows: scatter to their lanes
    for (int i = threadIdx.x; i < lanes * BM; i += kGemmThreads) dense[i] = 0.f;
    __syncthreads();
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      const int row = m0 + m;
      if (row >= M) break;
      for (int j = threadIdx.x; j < Kc; j += kGemmThreads) {
        const int lane = indices[(size_t)row * Kc + j];
        if (lane >= 0 && lane < K) dense[lane * BM + m] = to_f32(values[(size_t)row * Kc + j]);
      }
    }
  }

  unsigned w[kTileWords];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kTileWords; ++j) {
      const int i = threadIdx.x + j * kGemmThreads;
      w[j] = trit_word<kVec>(trits, k0 + i / kRowWords, c0 + i % kRowWords * 4, K, N);
    }
  };
  float acc[RPT];
#pragma unroll
  for (int m = 0; m < RPT; ++m) acc[m] = 0.f;
  const int8_t* tb = reinterpret_cast<const int8_t*>(tile) + cl;
  load_tile(0);
  for (int k0 = 0; k0 < lanes; k0 += kTileK) {
    __syncthreads();                 // staging done / the previous tile consumed
#pragma unroll
    for (int j = 0; j < kTileWords; ++j) tile[threadIdx.x + j * kGemmThreads] = w[j];
    __syncthreads();
    if (k0 + kTileK < lanes) load_tile(k0 + kTileK);   // in flight during the sums
    const float* xd = dense + (size_t)k0 * BM + r0;
#pragma unroll 8
    for (int kk = 0; kk < kTileK; ++kk) {
      const float t = (float)tb[kk * kCols];
#pragma unroll
      for (int m = 0; m < RPT; ++m) acc[m] += t * xd[kk * BM + m];
    }
  }

  const int col = c0 + cl;
  if (col >= N) return;
  const float ws = *w_scale;
#pragma unroll
  for (int m = 0; m < RPT; ++m) {
    const int row = m0 + r0 + m;
    if (row >= M) break;
    out[(size_t)row * N + col] = acc[m] * ws;
  }
}

template <int BM, int RPT, bool kVec, typename T>
static cudaError_t launch(const void* values, const int* indices, const int8_t* trits,
                          const float* w_scale, float* out, int M, int Kc, int K, int N,
                          cudaStream_t stream) {
  constexpr int kCols = kGemmThreads / (BM / RPT);
  const size_t smem =
      (size_t)gemv_lanes(K, kTileBytes / kCols) * BM * sizeof(float) + kTileBytes;
  const cudaError_t err = allow_smem(das_gemv_kernel<BM, RPT, kVec, T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kCols - 1) / kCols, (M + BM - 1) / BM);
  das_gemv_kernel<BM, RPT, kVec, T><<<grid, kGemmThreads, smem, stream>>>(
      static_cast<const T*>(values), indices, trits, w_scale, out, M, Kc, K, N);
  return cudaGetLastError();
}

template <int BM, int RPT, bool kVec>
static cudaError_t dispatch(const void* values, int dtype, const int* indices,
                            const int8_t* trits, const float* w_scale, float* out, int M,
                            int Kc, int K, int N, cudaStream_t stream) {
  switch (dtype) {
    case kF32:
      return launch<BM, RPT, kVec, float>(values, indices, trits, w_scale, out, M, Kc, K,
                                          N, stream);
    case kBF16:
      return launch<BM, RPT, kVec, __nv_bfloat16>(values, indices, trits, w_scale, out, M,
                                                  Kc, K, N, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int BM, int RPT>
static cudaError_t dispatch_vec(bool vec, const void* values, int dtype, const int* indices,
                                const int8_t* trits, const float* w_scale, float* out, int M,
                                int Kc, int K, int N, cudaStream_t stream) {
  return vec ? dispatch<BM, RPT, true>(values, dtype, indices, trits, w_scale, out, M, Kc, K,
                                       N, stream)
             : dispatch<BM, RPT, false>(values, dtype, indices, trits, w_scale, out, M, Kc,
                                        K, N, stream);
}

}  // namespace tenet

extern "C" int tenet_das_gemv(const void* values, int dtype, const void* indices,
                              const void* trits, const void* w_scale, void* out, int M, int Kc,
                              int K, int N, void* stream) {
  using namespace tenet;
  const int* idx = static_cast<const int*>(indices);
  const int8_t* w = static_cast<const int8_t*>(trits);
  const float* ws = static_cast<const float*>(w_scale);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(trits) % 4 == 0;
  // row tiling as in the packed GEMMs: 4 rows on 4 warps at decode; beyond
  // it a thread takes all the block's rows, 8 while two blocks fit on an SM
  if (M <= 4) return (int)dispatch_vec<4, 1>(vec, values, dtype, idx, w, ws, o, M, Kc, K, N, s);
  if ((size_t)gemv_lanes(K, kTileBytes / kGemmThreads) * 8 * sizeof(float) <= 100 * 1024)
    return (int)dispatch_vec<8, 8>(vec, values, dtype, idx, w, ws, o, M, Kc, K, N, s);
  return (int)dispatch_vec<4, 4>(vec, values, dtype, idx, w, ws, o, M, Kc, K, N, s);
}
