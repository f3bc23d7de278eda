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

namespace tenet {

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

// ---------------------------------------------------------------------------
// Packed ternary GEMM core, shared by ternary_gemm and das_ternary_gemm.
//
// Weights are base-3 packed along K: byte (r, n) holds trits 5r..5r+4 of
// column n, least significant digit first, digit {0,1,2} -> {-1,0,+1}.  A
// block owns BM rows of the output and kGemmThreads / (BM / RPT) columns:
// each thread owns one column and RPT of the BM rows, neighbouring threads
// own neighbouring columns, so a warp reads 32 neighbouring bytes of a
// packed row (one sector) and decodes them in registers: trits never reach
// device memory.  At decode (RPT = 1) the BM rows of a column go to BM
// warps, which keeps enough warps in flight to hide latency.  The block
// first stages its BM rows' activations for all lanes of the slab, rounded
// up to whole row groups, in shared memory as dense[lane][m] (zero where
// there is no activation), behind one barrier; then each thread loads
// kRowGroup packed rows ahead and accumulates over the lanes in ascending
// order.  Each output is one thread's sum over lanes 0..5R-1 in a fixed
// order, whatever the other rows hold: the engine's batch invariance rests
// on it.  No split-K and no atomics.
// ---------------------------------------------------------------------------

constexpr int kGemmThreads = 128;
constexpr int kRowGroup = 16;                  // packed rows loaded ahead
constexpr int kMaxSmem = 232448;               // an H100 block's shared memory
constexpr unsigned kZeroByte = 121;            // digits 1,1,1,1,1: five zero trits

// lanes staged for R packed rows: whole row groups
__host__ __device__ __forceinline__ int staged_lanes(int R) {
  return (R + kRowGroup - 1) / kRowGroup * kRowGroup * 5;
}

// acc[m] += sum_{lane < 5R} trit(lane, col) * dense[lane][m] for the RPT
// rows m that `dense` (offset to the thread's first row) starts at
template <int BM, int RPT, typename Acc>
__device__ __forceinline__ void packed_mac(const uint8_t* __restrict__ packed, int N, int R,
                                           int col, const Acc* __restrict__ dense,
                                           Acc (&acc)[RPT]) {
  const uint8_t* p = packed + col;
  for (int r0 = 0; r0 < R; r0 += kRowGroup) {
    unsigned b[kRowGroup];
#pragma unroll
    for (int g = 0; g < kRowGroup; ++g)
      b[g] = r0 + g < R ? (unsigned)__ldg(p + (size_t)(r0 + g) * N) : kZeroByte;
#pragma unroll
    for (int g = 0; g < kRowGroup; ++g) {
      unsigned v = b[g];
      const Acc* xr = dense + (size_t)(r0 + g) * 5 * BM;
#pragma unroll
      for (int d = 0; d < 5; ++d) {
        const Acc w = (Acc)next_trit(v);
#pragma unroll
        for (int m = 0; m < RPT; ++m) acc[m] += w * xr[d * BM + m];
      }
    }
  }
}

// Row tiling of a launch: at decode (M <= 4) 4 rows per block, one per
// thread; beyond it a thread takes all the block's rows, 8 while two blocks
// still fit on an SM (the decode amortised over more rows), else 4.
enum class Tiling { kDecode, kWide, kNarrow };
__host__ __forceinline__ Tiling tiling(int M, int R) {
  if (M <= 4) return Tiling::kDecode;
  return (size_t)staged_lanes(R) * 8 * 4 <= 100 * 1024 ? Tiling::kWide : Tiling::kNarrow;
}

// opt a kernel into `smem` bytes of dynamic shared memory
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace tenet
