// ternary_gemm: dense activations x base-3 packed ternary weights.
//
// Replaces src/repro/kernels/ternary_gemm.py::_ternary_gemm_kernel (the TPU
// kernel decodes a 320-trit slab in VMEM and feeds the MXU).
//
//   out[m, n] = (sum_k x[m, k] * trit[k, n]) * w_scale  (* x_scale[m])
//
// x: (M, K) f32 / bf16 (f32 accumulation) or int8 (exact int32 accumulation,
// then scaled by the per-row x_scale); packed: (R, N) uint8 with 5R >= K —
// lanes K..5R-1 are export padding and contribute nothing.  out: (M, N) f32.
//
// What bounds it on the H100: at decode (M = max_slots) the packed weight
// bytes, R*N (1104 x 2048 = 2.26 MB for bitnet-1.3b's down projection), over
// the 3.35 TB/s of HBM; the operations (2*M*5R*N) are far below the card's
// rate.  The design reads each packed byte once per row tile, a warp's 32
// bytes of a row together, and decodes it in registers, so the 1.6
// bits/weight stay the only weight traffic; a block stages its rows'
// activations once in shared memory.  No split-K and no atomics: every
// output is one ordered sum (common.cuh), so at decode a column is one
// serial chain of 5R multiply-adds per row.
#include "common.cuh"

namespace tenet {

template <int BM, int RPT, typename T, typename Acc>
__global__ void __launch_bounds__(kGemmThreads)
ternary_gemm_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
                    const float* __restrict__ w_scale, const float* __restrict__ x_scale,
                    float* __restrict__ out, int M, int K, int R, int N) {
  constexpr int kColsPerBlock = kGemmThreads / (BM / RPT);
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* dense = reinterpret_cast<Acc*>(smem);       // [staged_lanes(R)][BM]
  const int lanes = staged_lanes(R);
  const int m0 = blockIdx.y * BM;
  const int col = blockIdx.x * kColsPerBlock + threadIdx.x % kColsPerBlock;
  // the thread's first row; 0 when one thread owns all BM rows (a constant,
  // which keeps the BM-wide shared-memory reads vectorised)
  const int r0 = RPT == BM ? 0 : threadIdx.x / kColsPerBlock * RPT;
#pragma unroll
  for (int m = 0; m < BM; ++m) {
    const int row = m0 + m;
    for (int lane = threadIdx.x; lane < lanes; lane += kGemmThreads)
      dense[lane * BM + m] =
          row < M && lane < K ? convert<Acc>(x[(size_t)row * K + lane]) : (Acc)0;
  }
  __syncthreads();
  if (col >= N || m0 + r0 >= M) return;
  Acc acc[RPT];
#pragma unroll
  for (int m = 0; m < RPT; ++m) acc[m] = (Acc)0;
  packed_mac<BM, RPT, Acc>(packed, N, R, col, dense + r0, acc);
  const float ws = *w_scale;
#pragma unroll
  for (int m = 0; m < RPT; ++m) {
    const int row = m0 + r0 + m;
    if (row >= M) break;
    float y = (float)acc[m] * ws;
    if (x_scale != nullptr) y *= x_scale[row];
    out[(size_t)row * N + col] = y;
  }
}

template <int BM, int RPT, typename T, typename Acc>
static cudaError_t launch(const void* x, const uint8_t* packed, const float* w_scale,
                          const float* x_scale, float* out, int M, int K, int R, int N,
                          cudaStream_t stream) {
  constexpr int kColsPerBlock = kGemmThreads / (BM / RPT);
  const size_t smem = (size_t)staged_lanes(R) * BM * sizeof(Acc);
  const cudaError_t err = allow_smem(ternary_gemm_kernel<BM, RPT, T, Acc>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kColsPerBlock - 1) / kColsPerBlock, (M + BM - 1) / BM);
  ternary_gemm_kernel<BM, RPT, T, Acc><<<grid, kGemmThreads, smem, stream>>>(
      static_cast<const T*>(x), packed, w_scale, x_scale, out, M, K, R, N);
  return cudaGetLastError();
}

template <int BM, int RPT>
static cudaError_t dispatch(const void* x, int dtype, const uint8_t* packed,
                            const float* w_scale, const float* x_scale, float* out, int M,
                            int K, int R, int N, cudaStream_t stream) {
  switch (dtype) {
    case kF32:
      return launch<BM, RPT, float, float>(x, packed, w_scale, x_scale, out, M, K, R, N,
                                           stream);
    case kBF16:
      return launch<BM, RPT, __nv_bfloat16, float>(x, packed, w_scale, x_scale, out, M, K,
                                                   R, N, stream);
    case kI8:
      return launch<BM, RPT, int8_t, int>(x, packed, w_scale, x_scale, out, M, K, R, N,
                                          stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tenet

extern "C" int tenet_ternary_gemm(const void* x, int dtype, const void* packed,
                                  const void* w_scale, const void* x_scale, void* out,
                                  int M, int K, int R, int N, void* stream) {
  using namespace tenet;
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  const float* ws = static_cast<const float*>(w_scale);
  const float* xs = static_cast<const float*>(x_scale);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tiling(M, R)) {
    case Tiling::kDecode:
      return (int)dispatch<4, 1>(x, dtype, p, ws, xs, o, M, K, R, N, s);
    case Tiling::kWide:
      return (int)dispatch<8, 8>(x, dtype, p, ws, xs, o, M, K, R, N, s);
    default:
      return (int)dispatch<4, 4>(x, dtype, p, ws, xs, o, M, K, R, N, s);
  }
}
