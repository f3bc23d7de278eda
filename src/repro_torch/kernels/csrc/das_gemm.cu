// das_ternary_gemm: DAS-compacted activations x base-3 packed ternary weights.
//
// Replaces src/repro/kernels/das_gemm.py::_das_ternary_gemm_kernel (the TPU
// kernel scatters the compacted values block-locally in VMEM, decodes the
// 320-trit slab and runs the MXU dot).
//
//   out[m, n] = (sum_j values[m, j] * trit[indices[m, j], n]) * w_scale
//
// values: (M, Kc) f32 / bf16, indices: (M, Kc) int32 absolute lanes in
// [0, 5R); packed: (R, N) uint8 — R may exceed K/5 (the export pads packed
// rows to a multiple of 16; padding bytes decode to zero trits).  out: (M, N)
// f32.
//
// What bounds it on the H100: at decode (M = max_slots) the packed weight
// bytes, R*N (416 x 2048 = 0.85 MB for q/k/v/o, 416 x 5460 = 2.27 MB for
// gate/up of bitnet-1.3b), over the 3.35 TB/s of HBM.  Each block scatters
// its rows' compacted values once into a zeroed dense row of all 5R lanes
// in shared memory (the butterfly router), then streams the packed bytes
// along K, a warp's 32 bytes of a row together, decoding them in registers
// (common.cuh) — dense activations and decoded trits never touch device
// memory.  No split-K and no atomics: every output is one ordered sum,
// whatever the other rows hold.
#include "common.cuh"

namespace tenet {

template <int BM, int RPT, typename T>
__global__ void __launch_bounds__(kGemmThreads)
das_ternary_gemm_kernel(const T* __restrict__ values, const int* __restrict__ indices,
                        const uint8_t* __restrict__ packed, const float* __restrict__ w_scale,
                        float* __restrict__ out, int M, int Kc, int R, int N) {
  constexpr int kColsPerBlock = kGemmThreads / (BM / RPT);
  extern __shared__ __align__(16) unsigned char smem[];
  float* dense = reinterpret_cast<float*>(smem);   // [staged_lanes(R)][BM]
  const int lanes = staged_lanes(R);
  const int m0 = blockIdx.y * BM;
  const int col = blockIdx.x * kColsPerBlock + threadIdx.x % kColsPerBlock;
  // the thread's first row; 0 when one thread owns all BM rows (a constant,
  // which keeps the BM-wide shared-memory reads vectorised)
  const int r0 = RPT == BM ? 0 : threadIdx.x / kColsPerBlock * RPT;
  for (int i = threadIdx.x; i < lanes * BM; i += kGemmThreads) dense[i] = 0.f;
  __syncthreads();
  // block-local scatter (the butterfly router): each compacted entry lands
  // on its dense lane; lanes outside the slab are dropped
#pragma unroll
  for (int m = 0; m < BM; ++m) {
    const int row = m0 + m;
    if (row >= M) break;
    for (int j = threadIdx.x; j < Kc; j += kGemmThreads) {
      const int lane = indices[(size_t)row * Kc + j];
      if (lane >= 0 && lane < 5 * R)
        dense[lane * BM + m] = to_f32(values[(size_t)row * Kc + j]);
    }
  }
  __syncthreads();
  if (col >= N || m0 + r0 >= M) return;
  float acc[RPT];
#pragma unroll
  for (int m = 0; m < RPT; ++m) acc[m] = 0.f;
  packed_mac<BM, RPT, float>(packed, N, R, col, dense + r0, acc);
  const float ws = *w_scale;
#pragma unroll
  for (int m = 0; m < RPT; ++m) {
    const int row = m0 + r0 + m;
    if (row >= M) break;
    out[(size_t)row * N + col] = acc[m] * ws;
  }
}

template <int BM, int RPT, typename T>
static cudaError_t launch(const void* values, const int* indices, const uint8_t* packed,
                          const float* w_scale, float* out, int M, int Kc, int R, int N,
                          cudaStream_t stream) {
  constexpr int kColsPerBlock = kGemmThreads / (BM / RPT);
  const size_t smem = (size_t)staged_lanes(R) * BM * sizeof(float);
  const cudaError_t err = allow_smem(das_ternary_gemm_kernel<BM, RPT, T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kColsPerBlock - 1) / kColsPerBlock, (M + BM - 1) / BM);
  das_ternary_gemm_kernel<BM, RPT, T><<<grid, kGemmThreads, smem, stream>>>(
      static_cast<const T*>(values), indices, packed, w_scale, out, M, Kc, R, N);
  return cudaGetLastError();
}

template <int BM, int RPT>
static cudaError_t dispatch(const void* values, int dtype, const int* indices,
                            const uint8_t* packed, const float* w_scale, float* out, int M,
                            int Kc, int R, int N, cudaStream_t stream) {
  switch (dtype) {
    case kF32:
      return launch<BM, RPT, float>(values, indices, packed, w_scale, out, M, Kc, R, N,
                                    stream);
    case kBF16:
      return launch<BM, RPT, __nv_bfloat16>(values, indices, packed, w_scale, out, M, Kc,
                                            R, N, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tenet

extern "C" int tenet_das_ternary_gemm(const void* values, int dtype, const void* indices,
                                      const void* packed, const void* w_scale, void* out,
                                      int M, int Kc, int R, int N, void* stream) {
  using namespace tenet;
  const int* idx = static_cast<const int*>(indices);
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  const float* ws = static_cast<const float*>(w_scale);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tiling(M, R)) {
    case Tiling::kDecode:
      return (int)dispatch<4, 1>(values, dtype, idx, p, ws, o, M, Kc, R, N, s);
    case Tiling::kWide:
      return (int)dispatch<8, 8>(values, dtype, idx, p, ws, o, M, Kc, R, N, s);
    default:
      return (int)dispatch<4, 4>(values, dtype, idx, p, ws, o, M, Kc, R, N, s);
  }
}
