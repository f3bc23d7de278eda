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
// the 3.35 TB/s of HBM; at a prefill pack the bf16 tensor-core rate.  The
// design (common.cuh) reads each packed byte once per row tile and decodes it
// in registers: at decode split over 32-row K windows so that the whole card
// has loads in flight, with an ordered reduction of the windows in the same
// launch; at prefill on the tensor cores for bf16, on FMAs for f32 and int8.
#include "common.cuh"

namespace tenet {

// lane l of row m is x[m, l] (zero past K and M)
template <typename T>
struct DenseRows {
  const T* __restrict__ x;
  int M, K;
  static constexpr bool kScatter = false;
  static constexpr int kStages = 3;  // tensor-core route: windows in flight

  // put(mi, li, v) for rows m0..m0+ROWS-1, lanes lane0..lane0+LANES-1;
  // every load is issued before the first put
  template <int ROWS, int NT, typename Acc, int LANES = kWinLanes, class Put>
  __device__ __forceinline__ void stage(int m0, int lane0, Put put) const {
    constexpr int kN = ROWS * LANES, kPer = (kN + NT - 1) / NT;
    Acc v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + k * NT, mi = i / LANES, li = i % LANES;
      const int row = m0 + mi, lane = lane0 + li;
      v[k] = i < kN && row < M && lane < K ? convert<Acc>(x[(size_t)row * K + lane])
                                           : zero_acc<Acc>();
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + k * NT;
      if (kN % NT == 0 || i < kN) put(i / LANES, i % LANES, v[k]);
    }
  }

  // tensor-core route (T = bf16, K % 4 == 0): the window's activations go
  // by cp.async straight into their mma_lane places, 4 lanes a copy
  __host__ __device__ size_t mma_stage_bytes() const {
    return (size_t)kMmaRows * kAStride * sizeof(__nv_bfloat16);
  }
  __host__ __device__ size_t mma_extra_bytes() const { return 0; }
  __device__ __forceinline__ void mma_issue(unsigned char* buf, int m0, int s) const {
    __nv_bfloat16* at = reinterpret_cast<__nv_bfloat16*>(buf);
    constexpr int kGroups = kWinLanes / 4;
#pragma unroll
    for (int k = 0; k < kMmaRows * kGroups / kMmaThreads; ++k) {
      const int i = threadIdx.x + k * kMmaThreads;
      const int mi = i / kGroups, l = i % kGroups * 4;
      const int row = m0 + mi, lane = s * kWinLanes + l;
      const bool ok = row < M && lane < K;
      cp_async(at + mi * kAStride + mma_lane(l), ok ? x + (size_t)row * K + lane : x, 8,
               ok ? 8 : 0);
    }
  }
  __device__ __forceinline__ const __nv_bfloat16* mma_tile(unsigned char* buf, unsigned char*,
                                                           int) const {
    return reinterpret_cast<const __nv_bfloat16*>(buf);
  }
};

struct Scale {
  const float* w_scale;
  const float* x_scale;   // per row, or null
  float w;                // *w_scale, loaded when a block starts
  __device__ __forceinline__ void load() { w = __ldg(w_scale); }
  template <typename Acc> __device__ __forceinline__ float operator()(Acc v, int row) const {
    float y = (float)v * w;
    if (x_scale != nullptr) y *= x_scale[row];
    return y;
  }
};

template <typename T, typename Acc>
static cudaError_t launch(const void* x, const uint8_t* packed, Scale epi, float* out, int M,
                          int K, int R, int N, cudaStream_t stream) {
  const DenseRows<T> rows{static_cast<const T*>(x), M, K};
  if (M <= kDecRows) {
    return launch_decode<Acc, std::is_same<T, __nv_bfloat16>::value>(rows, packed, R, N, epi,
                                                                     out, stream);
  }
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (K % 4 == 0 && N % 4 == 0) {
      return launch_prefill_mma(rows, packed, R, N, epi, out, stream);
    }
  }
  prefill_fma_kernel<Acc><<<fma_grid(M, N), kFmaThreads, 0, stream>>>(rows, packed, R, N, epi,
                                                                      out);
  return cudaGetLastError();
}

}  // namespace tenet

extern "C" int tenet_ternary_gemm(const void* x, int dtype, const void* packed,
                                  const void* w_scale, const void* x_scale, void* out,
                                  int M, int K, int R, int N, void* stream) {
  using namespace tenet;
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  const Scale epi{static_cast<const float*>(w_scale), static_cast<const float*>(x_scale), 0.f};
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return (int)launch<float, float>(x, p, epi, o, M, K, R, N, s);
    case kBF16:
      return (int)launch<__nv_bfloat16, float>(x, p, epi, o, M, K, R, N, s);
    case kI8:
      return (int)launch<int8_t, int>(x, p, epi, o, M, K, R, N, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
