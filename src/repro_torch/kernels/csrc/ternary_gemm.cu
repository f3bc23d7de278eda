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
#include "rows.cuh"

namespace tenet {

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

// subs, parts: the launch config (common.cuh), 0 = the built-in choice; a
// knob of the other class, or parts on the FMA route, is refused
template <typename T, typename Acc>
static cudaError_t launch(const void* x, const uint8_t* packed, Scale epi, float* out, int M,
                          int K, int R, int N, int subs, int parts, cudaStream_t stream) {
  const DenseRows<T> rows{static_cast<const T*>(x), M, K};
  const PackedW wt{packed, R, N, N % 4 == 0};
  if (M <= kDecRows) {
    if (parts != 0) return cudaErrorInvalidValue;
    return launch_decode<Acc, std::is_same<T, __nv_bfloat16>::value>(rows, wt, epi, out,
                                                                     stream, subs);
  }
  if (subs != 0) return cudaErrorInvalidValue;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (K % 4 == 0 && N % 4 == 0) return launch_prefill_mma(rows, wt, epi, out, stream, parts);
  }
  if (parts != 0) return cudaErrorInvalidValue;
  return launch_prefill_fma<Acc>(rows, wt, epi, out, stream);
}

}  // namespace tenet

// subs, parts: the launch config, 0 = built in
extern "C" int tenet_ternary_gemm(const void* x, int dtype, const void* packed,
                                  const void* w_scale, const void* x_scale, void* out,
                                  int M, int K, int R, int N, int subs, int parts,
                                  void* stream) {
  using namespace tenet;
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  const Scale epi{static_cast<const float*>(w_scale), static_cast<const float*>(x_scale), 0.f};
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return (int)launch<float, float>(x, p, epi, o, M, K, R, N, subs, parts, s);
    case kBF16:
      return (int)launch<__nv_bfloat16, float>(x, p, epi, o, M, K, R, N, subs, parts, s);
    case kI8:
      return (int)launch<int8_t, int>(x, p, epi, o, M, K, R, N, subs, parts, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
