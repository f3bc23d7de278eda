// das_ternary_gemm: DAS-compacted activations x base-3 packed ternary weights.
//
// Replaces src/repro/kernels/das_gemm.py::_das_ternary_gemm_kernel (the TPU
// kernel scatters the compacted values block-locally in VMEM, decodes the
// 320-trit slab and runs the MXU dot).
//
//   out[m, n] = (sum_j values[m, j] * trit[indices[m, j], n]) * w_scale
//
// values: (M, Kc) f32 / bf16, indices: (M, Kc) int32 absolute lanes, as
// das_compact lays them out: `keep` lanes of every `block`, ascending, so
// Kc = K / block * keep and the entries of lanes [a, b) (a, b multiples of
// block) sit at positions [a / block * keep, b / block * keep).  packed:
// (R, N) uint8 with 5R >= K (the export pads packed rows to a multiple of 16;
// padding bytes decode to zero trits).  out: (M, N) f32.
//
// What bounds it on the H100: at decode (M = max_slots) the packed weight
// bytes, R*N (416 x 2048 = 0.85 MB for q/k/v/o, 416 x 5460 = 2.27 MB for
// gate/up of bitnet-1.3b), over the 3.35 TB/s of HBM; at a prefill pack the
// bf16 tensor-core rate.  A block scatters only its K window's entries (160
// lanes: 80 entries a row at keep 16 of 32) into a zeroed dense tile in
// shared memory — the butterfly router — and decodes the packed bytes in
// registers (common.cuh): dense activations and trits never touch device
// memory.  No float atomics; every output is summed in a fixed order.
#include "rows.cuh"

namespace tenet {

struct Scale {
  const float* w_scale;
  float w;                // *w_scale, loaded when a block starts
  __device__ __forceinline__ void load() { w = __ldg(w_scale); }
  __device__ __forceinline__ float operator()(float v, int) const { return v * w; }
};

// subs, parts: the launch config (common.cuh), 0 = the built-in choice; a
// knob of the other class, or parts on the FMA route, is refused
template <typename T>
static cudaError_t launch(const void* values, const int* indices, const uint8_t* packed,
                          Scale epi, float* out, int M, int Kc, int E, int R, int N,
                          int subs, int parts, cudaStream_t stream) {
  const CompactRows<T> rows{static_cast<const T*>(values), indices, M, Kc, E};
  const PackedW wt{packed, R, N, N % 4 == 0};
  if (M <= kDecRows) {
    if (parts != 0) return cudaErrorInvalidValue;
    return launch_decode<float, std::is_same<T, __nv_bfloat16>::value>(rows, wt, epi, out,
                                                                       stream, subs);
  }
  if (subs != 0) return cudaErrorInvalidValue;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (Kc % 8 == 0 && E % 8 == 0 && N % 4 == 0) {
      return launch_prefill_mma(rows, wt, epi, out, stream, parts);
    }
  }
  if (parts != 0) return cudaErrorInvalidValue;
  return launch_prefill_fma<float>(rows, wt, epi, out, stream);
}

}  // namespace tenet

// keep, block: das_compact's (kWinLanes % block == 0); subs, parts: the
// launch config, 0 = built in
extern "C" int tenet_das_ternary_gemm(const void* values, int dtype, const void* indices,
                                      const void* packed, const void* w_scale, void* out,
                                      int M, int Kc, int keep, int block, int R, int N,
                                      int subs, int parts, void* stream) {
  using namespace tenet;
  if (block < 1 || kWinLanes % block != 0) return (int)cudaErrorInvalidValue;
  const int E = kWinLanes / block * keep;
  const int* idx = static_cast<const int*>(indices);
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  const Scale epi{static_cast<const float*>(w_scale), 0.f};
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return (int)launch<float>(values, idx, p, epi, o, M, Kc, E, R, N, subs, parts, s);
    case kBF16:
      return (int)launch<__nv_bfloat16>(values, idx, p, epi, o, M, Kc, E, R, N, subs, parts, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
