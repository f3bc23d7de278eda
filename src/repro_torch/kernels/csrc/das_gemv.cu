// das_gemv: DAS-compacted (or dense) activations x int8-resident trits.
//
// Replaces src/repro/kernels/das_gemm.py::_das_gemv_kernel (the TPU kernel
// takes one token: per 512-lane K tile it scatters the compacted values to
// their dense lanes with a one-hot matmul and dots them with the (512, bn)
// int8 trit tile; its caller vmaps over batch rows).
//
//   out[m, n] = (sum_j values[m, j] * trits[lane(m, j), n]) * w_scale
//
// values: (M, Kc) f32 / bf16; indices: (M, Kc) int32 absolute lanes as
// das_compact lays them out (`keep` ascending lanes of every `block`, so Kc
// = K / block * keep), or null for dense rows (Kc == K, lane(m, j) = j: a
// DAS-masked row with a dense tail, or DAS off); trits: (K, N) int8 in
// {-1, 0, +1}; w_scale: one f32; out: (M, N) f32.
//
// What bounds it on the H100: at decode (M = max_slots) the trit bytes that
// the rows' kept lanes touch — with 4 rows nearly all K*N of them: 4.2 MB for
// q/k/v/o and 11.2 MB for gate/up and down of bitnet-1.3b, five times the
// packed path's bytes — over the 3.35 TB/s of HBM; at a prefill pack the
// bf16 tensor-core rate.  It runs on the GEMM core of common.cuh with the
// TritsW weight source: the packed GEMMs' K windows, clusters, tile classes
// and tensor-core routes, with int8 trit rows where they decode packed
// bytes.
#include "rows.cuh"

namespace tenet {

struct TritScale {
  const float* w_scale;
  float w;                // *w_scale, loaded when a block starts
  __device__ __forceinline__ void load() { w = __ldg(w_scale); }
  __device__ __forceinline__ float operator()(float v, int) const { return v * w; }
};

template <typename T, class Rows>
static cudaError_t launch(const Rows& rows, bool mma_ok, const TritsW& wt, TritScale epi,
                          float* out, cudaStream_t stream) {
  constexpr bool kBF16 = std::is_same<T, __nv_bfloat16>::value;
  if (rows.M <= kDecRows) return launch_decode<float, kBF16>(rows, wt, epi, out, stream);
  if constexpr (kBF16) {
    if (mma_ok && wt.N % 4 == 0) return launch_prefill_mma(rows, wt, epi, out, stream);
  }
  return launch_prefill_fma<float>(rows, wt, epi, out, stream);
}

template <typename T>
static cudaError_t dispatch(const void* values, const int* indices, const TritsW& wt,
                            TritScale epi, float* out, int M, int Kc, int keep, int block,
                            cudaStream_t stream) {
  const T* v = static_cast<const T*>(values);
  if (indices == nullptr) {
    const DenseRows<T> rows{v, M, wt.K};
    return launch<T>(rows, wt.K % 4 == 0, wt, epi, out, stream);
  }
  const int E = kWinLanes / block * keep;
  const CompactRows<T> rows{v, indices, M, Kc, E};
  return launch<T>(rows, Kc % 8 == 0 && E % 8 == 0, wt, epi, out, stream);
}

}  // namespace tenet

// indices null: dense rows (Kc == K); else keep, block: das_compact's
// (kWinLanes % block == 0)
extern "C" int tenet_das_gemv(const void* values, int dtype, const void* indices,
                              const void* trits, const void* w_scale, void* out, int M, int Kc,
                              int keep, int block, int K, int N, void* stream) {
  using namespace tenet;
  const int* idx = static_cast<const int*>(indices);
  if (idx != nullptr && (block < 1 || kWinLanes % block != 0)) return (int)cudaErrorInvalidValue;
  const TritsW wt{static_cast<const int8_t*>(trits), K, (K + 4) / 5, N, N % 4 == 0};
  const TritScale epi{static_cast<const float*>(w_scale), 0.f};
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return (int)dispatch<float>(values, idx, wt, epi, o, M, Kc, keep, block, s);
    case kBF16:
      return (int)dispatch<__nv_bfloat16>(values, idx, wt, epi, o, M, Kc, keep, block, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
