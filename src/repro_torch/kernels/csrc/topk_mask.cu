// das_topk: DAS per-32-lane top-k mask, compaction and masked dense copy.
//
// Replaces src/repro/kernels/topk_mask.py::_topk_mask_kernel (a 32x32
// broadcast compare on the TPU's vector unit) and the JAX model's
// das_compact / das_mask steps before every projection.
//
// One warp per 32-lane block, one lane per element.  Lane i survives iff
//   #{ |x_j| > |x_i| } + #{ j < i : |x_j| == |x_i| } < keep,
// its rank taken from 32 __shfl_sync compares; the rank is a strict total
// order, so exactly `keep` lanes of a full block survive.  A survivor's
// compacted slot is __popc(ballot(keep) & lanemask_lt), so survivors land in
// ascending lane order at [b*keep, (b+1)*keep) of the row.  A partial last
// block (K % 32 != 0, bitnet-1.3b's d_ff = 5460) keeps its lanes dense.
//
// Outputs (any but mask may be null): mask (M, K) int8; values (M, K/32*keep)
// in x's dtype and indices (M, K/32*keep) int32 (only when 32 divides K);
// dense (M, K), x with dropped lanes zeroed.
//
// What bounds it on the H100: bytes — x is read once and the outputs
// written once (a few hundred KB at decode, a few MB at a 256-token pack);
// 32 compares per element are far below the card's rate.
#include "common.cuh"

namespace tenet {

constexpr int kTopkThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__global__ void __launch_bounds__(kTopkThreads)
das_topk_kernel(const T* __restrict__ x, int M, int K, int keep, int8_t* __restrict__ mask,
                T* __restrict__ values, int* __restrict__ indices, T* __restrict__ dense) {
  const int lane = threadIdx.x & 31;
  const int nbk = (K + 31) / 32;  // blocks per row, a partial last one included
  const int kc = (K / 32) * keep;
  const long long total = (long long)M * nbk;
  const long long warps = (long long)gridDim.x * (kTopkThreads / 32);
  for (long long w = (long long)blockIdx.x * (kTopkThreads / 32) + threadIdx.x / 32; w < total;
       w += warps) {  // warp-uniform loop
    const int row = (int)(w / nbk), b = (int)(w % nbk);
    const int col = b * 32 + lane;
    const bool full = b * 32 + 32 <= K;  // warp-uniform
    const bool inb = col < K;
    const size_t off = (size_t)row * K + col;
    const T raw = inb ? x[off] : from_f32<T>(0.f);
    bool kept;
    if (full) {
      const float a = fabsf(to_f32(raw));
      int rank = 0;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float aj = __shfl_sync(kFull, a, j);
        rank += (aj > a) || (aj == a && j < lane);
      }
      kept = rank < keep;
      if (values != nullptr) {
        const unsigned ballot = __ballot_sync(kFull, kept);
        if (kept) {
          const int slot = __popc(ballot & ((1u << lane) - 1u));
          const size_t o = (size_t)row * kc + (size_t)b * keep + slot;
          values[o] = raw;
          indices[o] = col;
        }
      }
    } else {
      kept = inb;  // the tail lanes stay dense
    }
    if (inb) {
      mask[off] = kept ? 1 : 0;
      if (dense != nullptr) dense[off] = kept ? raw : from_f32<T>(0.f);
    }
  }
}

template <typename T>
static void launch(const void* x, int M, int K, int keep, void* mask, void* values,
                   void* indices, void* dense, cudaStream_t stream) {
  const long long warps = (long long)M * ((K + 31) / 32);
  long long blocks = (warps + kTopkThreads / 32 - 1) / (kTopkThreads / 32);
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // the loop strides over the rest
  das_topk_kernel<T><<<(unsigned)blocks, kTopkThreads, 0, stream>>>(
      static_cast<const T*>(x), M, K, keep, static_cast<int8_t*>(mask),
      static_cast<T*>(values), static_cast<int*>(indices), static_cast<T*>(dense));
}

}  // namespace tenet

extern "C" int tenet_das_topk(const void* x, int dtype, int M, int K, int keep, void* mask,
                              void* values, void* indices, void* dense, void* stream) {
  using namespace tenet;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      launch<float>(x, M, K, keep, mask, values, indices, dense, s);
      break;
    case kBF16:
      launch<__nv_bfloat16>(x, M, K, keep, mask, values, indices, dense, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
