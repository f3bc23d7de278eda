// twd_decode: base-3 packed bytes -> int8 trits (the TWD decompressor).
//
// Replaces src/repro/kernels/ternary_gemm.py::_twd_decode_kernel (the TPU
// kernel expands a (512, 256) tile of bytes to (2560, 256) trits in VMEM;
// its wrapper then slices the first k rows).
//
//   out[5r + d, n] = digit d of packed[r, n], {0,1,2} -> {-1,0,+1}, for 5r + d < K
//
// packed: (R, N) uint8, any shape; out: (K, N) int8 with K <= 5R.  Trits past
// K (the export's padding rows) are not written.
//
// What bounds it on the H100: bytes — R*N read and K*N written, six bytes
// moved per packed byte, five operations per trit.  One thread per packed
// byte, neighbouring threads on neighbouring columns: a warp reads 32
// consecutive bytes of a packed row and writes 32 consecutive bytes to each
// of its five trit rows.  No tiling, so every (R, N) is allowed.
#include "common.cuh"

namespace tenet {

constexpr int kDecodeThreads = 256;

__global__ void __launch_bounds__(kDecodeThreads)
twd_decode_kernel(const uint8_t* __restrict__ packed, int8_t* __restrict__ out, int R,
                  int K, int N) {
  const size_t i = (size_t)blockIdx.x * kDecodeThreads + threadIdx.x;
  if (i >= (size_t)R * N) return;
  const int r = (int)(i / (size_t)N);
  const int n = (int)(i % (size_t)N);
  unsigned v = __ldg(packed + i);
#pragma unroll
  for (int d = 0; d < 5; ++d) {
    const int t = next_trit(v);
    const int k = 5 * r + d;
    if (k < K) out[(size_t)k * N + n] = (int8_t)t;
  }
}

}  // namespace tenet

extern "C" int tenet_twd_decode(const void* packed, void* out, int R, int K, int N,
                                void* stream) {
  using namespace tenet;
  const size_t total = (size_t)R * N;
  if (total == 0 || K > 5 * R) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((total + kDecodeThreads - 1) / kDecodeThreads);
  twd_decode_kernel<<<blocks, kDecodeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<int8_t*>(out), R, K, N);
  return (int)cudaGetLastError();
}
