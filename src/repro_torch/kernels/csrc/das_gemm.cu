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
#include "common.cuh"

namespace tenet {

// the window's compacted entries, scattered to their lanes
template <typename T>
struct CompactRows {
  const T* __restrict__ values;
  const int* __restrict__ indices;
  int M, Kc, E;                      // E: entries a row of a window (kWinLanes / block * keep)
  static constexpr bool kScatter = true;
  static constexpr int kStages = 2;  // tensor-core route: windows in flight (shared memory)

  // put(mi, li, v) for the kept lanes of rows m0..m0+ROWS-1 in lanes
  // lane0..lane0+LANES-1 (whole windows), every load issued before the first
  // put; the caller has zeroed the tile
  template <int ROWS, int NT, typename Acc, int LANES = kWinLanes, class Put>
  __device__ __forceinline__ void stage(int m0, int lane0, Put put) const {
    constexpr int kTrips = (LANES + NT - 1) / NT;          // entries a row <= LANES
    const int e = LANES / kWinLanes * E;
    const int n = min(e, Kc - lane0 / kWinLanes * E);       // the window's entries a row
    const size_t j0 = (size_t)(lane0 / kWinLanes) * E;
    Acc v[kTrips][ROWS];
    int li[kTrips][ROWS];
#pragma unroll
    for (int k = 0; k < kTrips; ++k) {
      const int j = threadIdx.x + k * NT;
#pragma unroll
      for (int mi = 0; mi < ROWS; ++mi) {
        li[k][mi] = -1;
        if (j < n && m0 + mi < M) {
          const size_t o = (size_t)(m0 + mi) * Kc + j0 + j;
          li[k][mi] = indices[o] - lane0;
          v[k][mi] = convert<Acc>(values[o]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kTrips; ++k)
#pragma unroll
      for (int mi = 0; mi < ROWS; ++mi)
        if (li[k][mi] >= 0 && li[k][mi] < LANES) put(mi, li[k][mi], v[k][mi]);
  }

  // tensor-core route (T = bf16, Kc % 8 == 0, E % 8 == 0): the window's
  // values and indices go by cp.async to a staging buffer, 16 bytes a copy;
  // mma_tile scatters them into the zeroed activation tile
  __host__ __device__ size_t mma_stage_bytes() const {
    return (size_t)kMmaRows * E * (sizeof(__nv_bfloat16) + sizeof(int));
  }
  __host__ __device__ size_t mma_extra_bytes() const {
    return (size_t)kMmaRows * kAStride * sizeof(__nv_bfloat16);
  }
  __device__ __forceinline__ void mma_issue(unsigned char* buf, int m0, int s) const {
    __nv_bfloat16* sv = reinterpret_cast<__nv_bfloat16*>(buf);
    int* si = reinterpret_cast<int*>(buf + (size_t)kMmaRows * E * sizeof(__nv_bfloat16));
    const int j0 = s * E;
    const int vchunks = E / 8, ichunks = E / 4;      // 16-byte copies a row
    for (int i = threadIdx.x; i < kMmaRows * (vchunks + ichunks); i += kMmaThreads) {
      const int mi = i / (vchunks + ichunks), c = i % (vchunks + ichunks);
      const int row = m0 + mi;
      if (c < vchunks) {
        const int j = j0 + c * 8;
        const bool ok = row < M && j < Kc;
        cp_async(sv + mi * E + c * 8, ok ? values + (size_t)row * Kc + j : values, 16,
                 ok ? 16 : 0);
      } else {
        const int j = j0 + (c - vchunks) * 4;
        const bool ok = row < M && j < Kc;
        cp_async(si + mi * E + (c - vchunks) * 4, ok ? indices + (size_t)row * Kc + j : indices,
                 16, ok ? 16 : 0);
      }
    }
  }
  __device__ __forceinline__ const __nv_bfloat16* mma_tile(unsigned char* buf,
                                                           unsigned char* extra, int s) const {
    const __nv_bfloat16* sv = reinterpret_cast<const __nv_bfloat16*>(buf);
    const int* si =
        reinterpret_cast<const int*>(buf + (size_t)kMmaRows * E * sizeof(__nv_bfloat16));
    __nv_bfloat16* at = reinterpret_cast<__nv_bfloat16*>(extra);
    uint4* z = reinterpret_cast<uint4*>(extra);
    for (int i = threadIdx.x; i < kMmaRows * kAStride * 2 / 16; i += kMmaThreads)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
    const int lane0 = s * kWinLanes, n = min(E, Kc - s * E);
    // a warp a row at a time (rows past M hold zero values)
    for (int mi = threadIdx.x / 32; mi < kMmaRows; mi += kMmaThreads / 32)
      for (int j = threadIdx.x % 32; j < n; j += 32) {
        const int li = si[mi * E + j] - lane0;
        if (li >= 0 && li < kWinLanes) at[mi * kAStride + mma_lane(li)] = sv[mi * E + j];
      }
    __syncthreads();
    return at;
  }
};

struct Scale {
  const float* w_scale;
  float w;                // *w_scale, loaded when a block starts
  __device__ __forceinline__ void load() { w = __ldg(w_scale); }
  __device__ __forceinline__ float operator()(float v, int) const { return v * w; }
};

template <typename T>
static cudaError_t launch(const void* values, const int* indices, const uint8_t* packed,
                          Scale epi, float* out, int M, int Kc, int E, int R, int N,
                          cudaStream_t stream) {
  const CompactRows<T> rows{static_cast<const T*>(values), indices, M, Kc, E};
  if (M <= kDecRows) {
    return launch_decode<float, std::is_same<T, __nv_bfloat16>::value>(rows, packed, R, N, epi,
                                                                       out, stream);
  }
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (Kc % 8 == 0 && E % 8 == 0 && N % 4 == 0) {
      return launch_prefill_mma(rows, packed, R, N, epi, out, stream);
    }
  }
  prefill_fma_kernel<float><<<fma_grid(M, N), kFmaThreads, 0, stream>>>(rows, packed, R, N,
                                                                        epi, out);
  return cudaGetLastError();
}

}  // namespace tenet

// keep, block: das_compact's (kWinLanes % block == 0)
extern "C" int tenet_das_ternary_gemm(const void* values, int dtype, const void* indices,
                                      const void* packed, const void* w_scale, void* out,
                                      int M, int Kc, int keep, int block, int R, int N,
                                      void* stream) {
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
      return (int)launch<float>(values, idx, p, epi, o, M, Kc, E, R, N, s);
    case kBF16:
      return (int)launch<__nv_bfloat16>(values, idx, p, epi, o, M, Kc, E, R, N, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
