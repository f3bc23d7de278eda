// The row sources of the GEMM core (common.cuh): where a K window's
// activations come from.  Shared by ternary_gemm, das_ternary_gemm and
// das_gemv.
//  * DenseRows: (M, K) rows, lane l of row m is x[m, l] (a DAS-masked row
//    with a dense tail, DAS off, or int8 activations);
//  * CompactRows: das_compact's (M, Kc) values and absolute lane indices,
//    `keep` ascending lanes of every `block`, so the entries of a window
//    sit at positions [a / block * keep, b / block * keep), clamped to Kc.
#pragma once

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

}  // namespace tenet
