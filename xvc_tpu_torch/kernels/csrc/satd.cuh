// The Hadamard SATD butterflies, shared by satd.cu (SATD of given
// differences or predictions) and intra_satd.cu (every intra mode of a
// block predicted on chip, then its SATD): the reference's SATD metric
// (ref: src/xvc_enc_lib/sample_metric.cc Compute8x8Satd / Compute4x4Satd)
// as integer butterflies, exact in int32 (|diff| < 2^16, so a transformed
// coefficient stays below 2^22 and a tile's sum below 2^28).
//
// T lanes of a warp (T = 8, or 4 for 4x4 tiles), aligned to a multiple of
// T, share one T x T tile, one row a lane: the row transform runs in the
// lane's registers, the column transform across the T lanes with
// __shfl_xor_sync.  Every lane of the warp must call tile_sum together.
#pragma once
#include <cuda_runtime.h>

namespace xvc_hadamard {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int absi(int x) { return x < 0 ? -x : x; }

// In-register Hadamard butterfly over T values (order and signs of the
// outputs differ from the matrix form; the sum of |.| does not).
template <int T>
__device__ __forceinline__ void hadamard_regs(int (&v)[T]) {
#pragma unroll
  for (int h = 1; h < T; h <<= 1) {
#pragma unroll
    for (int i = 0; i < T; i += 2 * h) {
#pragma unroll
      for (int j = i; j < i + h; ++j) {
        const int a = v[j], b = v[j + h];
        v[j] = a + b;
        v[j + h] = a - b;
      }
    }
  }
}

// The same butterfly across the T lanes of a group, for each of the T
// register columns.
template <int T>
__device__ __forceinline__ void hadamard_lanes(int (&v)[T], int lane) {
#pragma unroll
  for (int mask = 1; mask < T; mask <<= 1) {
    const bool upper = (lane & mask) != 0;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const int other = __shfl_xor_sync(kFull, v[j], mask);
      v[j] = upper ? other - v[j] : v[j] + other;
    }
  }
}

// Sum of |H D H| of the group's tile, in every lane of the group.
template <int T>
__device__ __forceinline__ int tile_sum(int (&v)[T], int lane) {
  hadamard_regs<T>(v);
  hadamard_lanes<T>(v, lane);
  int s = 0;
#pragma unroll
  for (int j = 0; j < T; ++j) s += absi(v[j]);
#pragma unroll
  for (int mask = 1; mask < T; mask <<= 1)
    s += __shfl_xor_sync(kFull, s, mask);
  return s;
}

// A tile's sum normalised as the reference does before tiles are added:
// (s + 1) >> 1 for a 4x4 tile, (s + 2) >> 2 for an 8x8 one.
template <int T>
__device__ __forceinline__ int tile_norm(int s) {
  return T == 4 ? (s + 1) >> 1 : (s + 2) >> 2;
}

}  // namespace xvc_hadamard
