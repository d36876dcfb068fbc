// Hadamard SATD of square blocks (sum of absolute transformed differences).
//
// Replaces, on the GPU: xvc_tpu/tpu/pallas_satd.py satd8_pallas (the
// Pallas kernel: flattened 8x8 diff times the 64x64 Kronecker matrix
// H8 (x) H8 in f32, |.| summed in int32) and the XLA einsum of
// xvc_tpu/tpu/satd.py satd_square (ref: src/xvc_enc_lib/sample_metric.cc
// Compute8x8Satd / Compute4x4Satd):
//   n >= 8: the block is (n/8)^2 tiles of 8x8; each tile's sum of
//           |H8 D H8| is normalised (s + 2) >> 2 before the tiles are
//           added; the shift by bitdepth - 8 comes last, once per block;
//   n == 4: |H4 D H4| summed, (s + 1) >> 1, then the same shift.
//
// Not carried over from the TPU: the matrix product.  The MXU made a
// 64x64 f32 product the cheap form there; here the 8-point Hadamard is 24
// integer additions per row as a butterfly, exact in int32 (|diff| < 2^14
// for bitdepth <= 14, times 64 stays below 2^20).
//
// What bounds it on an H100: bytes.  Every difference is read once (4
// bytes) and takes about 8 integer operations, so the kernel's floor is
// the read of the input at the HBM rate.
//
// Design: T lanes of a warp share one TxT tile (T = 8, or 4 for n == 4).
// Each lane loads one row of the tile as 16-byte vectors, so that for
// n == T a warp reads 1024 contiguous bytes per tile row-set, and for
// n > 8 whole 32-byte row pieces.  The row transform is a butterfly in
// the lane's registers; the column transform is the same butterfly across
// the T lanes with __shfl_xor_sync; |.| is summed in the lane and then
// across the lanes.  For n == T each lane group owns one block; for
// n > 8 a warp owns one block and its lane groups walk the block's
// tiles, adding the normalised tile sums, so no atomics and no second
// pass are needed.  With `orig` given, the difference orig[b] - pred[b, m]
// is formed in the kernel (the fused entry, which the transform-RD
// prepass calls on its predictions), and the [B, M, n, n] difference
// never exists in memory.  The butterflies live in satd.cuh, shared with
// intra_satd.cu, which predicts the modes itself (the lookahead and the
// per-CU pre-pass).
#include <cuda_runtime.h>
#include <stdint.h>

#include "satd.cuh"

namespace {

using namespace xvc_hadamard;

constexpr int kThreads = 256;

// Row `row` of a TxT tile at element offset `off`: diff, or orig - pred.
template <int T>
__device__ __forceinline__ void load_row(const int32_t* __restrict__ src,
                                         const int32_t* __restrict__ orig,
                                         size_t off, size_t orig_off,
                                         bool valid, int (&v)[T]) {
#pragma unroll
  for (int q = 0; q < T / 4; ++q) {
    int4 d = make_int4(0, 0, 0, 0);
    if (valid) {
      d = *reinterpret_cast<const int4*>(src + off + 4 * q);
      if (orig != nullptr) {
        const int4 o =
            *reinterpret_cast<const int4*>(orig + orig_off + 4 * q);
        d = make_int4(o.x - d.x, o.y - d.y, o.z - d.z, o.w - d.w);
      }
    }
    v[4 * q + 0] = d.x;
    v[4 * q + 1] = d.y;
    v[4 * q + 2] = d.z;
    v[4 * q + 3] = d.w;
  }
}

// n == T: one lane group per block.  src [nblocks, T, T]; with orig
// [nblocks / M, T, T] the input is orig[i / M] - src[i].
template <int T>
__global__ void __launch_bounds__(kThreads)
satd_single_tile(const int32_t* __restrict__ src,
                 const int32_t* __restrict__ orig, long long nblocks, int M,
                 int shift, int32_t* __restrict__ out) {
  constexpr int kGroups = 32 / T;
  const int lane = threadIdx.x & 31;
  const int row = lane % T;
  const long long warp =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const long long blk = warp * kGroups + lane / T;
  const bool valid = blk < nblocks;
  int v[T];
  const size_t off = (size_t)(valid ? blk : 0) * (T * T) + row * T;
  const size_t orig_off =
      orig != nullptr ? (size_t)((valid ? blk : 0) / M) * (T * T) + row * T
                      : 0;
  load_row<T>(src, orig, off, orig_off, valid, v);
  const int s = tile_sum<T>(v, lane);
  if (valid && row == 0)
    out[blk] = tile_norm<T>(s) >> shift;
}

// n > 8: one warp per block of (n/8)^2 tiles; lane group g takes tiles
// g, g + 4, ...
__global__ void __launch_bounds__(kThreads)
satd_tiled(const int32_t* __restrict__ src, const int32_t* __restrict__ orig,
           long long nblocks, int M, int n, int shift,
           int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = lane & 7;
  const int group = lane >> 3;
  const long long blk =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (blk >= nblocks) return;  // the whole warp leaves together
  const int tn = n >> 3;
  const int tiles = tn * tn;   // a multiple of 4 for n >= 16
  const size_t base = (size_t)blk * n * n;
  const size_t orig_base = orig != nullptr ? (size_t)(blk / M) * n * n : 0;
  int acc = 0;
  for (int t = group; t < tiles; t += 4) {
    const int ty = t / tn, tx = t - ty * tn;
    const size_t in_blk = (size_t)(ty * 8 + row) * n + tx * 8;
    int v[8];
    load_row<8>(src, orig, base + in_blk, orig_base + in_blk, true, v);
    acc += tile_norm<8>(tile_sum<8>(v, lane));
  }
  acc += __shfl_xor_sync(kFull, acc, 8);
  acc += __shfl_xor_sync(kFull, acc, 16);
  if (lane == 0) out[blk] = acc >> shift;
}

}  // namespace

// src [nblocks, n, n] int32 -> out [nblocks] int32.  orig == NULL: src
// holds the differences.  orig [nblocks / M, n, n]: src holds predictions
// [nblocks / M, M, n, n] and the difference is orig - src.  All pointers
// 16-byte aligned.
extern "C" int xvc_satd(const void* src, const void* orig, long long nblocks,
                        int M, int n, int bitdepth, void* out, void* stream) {
  if (nblocks <= 0) return 0;
  if ((n != 4 && n != 8 && n != 16 && n != 32 && n != 64) || bitdepth < 8 ||
      M < 1 || (orig != nullptr && nblocks % M != 0))
    return (int)cudaErrorInvalidValue;
  const int shift = bitdepth - 8;
  const int warps_per_cta = kThreads / 32;
  const long long warps =
      n == 4 ? (nblocks + 7) / 8 : (n == 8 ? (nblocks + 3) / 4 : nblocks);
  const long long ctas = (warps + warps_per_cta - 1) / warps_per_cta;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int32_t* s = (const int32_t*)src;
  const int32_t* o = (const int32_t*)orig;
  int32_t* dst = (int32_t*)out;
  if (n == 4)
    satd_single_tile<4><<<(unsigned)ctas, kThreads, 0, st>>>(s, o, nblocks, M,
                                                             shift, dst);
  else if (n == 8)
    satd_single_tile<8><<<(unsigned)ctas, kThreads, 0, st>>>(s, o, nblocks, M,
                                                             shift, dst);
  else
    satd_tiled<<<(unsigned)ctas, kThreads, 0, st>>>(s, o, nblocks, M, n,
                                                    shift, dst);
  return (int)cudaGetLastError();
}
