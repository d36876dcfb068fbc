// All-mode intra SATD of square blocks: every intra mode of a block
// predicted on chip and the Hadamard SATD of orig - pred summed, in one
// launch.
//
// Replaces, on the GPU: xvc_tpu/tpu/analysis.py:27 _intra_satd_step, the
// device step of the encoder's all-mode SATD pre-pass and lookahead
// (ref: src/xvc_enc_lib/intra_search.cc:188-303 DetermineSlowIntraModes):
// xvc_tpu/tpu/intra_batch.py:164 predict_all_modes (every angular mode as
// one float32 product with a [65, n*n, 2(4n+1)] tap-weight tensor, planar
// and DC directly, the post filters as masked stores; ref:
// src/xvc_common_lib/intra_prediction.cc:306-558,850-871), then
// xvc_tpu/tpu/satd.py satd_square (ref: sample_metric.cc
// Compute8x8Satd / Compute4x4Satd).  The semantics are the JAX step's:
//   - modes planar, DC, then the angular modes 2, 2 + s, 2 + 2s, ... for
//     mode_step s (angular_weight_tensor(n)[::s]);
//   - the [1 2 1] filtered lines where use_filtered_ref_samples says so
//     (planar by its own rule, DC never);
//   - the post filters (DC's row and column with the corner last, the
//     exact horizontal and vertical modes, the modes at +-1 from them)
//     only where n <= 16 and s == 1: with s > 1 the JAX step drops them
//     all, DC's included, and so does this kernel;
//   - SATD: 8x8 tiles each normalised (s + 2) >> 2 (a 4x4 block: (s + 1)
//     >> 1), summed, then >> (bitdepth - 8).
//
// Not carried over from the TPU: the product with the weight tensor.  The
// MXU made that the cheap form there.  Here an angular sample is two
// integer taps of the mode's projected reference line (angle, inverse
// angle and the flip of the horizontal modes resolved once a mode, when
// the line is built), and neither the weights nor the [B, M, n, n]
// predictions ever reach global memory: a block's 4n + 1 reference
// samples and n^2 originals are read once a CTA, M costs are written.
//
// What bounds it on an H100: operations.  Each predicted sample costs
// some 20 integer operations (its two taps or the planar sum, the
// difference, its share of the butterflies and of |.|), against 4 bytes
// read per original sample for all M modes together.
//
// Design: a CTA takes one block and a chunk of its modes (grid B x
// chunks, blockIdx.x the block, so no CTA divides to find it; the host
// balances the chunks so that the CTA's T-lane groups cover its (mode,
// tile) units in about one round: one block of 4 to 32, as the per-CU
// pre-pass gives it, spreads over 2 to 34 CTAs).  The CTA stages orig,
// top and left in shared memory, filters the lines (filter_ref_line of
// intra_pred.cuh), builds each of its angular modes' projected line once
// (Angular::rv), and each warp computes the DC value.  Then each group of
// T lanes (T = 8, or 4 for n = 4) takes a (mode, tile) unit: a lane
// predicts one row of the tile, subtracts it from orig in registers, and
// the group runs the butterflies of satd.cuh.  The normalised tile sums
// of a mode meet in shared memory by atomicAdd: exact int32 addition, so
// the order of the tiles does not matter.
#include <cuda_runtime.h>
#include <stdint.h>

#include "intra_pred.cuh"
#include "satd.cuh"

namespace {

using namespace xvc_intra;
using namespace xvc_hadamard;

constexpr int kThreads = 256;  // at most, a CTA

// The geometry of block size N: a tile of T x T, T lanes to a tile, the
// lanes one mode needs for all its tiles, the modes a CTA may take, and
// the length of a mode's projected line (index 2N + 1 is read only with
// a zero weight).
template <int N>
struct Geo {
  static constexpr int T = N == 4 ? 4 : 8;
  static constexpr int kTilesX = N / T;
  static constexpr int kTiles = kTilesX * kTilesX;
  static constexpr int kLanesPerMode = kTiles * T;
  static constexpr int kMaxModes =
      kLanesPerMode >= kThreads ? 1 : kThreads / kLanesPerMode;
  static constexpr int kLineLen = 2 * N + 2;
  static constexpr int kL2 = N == 4    ? 2
                             : N == 8  ? 3
                             : N == 16 ? 4
                             : N == 32 ? 5
                                       : 6;
};

// use_filtered_ref_samples of a square N x N block (ref:
// intra_prediction.cc:342-363; intra_batch._use_filtered).
template <int N>
__device__ __forceinline__ bool use_filtered(int mode) {
  const int d = min(abs(mode - kHor), abs(mode - kVer));
  return d > kThrExt[Geo<N>::kL2];
}

template <int N>
__global__ void __launch_bounds__(kThreads)
intra_satd_kernel(const int32_t* __restrict__ orig,
                  const int32_t* __restrict__ top,
                  const int32_t* __restrict__ left, int M, int mode_step,
                  int per_cta, int post, int max_val, int shift,
                  int32_t* __restrict__ out) {
  using G = Geo<N>;
  constexpr int T = G::T;
  __shared__ int s_orig[N * N];
  __shared__ int s_top[2 * N + 2], s_left[2 * N + 1];
  __shared__ int s_ftop[2 * N + 2], s_fleft[2 * N + 1];
  __shared__ int s_line[G::kMaxModes][G::kLineLen];
  __shared__ int s_acc[G::kMaxModes];

  const long long b = blockIdx.x;  // the block; blockIdx.y its chunk
  const int m0 = blockIdx.y * per_cta;
  const int mc = min(per_cta, M - m0);  // this CTA's modes m0 .. m0+mc-1
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31;

  const int32_t* o = orig + b * (N * N);
  const int32_t* tp = top + b * (2 * N + 1);
  const int32_t* lp = left + b * (2 * N);
  for (int i = tid; i < N * N; i += nthreads) s_orig[i] = o[i];
  // the lines with one zero entry past their end (read with weight 0)
  for (int i = tid; i < 2 * N + 2; i += nthreads) {
    s_top[i] = i <= 2 * N ? tp[i] : 0;
    if (i <= 2 * N) s_left[i] = i < 2 * N ? lp[i] : 0;
  }
  if (tid == 0) {
    s_ftop[2 * N + 1] = 0;
    s_fleft[2 * N] = 0;
  }
  if (tid < mc) s_acc[tid] = 0;
  __syncthreads();
  if (tid < 32) filter_ref_line(s_top, s_left, 2 * N, lane, s_ftop, s_fleft);
  // every warp sums the DC value itself (the CTA is whole warps)
  const int dc = dc_value(s_top, s_left, N, N, lane);
  __syncthreads();

  // each angular mode's projected line, once a CTA
  for (int i = tid; i < mc * G::kLineLen; i += nthreads) {
    const int ml = i / G::kLineLen, jr = i - ml * G::kLineLen;
    const int mi = m0 + ml;
    if (mi >= 2) {
      const int mode = 2 + (mi - 2) * mode_step;
      const bool filt = use_filtered<N>(mode);
      const Angular a(filt ? s_ftop : s_top, filt ? s_fleft : s_left, N, N,
                      mode);
      s_line[ml][jr] = a.rv(jr);
    }
  }
  __syncthreads();

  const bool planar_filt = use_filtered<N>(0);
  const int group = tid / T, row = tid % T, groups = nthreads / T;
  const int units = mc * G::kTiles;
  // the bound is the CTA's, so every lane of a warp reaches the shuffles
  for (int u0 = 0; u0 < units; u0 += groups) {
    const int u = u0 + group;
    const bool valid = u < units;
    const int ml = valid ? u / G::kTiles : 0;
    const int t = valid ? u - ml * G::kTiles : 0;
    const int ty = t / G::kTilesX, tx = t - ty * G::kTilesX;
    const int y = ty * T + row, x0 = tx * T;
    const int mi = m0 + ml;
    int v[T];
    if (mi == 0) {
      const int* pt = planar_filt ? s_ftop : s_top;
      const int* pl = planar_filt ? s_fleft : s_left;
#pragma unroll
      for (int j = 0; j < T; ++j)
        v[j] = pred_planar(pt, pl, N, N, G::kL2, G::kL2, y, x0 + j);
    } else if (mi == 1) {
#pragma unroll
      for (int j = 0; j < T; ++j)
        v[j] = post ? dc_post(s_top, s_left, dc, y, x0 + j) : dc;
    } else {
      const int mode = 2 + (mi - 2) * mode_step;
      const bool filt = use_filtered<N>(mode);
      // where the post filters apply (n <= 16), the modes they touch
      // (within 1 of horizontal or vertical) take the unfiltered lines
      const Angular a(filt ? s_ftop : s_top, filt ? s_fleft : s_left, N, N,
                      mode);
      const int* line = s_line[ml];
      const bool edge = post && a.angle >= -1 && a.angle <= 1;
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const int x = x0 + j;
        const int yy = a.is_hor ? x : y, xx = a.is_hor ? y : x;
        const int asum = (yy + 1) * a.angle;
        const int iw = asum & 31;
        const int idx = a.base + (asum >> 5) + xx;
        int p = ((32 - iw) * line[idx] + iw * line[idx + 1] + 16) >> 5;
        if (edge && xx == 0) {
          const int diff = a.l(yy) - a.t(0);
          p = a.angle == 0 ? clampi(a.t(1) + (diff >> 1), 0, max_val)
                           : clampi(p + (diff >> 2), 0, max_val);
        }
        v[j] = p;
      }
    }
#pragma unroll
    for (int j = 0; j < T; ++j) v[j] = s_orig[y * N + x0 + j] - v[j];
    const int s = tile_sum<T>(v, lane);
    if (valid && row == 0) atomicAdd(&s_acc[ml], tile_norm<T>(s));
  }
  __syncthreads();
  if (tid < mc) out[b * M + m0 + tid] = s_acc[tid] >> shift;
}

template <int N>
int launch(const int32_t* orig, const int32_t* top, const int32_t* left,
           long long B, int M, int mode_step, int bitdepth, int32_t* out,
           cudaStream_t st) {
  using G = Geo<N>;
  // as many CTAs a block as keep each CTA's groups busy for one round,
  // the modes spread evenly over them
  int per_cta = M < G::kMaxModes ? M : G::kMaxModes;
  const int chunks = (M + per_cta - 1) / per_cta;
  per_cta = (M + chunks - 1) / chunks;
  int threads = (per_cta * G::kLanesPerMode + 31) / 32 * 32;
  if (threads > kThreads) threads = kThreads;
  if (B > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int post = N <= 16 && mode_step == 1;
  intra_satd_kernel<N><<<dim3((unsigned)B, chunks), threads, 0, st>>>(
      orig, top, left, M, mode_step, per_cta, post, (1 << bitdepth) - 1,
      bitdepth - 8, out);
  return (int)cudaGetLastError();
}

}  // namespace

// orig [B, n, n], top [B, 2n + 1], left [B, 2n] int32 (samples of
// `bitdepth` bits) -> out [B, M] int32, M = 2 + ceil(65 / mode_step)
// (67 when mode_step is 1): the SATD of every mode in the JAX step's
// order.  No alignment beyond int32's is needed.
extern "C" int xvc_intra_satd(const void* orig, const void* top,
                              const void* left, long long B, int n,
                              int bitdepth, int mode_step, void* out,
                              void* stream) {
  if (B <= 0) return 0;
  if (bitdepth < 8 || bitdepth > 16 || mode_step < 1)
    return (int)cudaErrorInvalidValue;
  const int M = 2 + (65 + mode_step - 1) / mode_step;
  const int32_t* o = (const int32_t*)orig;
  const int32_t* t = (const int32_t*)top;
  const int32_t* l = (const int32_t*)left;
  int32_t* dst = (int32_t*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (n) {
    case 4:
      return launch<4>(o, t, l, B, M, mode_step, bitdepth, dst, st);
    case 8:
      return launch<8>(o, t, l, B, M, mode_step, bitdepth, dst, st);
    case 16:
      return launch<16>(o, t, l, B, M, mode_step, bitdepth, dst, st);
    case 32:
      return launch<32>(o, t, l, B, M, mode_step, bitdepth, dst, st);
    case 64:
      return launch<64>(o, t, l, B, M, mode_step, bitdepth, dst, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
