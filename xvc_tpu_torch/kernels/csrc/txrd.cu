// Ranking stage of the encoder's transform-RD intra prepass.
//
// Replaces, on the GPU: the tail of xvc_tpu/tpu/txrd_prepass.py
// _txrd_step (:120-144), which XLA runs as some twenty elementwise passes
// and two reductions over [B, 8, n, n].  For each block b and each of its
// m = 8 SATD-screened candidates j, from the forward-transformed
// residual coeff[b, j] (n x n, f32 integers):
//   level = min(floor((|c| * scale + offset) * 2^-shift), 32767)
//   ch    = min(floor(level * inv_scale * 2^-inv_shift + 0.5), 32767)
//   dist  = f32(sum (|c| - ch)^2) * inv_gain        (Parseval distortion)
//   bits  = f32(sum over level > 0 of (1.5 + 2 * log2(level + 1)))
//   cost  = dist + lam * bits
// then keeps the `keep` candidates of lowest cost, lower index first on
// ties (lax.top_k's order), as true mode numbers (cand < 2: cand, else
// (cand - 2) * screen_step + 2).  Output [B, keep] int32.
//
// Exactness: the plain version (gpu/txrd_prepass.py txrd_rank_plain)
// does the same arithmetic operation for operation, and the kernel
// equals it bit for bit.  Every f32 product and sum is written with
// __fmul_rn / __fadd_rn, so nvcc cannot contract it into an FMA.  The
// two products XLA's CPU backend does contract (|c| * scale + offset and
// lam * bits + dist) are formed in f64, where the product is exact, and
// rounded once to f32: the FMA's result.  Both sums are f64: every term
// is exact there, so the result does not depend on the order of
// accumulation (XLA's f32 order is not reproducible), and they are
// rounded to f32 where the JAX expression has its f32 value.  log2 is
// the f64 log2 rounded to f32, the same function in torch.log2 on f64
// on either device.  The powers of two come from the host as the JAX
// package's XLA CPU backend computes them (gpu/txrd_prepass.py xla_exp2).
//
// Design (simple first): one warp per block, the m candidates in turn;
// each lane takes every 32nd coefficient, keeps both sums in f64
// registers and the warp adds them with __shfl_xor_sync; lane 0 picks
// the best `keep`.  What bounds it: bytes (each coefficient read once,
// some 30 operations on it).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCand = 8;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  float scale, offset, p_shift, inv_scale, p_inv, inv_gain, lam;
};

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int mask = 16; mask > 0; mask >>= 1)
    v += __shfl_xor_sync(kFull, v, mask);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    txrd_rank(const float* __restrict__ coeff,
              const int32_t* __restrict__ cand, long long nblocks, int m,
              int nn, int keep, int screen_step, Params p,
              int32_t* __restrict__ out) {
  const long long b =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= nblocks) return;  // whole warps leave together
  float cost[kMaxCand];
#pragma unroll
  for (int j = 0; j < kMaxCand; ++j) {
    if (j >= m) break;
    const float* c = coeff + (b * m + j) * (long long)nn;
    double err_sum = 0.0, bits_sum = 0.0;
    for (int i = lane; i < nn; i += 32) {
      const float a = fabsf(c[i]);
      // |c| * scale + offset with one rounding (XLA's FMA)
      const float u = (float)((double)a * (double)p.scale + (double)p.offset);
      const float level = fminf(floorf(__fmul_rn(u, p.p_shift)), 32767.0f);
      const float ch = fminf(
          floorf(__fadd_rn(__fmul_rn(__fmul_rn(level, p.inv_scale), p.p_inv),
                           0.5f)),
          32767.0f);
      const float err = __fsub_rn(a, ch);
      err_sum += (double)err * (double)err;
      if (level > 0.0f) {
        const float lg = (float)log2((double)__fadd_rn(level, 1.0f));
        bits_sum += (double)__fadd_rn(1.5f, __fmul_rn(2.0f, lg));
      }
    }
    err_sum = warp_sum(err_sum);
    bits_sum = warp_sum(bits_sum);
    const float dist = __fmul_rn((float)err_sum, p.inv_gain);
    const float bits = (float)bits_sum;
    // dist + lam * bits with one rounding (XLA's FMA)
    cost[j] = (float)((double)p.lam * (double)bits + (double)dist);
  }
  if (lane != 0) return;
  unsigned taken = 0;
  for (int k = 0; k < keep; ++k) {
    int best = -1;
#pragma unroll
    for (int j = 0; j < kMaxCand; ++j) {
      if (j >= m) break;
      if (!(taken >> j & 1u) && (best < 0 || cost[j] < cost[best])) best = j;
    }
    taken |= 1u << best;
    const int mode = cand[b * m + best];
    out[b * keep + k] = mode < 2 ? mode : (mode - 2) * screen_step + 2;
  }
}

}  // namespace

extern "C" int xvc_txrd_rank(const void* coeff, const void* cand,
                             long long nblocks, int m, int n, int keep,
                             int screen_step, float scale, float offset,
                             float p_shift, float inv_scale, float p_inv,
                             float inv_gain, float lam, void* out,
                             void* stream) {
  if (nblocks <= 0) return 0;
  if ((n != 4 && n != 8 && n != 16 && n != 32) || m < 1 || m > kMaxCand ||
      keep < 1 || keep > m || screen_step < 1)
    return (int)cudaErrorInvalidValue;
  const long long ctas = (nblocks + kThreads / 32 - 1) / (kThreads / 32);
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Params p{scale, offset, p_shift, inv_scale, p_inv, inv_gain, lam};
  txrd_rank<<<(unsigned)ctas, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)coeff, (const int32_t*)cand, nblocks, m, n * n, keep,
      screen_step, p, (int32_t*)out);
  return (int)cudaGetLastError();
}
