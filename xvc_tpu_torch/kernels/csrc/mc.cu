// Batched sub-pel motion compensation + scatter into the prediction planes.
//
// Replaces, on the GPU: xvc_tpu/tpu/pallas_mc.py make_mc_pallas (the
// Pallas window-DMA kernel), xvc_tpu/tpu/dsp.py _mc_core_builder (its XLA
// gather twin) and the scatter of xvc_tpu/tpu/flat_recon.py
// make_mc_scatter.  Rounding and int16 wrap points follow the scalar
// reference (native/xvcn.cpp xvcn_mc_filter, ref: inter_prediction.cc
// 1138-1378): all four fractional cases, clipped samples or the 14-bit
// bi-prediction intermediates (short_out).
//
// What bounds it on an H100: bytes.  A job reads its (h+taps-1) x
// (w+taps-1) int16 window and writes h x w int16 samples, at most 8+8
// multiply-adds per output sample, so the arithmetic intensity is a few
// operations per byte, far below the card's compute line; for the small
// buckets (8x8) the fixed cost per thread block dominates.
//
// Design: one thread block per job.  The window is staged once in shared
// memory (at most 71 x 71 int32), so each reference sample is read from
// device memory once per job instead of taps times; the threads then
// cover the (hb, wb) output.  The 2-D case first filters all window rows
// horizontally into a second shared buffer, then vertically, like the
// reference.  The window origin is taken exactly as
// lax.dynamic_slice takes it (a negative start counts from the end, then
// the start is clamped to [0, dim - size]; the same for the reference
// index), and lanes whose channel is the _BIG sentinel write nothing (the
// dropped updates of .at[].set(mode="drop")).  Only the valid w x h region is
// stored.  In short groups a slot-1 job sets mask[chan - nplanes] = 1;
// the combine stage reads only mask > 0, so a store replaces the JAX
// .add and needs no atomics.  Later work: several jobs per block for the
// small buckets, cp.async/TMA staging.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWin = 64 + 8 - 1;  // largest bucket + 8 taps - 1
constexpr int kThreads = 256;
constexpr int kFilterPrecision = 6;
constexpr int kInternalPrecision = 14;
constexpr int kInternalOffset = 8192;

struct FilterTable {
  int v[128];  // [phase][tap], 16 x 8 (luma) or 32 x 4 (chroma)
};

__device__ __forceinline__ int wrap16(int x) { return (int)(int16_t)x; }

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// a window start as lax.dynamic_slice takes it: negative counts from the
// end, then clamped so that the window fits
__device__ __forceinline__ int ds_start(int v, int dim, int size) {
  return clampi(v < 0 ? v + dim : v, 0, dim - size);
}

__global__ void __launch_bounds__(kThreads)
mc_scatter_kernel(const int16_t* __restrict__ planes, int R, int Hp, int Wp,
                  const int32_t* __restrict__ params, int B, int wb, int hb,
                  int taps, int nphase, FilterTable table, int bitdepth,
                  int short_out, int16_t* __restrict__ pred, int nchan,
                  int H, int W, int16_t* __restrict__ mask, int nplanes) {
  __shared__ int win[kMaxWin * kMaxWin];
  __shared__ int tmp[kMaxWin * 64];
  const int b = blockIdx.x;
  const int chan = params[5 * B + b];
  if (chan < 0 || chan >= nchan) return;  // padding lane: dropped
  const int cy = params[6 * B + b];
  const int cx = params[7 * B + b];
  const int w = params[8 * B + b];
  const int h = params[9 * B + b];
  const int half = taps / 2 - 1;
  const int wh = hb + taps - 1;
  const int ww = wb + taps - 1;
  const int r = ds_start(params[b], R, 1);
  const int y0 = ds_start(params[B + b], Hp, wh);
  const int x0 = ds_start(params[2 * B + b], Wp, ww);
  const int fx = clampi(params[3 * B + b], 0, nphase - 1);
  const int fy = clampi(params[4 * B + b], 0, nphase - 1);

  const int16_t* src = planes + ((size_t)r * Hp + y0) * Wp + x0;
  for (int i = threadIdx.x; i < wh * ww; i += blockDim.x) {
    const int yy = i / ww, xx = i - (i / ww) * ww;
    win[i] = src[(size_t)yy * Wp + xx];
  }
  __syncthreads();

  const int* fxt = table.v + fx * taps;
  const int* fyt = table.v + fy * taps;
  const int prec_diff = kInternalPrecision - bitdepth;
  const int max_val = (1 << bitdepth) - 1;
  const int shift1 = kFilterPrecision - prec_diff;
  const int offset1 = -(kInternalOffset << shift1);
  const int shift2 = kFilterPrecision + prec_diff;
  const int offset2 = (kInternalOffset << kFilterPrecision) +
                      (1 << (shift2 - 1));
  const int frnd = 1 << (kFilterPrecision - 1);

  if (fx != 0 && fy != 0) {  // uniform over the block
    for (int i = threadIdx.x; i < wh * wb; i += blockDim.x) {
      const int yy = i / wb, xx = i - (i / wb) * wb;
      const int* row = win + yy * ww + xx;
      int s = 0;
      for (int t = 0; t < taps; ++t) s += fxt[t] * row[t];
      tmp[i] = wrap16((s + offset1) >> shift1);
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < hb * wb; i += blockDim.x) {
    const int yy = i / wb, xx = i - (i / wb) * wb;
    if (yy >= h || xx >= w) continue;
    const int oy = cy + yy, ox = cx + xx;
    if (oy < 0 || oy >= H || ox < 0 || ox >= W) continue;
    int v;
    if (fx == 0 && fy == 0) {
      const int c = win[(yy + half) * ww + xx + half];
      v = short_out ? wrap16(wrap16(c << prec_diff) - kInternalOffset)
                    : clampi(c, 0, max_val);
    } else if (fy == 0) {
      const int* row = win + (yy + half) * ww + xx;
      int s = 0;
      for (int t = 0; t < taps; ++t) s += fxt[t] * row[t];
      v = short_out ? wrap16((s + offset1) >> shift1)
                    : clampi((s + frnd) >> kFilterPrecision, 0, max_val);
    } else if (fx == 0) {
      const int* col = win + yy * ww + xx + half;
      int s = 0;
      for (int t = 0; t < taps; ++t) s += fyt[t] * col[t * ww];
      v = short_out ? wrap16((s + offset1) >> shift1)
                    : clampi(wrap16((s + frnd) >> kFilterPrecision), 0,
                             max_val);
    } else {
      const int* col = tmp + yy * wb + xx;
      int s = 0;
      for (int t = 0; t < taps; ++t) s += fyt[t] * col[t * wb];
      v = short_out ? wrap16(s >> kFilterPrecision)
                    : clampi(wrap16((s + offset2) >> shift2), 0, max_val);
    }
    pred[((size_t)chan * H + oy) * W + ox] = (int16_t)v;
    if (short_out && chan >= nplanes)
      mask[((size_t)(chan - nplanes) * H + oy) * W + ox] = 1;
  }
}

}  // namespace

extern "C" int xvc_mc_scatter(const void* planes, int R, int Hp, int Wp,
                              const void* params, int B, int wb, int hb,
                              int taps, int nphase, const void* table_host,
                              int bitdepth, int short_out, void* pred,
                              int nchan, int H, int W, void* mask,
                              int nplanes, void* stream) {
  if (B <= 0) return 0;
  if (nphase * taps > 128 || wb > 64 || hb > 64 || (taps != 8 && taps != 4))
    return (int)cudaErrorInvalidValue;
  FilterTable table;
  const int* th = (const int*)table_host;
  for (int i = 0; i < 128; ++i) table.v[i] = i < nphase * taps ? th[i] : 0;
  mc_scatter_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)planes, R, Hp, Wp, (const int32_t*)params, B, wb, hb,
      taps, nphase, table, bitdepth, short_out, (int16_t*)pred, nchan, H, W,
      (int16_t*)mask, nplanes);
  return (int)cudaGetLastError();
}
