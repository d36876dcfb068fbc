// Whole-picture intra reconstruction: the luma scan and the chroma scan
// with LM, one launch each per picture.
//
// Replaces, on the GPU: xvc_tpu/tpu/intra_scan.py make_intra_scan (the
// lax.scan whose step gathers the reference line from the evolving
// canvas, filters it, predicts planar / DC / angular, adds the residual
// and writes the block back) and make_intra_chroma_scan (the same on two
// chroma planes, without the reference filter and the post filters, plus
// LM chroma: rescale_luma, derive_lm, pred_lm from the final luma canvas;
// ref: intra_prediction.cc:365-686,707-954).
//
// The dependency: a leaf's reference line is made of samples that
// earlier leaves of the same plane wrote, so the leaves of a plane are
// reconstructed in decode order.
//
// What bounds them on an H100: neither bytes nor arithmetic but that
// chain.  A 720p intra picture moves a few megabytes (microseconds at the
// HBM rate) and does a few operations per sample, yet its 5,000 luma
// leaves each wait for the one before: the time is the number of leaves
// times one round of metadata row -> reference loads -> predict -> store
// -> barrier.  Both kernels sit far above their byte bound.
//
// Design (right and simple): one persistent block of 256 threads per
// plane walks the metadata rows in order; the luma kernel is one block,
// the chroma kernel two (a row touches only its own plane and reads the
// finished luma, so the two walks are independent and each keeps its
// order).  Per leaf: every thread takes the row (the next row is fetched
// while this one is worked on), the block builds top[129] / left[128] in
// shared memory straight from the canvas (intra_pred.cuh), filters them
// if the mode asks for it, each thread predicts its samples, adds the
// residual, clips and stores, and __syncthreads() makes the stores
// visible to the block's next leaf.  One block owns a plane, so no
// atomics, flags or fences are needed; the canvas is never read through
// the read-only path.  DC and the four LM sums are summed by every warp
// on its own, so they need no barrier, and every thread derives the LM
// parameters itself: nothing goes back to the host.  Both kernels run on
// the caller's stream, which puts the luma scan before the chroma scan.
//
// Rows with ACTIVE == 0 (the power-of-two padding of the metadata) are
// skipped.  Later work: several leaves in flight (a wavefront over CTUs).
#include "intra_pred.cuh"

namespace {

using namespace xvc_intra;

// luma metadata columns
enum { M_PX, M_PY, M_W, M_H, M_MODE, M_HAS_L, M_HAS_A, M_HAS_AL, M_SBL,
       M_SAR, M_ACTIVE, kMetaCols };
// chroma metadata columns
enum { C_PLANE, C_PX, C_PY, C_W, C_H, C_MODE, C_IS_LM, C_HAS_L, C_HAS_A,
       C_HAS_AL, C_SBL, C_SAR, C_ACTIVE, kCMetaCols };

template <int COLS>
__device__ __forceinline__ void load_row(const int32_t* __restrict__ meta,
                                         int n, int (&m)[COLS]) {
#pragma unroll
  for (int c = 0; c < COLS; ++c) m[c] = __ldg(meta + (size_t)n * COLS + c);
}

// clip(pred + residual) into the canvas; the 64x64 window start is taken
// as lax.dynamic_slice takes it (a clamped start moves the block).
template <typename Pred>
__device__ __forceinline__ void write_back(int16_t* plane,
                                           const int32_t* __restrict__ resi,
                                           int Hp, int Wp, const Leaf& lf,
                                           int max_val, Pred pred) {
  const int wy = ds_start(lf.py + kPadTL, Hp, 64);
  const int wx = ds_start(lf.px + kPadTL, Wp, 64);
  const int n = lf.w * lf.h;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int y = i / lf.w, x = i - y * lf.w;
    const size_t at = (size_t)(wy + y) * Wp + wx + x;
    plane[at] = (int16_t)clampi(pred(y, x) + __ldg(resi + at), 0, max_val);
  }
}

__global__ void __launch_bounds__(kThreads)
intra_luma_scan(int16_t* plane, const int32_t* __restrict__ resi,
                const int32_t* __restrict__ meta, int N, int Hp, int Wp,
                int bitdepth) {
  __shared__ int s_top[kNTop], s_left[kNLeft];
  __shared__ int f_top[kNTop], f_left[kNLeft];
  const int dc_def = 1 << (bitdepth - 1);
  const int max_val = (1 << bitdepth) - 1;
  int cur[kMetaCols], nxt[kMetaCols];
  load_row(meta, 0, cur);
  for (int n = 0; n < N; ++n) {
    if (n + 1 < N) load_row(meta, n + 1, nxt);
    if (cur[M_ACTIVE] != 0) {
      const Leaf lf = {cur[M_PX], cur[M_PY], cur[M_W], cur[M_H], cur[M_MODE],
                       cur[M_HAS_L], cur[M_HAS_A], cur[M_HAS_AL], cur[M_SBL],
                       cur[M_SAR]};
      const int w = lf.w, h = lf.h, mode = lf.mode;
      const int wl2 = log2_dim(w), hl2 = log2_dim(h);
      const bool post = w <= 16 && h <= 16;
      load_ref_line(plane, Hp, Wp, lf, dc_def, s_top, s_left);
      __syncthreads();
      if (mode == 1) {
        // DC takes the raw line
        const int dc = dc_value(s_top, s_left, w, h);
        write_back(plane, resi, Hp, Wp, lf, max_val, [&](int y, int x) {
          return post ? dc_post(s_top, s_left, dc, y, x) : dc;
        });
      } else {
        // use_filtered_ref_samples (ref: intra_prediction.cc:342-363)
        const int* top = s_top;
        const int* left = s_left;
        const int size = (wl2 + hl2) >> 1;
        const int mode_diff = min(abs(mode - kHor), abs(mode - kVer));
        if (mode_diff > kThrExt[clampi(size, 0, 7)]) {
          filter_ref_line(s_top, s_left, w + h, f_top, f_left);
          __syncthreads();
          top = f_top;
          left = f_left;
        }
        if (mode <= 0) {
          write_back(plane, resi, Hp, Wp, lf, max_val, [&](int y, int x) {
            return pred_planar(top, left, w, h, wl2, hl2, y, x);
          });
        } else {
          const Angular ang(top, left, w, h, mode);
          write_back(plane, resi, Hp, Wp, lf, max_val, [&](int y, int x) {
            return ang.pred(y, x, post, max_val);
          });
        }
      }
      // the stores above are the next leaf's reference samples, and the
      // shared lines are about to be overwritten
      __syncthreads();
    }
    if (n + 1 < N) {
#pragma unroll
      for (int c = 0; c < kMetaCols; ++c) cur[c] = nxt[c];
    }
  }
}

// ---------------------------------------------------------------------------
// LM chroma.  int32 arithmetic wraps in the JAX version; signed overflow
// is undefined here, so every product, sum and left shift that may wrap is
// done in unsigned.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
// shifts as XLA defines them for any count >= 0: a left shift by 32 or
// more gives 0, an arithmetic right shift by 31 or more the sign
__device__ __forceinline__ int wshl(int a, int s) {
  return s >= 32 ? 0 : (int)((unsigned)a << s);
}
__device__ __forceinline__ int sar(int a, int s) { return a >> min(s, 31); }
// jnp.abs: INT_MIN stays INT_MIN
__device__ __forceinline__ int wabs(int a) { return a < 0 ? wsub(0, a) : a; }
__device__ __forceinline__ int log2floor(int v) {
  return 31 - clampi(__clz(max(v, 1)), 0, 31);
}

struct LmParams {
  int scale, offset, shift;
};

// derive_lm_params (xvc_tpu/tpu/intra_scan.py derive_lm, after the sums).
__device__ __forceinline__ LmParams derive_lm(int sum_x, int sum_y,
                                              int sum_xx, int sum_xy, int nbr,
                                              bool has_a, bool has_l,
                                              int bitdepth) {
  const int lg = log2floor(nbr);
  int size_shift = max(lg + ((1 << lg) < nbr ? 1 : 0), 1);
  const int sh = max(size_shift - (15 - bitdepth), 0);
  if (sh > 0) {
    const int rnd = 1 << (sh - 1);
    sum_x = wadd(sum_x, rnd) >> sh;
    sum_y = wadd(sum_y, rnd) >> sh;
    sum_xx = wadd(sum_xx, rnd) >> sh;
    sum_xy = wadd(sum_xy, rnd) >> sh;
  }
  size_shift -= sh;
  const int avg_x = sum_x >> size_shift;
  const int avg_y = sum_y >> size_shift;
  const int x_frac = sum_x & ((1 << size_shift) - 1);
  const int y_frac = sum_y & ((1 << size_shift) - 1);
  const int stddev_xy =
      wsub(wsub(wsub(sum_xy, wshl(wmul(avg_x, avg_y), size_shift)),
                wmul(avg_x, y_frac)),
           wmul(avg_y, x_frac));
  const int stddev_xx =
      wsub(wsub(sum_xx, wshl(wmul(avg_x, avg_x), size_shift)),
           wmul(wmul(2, avg_x), x_frac));
  const int shift_xy =
      stddev_xy == 0 ? 0
                     : max(log2floor(wabs(stddev_xy)) - bitdepth + 2, 0);
  const int shift_xx =
      stddev_xx == 0 ? 0 : max(log2floor(wabs(stddev_xx)) - 5, 0);
  const int sxy_sh = stddev_xy >> shift_xy;
  const int sxx_sh = stddev_xx >> shift_xx;
  const int total_shift = bitdepth + shift_xx + 4 + 7 - 13 - shift_xy;
  const bool degenerate = sxx_sh < (1 << 5);
  // sxx_sh can be negative after a wrap (the result is then discarded as
  // degenerate): floor division, as // is
  const int q = floor_div(wadd(1 << (bitdepth + 4), sxx_sh >> 1),
                          max(sxx_sh, 1));
  int scale = wmul(sxy_sh, q);
  scale = total_shift >= 0 ? sar(scale, total_shift)
                           : wshl(scale, -total_shift);
  const int lim = 1 << (15 - 7);
  scale = (1 << 7) * clampi(scale, -lim, lim - 1);
  const int base_v = scale < 0 ? -scale - 1 : scale;
  const int base_shift = log2floor(base_v) - (scale != 0 ? 5 : 0);
  int shift = 13 - base_shift;
  scale = base_shift >= 0 ? sar(scale, base_shift) : wshl(scale, -base_shift);
  int offset = wsub(avg_y, sar(wmul(scale, avg_x), shift));
  if (!has_a && !has_l) return {0, 1 << (bitdepth - 1), 0};
  if (degenerate) return {0, avg_y, 0};
  return {scale, offset, shift};
}

// rescale_luma (ref: intra_prediction.cc:873-954): the 4:2:0 luma
// downsample on the (h + 1) x (w + 1) LM grid, row and column 0 holding
// the above and left reference positions, into sub[33 * 33].  `luma` is
// the finished luma canvas (read-only here).
__device__ __forceinline__ void rescale_luma(const int16_t* __restrict__ luma,
                                             int HpL, int WpL, const Leaf& lf,
                                             int* sub) {
  const int w = lf.w, h = lf.h;
  const bool has_l = lf.has_l != 0, has_a = lf.has_a != 0;
  // window rows ly-2 .. ly+2h+1, cols lx-4 .. lx+2w+3 -> (68, 72)
  const int wy = ds_start(2 * lf.py - 2 + kPadTL, HpL, 68);
  const int wx = ds_start(2 * lf.px - 4 + kPadTL, WpL, 72);
  const int16_t* win = luma + (size_t)wy * WpL + wx;
  auto L = [&](int r, int c) {
    return (int)__ldg(win + (size_t)clampi(r, 0, 67) * WpL +
                      clampi(c, 0, 71));
  };
  const int n = (h + 1) * (w + 1);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int gy = i / (w + 1), gx = i - gy * (w + 1);
    const int yi = gy - 1, xi = gx - 1;
    const int ry = 2 + 2 * yi, cxl = 4 + 2 * xi;
    const bool valid_y = (has_a ? yi >= -1 : yi >= 0) && yi < h;
    int v = 0;
    if (gx >= 1 && valid_y && xi < w) {
      if (!has_l && gx == 1)
        v = (L(ry, 4) + L(ry + 1, 4) + 1) >> 1;
      else
        v = (L(ry, cxl - 1) + 2 * L(ry, cxl) + L(ry, cxl + 1) +
             L(ry + 1, cxl - 1) + 2 * L(ry + 1, cxl) + L(ry + 1, cxl + 1) +
             4) >> 3;
    } else if (gx == 0 && valid_y && has_l) {
      v = (L(ry, 1) + 2 * L(ry, 2) + L(ry, 3) + L(ry + 1, 1) +
           2 * L(ry + 1, 2) + L(ry + 1, 3) + 4) >> 3;
    }
    sub[gy * 33 + gx] = v;
  }
}

// The four neighbour sums of derive_lm over the above row (stride dx) and
// the left column (stride dy), then the parameters.  Every warp sums all
// 128 candidate terms on its own, so every thread ends with the same
// parameters and no barrier is needed.
__device__ __forceinline__ LmParams lm_params(const int* sub, const int* top,
                                              const int* left, const Leaf& lf,
                                              int bitdepth) {
  const int w = lf.w, h = lf.h;
  const bool has_l = lf.has_l != 0, has_a = lf.has_a != 0;
  const int dx = (has_l && w / h > 1) ? w / h : 1;
  const int dy = (has_a && h / w > 1) ? h / w : 1;
  unsigned sx = 0, sy = 0, sxx = 0, sxy = 0;
  int nbr = 0;
  const int lane = threadIdx.x & 31;
  for (int t = lane; t < 128; t += 32) {
    const int j = t & 63;
    int xv, yv;
    bool use;
    if (t < 64) {  // above row
      use = has_a && j < w && j % dx == 0;
      xv = sub[clampi(1 + j, 0, 32)];
      yv = top[clampi(1 + j, 0, 128)];
    } else {       // left column
      use = has_l && j < h && j % dy == 0;
      xv = sub[clampi(1 + j, 0, 32) * 33];
      yv = left[clampi(j, 0, 127)];
    }
    if (use) {
      sx += (unsigned)xv;
      sy += (unsigned)yv;
      sxx += (unsigned)xv * (unsigned)xv;
      sxy += (unsigned)xv * (unsigned)yv;
      nbr += 1;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    sx += __shfl_xor_sync(0xffffffffu, sx, o);
    sy += __shfl_xor_sync(0xffffffffu, sy, o);
    sxx += __shfl_xor_sync(0xffffffffu, sxx, o);
    sxy += __shfl_xor_sync(0xffffffffu, sxy, o);
    nbr += __shfl_xor_sync(0xffffffffu, nbr, o);
  }
  return derive_lm((int)sx, (int)sy, (int)sxx, (int)sxy, nbr, has_a, has_l,
                   bitdepth);
}

__global__ void __launch_bounds__(kThreads)
intra_chroma_scan(int16_t* planes, const int32_t* __restrict__ resi,
                  const int16_t* __restrict__ luma,
                  const int32_t* __restrict__ meta, int N, int Hp, int Wp,
                  int HpL, int WpL, int bitdepth) {
  __shared__ int s_top[kNTop], s_left[kNLeft];
  __shared__ int s_sub[33 * 33];
  const int dc_def = 1 << (bitdepth - 1);
  const int max_val = (1 << bitdepth) - 1;
  // this block's plane: it reads and writes no other
  const int pi = blockIdx.x;
  int16_t* plane = planes + (size_t)pi * Hp * Wp;
  const int32_t* rplane = resi + (size_t)pi * Hp * Wp;
  int cur[kCMetaCols], nxt[kCMetaCols];
  load_row(meta, 0, cur);
  for (int n = 0; n < N; ++n) {
    if (n + 1 < N) load_row(meta, n + 1, nxt);
    if (cur[C_ACTIVE] != 0 && ds_start(cur[C_PLANE], 2, 1) == pi) {
      const Leaf lf = {cur[C_PX], cur[C_PY], cur[C_W], cur[C_H], cur[C_MODE],
                       cur[C_HAS_L], cur[C_HAS_A], cur[C_HAS_AL], cur[C_SBL],
                       cur[C_SAR]};
      const int w = lf.w, h = lf.h, mode = lf.mode;
      const bool is_lm = cur[C_IS_LM] != 0;
      load_ref_line(plane, Hp, Wp, lf, dc_def, s_top, s_left);
      if (is_lm) rescale_luma(luma, HpL, WpL, lf, s_sub);
      __syncthreads();
      if (is_lm) {
        const LmParams lm = lm_params(s_sub, s_top, s_left, lf, bitdepth);
        write_back(plane, rplane, Hp, Wp, lf, max_val, [&](int y, int x) {
          const int blk = s_sub[clampi(1 + y, 0, 32) * 33 +
                                clampi(1 + x, 0, 32)];
          return clampi(wadd(sar(wmul(lm.scale, blk), lm.shift), lm.offset),
                        0, max_val);
        });
      } else if (mode <= 0) {
        const int wl2 = log2_dim(w), hl2 = log2_dim(h);
        write_back(plane, rplane, Hp, Wp, lf, max_val, [&](int y, int x) {
          return pred_planar(s_top, s_left, w, h, wl2, hl2, y, x);
        });
      } else if (mode == 1) {
        const int dc = dc_value(s_top, s_left, w, h);
        write_back(plane, rplane, Hp, Wp, lf, max_val,
                   [&](int, int) { return dc; });
      } else {
        const Angular ang(s_top, s_left, w, h, mode);
        write_back(plane, rplane, Hp, Wp, lf, max_val, [&](int y, int x) {
          return ang.pred(y, x, false, max_val);
        });
      }
      __syncthreads();
    }
    if (n + 1 < N) {
#pragma unroll
      for (int c = 0; c < kCMetaCols; ++c) cur[c] = nxt[c];
    }
  }
}

}  // namespace

extern "C" int xvc_intra_luma_scan(void* plane, const void* resi,
                                   const void* meta, int N, int Hp, int Wp,
                                   int bitdepth, void* stream) {
  if (N <= 0) return 0;
  // the caller holds the canvas to the windows' sizes
  if (bitdepth < 1 || bitdepth > 14) return (int)cudaErrorInvalidValue;
  intra_luma_scan<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (int16_t*)plane, (const int32_t*)resi, (const int32_t*)meta, N, Hp, Wp,
      bitdepth);
  return (int)cudaGetLastError();
}

extern "C" int xvc_intra_chroma_scan(void* planes, const void* resi,
                                     const void* luma, const void* meta, int N,
                                     int Hp, int Wp, int HpL, int WpL,
                                     int bitdepth, void* stream) {
  if (N <= 0) return 0;
  if (bitdepth < 1 || bitdepth > 14) return (int)cudaErrorInvalidValue;
  intra_chroma_scan<<<2, kThreads, 0, (cudaStream_t)stream>>>(
      (int16_t*)planes, (const int32_t*)resi, (const int16_t*)luma,
      (const int32_t*)meta, N, Hp, Wp, HpL, WpL, bitdepth);
  return (int)cudaGetLastError();
}
