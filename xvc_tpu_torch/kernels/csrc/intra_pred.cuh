// Device functions shared by the intra luma and chroma scan kernels
// (intra_scan.cu) and the all-mode intra SATD kernel (intra_satd.cu):
// window starts, the reference line, the [1 2 1] reference filter and
// the planar / DC / angular predictors, with the exact integer semantics
// of xvc_tpu/tpu/intra_scan.py (ref: intra_prediction.cc:365-558,
// 707-871).
//
// The JAX scan works on a padded 64x64 domain with `where` masks because
// XLA needs static shapes; these functions take the block geometry from
// the metadata row and answer for one sample (y, x) at a time.  Each
// leaf is one warp's: the functions that fill or reduce a line take the
// lane and stride by 32, and work on that warp's own slice of shared
// memory, so they need __syncwarp() at most, never a block barrier.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace xvc_intra {

constexpr int kPadTL = 8;    // canvas padding at the top and left
constexpr int kLine = 320;   // the availability line buffer of ref_line
constexpr int kRLen = 256;   // the projected angular reference line
constexpr int kHor = 18, kVer = 50, kDiag = 34;
constexpr int kNTop = 129, kNLeft = 128;

// static: each source that includes this header keeps its own copy
static __constant__ int kAngle[33] = {
    -32, -29, -26, -23, -21, -19, -17, -15, -13, -11, -9, -7, -5, -3, -2, -1,
    0,   1,   2,   3,   5,   7,   9,   11,  13,  15,  17, 19, 21, 23, 26, 29,
    32};
static __constant__ int kInvAngle[16] = {8192, 4096, 2731, 1638, 1170, 910,
                                         745,  630,  546,  482,  431,  390,
                                         356,  315,  282,  256};
// use_filtered_ref_samples thresholds by size class
static __constant__ int kThrExt[8] = {0, 20, 20, 14, 2, 0, 20, 0};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// A window start as lax.dynamic_slice takes it: a negative start counts
// from the end, then the start is clamped to [0, dim - size] (the twin of
// gpu/dsp.ds_start).
__device__ __forceinline__ int ds_start(int v, int dim, int size) {
  return clampi(v < 0 ? v + dim : v, 0, dim - size);
}

// Floor division by a positive divisor (Python's and JAX's //).
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// log2 of a block dimension as the scans' `where` chains give it.
__device__ __forceinline__ int log2_dim(int v) {
  return v == 2 ? 1 : v == 4 ? 2 : v == 8 ? 3 : v == 16 ? 4 : v == 32 ? 5 : 6;
}

struct Leaf {
  int px, py, w, h, mode, has_l, has_a, has_al, sbl, sar;
};

// The canvas samples a reference line is made of: the column left of the
// block (128 x 1 strip) and the row above (1 x 130), with the strip
// starts taken as lax.dynamic_slice takes them.  `raw` holds kRaw ints:
// col[0..127] then row[0..129].  Only what the flags select is loaded
// (the first min(h + sbl, w + h) column samples when has_l; the corner
// when has_al; the w samples above and min(sar, h) above-right when
// has_a), every lane's loads issued together: one round trip.
constexpr int kRaw = 128 + 130;

// `plane` is the evolving canvas: other warps of this kernel wrote it,
// so it is read with plain loads (never __ldg, never __restrict__).
__device__ __forceinline__ void load_strips(const int16_t* plane, int Hp,
                                            int Wp, const Leaf& lf, int lane,
                                            int* raw) {
  const int ppx = lf.px + kPadTL, ppy = lf.py + kPadTL;
  const int cy0 = ds_start(ppy, Hp, 128), cx0 = ds_start(ppx - 1, Wp, 1);
  const int ry0 = ds_start(ppy - 1, Hp, 1), rx0 = ds_start(ppx - 1, Wp, 130);
  const int16_t* col = plane + (size_t)cy0 * Wp + cx0;
  const int16_t* row = plane + (size_t)ry0 * Wp + rx0;
  const int ncol =
      lf.has_l != 0 ? clampi(min(lf.h + lf.sbl, lf.w + lf.h), 1, 128) : 0;
  const int nrow = lf.has_a != 0
                       ? 1 + min(lf.w + max(0, min(lf.sar, lf.h)), 129)
                       : (lf.has_al != 0 ? 1 : 0);
  const int r0 = lf.has_al != 0 ? 0 : 1;  // the corner only when has_al
  int v[9];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int i = lane + 32 * s;
    v[s] = i < ncol ? col[(size_t)i * Wp] : 0;
  }
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int i = lane + 32 * s;
    v[4 + s] = i >= r0 && i < nrow ? row[i] : 0;
  }
#pragma unroll
  for (int s = 0; s < 9; ++s) {
    const int i = lane + 32 * s;
    if (i < kRaw) raw[i] = v[s];
  }
}

// compute_ref_samples (ref: intra_prediction.cc:707-848): fills top[129]
// and left[128] from the strips in `raw` (load_strips, then __syncwarp).
// The JAX ref_line builds a 320-entry line in five dependent padding
// passes; each pass copies one earlier entry over a range, so a lane
// resolves its entry by walking the passes backwards (at most five
// redirects) and then reads the one strip sample it ends at.
//
// Only top[0..w+h] and left[0..w+h-1] are filled: the JAX line holds the
// constant 1 << (bitdepth - 1) beyond them, and no predictor, filter or LM
// sum here reads beyond them (planar reads top[1+w] and left[h], angular
// at most w + h along its line, the filter top[w+h] and left[w+h-1]).
// The w + h + 1 top and w + h left entries are packed into one range, so
// a warp takes an 8x8 block's 33 entries in two rounds, not nine.
__device__ __forceinline__ void resolve_ref_line(const int* raw,
                                                 const Leaf& lf, int dc_def,
                                                 int lane, int* top,
                                                 int* left) {
  const int w = lf.w, h = lf.h;
  const bool has_l = lf.has_l != 0, has_a = lf.has_a != 0;
  const bool has_al = lf.has_al != 0;
  const int sbl = lf.sbl, sar = lf.sar;
  const int* col = raw;
  const int* row = raw + 128;
  const int ls = w + h, tls = w, base = ls + tls;
  const bool has_any = has_l || has_a || has_al || sbl > 0 || sar > 0;
  const int ref_bl =
      has_l ? w : (has_al ? ls : (has_a ? ls + tls : ls + tls + w));
  const int ntop = min(w + h + 1, kNTop), nleft = min(w + h, kNLeft);
  for (int e = lane; e < ntop + nleft; e += 32) {
    const bool is_top = e < ntop;
    int j = is_top ? base - 1 + e : ls - 1 - (e - ntop);
    int v = dc_def;
    if (has_any) {
      j = clampi(j, 0, kLine - 1);
      // the five padding passes, last first
      if (sar == 0 && j >= base + w && j < base + w + h) j = base + w - 1;
      if (!has_a && j >= base && j < base + w) j = base - 1;
      if (!has_al && j >= ls && j < ls + tls) j = ls - 1;
      if (!has_l && j >= w && j < w + h) j = w - 1;
      if (sbl == 0 && j < w) j = ref_bl;
      j = clampi(j, 0, kLine - 1);
      // the line before padding: left column (bottom up), corner run,
      // above row, above-right run
      if (j < ls) {
        if (has_l) {
          const int i_left = ls - 1 - j;
          const int i = i_left < h + sbl ? i_left : h + sbl - 1;
          v = col[clampi(i, 0, 127)];
        }
      } else if (j < ls + tls) {
        if (has_al) v = row[0];
      } else if (j < base + w) {
        if (has_a) v = row[clampi(j - base + 1, 0, 129)];
      } else if (j < base + w + h) {
        if (has_a && sar > 0) {
          const int ar_i = j - (base + w);
          v = row[clampi(ar_i < sar ? 1 + w + ar_i : w + sar, 0, 129)];
        }
      }
    }
    if (is_top)
      top[e] = v;
    else
      left[e - ntop] = v;
  }
}

// [1 2 1] reference filter (ref: intra_prediction.cc:850-871) of the
// entries resolve_ref_line fills, n = w + h: ftop[0..n], fleft[0..n-1],
// packed into one range.
__device__ __forceinline__ void filter_ref_line(const int* top,
                                                const int* left, int n,
                                                int lane, int* ftop,
                                                int* fleft) {
  const int ntop = min(n + 1, kNTop), nleft = min(n, kNLeft);
  for (int e = lane; e < ntop + nleft; e += 32) {
    if (e < ntop) {
      const int j = e;
      int v = top[j];
      if (j < n) {
        v = j == 0 ? ((top[0] << 1) + top[1] + left[0] + 2) >> 2
                   : ((top[j] << 1) + top[j - 1] + top[min(j + 1, 128)] + 2) >>
                         2;
      }
      ftop[j] = v;
    } else {
      const int j = e - ntop;
      int v = left[j];
      if (j < n - 1) {
        v = j == 0
                ? ((left[0] << 1) + top[0] + left[1] + 2) >> 2
                : ((left[j] << 1) + left[j - 1] + left[min(j + 1, 127)] + 2) >>
                      2;
      }
      fleft[j] = v;
    }
  }
}

__device__ __forceinline__ int pred_planar(const int* top, const int* left,
                                           int w, int h, int wl2, int hl2,
                                           int y, int x) {
  const int above = top[clampi(1 + x, 0, 128)];
  const int leftv = left[clampi(y, 0, 127)];
  const int tr = top[clampi(1 + w, 0, 128)];
  const int bl = left[clampi(h, 0, 127)];
  const int shift = wl2 + hl2 + 1;
  const int hor = (h - 1 - y) * above + (y + 1) * bl;
  const int ver = (w - 1 - x) * leftv + (x + 1) * tr;
  return ((hor << wl2) + (ver << hl2) + (1 << (shift - 1))) >> shift;
}

// The DC value: the warp sums the w + h <= 128 neighbours (four per
// lane, then a butterfly), so every lane holds it.
__device__ __forceinline__ int dc_value(const int* top, const int* left,
                                        int w, int h, int lane) {
  int s = 0;
  for (int j = lane; j < w + h; j += 32)
    s += j < w ? top[clampi(1 + j, 0, 128)] : left[clampi(j - w, 0, 127)];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const int total = w + h;
  return floor_div(s + (total >> 1), total);
}

// DC edge filter of luma blocks up to 16x16.
__device__ __forceinline__ int dc_post(const int* top, const int* left,
                                       int dc, int y, int x) {
  if (x == 0 && y == 0) return (top[1] + left[0] + 2 * dc + 2) >> 2;
  if (x == 0) return (left[clampi(y, 0, 127)] + 3 * dc + 2) >> 2;
  if (y == 0) return (top[clampi(1 + x, 0, 128)] + 3 * dc + 2) >> 2;
  return dc;
}

// Angular prediction.  Horizontal modes (mode < 34) predict in the
// flipped frame, where the left column is the top line and hp = w, and
// transpose back; `Angular` holds what depends on the mode alone.
struct Angular {
  bool is_hor;
  int angle, inv_angle, base;
  const int* top;
  const int* left;

  __device__ __forceinline__ Angular(const int* top_, const int* left_,
                                     int w, int h, int mode)
      : top(top_), left(left_) {
    is_hor = mode < kDiag;
    const int hp = is_hor ? w : h;
    const int ao = is_hor ? kHor - mode : mode - kVer;
    angle = kAngle[clampi(16 + ao, 0, 32)];
    inv_angle = kInvAngle[clampi(-ao - 1, 0, 15)];
    base = angle < 0 ? -((hp * angle) >> 5) : 1;  // num_proj + 1
  }
  // the (flipped) top line t[0..128] and left line l[0..127]
  __device__ __forceinline__ int t(int j) const {
    if (!is_hor) return top[j];
    return j == 0 ? top[0] : left[clampi(j - 1, 0, 127)];
  }
  __device__ __forceinline__ int l(int j) const {
    return is_hor ? top[clampi(1 + j, 0, 128)] : left[j];
  }
  // the projected reference line rv[0..255]
  __device__ __forceinline__ int rv(int jr) const {
    const int d = jr - base;
    if (d >= -1) return t(clampi(d + 1, 0, 128));
    const int proj_idx = ((128 + (-d - 1) * inv_angle) >> 8) - 1;
    return l(clampi(proj_idx, 0, 127));
  }
  // the sample at (y, x) of the block; `post` enables the luma column-0
  // filters of blocks up to 16x16
  __device__ __forceinline__ int pred(int y, int x, bool post,
                                      int max_val) const {
    const int yy = is_hor ? x : y, xx = is_hor ? y : x;
    const int asum = (yy + 1) * angle;
    const int iw = asum & 31;
    const int idx0 = clampi(base + (asum >> 5) + xx, 0, kRLen - 1);
    const int s0 = rv(idx0);
    int out = s0;
    if (iw != 0) {
      const int s1 = rv(clampi(idx0 + 1, 0, kRLen - 1));
      out = ((32 - iw) * s0 + iw * s1 + 16) >> 5;
    }
    if (post && xx == 0) {
      const int diff = l(clampi(yy, 0, 127)) - t(0);
      if (angle == 0)
        out = clampi(t(1) + (diff >> 1), 0, max_val);
      else if (angle >= -1 && angle <= 1)
        out = clampi(out + (diff >> 2), 0, max_val);
    }
    return out;
  }
};

}  // namespace xvc_intra
