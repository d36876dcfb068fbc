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
// What bounds them on an H100: neither bytes nor arithmetic but the
// dependency chain.  A leaf's reference line is made of samples that
// earlier leaves of the same plane wrote.  A 720p intra picture moves a
// few megabytes and does a few operations per sample, but its leaves
// wait for each other: the time is the longest chain of leaves times the
// cost of one step.  That chain is not decode order: a leaf needs only
// the leaves that wrote the samples its reference line reads (picture 0
// of the 720p LD stream: 724 of 5,234 luma leaves, 144 of 960 per chroma
// plane; gpu/scan_deps.py computes it on the host).
//
// Design: one persistent block per plane (luma: one block; chroma: two,
// a row touches only its own plane and reads the finished luma).
//   Phase 1, the whole block.  Paint an owner map of the canvas's units
//   (4x4 luma, 2x2 chroma) with each active row's index; then every row
//   checks that it still owns all its units (no second writer) and that
//   no unit its reference line reads is owned by a later row.  Inside
//   that contract the rows may run in any order that puts each after
//   the owners of what it reads.  A breach, or more rows than the done
//   bits hold, makes the block run ordered: one warp takes every row in
//   decode order.  Then the ticket order: warps hand out rows in order
//   and a warp holds its row until the rows it reads are done, so decode
//   order keeps only a window of as many consecutive rows as there are
//   warps in flight, mostly one chain (picture 0: 3,435 steps for the
//   block's 16 warps where the graph's longest path is 724).  The
//   tickets go in wavefront order instead: the picture's 64x64 tiles
//   (chroma 32x32, the CTUs) by wave tx + 2 ty, then by rank in the
//   tile, then by tile row, so the warps work across the tiles of a wave
//   (1,005 steps).  Each row's position in that order is counted from
//   per-tile first rows and counts.  The order is used when every
//   tile's rows are consecutive in decode order and every row's owners
//   lie in its own tile or an earlier wave (then every owner has a lower
//   ticket), as on every picture the codec lays out; otherwise the
//   tickets go in decode order (scan_cases.tiled_case's interleave
//   option holds that path to the plain version).  (Ranks and
//   "consecutive" count a plane's own rows: the chroma rows of U and V
//   alternate.)
//   Phase 2, the warps.  A warp takes the next ticket, starts copying the
//   leaf's residual into its slice of shared memory (cp.async), looks up
//   the owners of the units its reference line reads and waits
//   (__all_sync, exponential __nanosleep back-off) until their done bits
//   are set; then it loads the strips the line is made of (one round
//   trip), builds the line, predicts, adds the residual, stores, fences
//   and sets its own done bit.  A warp waits only on lower tickets, whose
//   warps are running, so the kernel cannot hang on any input.
// Memory order: the writer's stores, __threadfence_block(), __syncwarp(),
// then its done bit; the reader sees the bit, __threadfence_block(), then
// loads.  Writers and readers share the block, so block scope suffices;
// the canvas is never read through the read-only path.  LM reads the
// finished luma canvas (the luma launch ran before, on the same stream)
// through __ldg, and computes its 4:2:0 downsample on the fly.  DC and
// the LM sums are warp reductions; LM is derived on the card.
//
// Scratch (int32, allocated by the wrapper, filled here): kStatusWords
// per plane, then per plane the owner map, the ticket order and each
// row's rank among the plane's rows.  The wrapper reads nothing
// back; the status words (schedule, rows run, breach flags, warps,
// wavefront tickets) are for tests.
#include "intra_pred.cuh"

namespace {

using namespace xvc_intra;

// luma metadata columns
enum { M_PX, M_PY, M_W, M_H, M_MODE, M_HAS_L, M_HAS_A, M_HAS_AL, M_SBL,
       M_SAR, M_ACTIVE, kMetaCols };
// chroma metadata columns
enum { C_PLANE, C_PX, C_PY, C_W, C_H, C_MODE, C_IS_LM, C_HAS_L, C_HAS_A,
       C_HAS_AL, C_SBL, C_SAR, C_ACTIVE, kCMetaCols };

constexpr unsigned kFull = 0xffffffffu;
constexpr int kResBuf = 512;          // residual samples a warp prefetches
constexpr int kMaxDoneWords = 16384;  // done bits of up to 524,288 rows
constexpr int kMaxWaves = 1024;
constexpr int kMaxBackoffNs = 256;
constexpr int kStatusWords = 5;
// the block: 16 warps (of 16, 24 and 32 measured on the H100: 16 fastest
// or within a few per cent, PERF.md PR 5)
constexpr int kWarps = 16;
// status: schedule, rows run, breach flags, warps, wavefront tickets
enum { kParallel = 1, kOrdered = 2 };
enum { kTwoWriters = 1, kReadsLater = 2, kTooManyRows = 4 };
// the slice of a warp: top, left, the strips (for luma also the room of
// the filtered lines, which are made after the strips are used), the
// residual
constexpr int kSlice = kNTop + kNLeft + kRaw + kResBuf;
static_assert(kRaw >= kNTop + kNLeft, "the filtered lines share the strips");

template <bool kChroma>
struct Kind {
  static constexpr int U = kChroma ? 2 : 4;      // unit side
  static constexpr int T = kChroma ? 32 : 64;    // tile side (the CTU)
  // the most units a reference line reads (left run + corner + top run,
  // each run one unit longer when unaligned), per lane
  static constexpr int kSlots = (2 * (128 / U + 1) + 1 + 31) / 32;
  static constexpr int kCols = kChroma ? (int)kCMetaCols : (int)kMetaCols;
};

// One metadata row of this block's plane: false for an inactive row or
// another plane's.  All columns are loaded at once (one round trip).
template <bool kChroma>
__device__ __forceinline__ bool row_leaf(const int32_t* __restrict__ meta,
                                         int n, int pi, Leaf& lf,
                                         bool& is_lm) {
  int m[Kind<kChroma>::kCols];
#pragma unroll
  for (int c = 0; c < Kind<kChroma>::kCols; ++c)
    m[c] = __ldg(meta + (size_t)n * Kind<kChroma>::kCols + c);
  if constexpr (kChroma) {
    lf = {m[C_PX], m[C_PY], m[C_W], m[C_H], m[C_MODE], m[C_HAS_L],
          m[C_HAS_A], m[C_HAS_AL], m[C_SBL], m[C_SAR]};
    is_lm = m[C_IS_LM] != 0;
    return m[C_ACTIVE] != 0 && ds_start(m[C_PLANE], 2, 1) == pi;
  } else {
    lf = {m[M_PX], m[M_PY], m[M_W], m[M_H], m[M_MODE], m[M_HAS_L],
          m[M_HAS_A], m[M_HAS_AL], m[M_SBL], m[M_SAR]};
    is_lm = false;
    return m[M_ACTIVE] != 0;
  }
}

// Whether row n is an active row of this block's plane (two columns).
template <bool kChroma>
__device__ __forceinline__ int row_is_mine(const int32_t* __restrict__ meta,
                                           int n, int pi) {
  const int32_t* m = meta + (size_t)n * Kind<kChroma>::kCols;
  if constexpr (kChroma)
    return __ldg(m + C_ACTIVE) != 0 &&
           ds_start(__ldg(m + C_PLANE), 2, 1) == pi;
  else
    return __ldg(m + M_ACTIVE) != 0;
}

// The units a row writes: its w x h block at the 64x64 window start, as
// lax.dynamic_slice takes it (gpu/scan_deps.write_units).
struct Rect {
  int y0, y1, x0, x1;  // inclusive
};
__device__ __forceinline__ Rect write_rect(const Leaf& lf, int Hp, int Wp,
                                           int U, int UH, int UW) {
  const int wy = ds_start(lf.py + kPadTL, Hp, 64);
  const int wx = ds_start(lf.px + kPadTL, Wp, 64);
  return {wy / U, min((wy + lf.h - 1) / U, UH - 1), wx / U,
          min((wx + lf.w - 1) / U, UW - 1)};
}

// The units a row's reference line reads: exactly the samples
// load_strips loads (gpu/scan_deps.read_units): the left column's first
// min(h + sbl, w + h) samples when has_l, the corner when has_al, the w
// samples above and min(sar, h) above-right when has_a.
struct ReadSet {
  int nl, nc, nt;  // units of the left run, the corner, the top run
  int l0, lx;      // left run: unit rows l0.., unit column lx
  int cx;          // the corner: unit row ty, unit column cx
  int ty, t0;      // top run: unit row ty, unit columns t0..
  __device__ __forceinline__ int total() const { return nl + nc + nt; }
  // the t-th unit's row and column
  __device__ __forceinline__ void at(int t, int& uy, int& ux) const {
    uy = t < nl ? l0 + t : ty;
    ux = t < nl ? lx : (t < nl + nc ? cx : t0 + (t - nl - nc));
  }
};
__device__ __forceinline__ ReadSet read_set(const Leaf& lf, int Hp, int Wp,
                                            int U) {
  ReadSet rs{0, 0, 0, 0, 0, 0, 0, 0};
  const int ppx = lf.px + kPadTL, ppy = lf.py + kPadTL;
  if (lf.has_l != 0) {
    const int cy0 = ds_start(ppy, Hp, 128), cx0 = ds_start(ppx - 1, Wp, 1);
    const int n = clampi(min(lf.h + lf.sbl, lf.w + lf.h), 1, 128);
    rs.l0 = cy0 / U;
    rs.nl = (cy0 + n - 1) / U - rs.l0 + 1;
    rs.lx = cx0 / U;
  }
  const int ry0 = ds_start(ppy - 1, Hp, 1), rx0 = ds_start(ppx - 1, Wp, 130);
  rs.ty = ry0 / U;
  if (lf.has_al != 0) {
    rs.nc = 1;
    rs.cx = rx0 / U;
  }
  if (lf.has_a != 0) {
    const int end = min(lf.w + max(0, min(lf.sar, lf.h)), 129);
    rs.t0 = (rx0 + 1) / U;
    rs.nt = (rx0 + end) / U - rs.t0 + 1;
  }
  return rs;
}

// ---------------------------------------------------------------------------
// cp.async: the leaf's residual into the warp's slice while it waits
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(int* dst, const int32_t* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Sample i of a block w wide as (y, x): a shift for the power-of-two
// widths the codec has (sh = log2 w), a division otherwise (sh < 0).
__device__ __forceinline__ int split_shift(int w) {
  return w > 0 && (w & (w - 1)) == 0 ? __ffs(w) - 1 : -1;
}
__device__ __forceinline__ void split(int i, int w, int sh, int& y, int& x) {
  y = sh >= 0 ? i >> sh : i / w;
  x = i - y * w;
}

// clip(pred + residual) into the canvas; the 64x64 window start is taken
// as lax.dynamic_slice takes it (a clamped start moves the block).  Lane
// `lane` takes samples lane, lane + 32, ..., the ones it prefetched into
// `res` (null: it reads the residual from `resi`, four samples' loads at
// a time).
template <typename Pred>
__device__ __forceinline__ void write_back(int16_t* plane,
                                           const int32_t* __restrict__ resi,
                                           const int* res, int Hp, int Wp,
                                           const Leaf& lf, int max_val,
                                           int lane, Pred pred) {
  const int wy = ds_start(lf.py + kPadTL, Hp, 64);
  const int wx = ds_start(lf.px + kPadTL, Wp, 64);
  const int n = lf.w * lf.h;
  const int sh = split_shift(lf.w);
  for (int b = lane; b < n; b += 128) {
    int r[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = b + 32 * u;
      r[u] = 0;
      if (i < n) {
        int y, x;
        split(i, lf.w, sh, y, x);
        r[u] = res != nullptr ? res[i]
                              : __ldg(resi + (size_t)(wy + y) * Wp + wx + x);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = b + 32 * u;
      if (i < n) {
        int y, x;
        split(i, lf.w, sh, y, x);
        plane[(size_t)(wy + y) * Wp + wx + x] =
            (int16_t)clampi(pred(y, x) + r[u], 0, max_val);
      }
    }
  }
}

// Start copying the leaf's residual into `buf` if it fits; returns where
// write_back finds it.
__device__ __forceinline__ const int* prefetch_residual(
    const int32_t* __restrict__ resi, int Hp, int Wp, const Leaf& lf,
    int lane, int* buf) {
  const int n = lf.w * lf.h;
  if (n > kResBuf || n <= 0) return nullptr;
  const int wy = ds_start(lf.py + kPadTL, Hp, 64);
  const int wx = ds_start(lf.px + kPadTL, Wp, 64);
  const int sh = split_shift(lf.w);
  for (int i = lane; i < n; i += 32) {
    int y, x;
    split(i, lf.w, sh, y, x);
    cp_async4(buf + i, resi + (size_t)(wy + y) * Wp + wx + x);
  }
  cp_async_commit();
  return buf;
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

// The sum s rounded down by sh: up to 14 bit in the int32 wrap of the
// JAX version; above, where the squares' sums pass 2^31, exact, as the
// host's derive_lm_params sums (sh is then at least 1, and the result
// fits in an int).
__device__ __forceinline__ int lm_round(unsigned long long s, int sh,
                                        int bitdepth) {
  if (bitdepth > 14)
    return (int)(((long long)s + (1LL << (sh - 1))) >> sh);
  const int v = (int)(unsigned)s;
  return sh > 0 ? wadd(v, 1 << (sh - 1)) >> sh : v;
}

// derive_lm_params (xvc_tpu/tpu/intra_scan.py derive_lm, after the sums).
__device__ __forceinline__ LmParams derive_lm(
    unsigned long long sx, unsigned long long sy, unsigned long long sxx,
    unsigned long long sxy, int nbr, bool has_a, bool has_l, int bitdepth) {
  const int lg = log2floor(nbr);
  int size_shift = max(lg + ((1 << lg) < nbr ? 1 : 0), 1);
  const int sh = max(size_shift - (15 - bitdepth), 0);
  const int sum_x = lm_round(sx, sh, bitdepth);
  const int sum_y = lm_round(sy, sh, bitdepth);
  const int sum_xx = lm_round(sxx, sh, bitdepth);
  const int sum_xy = lm_round(sxy, sh, bitdepth);
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

// rescale_luma (ref: intra_prediction.cc:873-954): entry (gy, gx) of the
// 4:2:0 luma downsample on the (h + 1) x (w + 1) LM grid, row and column
// 0 holding the above and left reference positions, computed on the fly
// from `win`, the 68 x 72 window of the finished luma canvas.
__device__ __forceinline__ int lm_sub(const int16_t* __restrict__ win,
                                      int WpL, const Leaf& lf, int gy,
                                      int gx) {
  const bool has_l = lf.has_l != 0, has_a = lf.has_a != 0;
  auto L = [&](int r, int c) {
    return (int)__ldg(win + (size_t)clampi(r, 0, 67) * WpL +
                      clampi(c, 0, 71));
  };
  const int yi = gy - 1, xi = gx - 1;
  const int ry = 2 + 2 * yi, cxl = 4 + 2 * xi;
  const bool valid_y = (has_a ? yi >= -1 : yi >= 0) && yi < lf.h;
  if (gx >= 1 && valid_y && xi < lf.w) {
    if (!has_l && gx == 1) return (L(ry, 4) + L(ry + 1, 4) + 1) >> 1;
    return (L(ry, cxl - 1) + 2 * L(ry, cxl) + L(ry, cxl + 1) +
            L(ry + 1, cxl - 1) + 2 * L(ry + 1, cxl) + L(ry + 1, cxl + 1) +
            4) >> 3;
  }
  if (gx == 0 && valid_y && has_l)
    return (L(ry, 1) + 2 * L(ry, 2) + L(ry, 3) + L(ry + 1, 1) +
            2 * L(ry + 1, 2) + L(ry + 1, 3) + 4) >> 3;
  return 0;
}

// The four neighbour sums of derive_lm over the above row (stride dx) and
// the left column (stride dy), summed by the warp, then the parameters.
__device__ __forceinline__ LmParams lm_params(const int16_t* __restrict__ win,
                                              int WpL, const int* top,
                                              const int* left, const Leaf& lf,
                                              int bitdepth, int lane) {
  const int w = lf.w, h = lf.h;
  const bool has_l = lf.has_l != 0, has_a = lf.has_a != 0;
  const int dx = (has_l && w / h > 1) ? w / h : 1;
  const int dy = (has_a && h / w > 1) ? h / w : 1;
  unsigned long long sx = 0, sy = 0, sxx = 0, sxy = 0;
  int nbr = 0;
  for (int t = lane; t < 128; t += 32) {
    const int j = t & 63;
    const bool above = t < 64;
    const bool use = above ? has_a && j < w && j % dx == 0
                           : has_l && j < h && j % dy == 0;
    if (use) {
      const int g = clampi(1 + j, 0, 32);
      const unsigned xv = (unsigned)(above ? lm_sub(win, WpL, lf, 0, g)
                                           : lm_sub(win, WpL, lf, g, 0));
      const unsigned yv = (unsigned)(above ? top[clampi(1 + j, 0, 128)]
                                           : left[clampi(j, 0, 127)]);
      sx += xv;
      sy += yv;
      sxx += (unsigned long long)xv * xv;
      sxy += (unsigned long long)xv * yv;
      nbr += 1;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    sx += __shfl_xor_sync(kFull, sx, o);
    sy += __shfl_xor_sync(kFull, sy, o);
    sxx += __shfl_xor_sync(kFull, sxx, o);
    sxy += __shfl_xor_sync(kFull, sxy, o);
    nbr += __shfl_xor_sync(kFull, nbr, o);
  }
  return derive_lm(sx, sy, sxx, sxy, nbr, has_a, has_l, bitdepth);
}

// ---------------------------------------------------------------------------
// One leaf, by one warp
// ---------------------------------------------------------------------------

// The reference line into top / left of the slice: the strips in one
// round trip, then the line from them.
__device__ __forceinline__ void ref_line(const int16_t* plane, int Hp, int Wp,
                                         const Leaf& lf, int dc_def, int lane,
                                         int* top, int* left, int* raw) {
  load_strips(plane, Hp, Wp, lf, lane, raw);
  __syncwarp();
  resolve_ref_line(raw, lf, dc_def, lane, top, left);
  __syncwarp();
}

__device__ __forceinline__ void luma_leaf(int16_t* plane,
                                          const int32_t* __restrict__ resi,
                                          const int* res, int Hp, int Wp,
                                          const Leaf& lf, int bitdepth,
                                          int lane, int* slice) {
  int* s_top = slice;
  int* s_left = s_top + kNTop;
  int* f_top = s_left + kNLeft;  // made after the strips there are used
  int* f_left = f_top + kNTop;
  const int max_val = (1 << bitdepth) - 1;
  const int w = lf.w, h = lf.h, mode = lf.mode;
  const int wl2 = log2_dim(w), hl2 = log2_dim(h);
  const bool post = w <= 16 && h <= 16;
  ref_line(plane, Hp, Wp, lf, 1 << (bitdepth - 1), lane, s_top, s_left,
           f_top);
  if (mode == 1) {
    // DC takes the raw line
    const int dc = dc_value(s_top, s_left, w, h, lane);
    write_back(plane, resi, res, Hp, Wp, lf, max_val, lane,
               [&](int y, int x) {
                 return post ? dc_post(s_top, s_left, dc, y, x) : dc;
               });
    return;
  }
  // use_filtered_ref_samples (ref: intra_prediction.cc:342-363)
  const int* top = s_top;
  const int* left = s_left;
  const int size = (wl2 + hl2) >> 1;
  const int mode_diff = min(abs(mode - kHor), abs(mode - kVer));
  if (mode_diff > kThrExt[clampi(size, 0, 7)]) {
    filter_ref_line(s_top, s_left, w + h, lane, f_top, f_left);
    __syncwarp();
    top = f_top;
    left = f_left;
  }
  if (mode <= 0) {
    write_back(plane, resi, res, Hp, Wp, lf, max_val, lane,
               [&](int y, int x) {
                 return pred_planar(top, left, w, h, wl2, hl2, y, x);
               });
  } else {
    const Angular ang(top, left, w, h, mode);
    write_back(plane, resi, res, Hp, Wp, lf, max_val, lane,
               [&](int y, int x) { return ang.pred(y, x, post, max_val); });
  }
}

__device__ __forceinline__ void chroma_leaf(
    int16_t* plane, const int32_t* __restrict__ resi, const int* res,
    const int16_t* __restrict__ luma, int Hp, int Wp, int HpL, int WpL,
    const Leaf& lf, bool is_lm, int bitdepth, int lane, int* slice) {
  int* s_top = slice;
  int* s_left = s_top + kNTop;
  const int max_val = (1 << bitdepth) - 1;
  const int w = lf.w, h = lf.h, mode = lf.mode;
  ref_line(plane, Hp, Wp, lf, 1 << (bitdepth - 1), lane, s_top, s_left,
           s_left + kNLeft);
  if (is_lm) {
    // the luma window rows ly-2 .. ly+2h+1, cols lx-4 .. lx+2w+3
    const int wy = ds_start(2 * lf.py - 2 + kPadTL, HpL, 68);
    const int wx = ds_start(2 * lf.px - 4 + kPadTL, WpL, 72);
    const int16_t* win = luma + (size_t)wy * WpL + wx;
    const LmParams lm = lm_params(win, WpL, s_top, s_left, lf, bitdepth,
                                  lane);
    write_back(plane, resi, res, Hp, Wp, lf, max_val, lane,
               [&](int y, int x) {
                 const int blk = lm_sub(win, WpL, lf, clampi(1 + y, 0, 32),
                                        clampi(1 + x, 0, 32));
                 return clampi(wadd(sar(wmul(lm.scale, blk), lm.shift),
                                    lm.offset),
                               0, max_val);
               });
  } else if (mode <= 0) {
    const int wl2 = log2_dim(w), hl2 = log2_dim(h);
    write_back(plane, resi, res, Hp, Wp, lf, max_val, lane,
               [&](int y, int x) {
                 return pred_planar(s_top, s_left, w, h, wl2, hl2, y, x);
               });
  } else if (mode == 1) {
    const int dc = dc_value(s_top, s_left, w, h, lane);
    write_back(plane, resi, res, Hp, Wp, lf, max_val, lane,
               [&](int, int) { return dc; });
  } else {
    const Angular ang(s_top, s_left, w, h, mode);
    write_back(plane, resi, res, Hp, Wp, lf, max_val, lane,
               [&](int y, int x) { return ang.pred(y, x, false, max_val); });
  }
}

// ---------------------------------------------------------------------------
// The scan: phase 1 (owner map, contract, ticket order), phase 2 (warps)
// ---------------------------------------------------------------------------

template <bool kChroma>
__global__ void __launch_bounds__(kWarps * 32)
intra_scan_kernel(int16_t* planes, const int32_t* __restrict__ resi,
                  const int16_t* __restrict__ luma,
                  const int32_t* __restrict__ meta, int N, int Hp, int Wp,
                  int HpL, int WpL, int bitdepth, int32_t* scratch,
                  int done_words) {
  using K = Kind<kChroma>;
  constexpr int U = K::U, T = K::T;
  extern __shared__ int smem[];
  __shared__ int s_ticket, s_end, s_flags, s_nowave, s_rows;
  __shared__ int s_wave[kMaxWaves + 1];  // rows per wave, then their bases
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthr = kWarps * 32;
  // this block's plane: it reads and writes no other
  const int pi = blockIdx.x;
  const int UH = (Hp + U - 1) / U, UW = (Wp + U - 1) / U;
  const int TH = (Hp + T - 1) / T, TW = (Wp + T - 1) / T;
  const int nwaves = TW + 2 * (TH - 1);
  int16_t* plane = planes + (size_t)pi * Hp * Wp;
  const int32_t* rplane = resi + (size_t)pi * Hp * Wp;
  int32_t* status = scratch + kStatusWords * pi;
  int32_t* owner = scratch + kStatusWords * gridDim.x +
                   (size_t)pi * (UH * UW + 2 * N);
  int32_t* order = owner + UH * UW;  // ticket -> row
  int32_t* rank = order + N;         // row -> rank among the plane's rows
  unsigned* done = (unsigned*)(smem + kWarps * kSlice);
  // phase 1's per-tile first and last ranks and row counts, and the rows
  // before each batch of 32 rows, in the warps' slices, which only phase
  // 2 uses; where they do not fit, the tickets go in decode order
  const int TT = TH * TW, nb = (N + 31) / 32;
  const bool tiles = nwaves <= kMaxWaves && 3 * TT + nb <= kWarps * kSlice;
  int* tfirst = smem;
  int* tlast = tfirst + TT;
  int* tcount = tlast + TT;
  int* bbase = tcount + TT;

  // ---- phase 1: the owner map, the contract and the ticket order
  if (tid == 0) {
    s_ticket = 0;
    s_end = 0;
    s_flags = N > done_words * 32 ? kTooManyRows : 0;
    s_nowave = !tiles;
    s_rows = 0;
  }
  // the owner map reads -1 where no row writes: cleared whole, or, for a
  // table that reads fewer units than an eighth of the map, on the units
  // the rows read (written units are all painted below)
  const bool clear_read = (long long)N * K::kSlots * 32 * 8 <
                          (long long)UH * UW;
  if (clear_read) {
    for (int n = tid; n < N; n += nthr) {
      Leaf lf;
      bool is_lm;
      if (!row_leaf<kChroma>(meta, n, pi, lf, is_lm)) continue;
      const ReadSet rs = read_set(lf, Hp, Wp, U);
      for (int i = 0; i < rs.total(); ++i) {
        int uy, ux;
        rs.at(i, uy, ux);
        owner[uy * UW + ux] = -1;
      }
    }
  } else {
    for (int i = tid; i < UH * UW; i += nthr) owner[i] = -1;
  }
  for (int i = tid; i < (tiles ? TT : 0); i += nthr) {
    tfirst[i] = N;
    tlast[i] = -1;
    tcount[i] = 0;
  }
  for (int i = tid; i < done_words; i += nthr) done[i] = 0;
  // the tile of a unit (a row's tile: that of its first unit) and its wave
  auto unit_tile = [&](int uy, int ux) {
    return clampi((uy * U - kPadTL) / T, 0, TH - 1) * TW +
           clampi((ux * U - kPadTL) / T, 0, TW - 1);
  };
  auto wave_of = [&](int t) { return t % TW + 2 * (t / TW); };
  __syncthreads();
  // the rows in batches of 32, a warp's lanes on consecutive rows: count
  // the plane's rows of each batch, their exclusive sums, then each row's
  // rank among the plane's rows; paint the owner map and count the rows
  // in their tiles
  for (int b = warp; b < (tiles ? nb : 0); b += kWarps) {
    const int n = b * 32 + lane;
    const unsigned mask =
        __ballot_sync(kFull, n < N && row_is_mine<kChroma>(meta, n, pi));
    if (lane == 0) bbase[b] = __popc(mask);
  }
  __syncthreads();
  if (warp == 0 && tiles) {
    int carry = 0;
    for (int c = 0; c < nb; c += 32) {
      const int i = c + lane;
      const int v = i < nb ? bbase[i] : 0;
      int incl = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += u;
      }
      if (i < nb) bbase[i] = carry + incl - v;
      carry += __shfl_sync(kFull, incl, 31);
    }
  }
  __syncthreads();
  int last = 0;
  bool straddle = false;
  for (int b = warp; b < nb; b += kWarps) {
    const int n = b * 32 + lane;
    Leaf lf;
    bool is_lm;
    const bool mine = n < N && row_leaf<kChroma>(meta, n, pi, lf, is_lm);
    const unsigned mask = __ballot_sync(kFull, mine);
    if (!mine) continue;
    last = n + 1;
    const Rect r = write_rect(lf, Hp, Wp, U, UH, UW);
    for (int uy = r.y0; uy <= r.y1; ++uy)
      for (int ux = r.x0; ux <= r.x1; ++ux) owner[uy * UW + ux] = n;
    if (!tiles) continue;
    const int t = unit_tile(r.y0, r.x0);
    straddle |= unit_tile(r.y1, r.x1) != t;
    const int p = bbase[b] + __popc(mask & ((1u << lane) - 1));
    rank[n] = p;
    atomicMin(tfirst + t, p);
    atomicMax(tlast + t, p);
    atomicAdd(tcount + t, 1);
  }
  atomicMax(&s_end, last);
  if (straddle) s_nowave = 1;
  __syncthreads();
  // rows per wave, then their exclusive sums
  if (tiles) {
    for (int w = tid; w < nwaves; w += nthr) {
      int sum = 0;
#pragma unroll 4
      for (int ty = max(0, (w - TW + 2) / 2); ty < TH && 2 * ty <= w; ++ty)
        sum += tcount[ty * TW + w - 2 * ty];
      s_wave[w] = sum;
    }
    __syncthreads();
    if (warp == 0) {
      int carry = 0;
      for (int c = 0; c < nwaves; c += 32) {
        const int i = c + lane;
        const int v = i < nwaves ? s_wave[i] : 0;
        int incl = v;
        for (int o = 1; o < 32; o <<= 1) {
          const int u = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += u;
        }
        if (i < nwaves) s_wave[i] = carry + incl - v;
        carry += __shfl_sync(kFull, incl, 31);
      }
      if (lane == 0) s_wave[nwaves] = carry;
    }
  }
  __syncthreads();
  // per row: the contract (no second writer in its units, no later owner
  // of what it reads); the wavefront order's conditions (its tile's rows
  // consecutive, owners in its tile or an earlier wave); its ticket in
  // that order: the rows of its wave's tiles with a lower rank, and those
  // of its rank in a tile row above
  int flags = 0;
  bool nowave = false;
  for (int n = tid; n < N && flags == 0; n += nthr) {
    Leaf lf;
    bool is_lm;
    if (!row_leaf<kChroma>(meta, n, pi, lf, is_lm)) continue;
    const Rect r = write_rect(lf, Hp, Wp, U, UH, UW);
    for (int uy = r.y0; uy <= r.y1; ++uy) {
#pragma unroll 4
      for (int ux = r.x0; ux <= r.x1; ++ux)
        if (owner[uy * UW + ux] != n) flags |= kTwoWriters;
    }
    const int t = unit_tile(r.y0, r.x0), w = wave_of(t);
    const ReadSet rs = read_set(lf, Hp, Wp, U);
#pragma unroll 8
    for (int i = 0; i < rs.total(); ++i) {
      int uy, ux;
      rs.at(i, uy, ux);
      const int o = owner[uy * UW + ux];
      if (o > n) flags |= kReadsLater;
      const int ut = unit_tile(uy, ux);
      if (o >= 0 && o != n && ut != t && wave_of(ut) >= w) nowave = true;
    }
    if (tiles) {
      const int first = tfirst[t], count = tcount[t];
      nowave |= tlast[t] - first + 1 != count;
      const int k = rank[n] - first, ty = t / TW;
      int pos = s_wave[w];
#pragma unroll 4
      for (int y = max(0, (w - TW + 2) / 2); y < TH && 2 * y <= w; ++y) {
        const int c = tcount[y * TW + w - 2 * y];
        pos += min(k, c) + (y < ty && c > k ? 1 : 0);
      }
      if (pos >= 0 && pos < N) order[pos] = n;
    }
  }
  if (flags) atomicOr(&s_flags, flags);
  if (nowave) s_nowave = 1;
  __syncthreads();
  const bool ordered = s_flags != 0;
  const bool wavefront = !ordered && !s_nowave;
  const int total = wavefront ? s_wave[nwaves] : s_end;

  // ---- phase 2: the warps take the rows by ticket
  int* slice = smem + warp * kSlice;
  int* rbuf = slice + kNTop + kNLeft + kRaw;
  const volatile unsigned* vdone = done;
  int rows = 0;
  if (!ordered || warp == 0) {
    for (;;) {
      int tk = 0;
      if (lane == 0) tk = atomicAdd(&s_ticket, 1);
      tk = __shfl_sync(kFull, tk, 0);
      if (tk >= total) break;
      const int n = wavefront ? order[tk] : tk;
      Leaf lf;
      bool is_lm;
      if (!row_leaf<kChroma>(meta, n, pi, lf, is_lm)) continue;
      const int* res = prefetch_residual(rplane, Hp, Wp, lf, lane, rbuf);
      if (!ordered) {
        // the owners of the units the reference line reads (all lower
        // tickets), then their done bits
        const ReadSet rs = read_set(lf, Hp, Wp, U);
        int own[K::kSlots];
#pragma unroll
        for (int s = 0; s < K::kSlots; ++s) {
          const int i = lane + 32 * s;
          int uy, ux, o = -1;
          if (i < rs.total()) {
            rs.at(i, uy, ux);
            o = owner[uy * UW + ux];
          }
          own[s] = o >= 0 && o < n ? o : -1;
        }
        for (int sleep = 32;; sleep = min(2 * sleep, kMaxBackoffNs)) {
          bool ready = true;
#pragma unroll
          for (int s = 0; s < K::kSlots; ++s) {
            if (own[s] < 0) continue;
            if (vdone[own[s] >> 5] & (1u << (own[s] & 31)))
              own[s] = -1;
            else
              ready = false;
          }
          if (__all_sync(kFull, ready)) break;
          __nanosleep(sleep);
        }
        __threadfence_block();
      }
      cp_async_wait_all();
      __syncwarp();
      if constexpr (kChroma)
        chroma_leaf(plane, rplane, res, luma, Hp, Wp, HpL, WpL, lf, is_lm,
                    bitdepth, lane, slice);
      else
        luma_leaf(plane, rplane, res, Hp, Wp, lf, bitdepth, lane, slice);
      // the stores, then the done bit; the slice is free after the vote
      __threadfence_block();
      __syncwarp();
      if (lane == 0 && !ordered) atomicOr(&done[n >> 5], 1u << (n & 31));
      rows += 1;
      __syncwarp();
    }
  }
  if (lane == 0 && rows) atomicAdd(&s_rows, rows);
  __syncthreads();
  if (tid == 0) {
    status[0] = ordered ? kOrdered : kParallel;
    status[1] = s_rows;
    status[2] = s_flags;
    status[3] = kWarps;
    status[4] = wavefront ? 1 : 0;
  }
}

template <bool kChroma>
int launch(int16_t* planes, const int32_t* resi, const int16_t* luma,
           const int32_t* meta, int N, int Hp, int Wp, int HpL, int WpL,
           int bitdepth, int32_t* scratch, cudaStream_t stream) {
  constexpr int kSliceBytes = kWarps * kSlice * 4;
  // the attribute is set once per kernel and device (function attributes
  // are per device), for the most a launch asks
  static unsigned long long attr_set = 0;  // bit d: set on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(attr_set & bit)) {
    err = cudaFuncSetAttribute(intra_scan_kernel<kChroma>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSliceBytes + kMaxDoneWords * 4);
    if (err != cudaSuccess) return (int)err;
    attr_set |= bit;
  }
  int done_words = (N + 31) / 32;
  if (done_words > kMaxDoneWords) done_words = 0;  // runs ordered
  intra_scan_kernel<kChroma>
      <<<kChroma ? 2 : 1, kWarps * 32, kSliceBytes + done_words * 4,
         stream>>>(planes, resi, luma, meta, N, Hp, Wp, HpL, WpL, bitdepth,
                   scratch, done_words);
  return (int)cudaGetLastError();
}

}  // namespace

// `scratch`: int32, 5 status words per plane, then per plane the owner
// map of ceil(Hp / U) x ceil(Wp / U) units (U = 4 luma, 2 chroma), N
// ticket entries and N row ranks (gpu/intra_scan._scratch).
extern "C" int xvc_intra_luma_scan(void* plane, const void* resi,
                                   const void* meta, int N, int Hp, int Wp,
                                   int bitdepth, void* scratch, void* stream) {
  if (N <= 0) return 0;
  // the caller holds the canvas to the windows' sizes
  if (bitdepth < 1 || bitdepth > 15) return (int)cudaErrorInvalidValue;
  return launch<false>((int16_t*)plane, (const int32_t*)resi, nullptr,
                       (const int32_t*)meta, N, Hp, Wp, 0, 0, bitdepth,
                       (int32_t*)scratch, (cudaStream_t)stream);
}

extern "C" int xvc_intra_chroma_scan(void* planes, const void* resi,
                                     const void* luma, const void* meta, int N,
                                     int Hp, int Wp, int HpL, int WpL,
                                     int bitdepth, void* scratch,
                                     void* stream) {
  if (N <= 0) return 0;
  if (bitdepth < 1 || bitdepth > 15) return (int)cudaErrorInvalidValue;
  return launch<true>((int16_t*)planes, (const int32_t*)resi,
                      (const int16_t*)luma, (const int32_t*)meta, N, Hp, Wp,
                      HpL, WpL, bitdepth, (int32_t*)scratch,
                      (cudaStream_t)stream);
}
