// Sub-pel motion compensation + scatter into the prediction planes.
//
// Replaces, on the GPU: xvc_tpu/tpu/pallas_mc.py make_mc_pallas (the
// Pallas window-DMA kernel), xvc_tpu/tpu/dsp.py _mc_core_builder (its XLA
// gather twin) and the scatter of xvc_tpu/tpu/flat_recon.py
// make_mc_scatter; and, in the picture kernel, the host job build in
// front of them (flat_recon.py _build_mc_groups, _emit_mc_rows and the
// affine expansion _emit_affine_rows / _affine_plain / _affine_subblocks).
// Rounding and int16 wrap points follow the scalar reference
// (native/xvcn.cpp xvcn_mc_filter, ref: inter_prediction.cc 1138-1378):
// all four fractional cases, clipped samples or the 14-bit bi-prediction
// intermediates (short_out).
//
// Two entry points share one per-job device function (mc_job):
//   xvc_mc_scatter  one group of jobs of one window class, a thread block
//                   per job, jobs built by the caller (the group API);
//   xvc_mc_picture  every inter prediction of a picture in one launch,
//                   each derived from the parse's record table (mc_leaf).
//
// mc_job.  The window a job reads starts where lax.dynamic_slice would
// start it (a negative start counts from the end, then the start is
// clamped so that a window of the job's CLASS fits: (hb + taps - 1) x (wb +
// taps - 1), hb and wb the job's bucket 8/16/32/64, as the JAX path
// clamps it), but only the (h + taps - 1) x (w + taps - 1) samples the job
// reads are staged, as int16, into shared memory by cp.async, 16 bytes a
// lane from the 16-byte-aligned column at or before the window's first
// (the store's rows are multiples of 128 samples; the entry points refuse
// a stack whose rows are not a multiple of 8 or that is not 16-byte
// aligned).  The 2-D case filters all window rows
// horizontally into a second buffer, then vertically, like the reference.
// Only the valid w x h region is stored, and only inside the plane; a
// slot-1 job of a bi leaf (short_out, chan >= nplanes) also sets the
// coverage mask.  Leaves never overlap, so stores need no atomics.
//
// The picture kernel.  One work item per (record, component, dslot): it
// exits unless the record is a tree-0 inter leaf and (dslot == 0 or the
// leaf is bi).  It derives the list (dslot 0: L1 for an L1 leaf, else L0;
// dslot 1: L1), the reference index and the MVs, clips them against that
// reference's size (clip_mv), splits them into full-pel offset and
// phase (GetFullpelRef, the three cases of _emit_mc_rows, the hp_mv
// shift) and places the window at pad + c + pel - half.  Before any
// access the record's indices are bounded: the reference index in 0..4
// with a slot in the reference table (-1: none) below the store's count,
// the luma sides powers of two in 4..64, the origin inside the plane; a
// record that fails drops its jobs.  An affine CU's item expands the CU's
// subblocks on the card with the JAX package's arithmetic (the subblock
// size loop, the truncating division, the clamps to mv_min / mv_max; a
// CU whose first two corner MVs agree is plain MC) and runs them one
// after another.  The worker is sized to the CU: a warp when both sides
// of the component block are at most 16 (a window of at most 23 x 23),
// the whole thread block (and first, so the long jobs start early) for
// 32 and 64.
//
// No intermediate leaves int32.  After the bounds above, a clipped MV
// lies within (64 + 8 + W) << 4 of zero (W, the plane's side, < 2^13 by
// the store's size), so mv << 8 in the affine model is below 2^30; the
// affine model's sums (hor_x = mv << 8 plus delta * 64 terms) are taken
// in int64 all the same, as the JAX package's Python ints are unbounded,
// and what comes back into int32 is clamped to mv_min / mv_max first.
// Arithmetic >> and & of negative int32 here are numpy's floor shift and
// two's-complement mask on int64: they agree.
//
// What bounds it on an H100: bytes.  A job reads its (h+taps-1) x
// (w+taps-1) int16 window and writes h x w int16 samples, at most 8+8
// multiply-adds per output sample, so the arithmetic intensity is a few
// operations per byte, far below the card's compute line.  At 720p an
// inter picture moves about a MB: the launch and the tail dominate.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "records.cuh"

namespace {

using rec::clampi;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmall = 16;  // a warp's jobs: both sides at most this
constexpr int kMaxGrid = 2048;
constexpr int kFilterPrecision = 6;
constexpr int kInternalPrecision = 14;
constexpr int kInternalOffset = 8192;
constexpr int kMvShift = 4;          // inter_mv.MV_PRECISION_SHIFT
constexpr int kHighToNormal = 2;     // inter_mv.HIGH_TO_NORMAL_DELTA
constexpr int kMaxBlock = 64;        // constants.MAX_BLOCK_SIZE
constexpr int kMaxRefs = 5;
constexpr int kBi = 2, kL1 = 1;      // constants.InterDir

// Shared memory: a warp's window (23 rows of at most 32 samples read as
// 16-byte chunks) and 2-D buffer (23 x 16 int32); the whole block's
// window (71 rows of at most 80) and buffer (71 x 64 int32).  Byte sizes,
// all multiples of 16.
constexpr int kWarpWin = (kSmall + 7) * 32 * 2;
constexpr int kWarpSlice = kWarpWin + (kSmall + 7) * kSmall * 4;
constexpr int kBlockWin = (64 + 7) * 80 * 2;
constexpr int kBlockBytes = kBlockWin + (64 + 7) * 64 * 4;
constexpr int kSmemBytes =
    kWarps * kWarpSlice > kBlockBytes ? kWarps * kWarpSlice : kBlockBytes;
static_assert(kWarpWin % 16 == 0 && kWarpSlice % 16 == 0 &&
              kBlockWin % 16 == 0, "cp.async targets stay 16-byte aligned");

struct FilterTable {
  int v[128];  // [phase][tap], 16 x 8 (luma) or 32 x 4 (chroma)
};

__device__ __forceinline__ int wrap16(int x) { return (int)(int16_t)x; }

// a window start as lax.dynamic_slice takes it: negative counts from the
// end, then clamped so that the window fits
__device__ __forceinline__ int ds_start(int v, int dim, int size) {
  return clampi(v < 0 ? v + dim : v, 0, dim - size);
}

__device__ __forceinline__ int bucket(int n) {
  return n <= 8 ? 8 : (n <= 16 ? 16 : (n <= 32 ? 32 : 64));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                   "memory");
}

// One job: window origin (unclamped), phases and where its w x h samples
// go, and its window class (wb, hb) for the clamp.
struct McJob {
  int r, ypad, xpad, fx, fy, chan, cy, cx, w, h, wb, hb;
};

// Where the predictions of one component go.
struct McOut {
  const int16_t* planes;  // (R, Hp, Wp) reference stack
  int R, Hp, Wp;
  int16_t* pred;          // (nchan, H, W)
  int16_t* mask;          // (nplanes, H, W)
  int nchan, nplanes, H, W;
};

template <int kTaps, typename G>
__device__ void mc_job(const G& g, const McOut& o, const McJob& j,
                       const int* __restrict__ table, int nphase,
                       int bitdepth, int short_out, int16_t* win, int* tmp) {
  constexpr int half = kTaps / 2 - 1;
  const int r = ds_start(j.r, o.R, 1);
  const int y0 = ds_start(j.ypad, o.Hp, j.hb + kTaps - 1);
  const int x0 = ds_start(j.xpad, o.Wp, j.wb + kTaps - 1);
  const int w = j.w, h = j.h;
  const int wh = h + kTaps - 1, ww = w + kTaps - 1;
  const int16_t* src = o.planes + ((size_t)r * o.Hp + y0) * o.Wp;
  // rows from the aligned column at or before x0, 16 bytes a lane (the
  // entry points take only stacks 16-byte aligned with rows a multiple of
  // 8 samples); the last chunk ends at or before Wp
  const int xa = x0 & ~7;
  const int nch = (x0 + ww - xa + 7) >> 3;
  const int stride = nch * 8, xoff = x0 - xa;
  for (int i = g.tid; i < wh * nch; i += G::n) {
    const int yy = i / nch, c = i - yy * nch;
    cp_async16(win + yy * stride + c * 8,
               src + (size_t)yy * o.Wp + xa + c * 8);
  }
  cp_async_wait_all();
  g.sync();
  const int16_t* wv = win + xoff;

  const int fx = clampi(j.fx, 0, nphase - 1);
  const int fy = clampi(j.fy, 0, nphase - 1);
  int cfx[kTaps], cfy[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    cfx[t] = table[fx * kTaps + t];
    cfy[t] = table[fy * kTaps + t];
  }
  const int prec_diff = kInternalPrecision - bitdepth;
  const int max_val = (1 << bitdepth) - 1;
  const int shift1 = kFilterPrecision - prec_diff;
  const int offset1 = -(kInternalOffset << shift1);
  const int shift2 = kFilterPrecision + prec_diff;
  const int offset2 = (kInternalOffset << kFilterPrecision) +
                      (1 << (shift2 - 1));
  const int frnd = 1 << (kFilterPrecision - 1);

  if (fx != 0 && fy != 0) {  // uniform over the job
    for (int i = g.tid; i < wh * w; i += G::n) {
      const int yy = i / w, xx = i - yy * w;
      const int16_t* row = wv + yy * stride + xx;
      int s = 0;
#pragma unroll
      for (int t = 0; t < kTaps; ++t) s += cfx[t] * row[t];
      tmp[i] = wrap16((s + offset1) >> shift1);
    }
    g.sync();
  }

  for (int i = g.tid; i < h * w; i += G::n) {
    const int yy = i / w, xx = i - yy * w;
    const int oy = j.cy + yy, ox = j.cx + xx;
    if (oy < 0 || oy >= o.H || ox < 0 || ox >= o.W) continue;
    int v;
    if (fx == 0 && fy == 0) {
      const int c = wv[(yy + half) * stride + xx + half];
      // above 14 bit prec_diff is negative; the shift's int16 store is 0
      // there (gpu/dsp.py fullpel_short)
      v = short_out ? wrap16(wrap16(prec_diff >= 0 ? c << prec_diff : 0) -
                             kInternalOffset)
                    : clampi(c, 0, max_val);
    } else if (fy == 0) {
      const int16_t* row = wv + (yy + half) * stride + xx;
      int s = 0;
#pragma unroll
      for (int t = 0; t < kTaps; ++t) s += cfx[t] * row[t];
      v = short_out ? wrap16((s + offset1) >> shift1)
                    : clampi((s + frnd) >> kFilterPrecision, 0, max_val);
    } else if (fx == 0) {
      const int16_t* col = wv + yy * stride + xx + half;
      int s = 0;
#pragma unroll
      for (int t = 0; t < kTaps; ++t) s += cfy[t] * col[t * stride];
      v = short_out ? wrap16((s + offset1) >> shift1)
                    : clampi(wrap16((s + frnd) >> kFilterPrecision), 0,
                             max_val);
    } else {
      const int* col = tmp + yy * w + xx;
      int s = 0;
#pragma unroll
      for (int t = 0; t < kTaps; ++t) s += cfy[t] * col[t * w];
      v = short_out ? wrap16(s >> kFilterPrecision)
                    : clampi(wrap16((s + offset2) >> shift2), 0, max_val);
    }
    o.pred[((size_t)j.chan * o.H + oy) * o.W + ox] = (int16_t)v;
    if (short_out && j.chan >= o.nplanes)
      o.mask[((size_t)(j.chan - o.nplanes) * o.H + oy) * o.W + ox] = 1;
  }
  g.sync();  // the group's next job overwrites the window and the buffer
}

// ---------------------------------------------------------------------------
// The group kernel: one thread block per job of one window class
// ---------------------------------------------------------------------------

template <int kTaps>
__global__ void __launch_bounds__(kThreads)
mc_scatter_kernel(McOut o, const int32_t* __restrict__ params, int B,
                  int wb, int hb, int nphase, FilterTable table, int bitdepth,
                  int short_out) {
  __shared__ __align__(16) unsigned char smem[kBlockBytes];
  const int b = blockIdx.x;
  McJob j;
  j.chan = params[5 * B + b];
  if (j.chan < 0 || j.chan >= o.nchan) return;  // padding lane: dropped
  j.r = params[b];
  j.ypad = params[B + b];
  j.xpad = params[2 * B + b];
  j.fx = params[3 * B + b];
  j.fy = params[4 * B + b];
  j.cy = params[6 * B + b];
  j.cx = params[7 * B + b];
  // samples beyond the class are never stored
  j.w = clampi(params[8 * B + b], 0, wb);
  j.h = clampi(params[9 * B + b], 0, hb);
  j.wb = wb;
  j.hb = hb;
  mc_job<kTaps>(rec::BlockGroup<kThreads>{(int)threadIdx.x}, o, j, table.v,
                nphase, bitdepth, short_out, (int16_t*)smem,
                (int*)(smem + kBlockWin));
}

// ---------------------------------------------------------------------------
// The picture kernel: every inter prediction, derived from the records
// ---------------------------------------------------------------------------

// the order of mc.mc_picture's config array (McFlags.cfg last)
struct McCfg {
  int n, stride, ncomp, S, Hp, Wp, Hpc, Wpc, H, W, Hc, Wc;
  int bitdepth, hp_mv, chroma_subpel, sx, sy, pad_x0, pad_y0, pad_xc,
      pad_yc, luma_w, luma_h;
};

// An item's leaf: what its jobs share.
struct McLeaf {
  int comp, dslot, slot, short_out, posx, posy, w, h, affine;
  int mv[3][2];  // clipped corner MVs of the item's list
};

// Work item -> leaf, as _build_mc_groups selects it; false for an item
// that is no prediction or fails a guard.
__device__ bool mc_leaf(const int32_t* __restrict__ recs, const McCfg& c,
                        const int32_t* __restrict__ refs, int item,
                        McLeaf& L) {
  const int per = 2 * c.ncomp;
  const int ri = item / per, k = item - ri * per;
  L.comp = k >> 1;
  L.dslot = k & 1;
  const int32_t* r = recs + (size_t)ri * c.stride;
  if (r[rec::kSplit] != 0 || r[rec::kTree] != 0 || r[rec::kPred] != 1)
    return false;
  const int dir = r[rec::kDir];
  if (L.dslot == 1 && dir != kBi) return false;
  L.w = r[rec::kW];
  L.h = r[rec::kH];
  L.posx = r[rec::kX];
  L.posy = r[rec::kY];
  if (rec::log2_side(L.w, 4, kMaxBlock) < 0 ||
      rec::log2_side(L.h, 4, kMaxBlock) < 0 || L.posx < 0 ||
      L.posx >= c.W || L.posy < 0 || L.posy >= c.H)
    return false;
  const int lst = L.dslot == 1 || dir == kL1 ? 1 : 0;
  const int ridx = r[rec::kRef0 + lst];
  if (ridx < 0 || ridx >= kMaxRefs) return false;
  const int32_t* e = refs + (lst * kMaxRefs + ridx) * 3;
  L.slot = e[0];
  if (L.slot < 0 || L.slot >= c.S) return false;
  // clip_mv (ref: inter_prediction.cc:769-782)
  const int rw = e[1], rh = e[2];
  for (int k2 = 0; k2 < 3; ++k2) {
    const int* mv = r + rec::kMv + 8 * lst + 2 * k2;
    L.mv[k2][0] = clampi(mv[0], -((kMaxBlock + 8 + L.posx - 1) << kMvShift),
                         (rw + 8 - L.posx - 1) << kMvShift);
    L.mv[k2][1] = clampi(mv[1], -((kMaxBlock + 8 + L.posy - 1) << kMvShift),
                         (rh + 8 - L.posy - 1) << kMvShift);
  }
  L.short_out = dir == kBi;
  L.affine = r[rec::kAffine] != 0;
  return true;
}

// The job of a whole (component) block with one MV (GetFullpelRef,
// ref: inter_prediction.cc:1174-1205; _emit_mc_rows / _affine_plain).
__device__ void plain_job(const McCfg& c, const McLeaf& L, int mvx, int mvy,
                          McJob& j) {
  const int comp = L.comp;
  const int sx = comp ? c.sx : 0, sy = comp ? c.sy : 0;
  const int shx = kMvShift + sx, shy = kMvShift + sy;
  int pel_x, pel_y, fx, fy;
  if (comp != 0 && !c.chroma_subpel) {
    pel_x = (mvx + (1 << (shx - 1))) >> shx;
    pel_y = (mvy + (1 << (shy - 1))) >> shy;
    fx = fy = 0;
  } else {
    pel_x = mvx >> shx;
    pel_y = mvy >> shy;
    fx = (mvx & ((1 << shx) - 1)) << (comp ? 1 - sx : 0);
    fy = (mvy & ((1 << shy) - 1)) << (comp ? 1 - sy : 0);
  }
  if (!c.hp_mv) {
    fx >>= kHighToNormal;
    fy >>= kHighToNormal;
  }
  const int half = (comp ? 4 : 8) / 2 - 1;
  j.cx = L.posx >> sx;
  j.cy = L.posy >> sy;
  j.w = L.w >> sx;
  j.h = L.h >> sy;
  j.ypad = (comp ? c.pad_yc : c.pad_y0) + j.cy + pel_y - half;
  j.xpad = (comp ? c.pad_xc : c.pad_x0) + j.cx + pel_x - half;
  j.fx = fx;
  j.fy = fy;
  j.r = comp ? L.slot * 2 + comp - 1 : L.slot;
  j.chan = comp ? L.dslot * 2 + comp - 1 : L.dslot;
  j.wb = bucket(j.w);
  j.hb = bucket(j.h);
}

// get_subblock_size of the affine model (component side, its shift)
__device__ int subblock_size(const int* ref, const int* uni, int size,
                             int scale) {
  const int dx = abs(uni[0] - ref[0]), dy = abs(uni[1] - ref[1]);
  const int max_len = dx > dy ? dx : dy;
  if (max_len == 0) return size;
  int sub = (size >> (6 - kMvShift)) / max_len;
  if (sub < 1) sub = 1;
  while (size % sub) --sub;
  return (sub > 4 ? sub : 4) >> scale;
}

__device__ __forceinline__ long long clampll(long long x, long long lo,
                                             long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// All jobs of one item, one after another, by group g.
template <int kTaps, typename G>
__device__ void run_item(const G& g, const McCfg& c, const McLeaf& L,
                         const McOut& o, const int* table, int nphase,
                         int16_t* win, int* tmp) {
  McJob j;
  if (!L.affine || (L.mv[0][0] == L.mv[1][0] && L.mv[0][1] == L.mv[1][1])) {
    plain_job(c, L, L.mv[0][0], L.mv[0][1], j);
    mc_job<kTaps>(g, o, j, table, nphase, c.bitdepth, L.short_out, win, tmp);
    return;
  }
  // affine subblocks (ref: inter_prediction.cc:1044-1136), in component
  // coordinates; int64 for the model's sums (see the note at the top)
  const int comp = L.comp;
  const int scale_x = comp ? c.sx : 0, scale_y = comp ? c.sy : 0;
  const int width = L.w >> scale_x, height = L.h >> scale_y;
  const int sw = subblock_size(L.mv[0], L.mv[1], width, scale_x);
  const int shh = subblock_size(L.mv[0], L.mv[2], height, scale_y);
  const int msx = kMvShift + scale_x, msy = kMvShift + scale_y;
  constexpr long long kMvScale = 1 << kMvShift, kPrec = 1 << 8;
  const long long mv_max_x = (long long)(c.luma_w - L.posx + 8 - 1) * kMvScale;
  const long long mv_min_x = (long long)(-kMaxBlock - L.posx - 8 + 1) * kMvScale;
  const long long mv_max_y = (long long)(c.luma_h - L.posy + 8 - 1) * kMvScale;
  const long long mv_min_y = (long long)(-kMaxBlock - L.posy - 8 + 1) * kMvScale;
  // C's / truncates toward zero, as the JAX package's trunc_div
  const long long dhx = (long long)(L.mv[1][0] - L.mv[0][0]) * kPrec / width;
  const long long dhy = (long long)(L.mv[1][1] - L.mv[0][1]) * kPrec / width;
  const long long dvx = -dhy, dvy = dhx;
  long long ver_x = (long long)L.mv[0][0] * kPrec;
  long long ver_y = (long long)L.mv[0][1] * kPrec;
  const int half = kTaps / 2 - 1;
  const int ccx = L.posx >> scale_x, ccy = L.posy >> scale_y;
  j.r = comp ? L.slot * 2 + comp - 1 : L.slot;
  j.chan = comp ? L.dslot * 2 + comp - 1 : L.dslot;
  j.w = sw;
  j.h = shh;
  j.wb = bucket(sw);
  j.hb = bucket(shh);
  for (int sub_y = 0; sub_y < height; sub_y += shh) {
    long long hor_x = ver_x, hor_y = ver_y;
    for (int sub_x = 0; sub_x < width; sub_x += sw) {
      const int mv_x = (int)clampll(
          (hor_x + dhx * (sw >> 1) + dvx * (shh >> 1)) >> 8, mv_min_x,
          mv_max_x);
      const int mv_y = (int)clampll(
          (hor_y + dhy * (sw >> 1) + dvy * (shh >> 1)) >> 8, mv_min_y,
          mv_max_y);
      j.cx = ccx + sub_x;
      j.cy = ccy + sub_y;
      j.xpad = (comp ? c.pad_xc : c.pad_x0) + j.cx + (mv_x >> msx) - half;
      j.ypad = (comp ? c.pad_yc : c.pad_y0) + j.cy + (mv_y >> msy) - half;
      j.fx = mv_x & ((1 << msx) - 1);
      j.fy = mv_y & ((1 << msy) - 1);
      mc_job<kTaps>(g, o, j, table, nphase, c.bitdepth, L.short_out, win,
                    tmp);
      hor_x += dhx * sw;
      hor_y += dhy * sw;
    }
    ver_x += dvx * shh;
    ver_y += dvy * shh;
  }
}

template <typename G>
__device__ void run_leaf(const G& g, const McCfg& c, const McLeaf& L,
                         const McOut* outs, const FilterTable& luma_tab,
                         const FilterTable& chroma_tab, int16_t* win,
                         int* tmp) {
  if (L.comp == 0)
    run_item<8>(g, c, L, outs[0], luma_tab.v, c.hp_mv ? 16 : 4, win, tmp);
  else
    run_item<4>(g, c, L, outs[1], chroma_tab.v, c.hp_mv ? 32 : 8, win, tmp);
}

__device__ __forceinline__ bool small_leaf(const McCfg& c, const McLeaf& L) {
  return (L.w >> (L.comp ? c.sx : 0)) <= kSmall &&
         (L.h >> (L.comp ? c.sy : 0)) <= kSmall;
}

__global__ void __launch_bounds__(kThreads)
mc_picture_kernel(const int32_t* __restrict__ recs,
                  const int32_t* __restrict__ refs, McOut luma, McOut chroma,
                  McCfg c, FilterTable luma_tab, FilterTable chroma_tab) {
  __shared__ __align__(16) unsigned char smem[kSmemBytes];
  const McOut outs[2] = {luma, chroma};
  const int items = c.n * 2 * c.ncomp;
  McLeaf L;
  // blocks larger than 16 on a side: the whole thread block each
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    if (!mc_leaf(recs, c, refs, it, L) || small_leaf(c, L)) continue;
    run_leaf(rec::BlockGroup<kThreads>{(int)threadIdx.x}, c, L, outs,
             luma_tab, chroma_tab, (int16_t*)smem, (int*)(smem + kBlockWin));
  }
  __syncthreads();  // the warps' slices overlap the block's buffers
  const int warp = threadIdx.x >> 5;
  unsigned char* slice = smem + warp * kWarpSlice;
  for (int it = blockIdx.x * kWarps + warp; it < items;
       it += gridDim.x * kWarps) {
    if (!mc_leaf(recs, c, refs, it, L) || !small_leaf(c, L)) continue;
    run_leaf(rec::WarpGroup{(int)(threadIdx.x & 31)}, c, L, outs, luma_tab,
             chroma_tab, (int16_t*)slice, (int*)(slice + kWarpWin));
  }
}

// what cp.async staging of 16 bytes a lane needs of a stack
bool staged_aligned(const void* planes, int Wp) {
  return (Wp & 7) == 0 && ((uintptr_t)planes & 15) == 0;
}

FilterTable table_of(const int* host, int n) {
  FilterTable t;
  for (int i = 0; i < 128; ++i) t.v[i] = i < n ? host[i] : 0;
  return t;
}

}  // namespace

extern "C" int xvc_mc_scatter(const void* planes, int R, int Hp, int Wp,
                              const void* params, int B, int wb, int hb,
                              int taps, int nphase, const void* table_host,
                              int bitdepth, int short_out, void* pred,
                              int nchan, int H, int W, void* mask,
                              int nplanes, void* stream) {
  if (B <= 0) return 0;
  if (nphase * taps > 128 || wb > 64 || hb > 64 || (taps != 8 && taps != 4) ||
      !staged_aligned(planes, Wp))
    return (int)cudaErrorInvalidValue;
  const FilterTable table = table_of((const int*)table_host, nphase * taps);
  const McOut o{(const int16_t*)planes, R, Hp, Wp, (int16_t*)pred,
                (int16_t*)mask, nchan, nplanes, H, W};
  if (taps == 8)
    mc_scatter_kernel<8><<<B, kThreads, 0, (cudaStream_t)stream>>>(
        o, (const int32_t*)params, B, wb, hb, nphase, table, bitdepth,
        short_out);
  else
    mc_scatter_kernel<4><<<B, kThreads, 0, (cudaStream_t)stream>>>(
        o, (const int32_t*)params, B, wb, hb, nphase, table, bitdepth,
        short_out);
  return (int)cudaGetLastError();
}

// tables: the luma filter table (phases x 8) then the chroma one (phases
// x 4), of the picture's MV precision
extern "C" int xvc_mc_picture(const void* recs, const void* refs,
                              const void* luma_stack,
                              const void* chroma_stack, void* pred_l,
                              void* mask_l, void* pred_c, void* mask_c,
                              const void* cfg_host, int ncfg,
                              const void* tables, int ntables,
                              void* stream) {
  McCfg c;
  if (ncfg != (int)(sizeof(c) / sizeof(int))) return (int)cudaErrorInvalidValue;
  memcpy(&c, cfg_host, sizeof(c));
  if (c.n <= 0) return 0;
  const int nl = c.hp_mv ? 16 * 8 : 4 * 8, nc = c.hp_mv ? 32 * 4 : 8 * 4;
  if (c.stride < rec::kMinCols || (c.ncomp != 1 && c.ncomp != 3) ||
      (c.ncomp == 3 && (!chroma_stack || !pred_c || !mask_c)) ||
      ntables != nl + nc || c.bitdepth < 8 || c.bitdepth > 15 ||
      c.S <= 0 || c.Hp < kMaxBlock + 7 || c.Wp < kMaxBlock + 7 ||
      (c.ncomp == 3 && (c.Hpc < kMaxBlock + 3 || c.Wpc < kMaxBlock + 3)) ||
      !staged_aligned(luma_stack, c.Wp) ||
      (c.ncomp == 3 && !staged_aligned(chroma_stack, c.Wpc)) ||
      (long long)c.n * 2 * c.ncomp > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const FilterTable lt = table_of((const int*)tables, nl);
  const FilterTable ct = table_of((const int*)tables + nl, nc);
  const McOut luma{(const int16_t*)luma_stack, c.S, c.Hp, c.Wp,
                   (int16_t*)pred_l, (int16_t*)mask_l, 2, 1, c.H, c.W};
  const McOut chroma{(const int16_t*)chroma_stack, 2 * c.S, c.Hpc, c.Wpc,
                     (int16_t*)pred_c, (int16_t*)mask_c, 4, 2, c.Hc, c.Wc};
  const long long blocks =
      ((long long)c.n * 2 * c.ncomp + kWarps - 1) / kWarps;
  mc_picture_kernel<<<(int)(blocks < kMaxGrid ? blocks : kMaxGrid), kThreads,
                      0, (cudaStream_t)stream>>>(
      (const int32_t*)recs, (const int32_t*)refs, luma, chroma, c, lt, ct);
  return (int)cudaGetLastError();
}
