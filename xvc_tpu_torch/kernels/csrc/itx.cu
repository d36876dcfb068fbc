// Dequantization + inverse transform + scatter into the residual planes.
//
// Replaces, on the GPU: xvc_tpu/tpu/flat_recon.py make_itx_scatter_gen and
// make_itx_scatter, i.e. dsp._dequant_expr followed by the two int32
// einsums of dsp._itx_core (ref: quantize.cc:94-125, transform.cc inverse
// paths) and the .at[].set(mode="drop") scatter; and, in the picture
// kernel, the host job build in front of them (flat_recon.py
// _build_itx_groups: selection, grouping by shape, coefficient gather).
//
// Two entry points share one per-block device function (itx_block):
//   xvc_itx_scatter  one group of blocks of one shape, a thread block per
//                    block, jobs built by the caller (the group API);
//   xvc_itx_picture  every coded block of a picture in one launch, each
//                    derived from the parse's record table (itx_item).
//
// Exactness: CUDA PyTorch has no int32 matrix product and float32 is not
// exact here, so both passes accumulate in int32 on the CUDA cores.  The
// bound: dequantized values and the first pass's output are clipped to
// int16 (|x| <= 2^15), basis entries are at most 374 in magnitude
// (< 2^9, ops/transform.get_matrix at every size and precision), and a
// pass sums at most 32 terms (the zero-out of rows and columns beyond
// 32), so |sum| < 2^15 * 2^9 * 2^5 = 2^29 and the rounding offset keeps
// it below 2^31: no int32 accumulation can overflow.  The dequant
// product itself wraps like the reference's C int math (unsigned
// arithmetic here, so the wrap is defined), and so does the qp scale
// times 181 of a block whose log2 sides sum to an odd number (the host
// job table's int32 store).  The picture kernel reads the int32 arena as
// int16, the wrap of the host job table's coeff[idx].astype(np.int16).
//
// The picture kernel.  One work item per (record, component), found by a
// grid-stride walk over N x ncomp; an item that is no coded block (a
// node that is split, a CBF of 0, no coefficient offset) exits at once.
// Before any access every index a record gives is bounded: the sides are
// powers of two in 2..64, the coefficients [offset, offset + w h) lie in
// the arena, the origin lies in the plane, the qp in the scale table; a
// record that fails drops its block (samples outside the plane are
// dropped one by one, as the JAX scatter drops them).  The worker is
// sized to the block: blocks of at most 16 x 16 (at most 256 samples, 8
// a lane) take a warp each, with their dq / tmp slice in shared memory;
// blocks of 32 or 64 on a side take the whole thread block, first, so the
// long jobs start early.  The bases of every side and family and the
// DST-4 matrix are one small table in device memory (itx.picture_bases_np).
// No tensor cores: there is no exact int16 x int9 product on them, and
// the arithmetic is far below any compute line.
//
// What bounds it on an H100: bytes, the arena read (4 bytes a
// coefficient) and the residual written (4 bytes a sample), a few MB at
// 720p -- a microsecond at the card's rate.  In practice the launch and
// the tail of the last large blocks dominate.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "records.cuh"

namespace {

using rec::clampi;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kZeroOut = 32;
constexpr int kSmall = 16;      // a warp's blocks: both sides at most this
constexpr int kSlice = 2 * kSmall * kSmall;  // a warp's dq + tmp, ints
constexpr int kMaxGrid = 2048;
constexpr int kNfam = 5;

enum Mode { kMatrix = 0, kDc = 2, kSkip = 3 };

__device__ __forceinline__ int clip16(int x) {
  return x < -32768 ? -32768 : (x > 32767 ? 32767 : x);
}

// (c * s + rnd) >> shift, or (c * s) << -shift, in wrapping int32; in
// 64 bits when `wide` (above 14 bit, as the host dequantization takes it)
__device__ __forceinline__ int dequant(int c, int s, int shift, bool wide) {
  if (wide) {
    const long long prod = (long long)c * s;
    const long long v = shift > 0 ? (prod + (1LL << (shift - 1))) >> shift
                                  : prod << (-shift);
    return v < -32768 ? -32768 : (v > 32767 ? 32767 : (int)v);
  }
  const unsigned prod = (unsigned)c * (unsigned)s;
  if (shift > 0)
    return clip16((int)(prod + (1u << (shift - 1))) >> shift);
  return clip16((int)(prod << (-shift)));
}

// One block's arithmetic: where it goes and how it is transformed.
struct ItxJob {
  int s;                      // dequant scale
  bool wide;                  // the dequant product in 64 bits
  int width, height, mode;
  int dq_shift, aux_shift, aux_scale;
  const int32_t* m1;          // [j][i], min(h, 32) x h
  const int32_t* m2;          // [j][k], min(w, 32) x w
  int s1, s2;
  int32_t* out;               // the plane
  int cy, cx, H, W;
};

// The block of coefficients c (int16 values: an int32 arena is read as
// int16) by the threads of group g; dq (at most 32 x 32) and tmp (at most
// 64 x 32) are the group's shared memory.  Used by both kernels.
template <typename G, typename C>
__device__ void itx_block(const G& g, const C* __restrict__ c,
                          const ItxJob& j, int* dq, int* tmp) {
  const int width = j.width, height = j.height;
  if (j.mode == kSkip) {
    for (int i = g.tid; i < width * height; i += G::n) {
      const int y = i / width, x = i - (i / width) * width;
      const int oy = j.cy + y, ox = j.cx + x;
      if (oy < 0 || oy >= j.H || ox < 0 || ox >= j.W) continue;
      const int d =
          dequant((int16_t)c[i], j.s, j.dq_shift, j.wide) * j.aux_scale;
      const int v = j.aux_shift > 0
                        ? (d + (1 << (j.aux_shift - 1))) >> j.aux_shift
                        : (int)((unsigned)d << (-j.aux_shift));
      j.out[(size_t)oy * j.W + ox] = v;
    }
    return;
  }
  if (j.mode == kDc) {
    // aux_shift = 14 - bitdepth; at 0 and below what the native code that
    // reconstructs every stream computes (gpu/dsp.py dc_only_residual)
    const int d = dequant((int16_t)c[0], j.s, j.dq_shift, j.wide);
    const int half = (d + 1) >> 1;
    const int v = (int)(int16_t)(
        j.aux_shift > 0 ? (half + (1 << (j.aux_shift - 1))) >> j.aux_shift
                        : (j.aux_shift == 0 ? half : 0));
    for (int i = g.tid; i < width * height; i += G::n) {
      const int y = i / width, x = i - (i / width) * width;
      const int oy = j.cy + y, ox = j.cx + x;
      if (oy < 0 || oy >= j.H || ox < 0 || ox >= j.W) continue;
      j.out[(size_t)oy * j.W + ox] = v;
    }
    return;
  }

  const int in1 = height < kZeroOut ? height : kZeroOut;
  const int cols = width < kZeroOut ? width : kZeroOut;
  for (int i = g.tid; i < in1 * cols; i += G::n) {
    const int r = i / cols, k = i - (i / cols) * cols;
    dq[i] = dequant((int16_t)c[r * width + k], j.s, j.dq_shift, j.wide);
  }
  g.sync();
  // first pass: tmp[i][k] = clip16((sum_j m1[j][i] dq[j][k] + rnd) >> s1)
  for (int o = g.tid; o < height * cols; o += G::n) {
    const int i = o / cols, k = o - (o / cols) * cols;
    int acc = 0;
    for (int r = 0; r < in1; ++r)
      acc += j.m1[r * height + i] * dq[r * cols + k];
    tmp[o] = clip16((acc + (1 << (j.s1 - 1))) >> j.s1);
  }
  g.sync();
  // second pass: out[i][k] = clip16((sum_j tmp[i][j] m2[j][k] + rnd) >> s2)
  for (int o = g.tid; o < height * width; o += G::n) {
    const int i = o / width, k = o - (o / width) * width;
    const int oy = j.cy + i, ox = j.cx + k;
    if (oy < 0 || oy >= j.H || ox < 0 || ox >= j.W) continue;
    int acc = 0;
    for (int r = 0; r < cols; ++r)
      acc += tmp[i * cols + r] * j.m2[r * width + k];
    j.out[(size_t)oy * j.W + ox] = clip16((acc + (1 << (j.s2 - 1))) >> j.s2);
  }
  // no sync needed before the group's next job: a thread reaches its dq
  // writes only after every thread passed this job's second sync (none
  // still reads dq), its tmp writes only after that job's first sync
  // (none still reads tmp)
}

// ---------------------------------------------------------------------------
// The group kernel: one thread block per block of one shape
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
itx_scatter_kernel(const int16_t* __restrict__ coeff,
                   const int32_t* __restrict__ scale,
                   const int32_t* __restrict__ params, int B, int width,
                   int height, int bitdepth, int mode, int fam_rows,
                   int dq_shift, int aux_shift, int aux_scale,
                   const int32_t* __restrict__ M1,
                   const int32_t* __restrict__ S1,
                   const int32_t* __restrict__ M2,
                   const int32_t* __restrict__ S2, int nfam,
                   int32_t* __restrict__ resi, int nplanes, int H, int W) {
  __shared__ int dq[kZeroOut * kZeroOut];
  __shared__ int tmp[64 * kZeroOut];
  const int b = blockIdx.x;
  const int pidx = params[b];
  if (pidx < 0 || pidx >= nplanes) return;  // padding lane: dropped
  const int in1 = height < kZeroOut ? height : kZeroOut;
  const int cols = width < kZeroOut ? width : kZeroOut;
  const int f1 = fam_rows ? clampi(params[3 * B + b], 0, nfam - 1) : 0;
  const int f2 = fam_rows ? clampi(params[4 * B + b], 0, nfam - 1) : 0;
  ItxJob j;
  j.s = scale[b];
  j.wide = bitdepth > 14;
  j.width = width;
  j.height = height;
  j.mode = mode;
  j.dq_shift = dq_shift;
  j.aux_shift = aux_shift;
  j.aux_scale = aux_scale;
  j.m1 = M1 + (size_t)f1 * in1 * height;
  j.m2 = M2 + (size_t)f2 * cols * width;
  j.s1 = S1[f1];
  j.s2 = S2[f2];
  j.out = resi + (size_t)pidx * H * W;
  j.cy = params[B + b];
  j.cx = params[2 * B + b];
  j.H = H;
  j.W = W;
  itx_block(rec::BlockGroup<kThreads>{(int)threadIdx.x},
            coeff + (size_t)b * width * height, j, dq, tmp);
}

// ---------------------------------------------------------------------------
// The picture kernel: every coded block, derived from the records
// ---------------------------------------------------------------------------

// the order of itx.itx_picture's config array
struct ItxCfg {
  int n, stride, ncoeff, bitdepth, no_dst, sx, sy, ncomp, H, W, Hc, Wc,
      qp_min, nqp;
};

// Work item -> block, as _build_itx_groups selects and parameterizes it;
// false for an item that is no coded block or fails a guard.
__device__ bool itx_item(const int32_t* __restrict__ recs, const ItxCfg& c,
                         int item, const int32_t* __restrict__ qp_scales,
                         const int32_t* __restrict__ mats,
                         const int32_t* __restrict__ info, int32_t* resi_l,
                         int32_t* resi_c, ItxJob& j, int& off) {
  const int ri = item / c.ncomp, comp = item - ri * c.ncomp;
  const int32_t* r = recs + (size_t)ri * c.stride;
  if (r[rec::kSplit] != 0 || r[rec::kCbf0 + comp] == 0) return false;
  off = r[rec::kCoeff0 + comp];
  const int csx = comp ? c.sx : 0, csy = comp ? c.sy : 0;
  const int w = r[rec::kW] >> csx, h = r[rec::kH] >> csy;
  const int wl2 = rec::log2_side(w, 2, 64), hl2 = rec::log2_side(h, 2, 64);
  if (off < 0 || wl2 < 0 || hl2 < 0 || off > c.ncoeff - w * h) return false;
  const int x = r[rec::kX] >> csx, y = r[rec::kY] >> csy;
  const int H = comp ? c.Hc : c.H, W = comp ? c.Wc : c.W;
  if (x < 0 || x >= W || y < 0 || y >= H) return false;
  const int qi = r[rec::kQp] - c.qp_min;
  if (qi < 0 || qi >= c.nqp) return false;
  const bool bias = ((wl2 + hl2) & 1) != 0;
  const int s = qp_scales[comp * c.nqp + qi];
  j.s = bias ? (int)((unsigned)s * 181u) : s;
  j.wide = c.bitdepth > 14;
  const int t0 = r[comp ? rec::kTt10 : rec::kTt00];
  const int t1 = r[comp ? rec::kTt11 : rec::kTt01];
  const int tshift = 15 - c.bitdepth - ((wl2 + hl2) >> 1);  // MAX_TR_DYNAMIC_RANGE
  j.width = w;
  j.height = h;
  j.dq_shift = 6 - tshift + (bias ? 8 : 0);
  j.aux_shift = 0;
  j.aux_scale = 1;
  j.mode = kMatrix;
  if (r[rec::kTskip0 + comp] != 0) {
    j.mode = kSkip;
    j.aux_shift = tshift + (bias ? 7 : 0);
    j.aux_scale = bias ? 181 : 1;
  } else if (comp == 0 && r[rec::kPred] == 0 && t0 == 0 && t1 == 0 &&
             w == 4 && h == 4 && !c.no_dst) {
    const int e = 6 * kNfam;  // the DST-4 row of the index
    j.m1 = j.m2 = mats + info[2 * e];
    j.s1 = info[2 * e + 1];
    j.s2 = 20 - c.bitdepth;
  } else {  // 'gen', DC-only blocks too; DEFAULT -> the DCT-2 family
    // above 14 bit a DC-only block of the DCT-2 family has a residual of
    // 0 (gpu/dsp.py dc_only_residual): no job, the plane stays 0
    if (c.bitdepth > 14 && r[rec::kDconly0 + comp] != 0 && t0 <= 1 &&
        t1 <= 1)
      return false;
    const int e1 = (hl2 - 1) * kNfam + clampi((t0 > 1 ? t0 : 1) - 1, 0, 4);
    const int e2 = (wl2 - 1) * kNfam + clampi((t1 > 1 ? t1 : 1) - 1, 0, 4);
    j.m1 = mats + info[2 * e1];
    j.s1 = info[2 * e1 + 1];
    j.m2 = mats + info[2 * e2];
    j.s2 = info[2 * e2 + 1] + 13 - c.bitdepth;
  }
  j.out = comp == 0 ? resi_l : resi_c + (size_t)(comp - 1) * H * W;
  j.cy = y;
  j.cx = x;
  j.H = H;
  j.W = W;
  return true;
}

__global__ void __launch_bounds__(kThreads)
itx_picture_kernel(const int32_t* __restrict__ recs,
                   const int32_t* __restrict__ coeff,
                   const int32_t* __restrict__ qp_scales,
                   const int32_t* __restrict__ mats,
                   const int32_t* __restrict__ info,
                   int32_t* __restrict__ resi_l,
                   int32_t* __restrict__ resi_c, ItxCfg c) {
  // a warp's slices, or the whole block's dq (32 x 32) + tmp (64 x 32)
  __shared__ int smem[kWarps * kSlice];
  static_assert(kZeroOut * kZeroOut + 64 * kZeroOut <= kWarps * kSlice,
                "a large block's buffers fit in the warps' slices");
  const int items = c.n * c.ncomp;
  ItxJob j;
  int off;
  // blocks larger than 16 on a side: the whole thread block each (the
  // test is uniform over the block, so are its syncs)
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    if (!itx_item(recs, c, it, qp_scales, mats, info, resi_l, resi_c, j,
                  off) ||
        (j.width <= kSmall && j.height <= kSmall))
      continue;
    itx_block(rec::BlockGroup<kThreads>{(int)threadIdx.x}, coeff + off, j,
              smem, smem + kZeroOut * kZeroOut);
  }
  __syncthreads();  // the warps' slices overlap the block's buffers
  // the others: a warp each
  const int warp = threadIdx.x >> 5;
  int* dq = smem + warp * kSlice;
  for (int it = blockIdx.x * kWarps + warp; it < items;
       it += gridDim.x * kWarps) {
    if (!itx_item(recs, c, it, qp_scales, mats, info, resi_l, resi_c, j,
                  off) ||
        j.width > kSmall || j.height > kSmall)
      continue;
    itx_block(rec::WarpGroup{(int)(threadIdx.x & 31)}, coeff + off, j, dq,
              dq + kSmall * kSmall);
  }
}

}  // namespace

extern "C" int xvc_itx_scatter(const void* coeff, const void* scale,
                               const void* params, int B, int prow,
                               int width, int height, int bitdepth,
                               int mode, int fam_rows, int dq_shift,
                               int aux_shift, int aux_scale, const void* M1,
                               const void* S1, const void* M2,
                               const void* S2, int nfam, void* resi,
                               int nplanes, int H, int W, void* stream) {
  if (B <= 0) return 0;
  if (width > 64 || height > 64 || (fam_rows && prow < 5) || prow < 3)
    return (int)cudaErrorInvalidValue;
  itx_scatter_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)coeff, (const int32_t*)scale, (const int32_t*)params,
      B, width, height, bitdepth, mode, fam_rows, dq_shift, aux_shift,
      aux_scale, (const int32_t*)M1, (const int32_t*)S1, (const int32_t*)M2,
      (const int32_t*)S2, nfam, (int32_t*)resi, nplanes, H, W);
  return (int)cudaGetLastError();
}

extern "C" int xvc_itx_picture(const void* recs, const void* coeff,
                               const void* qp_scales, const void* mats,
                               const void* info, void* resi_l, void* resi_c,
                               const void* cfg_host, int ncfg, void* stream) {
  ItxCfg c;
  if (ncfg != (int)(sizeof(c) / sizeof(int)))
    return (int)cudaErrorInvalidValue;
  memcpy(&c, cfg_host, sizeof(c));
  if (c.n <= 0) return 0;
  if (c.stride < rec::kMinCols || (c.ncomp != 1 && c.ncomp != 3) ||
      (c.ncomp == 3 && resi_c == nullptr) || c.ncoeff < 0 ||
      c.bitdepth < 8 || c.bitdepth > 15 || c.nqp <= 0 ||
      (long long)c.n * c.ncomp > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)c.n * c.ncomp + kWarps - 1) / kWarps;
  itx_picture_kernel<<<(int)(blocks < kMaxGrid ? blocks : kMaxGrid),
                       kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)recs, (const int32_t*)coeff,
      (const int32_t*)qp_scales, (const int32_t*)mats,
      (const int32_t*)info, (int32_t*)resi_l, (int32_t*)resi_c, c);
  return (int)cudaGetLastError();
}
