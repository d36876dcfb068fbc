// Transform-RD intra prepass of the encoder: from the SATD screen to the
// kept modes, one launch per block size.
//
// Replaces, on the GPU: xvc_tpu/tpu/txrd_prepass.py _txrd_step (:80)
// after its SATD (:103-144), which XLA runs as one jitted program: the
// 8-candidate screen (lax.top_k of -satd), the gather of the 8 picked
// predictions, the residual, the forward transform as two float32
// einsums with a floor shift after each, and the ranking.  For each block
// b (orig [B, n, n], preds [B, M, n, n], satd [B, M], all int32):
//   cand  = the 8 modes of least satd[b], ties to the lower index, in
//           that order (lax.top_k's)
//   r     = orig[b] - preds[b, cand[j]]                 (j = 0..7)
//   t1    = floor((f32(r . basis^T) + 2^(s1-1)) * 2^-s1)   row pass
//   c     = floor((f32(basis . t1) + 2^(s2-1)) * 2^-s2)    column pass
//   level = min(floor(f32(|c| * scale + offset) * 2^-shift), 32767)
//   ch    = min(floor(level * inv_scale * 2^-inv_shift + 0.5), 32767)
//   dist  = f32(sum (|c| - ch)^2) * inv_gain
//   bits  = f32(sum over level > 0 of (1.5 + 2 * log2(level + 1)))
//   cost  = f32(dist + lam * bits)
// then keeps the `keep` candidates of lowest cost, lower candidate first
// on ties, as true mode numbers (cand < 2: cand, else (cand - 2) *
// screen_step + 2).  Output [B, keep] int32.
//
// Exactness: the plain version (gpu/txrd_prepass.py txrd_plain: a stable
// sort, a gather, a float64 transform and txrd_rank_plain) gives the same
// result bit for bit.
// - Each dot product of the transform is an exact integer sum in int32
//   (the wrapper refuses bit depths where a sum could pass 2^31;
//   txrd_prepass.exact_sum_bounds) and is rounded once to float32 with
//   __int2float_rn: the plain version's exact float64 product rounded to
//   float32.  The floor shifts are float32, __fadd_rn / __fmul_rn.  Where
//   the wrapper's bounds show that every sum of a pass plus its rounding
//   offset stays below 2^24 (txrd_prepass.integer_shifts: both passes at
//   n = 4, which the wrapper requires, so up to 16 bit there; pass 1 up
//   to 11 bit at n = 32, kInt1), float32 holds it exactly and the floor
//   shift is the integer (s + 2^(sh-1)) >> sh.
// - Sum (|c| - ch)^2 is an int64 sum of exact integer squares, and the
//   bit sum an int64 sum in fixed point at 2^-22: every term is a float32
//   in [3.5, 31.5], hence a multiple of 2^-22.  Both equal the plain
//   version's float64 sums exactly, whatever the order, and are rounded
//   once to float32 (__ll2float_rn, then an exact power-of-two scale).
// - log2(level + 1) comes from a table of the float64 log2 rounded to
//   float32, built once on the host, which equals torch.log2 of float64 on
//   the CPU and on the card at every level the clamp allows.
// - The two products XLA's CPU backend contracts into an FMA (|c| * scale
//   + offset, lam * bits + dist) are formed in float64, where the product
//   is exact, and rounded once to float32, as the plain version does.  All
//   other float32 arithmetic is written with __fmul_rn / __fadd_rn, so
//   nvcc contracts nothing.  The powers of two are the JAX package's XLA
//   CPU values, from the host (txrd_prepass.xla_exp2).
// - Ties: the screen takes the least (satd, mode) and the pick the least
//   (cost, candidate): a strict order, lower index first, as the stable
//   sort and lax.top_k.
//
// What bounds it on this card, and what the design does about it.  The
// bytes are the 8 picked n x n tiles of preds, orig and satd, read once
// (33-49 MB for one 720p picture at each size); the operations are the
// transform's multiply-adds (2n per coefficient counted) and some 20 more
// per coefficient for the floor shifts and the ranking.  At n = 4 the
// bytes bound, at n = 32 the multiply-adds.  Beside them the card's
// issue slots go to what a coefficient needs besides: conversions (a
// sixteenth of a warp per clock on an SM, an eighth of the float32 rate)
// are kept to one or two per coefficient (the integer floor shifts
// above; |c| reaches float32 and float64 by adding 1.5 * 2^23 and 2^52),
// and the screen's eight rounds of a group minimum are 32-bit.
// - n = 4 (txrd4): one thread per (block, candidate), the 4x4 tile, the
//   basis and both passes in registers.  An 8-lane group holds a block and
//   screens its M SATDs (9 per lane) by eight rounds of a group minimum
//   over shuffles; the pick is keep rounds of the same.  No shared memory.
// - n = 8, 16, 32 (txrd_rows<N>): a group of N lanes per candidate, one
//   row (then one column) per lane; a CTA of 256 threads holds 4, 2 or 1
//   blocks.  One warp per block screens its SATDs (3 per lane; a round is
//   two warp reductions, redux.sync) into shared memory while the others
//   load the basis.  Each group loads its residual tile coalesced into
//   shared memory (pitch N + 1: no bank conflicts along rows or columns),
//   each lane takes its row into registers for the row pass, writes t1
//   back into the tile, and takes its column for the column pass; the
//   basis sits in shared memory and is read as 16-byte broadcasts.  The
//   DCT-2 rows are even or odd (m[k][N-1-j] = (-1)^k m[k][j], which the
//   wrapper checks), so each pass forms the sums and differences of
//   mirrored entries first and needs N / 2 multiply-adds an output, not
//   N: the same integer sums.  At n = 32 the CTA is one block, 8 warps,
//   32 KB of tiles: 880 CTAs for a 720p picture fill the 132 SMs.
// - The transform runs on the CUDA cores in int32.  int8 IMMA cannot hold
//   the basis (values up to 362) or a 10-bit residual; FP64 DMMA would be
//   exact but is not needed.  The basis stays in shared memory: read from
//   constant memory as operands of the multiply-adds, it let ptxas keep
//   110-255 registers at n = 16 and 32 (spilling at 32), and those sizes
//   ran slower (PERF.md, the kernel table).
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCand = 8;        // SATD_KEEP
constexpr int kMaxModes = 67;   // planar, DC and 65 angular modes
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoMode = INT_MAX;

struct Params {
  double scale, offset, lam;  // float32 values, for the float64 products
  float p_shift, inv_scale, p_inv, inv_gain;
  float add1, inv1, add2, inv2;  // the floor shifts: 2^(s-1), 2^-s
  int iadd1, shift1, iadd2, shift2;
  int modes, keep, screen_step;
};

// An integer-valued float32 of magnitude below 2^22 as an int, and back,
// exactly: 1.5 * 2^23 puts it in the mantissa.
__device__ __forceinline__ int small_f2i(float x) {
  return __float_as_int(__fadd_rn(x, 12582912.0f)) - 0x4B400000;
}
__device__ __forceinline__ float small_i2f(int x) {
  return __fsub_rn(__int_as_float(x + 0x4B400000), 12582912.0f);
}
// 0 <= x < 2^31 as a double, exactly: 2^52 puts it in the mantissa.
__device__ __forceinline__ double u31_to_double(int x) {
  return __dsub_rn(__hiloint2double(0x43300000, x), 4503599627370496.0);
}

// One floor shift of the transform: floor((f32(s) + 2^(sh-1)) * 2^-sh).
template <bool kInt>
__device__ __forceinline__ int floor_shift(int s, int iadd, int sh,
                                           float add, float inv) {
  if (kInt) return (s + iadd) >> sh;  // |s| + iadd < 2^24: all exact
  return small_f2i(
      floorf(__fmul_rn(__fadd_rn(__int2float_rn(s), add), inv)));
}

template <int G>
__device__ __forceinline__ int group_min(int v) {
  if (G == 32) return __reduce_min_sync(kFull, v);
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(kFull, v, off, G));
  return v;
}

// The screen: the candidate `want` (0..7) of the block whose SATD row is
// `satd`, i.e. the mode of rank `want` in the (satd, mode) order.  A group
// of G aligned lanes of a full warp calls it together; lane g of the
// group holds modes g, g + G, ...  Each round takes the least satd of the
// group, then the least mode that has it.
template <int G>
__device__ __forceinline__ int screen(const int32_t* __restrict__ satd,
                                      int modes, int g, int want) {
  constexpr int kSlots = (kMaxModes + G - 1) / G;
  int sat[kSlots];
  unsigned live = 0;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int i = g + s * G;
    sat[s] = i < modes ? __ldg(satd + i) : 0;
    live |= (i < modes ? 1u : 0u) << s;
  }
  int mine = 0;
#pragma unroll
  for (int j = 0; j < kCand; ++j) {
    // this lane's least (satd, mode): its modes ascend with the slot
    int best = INT_MAX, mode = kNoMode;
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      if ((live >> s & 1u) && (mode == kNoMode || sat[s] < best))
        best = sat[s], mode = g + s * G;
    const int v = group_min<G>(mode == kNoMode ? INT_MAX : best);
    const int w = group_min<G>(mode != kNoMode && best == v ? mode : kNoMode);
    if (w % G == g) live &= ~(1u << (w / G));
    if (j == want) mine = w;
  }
  return mine;
}

// One coefficient's share of the two sums, from its column-pass sum.
template <bool kInt2>
__device__ __forceinline__ void rank_coeff(int s2, const Params& p,
                                           const float* __restrict__ lg2,
                                           long long& err, long long& bits) {
  const int ai = abs(floor_shift<kInt2>(s2, p.iadd2, p.shift2, p.add2,
                                        p.inv2));
  const float a = small_i2f(ai);
  // |c| * scale + offset with one rounding (XLA's FMA)
  const float u = __double2float_rn(
      __dadd_rn(__dmul_rn(u31_to_double(ai), p.scale), p.offset));
  const float level = fminf(floorf(__fmul_rn(u, p.p_shift)), 32767.0f);
  const float ch = fminf(
      floorf(__fadd_rn(__fmul_rn(__fmul_rn(level, p.inv_scale), p.p_inv),
                       0.5f)),
      32767.0f);
  const int e = small_f2i(__fsub_rn(a, ch));
  err += (long long)e * e;
  if (level > 0.0f) {
    const float term =
        __fadd_rn(1.5f, __fmul_rn(2.0f, __ldg(lg2 + small_f2i(level))));
    bits += __float2int_rn(__fmul_rn(term, 4194304.0f));  // * 2^22, exact
  }
}

// cost = f32(dist + lam * bits) from the two exact sums.
__device__ __forceinline__ float cost_of(long long err, long long bits,
                                         const Params& p) {
  const float dist = __fmul_rn(__ll2float_rn(err), p.inv_gain);
  const float b = __fmul_rn(__ll2float_rn(bits), 2.384185791015625e-07f);
  // dist + lam * bits with one rounding (XLA's FMA)
  return __double2float_rn(__dadd_rn(__dmul_rn(p.lam, (double)b),
                                     (double)dist));
}

__device__ __forceinline__ int true_mode(int cand, int screen_step) {
  return cand < 2 ? cand : (cand - 2) * screen_step + 2;
}

__global__ void __launch_bounds__(kThreads)
    txrd4(const int32_t* __restrict__ orig, const int32_t* __restrict__ preds,
          const int32_t* __restrict__ satd, const int32_t* __restrict__ basis,
          const float* __restrict__ lg2, long long nblocks, Params p,
          int32_t* __restrict__ out) {
  const long long raw = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 3;
  const int j = threadIdx.x & 7;
  const bool live = raw < nblocks;
  // lanes past the last block compute on it too (every shuffle needs the
  // full warp) and store nothing
  const long long b = live ? raw : nblocks - 1;
  const int cand = screen<8>(satd + b * p.modes, p.modes, j, j);

  int m[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(basis) + k);
    m[k][0] = v.x, m[k][1] = v.y, m[k][2] = v.z, m[k][3] = v.w;
  }
  const int4* o = reinterpret_cast<const int4*>(orig + b * 16);
  const int4* q = reinterpret_cast<const int4*>(
      preds + (b * p.modes + cand) * 16);
  int t1[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int4 ov = __ldg(o + i), qv = __ldg(q + i);
    const int r[4] = {ov.x - qv.x, ov.y - qv.y, ov.z - qv.z, ov.w - qv.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int s = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) s += r[c] * m[k][c];
      t1[i][k] = floor_shift<true>(s, p.iadd1, p.shift1, p.add1, p.inv1);
    }
  }
  long long err = 0, bits = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      int s = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) s += m[k][i] * t1[i][c];
      rank_coeff<true>(s, p, lg2, err, bits);
    }
  }
  // keep rounds of the group minimum of (cost, candidate); cost >= 0, so
  // its bits order as the float (+ 0.0f folds a -0 into +0)
  int key = __float_as_int(__fadd_rn(cost_of(err, bits, p), 0.0f));
  for (int k = 0; k < p.keep; ++k) {
    const int v = group_min<8>(key);
    const int w = group_min<8>(key == v ? j : kCand);
    const int mode = __shfl_sync(kFull, cand, w, 8);
    if (j == w) key = INT_MAX;  // above every cost's bits
    if (live && j == k) out[b * p.keep + k] = true_mode(mode, p.screen_step);
  }
}

// One pass of the even-odd DCT-2 for the lane's vector v (a row, then a
// column): sink(k, sum_i m[k][i] * v[i]) for every k, from the first half
// of each basis row and the sums (even k) or differences (odd k) of
// mirrored entries of v.
template <int N, typename Sink>
__device__ __forceinline__ void even_odd_pass(const int (&v)[N],
                                              const int4* basis_s,
                                              Sink sink) {
  int e[N / 2], d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    e[i] = v[i] + v[N - 1 - i];
    d[i] = v[i] - v[N - 1 - i];
  }
#pragma unroll
  for (int k = 0; k < N; k += 2) {
    int s = 0, u = 0;
#pragma unroll
    for (int i = 0; i < N / 2; i += 4) {
      const int4 m = basis_s[(k * N + i) / 4];
      const int4 n = basis_s[((k + 1) * N + i) / 4];
      s += m.x * e[i] + m.y * e[i + 1] + m.z * e[i + 2] + m.w * e[i + 3];
      u += n.x * d[i] + n.y * d[i + 1] + n.z * d[i + 2] + n.w * d[i + 3];
    }
    sink(k, s);
    sink(k + 1, u);
  }
}

template <int N, bool kInt1>
__global__ void __launch_bounds__(kThreads)
    txrd_rows(const int32_t* __restrict__ orig,
              const int32_t* __restrict__ preds,
              const int32_t* __restrict__ satd,
              const int32_t* __restrict__ basis,
              const float* __restrict__ lg2, long long nblocks, Params p,
              int32_t* __restrict__ out) {
  constexpr int kPerBlock = N * kCand;          // threads of one block
  constexpr int kBlocks = kThreads / kPerBlock;  // blocks of one CTA
  constexpr int kPitch = N + 1;
  constexpr int kVec = N * N / 4;                // int4 of one tile
  __shared__ int tile[kBlocks][kCand][N][kPitch];
  __shared__ int4 basis_s[kVec];
  __shared__ float cost_s[kBlocks][kCand];
  __shared__ int cand_s[kBlocks][kCand];

  const int tid = threadIdx.x;
  const int slot = tid / kPerBlock;
  const int j = tid % kPerBlock / N;  // candidate of the group
  const int l = tid % N;              // lane of the group: row, then column
  const long long first = (long long)blockIdx.x * kBlocks;
  const bool live = first + slot < nblocks;
  const long long b = live ? first + slot : nblocks - 1;

  // warp w < kBlocks screens block w of the CTA, the others load the basis
  const int warp = tid >> 5;
  if (warp < kBlocks) {
    const long long sb = min(first + warp, nblocks - 1);
    const int c = screen<32>(satd + sb * p.modes, p.modes, tid & 31,
                             tid & 7);
    if ((tid & 31) < kCand) cand_s[warp][tid & 31] = c;
  } else {
    for (int x = tid - kBlocks * 32; x < kVec; x += kThreads - kBlocks * 32)
      basis_s[x] = __ldg(reinterpret_cast<const int4*>(basis) + x);
  }
  __syncthreads();
  const int cand = cand_s[slot][j];

  // the residual tile, loaded by the group in 16-byte pieces
  int(*t)[kPitch] = tile[slot][j];
  {
    const int4* o = reinterpret_cast<const int4*>(orig + b * N * N);
    const int4* q = reinterpret_cast<const int4*>(
        preds + (b * p.modes + cand) * N * N);
#pragma unroll
    for (int s = 0; s < N / 4; ++s) {
      const int x = l + s * N;
      const int4 ov = __ldg(o + x), qv = __ldg(q + x);
      const int row = x * 4 / N, col = x * 4 % N;
      t[row][col] = ov.x - qv.x;
      t[row][col + 1] = ov.y - qv.y;
      t[row][col + 2] = ov.z - qv.z;
      t[row][col + 3] = ov.w - qv.w;
    }
  }
  __syncwarp();  // the group lies inside one warp

  int v[N];
#pragma unroll
  for (int c = 0; c < N; ++c) v[c] = t[l][c];
  even_odd_pass<N>(v, basis_s, [&](int k, int s) {
    t[l][k] = floor_shift<kInt1>(s, p.iadd1, p.shift1, p.add1, p.inv1);
  });
  __syncwarp();

#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = t[i][l];
  long long err = 0, bits = 0;
  even_odd_pass<N>(v, basis_s, [&](int, int s) {
    rank_coeff<false>(s, p, lg2, err, bits);
  });
#pragma unroll
  for (int off = N / 2; off > 0; off >>= 1) {
    err += __shfl_xor_sync(kFull, err, off, N);
    bits += __shfl_xor_sync(kFull, bits, off, N);
  }
  if (l == 0) cost_s[slot][j] = cost_of(err, bits, p);
  __syncthreads();
  if (!live || tid % kPerBlock != 0) return;
  const float* cost = cost_s[slot];
  unsigned taken = 0;
  for (int k = 0; k < p.keep; ++k) {
    int best = -1;
#pragma unroll
    for (int c = 0; c < kCand; ++c)
      if (!(taken >> c & 1u) && (best < 0 || cost[c] < cost[best])) best = c;
    taken |= 1u << best;
    out[b * p.keep + k] = true_mode(cand_s[slot][best], p.screen_step);
  }
}

struct Args {
  const int32_t *orig, *preds, *satd, *basis;
  const float* lg2;
  long long nblocks;
  Params p;
  int32_t* out;
  cudaStream_t stream;
};

void launch4(const Args& a) {
  txrd4<<<(unsigned)((a.nblocks * kCand + kThreads - 1) / kThreads), kThreads,
         0, a.stream>>>(a.orig, a.preds, a.satd, a.basis, a.lg2, a.nblocks,
                        a.p, a.out);
}

template <int N, bool kInt1>
void launch_rows(const Args& a) {
  constexpr long long per = kThreads / (N * kCand);
  txrd_rows<N, kInt1>
      <<<(unsigned)((a.nblocks + per - 1) / per), kThreads, 0, a.stream>>>(
          a.orig, a.preds, a.satd, a.basis, a.lg2, a.nblocks, a.p, a.out);
}

template <int N>
void launch_rows_for(const Args& a, bool int1) {
  int1 ? launch_rows<N, true>(a) : launch_rows<N, false>(a);
}

}  // namespace

// orig [B, n, n], preds [B, modes, n, n], satd [B, modes], basis [n, n]
// (int32, 16-byte aligned, contiguous; at n >= 8 a DCT-2 basis, every row
// even or odd), lg2 [32768] float32 (log2(i + 1)); out [B, keep] int32.
// int1 / int2: the sums of pass 1 / 2 plus 2^(shift-1) stay below 2^24
// (at n = 4 both must).
// Enqueues one kernel on `stream`.
extern "C" int xvc_txrd(const void* orig, const void* preds, const void* satd,
                        const void* basis, const void* lg2, long long nblocks,
                        int modes, int n, int keep, int screen_step,
                        int shift1, int shift2, int int1, int int2,
                        float scale, float offset, float p_shift,
                        float inv_scale, float p_inv, float inv_gain,
                        float lam, void* out, void* stream) {
  if (nblocks <= 0) return 0;
  if ((n != 4 && n != 8 && n != 16 && n != 32) || modes < kCand ||
      modes > kMaxModes || keep < 1 || keep > kCand || screen_step < 1 ||
      shift1 < 1 || shift1 > 30 || shift2 < 1 || shift2 > 30 ||
      nblocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Args a{(const int32_t*)orig, (const int32_t*)preds,
               (const int32_t*)satd, (const int32_t*)basis,
               (const float*)lg2, nblocks,
               Params{scale, offset, lam, p_shift, inv_scale, p_inv,
                      inv_gain, ldexpf(1.0f, shift1 - 1),
                      ldexpf(1.0f, -shift1), ldexpf(1.0f, shift2 - 1),
                      ldexpf(1.0f, -shift2), 1 << (shift1 - 1), shift1,
                      1 << (shift2 - 1), shift2, modes, keep, screen_step},
               (int32_t*)out, (cudaStream_t)stream};
  switch (n) {
    case 4:
      if (!int1 || !int2) return (int)cudaErrorInvalidValue;
      launch4(a);
      break;
    case 8:
      launch_rows_for<8>(a, int1);
      break;
    case 16:
      launch_rows_for<16>(a, int1);
      break;
    default:
      launch_rows_for<32>(a, int1);
  }
  return (int)cudaGetLastError();
}
