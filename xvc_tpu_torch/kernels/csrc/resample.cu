// Separable windowed-sinc picture rescale (decoder output resizing and
// cross-segment reference rescaling): every plane of a picture in one
// launch, both passes fused, the source read from the frame store.
//
// Replaces, on the GPU: xvc_tpu/tpu/resample_jax.py _resample_fn (an XLA
// stage: the polyphase filter of each axis materialised as a dense int32
// tap matrix, tmp = window @ Mh, out = Mv @ tmp, with the reference's
// shift and clip between the passes; ref: src/xvc_common_lib/
// resample.cc:786-852 resample::Resample), and the host work around it
// in the JAX package (the window cut from the host plane, its upload,
// one call and one download a plane).
//
// Not carried over from the TPU: the dense tap matrices.  They are at
// least 99% zeros (for 1920 -> 1280, 1,936 rows and 12 non-zero entries a
// column), the MXU made them cheap there, and CUDA has no int32 matrix
// product.  Here each output sample is the polyphase sum itself, at most
// 12 taps, read through a per-axis table (int32 [out, 1 + T]: the first
// window index of the output position's taps, then its T taps; built on
// the host from ops/resample._axis_taps and uploaded once per geometry):
//   horizontal pass over the window's rows [-8, src_h + 8):
//     tmp = clip((sum >> post_x) >> shift_hor, 0, 65535)
//   vertical pass:
//     out = clip((sum >> post_y) >> shift_ver, 0, (1 << dst_bd) - 1)
// T is 8 (upsampling), 1 (equal size) or 12 (the downsampling classes of
// get_filter_from_scale).  Sums are int32: the sum of |taps| of every
// filter times the largest sample stays below 2^31 in both passes up to
// 16 bit (tests/test_torch_resample.py proves it from the tables).  The
// shifts are arithmetic, as the reference's, and the clip comes after.
//
// What bounds it on an H100: bytes.  For 1080p -> 720p 4:2:0 at 8 bit the
// int16 windows (luma 1096 x 1936, chroma 2 x 556 x 976) are read once
// and the uint8 output (1280 x 720 x 1.5) written once: 7.8 MB, 2.3 us at
// 3.35 TB/s, against 12 x (1096 x 1280 + 720 x 1280) x 1.5 = 42 M integer
// multiply-adds (1.3 us at the CUDA cores' rate).  The first version (two
// launches a plane) also wrote the [win_h, dst_w] int32 intermediate to
// device memory and read it back, and read and wrote int32 samples.
//
// Design: one launch for up to three planes, each described by a plane
// descriptor (source pointer, row stride and window origin: the picture's
// int16 frame-store slot, or a window on the card; the two axis tables;
// the shifts; the output pointer, row stride and element size).  A block
// owns an output tile of one plane.  The axis tables' first window index
// is monotone in the output position, so the tile's rows and columns
// need a contiguous span of window rows and columns: the block copies that
// span into shared memory with cp.async (4-byte words; row strides are
// even and bases 4-byte aligned, so a row's span is whole words from the
// word that holds its first sample) in four groups of rows, runs the
// horizontal pass over each group as soon as it has landed (the later
// groups still in flight) into an intermediate in shared memory (uint16:
// the pass clips to 0..65535), then the vertical pass out of it, and
// writes each output sample once: uint8 or 16-bit straight into the
// packed output bytes, int16 into a store slot.  The table rows are
// padded to 16 bytes, so that a row is four or fewer vector loads.
// Tiles recompute the horizontal rows of their halo (the taps that reach
// into the next tile); the host sizes the tile (at most 64 x 64 outputs,
// shrunk until the largest span fits its shared-memory budget), so every
// ratio runs.  The output plane may be larger than the rescaled plane:
// position (y, x) takes the rescaled sample at (clamp(y - off_y),
// clamp(x - off_x)), the store's edge replication of an alternative
// reconstruction in the same pass (clamping is monotone, so a tile still
// needs a contiguous span).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPlanes = 3;
// the span's rows are copied in this many groups (see hor_pass)
constexpr int kChunks = 4;
// int64 fields of one plane descriptor in the host array (see Plane)
constexpr int kFields = 26;
constexpr int kMaxSmem = 232448;

struct Plane {
  const uint16_t* src;  // window sample (0, 0) at src[y0 * stride + x0]
  long long src_stride;  // elements, even
  int y0, x0;
  const int32_t* tab_x;  // [dst_w, (tx + 4) & ~3]: first index, taps, 0s
  const int32_t* tab_y;  // [dst_h, (ty + 4) & ~3]
  int tx, ty, post_x, post_y, shift_hor, shift_ver, maxv;
  int dst_w, dst_h;
  void* out;
  long long out_stride;  // elements
  int esize;  // 1, 2 or 4 bytes
  int out_w, out_h, off_x, off_y;
  int tile_w, tile_h;  // tile_w 64, 8 or 1
  int rows_cap, pitch_words;  // the shared-memory span's capacity
  int tiles_x, block0;  // set by the entry point
};

struct Params {
  Plane p[kMaxPlanes];
  int n;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most ``pending`` (0 to kChunks - 1) groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 3)
    asm volatile("cp.async.wait_group 3;\n" ::);
  else if (pending == 2)
    asm volatile("cp.async.wait_group 2;\n" ::);
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else
    asm volatile("cp.async.wait_group 0;\n" ::);
}

// int32 words of a table row of T taps: the first window index, the
// taps, padded to 16 bytes
template <int T>
__host__ __device__ constexpr int row_words() {
  return (T + 4) & ~3;
}

template <int T>
__device__ __forceinline__ void load_row(const int32_t* tab, int i,
                                         int (&v)[row_words<T>()]) {
  const int4* r = (const int4*)(tab + (size_t)i * row_words<T>());
#pragma unroll
  for (int q = 0; q < row_words<T>() / 4; ++q) {
    const int4 w = __ldg(r + q);
    v[4 * q] = w.x;
    v[4 * q + 1] = w.y;
    v[4 * q + 2] = w.z;
    v[4 * q + 3] = w.w;
  }
}

// The span's rows arrive in kChunks groups (``chunk`` rows each); the
// horizontal pass runs over each group as soon as it has landed, while
// the later ones are still on their way.  Rows r of the span (window
// rows ry0 + r), columns vx0 + j of the rescaled plane for j < nvx:
// tmp[r * TW + j].
template <int T, int TW>
__device__ void hor_pass(const Plane& P, const uint16_t* span, int pitch,
                         int shift, int nrows, int chunk, int vx0, int nvx,
                         uint16_t* tmp) {
  const int j = threadIdx.x % TW;
  const bool active = j < nvx;
  int v[row_words<T>()] = {};
  if (active) load_row<T>(P.tab_x, vx0 + j, v);
  const int c = v[0] - shift;
  for (int q = 0; q < kChunks; ++q) {
    cp_async_wait(kChunks - 1 - q);
    __syncthreads();
    const int r_end = min(nrows, (q + 1) * chunk);
    if (!active) continue;
    for (int r = q * chunk + threadIdx.x / TW; r < r_end;
         r += kThreads / TW) {
      const uint16_t* s = span + r * pitch + c;
      int sum = 0;
#pragma unroll
      for (int k = 0; k < T; ++k) sum += (int)s[k] * v[1 + k];
      sum = (sum >> P.post_x) >> P.shift_hor;
      tmp[r * TW + j] = (uint16_t)clampi(sum, 0, 65535);
    }
  }
}

__device__ __forceinline__ void store(const Plane& P, int y, int x, int v) {
  const size_t at = (size_t)y * P.out_stride + x;
  if (P.esize == 1)
    ((uint8_t*)P.out)[at] = (uint8_t)v;
  else if (P.esize == 2)
    ((uint16_t*)P.out)[at] = (uint16_t)v;
  else
    ((int32_t*)P.out)[at] = v;
}

// output rows oy0 + r (r < ny), columns ox0 + i (i < nx)
template <int T, int TW>
__device__ void ver_pass(const Plane& P, const uint16_t* tmp, int ry0,
                         int vx0, int oy0, int ox0, int ny, int nx) {
  const int i = threadIdx.x % TW;
  if (i >= nx) return;
  const int ox = ox0 + i;
  const int j = clampi(ox - P.off_x, 0, P.dst_w - 1) - vx0;
  for (int r = threadIdx.x / TW; r < ny; r += kThreads / TW) {
    const int oy = oy0 + r;
    int v[row_words<T>()];
    load_row<T>(P.tab_y, clampi(oy - P.off_y, 0, P.dst_h - 1), v);
    const uint16_t* s = tmp + (v[0] - ry0) * TW + j;
    int sum = 0;
#pragma unroll
    for (int k = 0; k < T; ++k) sum += (int)s[k * TW] * v[1 + k];
    sum = (sum >> P.post_y) >> P.shift_ver;
    store(P, oy, ox, clampi(sum, 0, P.maxv));
  }
}

// both passes of a tile TW columns wide (the tap counts picked at run
// time, the width at compile time: the passes' strides are immediates)
template <int TW>
__device__ void passes(const Plane& P, const uint16_t* span, int pitch,
                       int shift, int nrows, int chunk, int ry0, int vx0,
                       int nvx, int oy0, int ox0, int ny, int nx,
                       uint16_t* tmp) {
  if (P.tx == 12)
    hor_pass<12, TW>(P, span, pitch, shift, nrows, chunk, vx0, nvx, tmp);
  else if (P.tx == 8)
    hor_pass<8, TW>(P, span, pitch, shift, nrows, chunk, vx0, nvx, tmp);
  else
    hor_pass<1, TW>(P, span, pitch, shift, nrows, chunk, vx0, nvx, tmp);
  __syncthreads();
  if (P.ty == 12)
    ver_pass<12, TW>(P, tmp, ry0, vx0, oy0, ox0, ny, nx);
  else if (P.ty == 8)
    ver_pass<8, TW>(P, tmp, ry0, vx0, oy0, ox0, ny, nx);
  else
    ver_pass<1, TW>(P, tmp, ry0, vx0, oy0, ox0, ny, nx);
}

__device__ __forceinline__ int first_of(const int32_t* tab, int t, int i) {
  return __ldg(tab + (size_t)i * ((t + 4) & ~3));
}

__global__ void __launch_bounds__(kThreads)
    resample_picture(const __grid_constant__ Params prm) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the block's plane, copied out of the parameters with fixed indices
  // (a reference with a block-dependent index would be a generic pointer
  // that the compiler must reload after every store)
  const int bx = (int)blockIdx.x;
  const Plane P = prm.n > 2 && bx >= prm.p[2].block0 ? prm.p[2]
                  : prm.n > 1 && bx >= prm.p[1].block0 ? prm.p[1]
                                                       : prm.p[0];
  const int b = bx - P.block0;
  const int oy0 = (b / P.tiles_x) * P.tile_h;
  const int ox0 = (b % P.tiles_x) * P.tile_w;
  const int ny = min(P.tile_h, P.out_h - oy0);
  const int nx = min(P.tile_w, P.out_w - ox0);
  // the rescaled rows and columns the tile shows (a contiguous range)
  const int vy0 = clampi(oy0 - P.off_y, 0, P.dst_h - 1);
  const int vy1 = clampi(oy0 + ny - 1 - P.off_y, 0, P.dst_h - 1);
  const int vx0 = clampi(ox0 - P.off_x, 0, P.dst_w - 1);
  const int vx1 = clampi(ox0 + nx - 1 - P.off_x, 0, P.dst_w - 1);
  // and the span of window rows and columns their taps read
  const int ry0 = first_of(P.tab_y, P.ty, vy0);
  const int nrows = first_of(P.tab_y, P.ty, vy1) + P.ty - ry0;
  const int cx0 = first_of(P.tab_x, P.tx, vx0);
  const int cx1 = first_of(P.tab_x, P.tx, vx1) + P.tx;
  const int e0 = P.x0 + cx0;  // the span's first sample in its source row
  const int w0 = e0 >> 1;
  const int nwords = ((P.x0 + cx1 - 1) >> 1) - w0 + 1;
  // never taken: the host sizes rows_cap and pitch_words from the tables
  if (nrows > P.rows_cap || nwords > P.pitch_words) return;
  uint32_t* span = (uint32_t*)smem;
  uint16_t* tmp = (uint16_t*)(smem + (size_t)P.rows_cap * P.pitch_words * 4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunk = (nrows + kChunks - 1) / kChunks;
  for (int q = 0; q < kChunks; ++q) {
    const int r_end = min(nrows, (q + 1) * chunk);
    for (int r = q * chunk + warp; r < r_end; r += kThreads / 32) {
      const uint32_t* g = (const uint32_t*)(
          P.src + (size_t)(P.y0 + ry0 + r) * P.src_stride) + w0;
      uint32_t* s = span + r * P.pitch_words;
      for (int w = lane; w < nwords; w += 32) cp_async4(s + w, g + w);
    }
    cp_async_commit();
  }
  // window column cx lies at span column cx - cx0 + (e0 & 1)
  const uint16_t* span16 = (const uint16_t*)span;
  const int pitch = 2 * P.pitch_words;
  const int shift = cx0 - (e0 & 1);
  const int nvx = vx1 - vx0 + 1;
  if (P.tile_w == 64)
    passes<64>(P, span16, pitch, shift, nrows, chunk, ry0, vx0, nvx, oy0,
               ox0, ny, nx, tmp);
  else if (P.tile_w == 8)
    passes<8>(P, span16, pitch, shift, nrows, chunk, ry0, vx0, nvx, oy0,
              ox0, ny, nx, tmp);
  else
    passes<1>(P, span16, pitch, shift, nrows, chunk, ry0, vx0, nvx, oy0,
              ox0, ny, nx, tmp);
}

bool taps_ok(int t) { return t == 1 || t == 8 || t == 12; }

}  // namespace

// desc: n (1-3) plane descriptors of kFields int64 each, in Plane's order
// from src to pitch_words: src pointer, src row stride (elements, even),
// window origin y0, x0 in the source; tab_x, tab_y pointers (16-byte
// aligned, [dst_w] and [dst_h] rows of (T + 4) & ~3 int32: the first
// window index, the T taps, zeros; every window index they give checked
// by the caller), tx, ty, post_x, post_y, shift_hor, shift_ver, maxv,
// dst_w, dst_h; out pointer, out row stride (elements), element size (1,
// 2, 4), out_w, out_h, off_x, off_y; tile_w, tile_h, rows_cap and
// pitch_words (the shared-memory span's rows and 4-byte words a row, the
// intermediate taking rows_cap x tile_w uint16 after it; at most smem
// bytes in all).  Enqueues one launch for every tile of every plane.
extern "C" int xvc_resample_picture(const long long* desc, int n, int smem,
                                    void* stream) {
  if (n < 1 || n > kMaxPlanes || smem <= 0 || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  Params prm;
  prm.n = n;
  long long blocks = 0;
  for (int i = 0; i < n; ++i) {
    const long long* d = desc + (size_t)i * kFields;
    Plane& P = prm.p[i];
    P.src = (const uint16_t*)(uintptr_t)d[0];
    P.src_stride = d[1];
    P.y0 = (int)d[2];
    P.x0 = (int)d[3];
    P.tab_x = (const int32_t*)(uintptr_t)d[4];
    P.tab_y = (const int32_t*)(uintptr_t)d[5];
    P.tx = (int)d[6];
    P.ty = (int)d[7];
    P.post_x = (int)d[8];
    P.post_y = (int)d[9];
    P.shift_hor = (int)d[10];
    P.shift_ver = (int)d[11];
    P.maxv = (int)d[12];
    P.dst_w = (int)d[13];
    P.dst_h = (int)d[14];
    P.out = (void*)(uintptr_t)d[15];
    P.out_stride = d[16];
    P.esize = (int)d[17];
    P.out_w = (int)d[18];
    P.out_h = (int)d[19];
    P.off_x = (int)d[20];
    P.off_y = (int)d[21];
    P.tile_w = (int)d[22];
    P.tile_h = (int)d[23];
    P.rows_cap = (int)d[24];
    P.pitch_words = (int)d[25];
    const long long need =
        4LL * P.rows_cap * P.pitch_words + 2LL * P.rows_cap * P.tile_w;
    if (!P.src || (d[0] & 3) || (d[4] & 15) || (d[5] & 15) ||
        P.src_stride <= 0 || (P.src_stride & 1) ||
        P.y0 < 0 || P.x0 < 0 || !taps_ok(P.tx) || !taps_ok(P.ty) ||
        P.post_x < 0 || P.post_x > 1 || P.post_y < 0 || P.post_y > 1 ||
        P.shift_hor < 0 || P.shift_hor > 31 || P.shift_ver < 0 ||
        P.shift_ver > 31 || P.maxv < 0 || P.maxv > 65535 || P.dst_w <= 0 ||
        P.dst_h <= 0 || !P.out ||
        (P.esize != 1 && P.esize != 2 && P.esize != 4) ||
        (d[15] % P.esize) || P.out_stride < P.out_w || P.out_w <= 0 ||
        P.out_h <= 0 ||
        (P.tile_w != 64 && P.tile_w != 8 && P.tile_w != 1) || P.tile_h <= 0 ||
        P.rows_cap <= 0 || P.pitch_words <= 0 || need > smem)
      return (int)cudaErrorInvalidValue;
    P.tiles_x = (P.out_w + P.tile_w - 1) / P.tile_w;
    P.block0 = (int)blocks;
    blocks += (long long)P.tiles_x * ((P.out_h + P.tile_h - 1) / P.tile_h);
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        resample_picture, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  resample_picture<<<(unsigned)blocks, kThreads, smem,
                      (cudaStream_t)stream>>>(prm);
  return (int)cudaGetLastError();
}
