// Separable windowed-sinc picture rescale (decoder output resizing and
// cross-segment reference rescaling).
//
// Replaces, on the GPU: xvc_tpu/tpu/resample_jax.py _resample_fn (an XLA
// stage: the polyphase filter of each axis materialised as a dense int32
// tap matrix, tmp = window @ Mh, out = Mv @ tmp, with the reference's
// shift and clip between the passes; ref: src/xvc_common_lib/
// resample.cc:786-852 resample::Resample).
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
// filter times the largest sample stays below 2^31 in both passes at 14
// bit (tests/test_torch_resample.py proves it from the tables).  The
// shifts are arithmetic, as the reference's, and the clip comes after.
//
// What bounds it on an H100: bytes.  Each output takes T multiply-adds
// (at 1080p -> 720p luma, 12 x (1096 x 1280 + 720 x 1280) = 28 M integer
// operations, 0.4 us at the CUDA cores' rate) against the window read,
// the intermediate written and read back and the output written (23 MB,
// 7 us at 3.35 TB/s).
//
// Design: one launch per pass, a thread per output sample, neighbouring
// threads on neighbouring output columns.  In the horizontal pass a
// thread keeps its column's taps in registers and walks kRows rows, so
// the table is read once per kRows samples; the T window reads of a warp
// overlap (the taps of neighbouring columns are a sample or two apart) and
// come from L1.  In the vertical pass the table row is the same for every
// thread of a block row (a broadcast) and each tap reads one coalesced
// row of the intermediate.  A fused pass with the intermediate rows in
// shared memory is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 8;

template <int T>
__global__ void resample_hor(const int32_t* __restrict__ win, int win_h,
                             int win_w, const int32_t* __restrict__ tab,
                             int post, int shift, int dst_w,
                             int32_t* __restrict__ tmp) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= dst_w) return;
  const int32_t* t = tab + (size_t)j * (1 + T);
  const int x0 = __ldg(t);
  int taps[T];
#pragma unroll
  for (int k = 0; k < T; ++k) taps[k] = __ldg(t + 1 + k);
  const int r_end = min(win_h, (int)(blockIdx.y + 1) * kRows);
  for (int r = blockIdx.y * kRows; r < r_end; ++r) {
    const int32_t* src = win + (size_t)r * win_w + x0;
    int s = 0;
#pragma unroll
    for (int k = 0; k < T; ++k) s += __ldg(src + k) * taps[k];
    s = (s >> post) >> shift;
    tmp[(size_t)r * dst_w + j] = min(max(s, 0), 65535);
  }
}

template <int T>
__global__ void resample_ver(const int32_t* __restrict__ tmp, int dst_w,
                             const int32_t* __restrict__ tab, int post,
                             int shift, int maxv, int dst_h,
                             int32_t* __restrict__ out) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= dst_w) return;
  for (int i = blockIdx.y; i < dst_h; i += gridDim.y) {
    const int32_t* t = tab + (size_t)i * (1 + T);
    const int32_t* src = tmp + (size_t)__ldg(t) * dst_w + j;
    int s = 0;
#pragma unroll
    for (int k = 0; k < T; ++k) s += __ldg(src + (size_t)k * dst_w) *
                                     __ldg(t + 1 + k);
    s = (s >> post) >> shift;
    out[(size_t)i * dst_w + j] = min(max(s, 0), maxv);
  }
}

template <int T>
void launch_hor(const int32_t* win, int win_h, int win_w, const int32_t* tab,
                int post, int shift, int dst_w, int32_t* tmp,
                cudaStream_t st) {
  const dim3 grid((dst_w + kThreads - 1) / kThreads,
                  (win_h + kRows - 1) / kRows);
  resample_hor<T><<<grid, kThreads, 0, st>>>(win, win_h, win_w, tab, post,
                                             shift, dst_w, tmp);
}

template <int T>
void launch_ver(const int32_t* tmp, int dst_w, const int32_t* tab, int post,
                int shift, int maxv, int dst_h, int32_t* out,
                cudaStream_t st) {
  const dim3 grid((dst_w + kThreads - 1) / kThreads, min(dst_h, 65535));
  resample_ver<T><<<grid, kThreads, 0, st>>>(tmp, dst_w, tab, post, shift,
                                             maxv, dst_h, out);
}

bool taps_ok(int t) { return t == 1 || t == 8 || t == 12; }

}  // namespace

// window [win_h, win_w] int32 (the source plane with 8 rows and columns
// around it); tab_x [dst_w, 1 + taps_x], tab_y [dst_h, 1 + taps_y] int32,
// every window index they give checked by the caller; tmp [win_h, dst_w]
// and out [dst_h, dst_w] int32.  Enqueues the horizontal pass, then the
// vertical one.
extern "C" int xvc_resample(const void* window, int win_h, int win_w,
                            const void* tab_x, int taps_x, int post_x,
                            int shift_hor, const void* tab_y, int taps_y,
                            int post_y, int shift_ver, int maxv, int dst_h,
                            int dst_w, void* tmp, void* out, void* stream) {
  if (win_h <= 0 || win_w <= 0 || dst_h <= 0 || dst_w <= 0 ||
      win_h > 65535 * kRows || !taps_ok(taps_x) || !taps_ok(taps_y) ||
      post_x < 0 || post_x > 1 || post_y < 0 || post_y > 1 ||
      shift_hor < 0 || shift_hor > 31 || shift_ver < 0 || shift_ver > 31)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int32_t* w = (const int32_t*)window;
  const int32_t* tx = (const int32_t*)tab_x;
  const int32_t* ty = (const int32_t*)tab_y;
  int32_t* t = (int32_t*)tmp;
  int32_t* o = (int32_t*)out;
  if (taps_x == 12)
    launch_hor<12>(w, win_h, win_w, tx, post_x, shift_hor, dst_w, t, st);
  else if (taps_x == 8)
    launch_hor<8>(w, win_h, win_w, tx, post_x, shift_hor, dst_w, t, st);
  else
    launch_hor<1>(w, win_h, win_w, tx, post_x, shift_hor, dst_w, t, st);
  if (taps_y == 12)
    launch_ver<12>(t, dst_w, ty, post_y, shift_ver, maxv, dst_h, o, st);
  else if (taps_y == 8)
    launch_ver<8>(t, dst_w, ty, post_y, shift_ver, maxv, dst_h, o, st);
  else
    launch_ver<1>(t, dst_w, ty, post_y, shift_ver, maxv, dst_h, o, st);
  return (int)cudaGetLastError();
}
