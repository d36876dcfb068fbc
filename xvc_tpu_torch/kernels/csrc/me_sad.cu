// Fullpel SAD sweep of the motion search: the SAD of one CU's original
// block against the reference window at each of N candidate offsets, in
// one launch.
//
// Replaces, on the GPU: xvc_tpu/tpu/me.py:30 make_sad_fn, the device
// sweep behind DeviceSadTable.prefetch (me.py:110) that the TZ search
// (ref: src/xvc_enc_lib/inter_tz_search.cc:85-330) calls for its initial
// diamond sweep, its raster grid and its refinement sweeps.  The
// semantics are the JAX function's:
//   - candidate c reads the w x h block of the window whose top-left
//     sample is (y[c], x[c]) (the window is the part of the padded
//     reference luma the candidates read);
//   - |orig - block| summed over every row, or over rows 0, 2, 4, ...
//     and doubled (SAD_FAST), with int32 wrap-around (the JAX sum keeps
//     int32);
//   - then an arithmetic shift right by bitdepth - 8.
// Not carried over: the reference pads N to a power of two (one jit a
// size) and casts everything to int32; here N is the call's own and the
// samples travel as int16 where they fit (bitdepth <= 15), int32 above.
//
// One packed buffer, uploaded once a call: window [wh, ww], then orig
// [h, w], then the offsets y [N] and x [N], all of one element type.
//
// What bounds it on an H100: the launch.  A TZ sweep is tens to a few
// hundred candidates of at most 64 x 64 samples, well under a
// microsecond of the card's memory or integer rate.
//
// Design: a warp a candidate where w * h <= 256 (most calls: 4x4 to
// 16x16 CUs); a CTA of 8 warps stages orig once in shared memory and
// takes 8 candidates.  Above 256 samples a CTA a candidate, its 8 warps'
// sums meeting in shared memory.  Sums are unsigned 32-bit (wrap-around
// is then defined and equals the reference's int32 wrap), in a fixed
// order: each lane its strided samples, then the warp's butterfly, then
// the warps in order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmall = 256;  // samples of the largest block a warp takes

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int finish(unsigned acc, int fast, int shift) {
  if (fast) acc <<= 1;
  return ((int)acc) >> shift;
}

// the sum of |orig - block| over rows 0, step, 2 step, ... of one
// candidate, lane `lane` of `lanes` taking every lanes-th sample
template <typename T, typename O>
__device__ __forceinline__ unsigned candidate_sum(const T* win, int ww,
                                                  const O* org, int w,
                                                  int rows, int step, int y,
                                                  int x, int lane,
                                                  int lanes) {
  unsigned acc = 0;
  const int cnt = rows * w;
  for (int i = lane; i < cnt; i += lanes) {
    const int r = (i / w) * step;
    const int col = i - (i / w) * w;
    const int d = (int)org[r * w + col] - (int)win[(y + r) * ww + x + col];
    acc += (unsigned)(d < 0 ? -d : d);
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sad_warp(const T* __restrict__ packed, int wh, int ww, int h, int w,
             int n, int step, int fast, int shift, int* __restrict__ out) {
  __shared__ int s_orig[kSmall];
  const T* win = packed;
  const T* org = win + (long long)wh * ww;
  const T* cy = org + h * w;
  const T* cx = cy + n;
  for (int i = threadIdx.x; i < h * w; i += kThreads) s_orig[i] = org[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= n) return;
  const int rows = (h + step - 1) / step;
  unsigned acc = candidate_sum(win, ww, s_orig, w, rows, step, (int)cy[c],
                               (int)cx[c], lane, 32);
  acc = warp_sum(acc);
  if (lane == 0) out[c] = finish(acc, fast, shift);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sad_cta(const T* __restrict__ packed, int wh, int ww, int h, int w,
            int n, int step, int fast, int shift, int* __restrict__ out) {
  __shared__ unsigned s_part[kWarps];
  const T* win = packed;
  const T* org = win + (long long)wh * ww;
  const T* cy = org + h * w;
  const T* cx = cy + n;
  const int c = blockIdx.x;
  const int rows = (h + step - 1) / step;
  unsigned acc = candidate_sum(win, ww, org, w, rows, step, (int)cy[c],
                               (int)cx[c], threadIdx.x, kThreads);
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned s = 0;
    for (int i = 0; i < kWarps; ++i) s += s_part[i];
    out[c] = finish(s, fast, shift);
  }
}

template <typename T>
int launch(const void* packed, int wh, int ww, int h, int w, int n,
           int fast, int bitdepth, int* out, cudaStream_t st) {
  const T* p = (const T*)packed;
  const int step = fast ? 2 : 1;
  const int shift = bitdepth - 8;
  if (h * w <= kSmall) {
    sad_warp<T><<<(n + kWarps - 1) / kWarps, kThreads, 0, st>>>(
        p, wh, ww, h, w, n, step, fast, shift, out);
  } else {
    sad_cta<T><<<n, kThreads, 0, st>>>(p, wh, ww, h, w, n, step, fast,
                                       shift, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// packed: elem_bytes 2 (int16, bitdepth <= 15) or 4 (int32) elements in
// the layout above; out: int32 [n].  Every candidate's block must lie in
// the window (the wrapper checks it).
extern "C" int xvc_me_sad(const void* packed, int elem_bytes, int wh, int ww,
                          int h, int w, int n, int fast, int bitdepth,
                          void* out, void* stream) {
  if (n <= 0) return 0;
  if (bitdepth < 8 || bitdepth > 16 || h < 1 || w < 1 || h > wh || w > ww)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int* dst = (int*)out;
  if (elem_bytes == 2)
    return launch<int16_t>(packed, wh, ww, h, w, n, fast, bitdepth, dst, st);
  if (elem_bytes == 4)
    return launch<int32_t>(packed, wh, ww, h, w, n, fast, bitdepth, dst, st);
  return (int)cudaErrorInvalidValue;
}
