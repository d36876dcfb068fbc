// Fullpel SAD sweep of the motion search: the SAD of one CU's original
// block against the reference picture's padded luma at each of N
// candidate offsets, in one launch.
//
// Replaces, on the GPU: xvc_tpu/tpu/me.py:30 make_sad_fn, the device
// sweep behind DeviceSadTable.prefetch (me.py:110) that the TZ search
// (ref: src/xvc_enc_lib/inter_tz_search.cc:85-330) calls for its initial
// diamond sweep, its raster grid and its refinement sweeps.  The
// semantics are the JAX function's:
//   - candidate c reads the w x h block of the plane whose top-left
//     sample is (oy + y[c], ox + x[c]): (oy, ox) is the CU's origin in
//     the padded plane plus the origin of the candidates' box, (y, x)
//     the offset in the box (the JAX function cuts the 192 x 192 window
//     at that box origin and offsets into it);
//   - |orig - block| summed over every row, or over rows 0, 2, 4, ...
//     and doubled (SAD_FAST), with int32 wrap-around (the JAX sum keeps
//     int32);
//   - then an arithmetic shift right by bitdepth - 8.
// Not carried over: the reference pads N to a power of two (one jit a
// size) and casts everything to int32; here N is the call's own and the
// samples are int16 where they fit (bitdepth <= 15), int32 above.
//
// Inputs: the plane, resident on the card (uploaded once a reference
// picture, gpu/me.reference_luma), and the sweep's staging, which the
// wrapper keeps in mapped pinned host memory and the kernel reads where
// it lies: the offsets y [N] and x [N] as int32, then the block [h, w]
// in the plane's element type.  The SADs go to `out`, mapped pinned host
// memory as well, so a sweep is one device operation and no copy.
//
// What bounds it on an H100: the launch and, for the staging, the PCIe
// round trip.  A TZ sweep is tens to a few hundred candidates of at most
// 64 x 64 samples, well under a microsecond of the card's memory or
// integer rate.  So every CTA reads its share of the staging once, into
// shared memory, and the CTAs that read it are few: each takes a run of
// candidates, and their count is capped so that the blocks they stage
// come to at most kStageBytes.
// The candidates' reference rows overlap heavily and are served by L2.
//
// Design: a warp a candidate where w * h <= 256 (most calls: 4x4 to
// 16x16 CUs), the 8 warps of a CTA taking its candidates in turn;
// above 256 samples the whole CTA a candidate, its 8 warps' sums meeting
// in shared memory.  Sums are unsigned 32-bit (wrap-around is then
// defined and equals the reference's int32 wrap), in a fixed order:
// each lane its strided samples, then the warp's butterfly, then the
// warps in order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmall = 256;      // samples of the largest block a warp takes
constexpr int kMaxSide = 64;     // the largest CU side
constexpr int kMaxCtas = 32;     // CTAs a launch takes at most
constexpr int kStageBytes = 64 * 1024;  // staged block bytes, all CTAs
constexpr int kMaxRun = 2048;    // candidates a CTA takes at most

template <typename T>
struct Sweep {
  const T* plane;
  long long stride;
  int oy, ox;
  const int* ys;  // staging: y [n], x [n], then the block
  const int* xs;
  const T* blk;
  int w, n, run, step, rows, fast, shift;
  int* out;
};

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int finish(unsigned acc, int fast, int shift) {
  if (fast) acc <<= 1;
  return ((int)acc) >> shift;
}

// Read the block's summed rows and this CTA's run of offsets into shared
// memory, in one pass; returns the run's first candidate and its length.
template <typename T>
__device__ __forceinline__ int stage(const Sweep<T>& s, int* s_blk, int* s_y,
                                     int* s_x, int* first) {
  const int c0 = blockIdx.x * s.run;
  const int cnt = min(s.n - c0, s.run);
  const int nb = s.rows * s.w;
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    const int r = i / s.w;
    s_blk[i] = (int)s.blk[(r * s.step) * s.w + i - r * s.w];
  }
  for (int i = threadIdx.x; i < cnt; i += kThreads) {
    s_y[i] = s.ys[c0 + i];
    s_x[i] = s.xs[c0 + i];
  }
  __syncthreads();
  *first = c0;
  return cnt;
}

// the sum of |orig - block| over the summed rows of the candidate at
// (y, x), lane `lane` of `lanes` taking every lanes-th sample
template <typename T>
__device__ __forceinline__ unsigned candidate_sum(const Sweep<T>& s,
                                                  const int* s_blk, int y,
                                                  int x, int lane,
                                                  int lanes) {
  const T* ref = s.plane + (long long)(s.oy + y) * s.stride + s.ox + x;
  const long long rstride = s.stride * s.step;
  const int cnt = s.rows * s.w;
  unsigned acc = 0;
  for (int i = lane; i < cnt; i += lanes) {
    const int r = i / s.w;
    const int d = s_blk[i] - (int)ref[r * rstride + i - r * s.w];
    acc += (unsigned)(d < 0 ? -d : d);
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) sad_warp(Sweep<T> s) {
  extern __shared__ int smem[];
  int* s_blk = smem;
  int* s_y = s_blk + s.rows * s.w;
  int* s_x = s_y + s.run;
  int c0;
  const int cnt = stage(s, s_blk, s_y, s_x, &c0);
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < cnt; j += kWarps) {
    const unsigned acc =
        warp_sum(candidate_sum(s, s_blk, s_y[j], s_x[j], lane, 32));
    if (lane == 0) s.out[c0 + j] = finish(acc, s.fast, s.shift);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) sad_cta(Sweep<T> s) {
  extern __shared__ int smem[];
  __shared__ unsigned s_part[kWarps];
  int* s_blk = smem;
  int* s_y = s_blk + s.rows * s.w;
  int* s_x = s_y + s.run;
  int c0;
  const int cnt = stage(s, s_blk, s_y, s_x, &c0);
  for (int j = 0; j < cnt; ++j) {
    const unsigned acc = warp_sum(
        candidate_sum(s, s_blk, s_y[j], s_x[j], threadIdx.x, kThreads));
    if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned sum = 0;
      for (int i = 0; i < kWarps; ++i) sum += s_part[i];
      s.out[c0 + j] = finish(sum, s.fast, s.shift);
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* plane, long long stride, int oy, int ox,
           const void* staging, int h, int w, int n, int fast, int bitdepth,
           int* out, cudaStream_t st) {
  Sweep<T> s;
  s.plane = (const T*)plane;
  s.stride = stride;
  s.oy = oy;
  s.ox = ox;
  s.ys = (const int*)staging;
  s.xs = s.ys + n;
  s.blk = (const T*)(s.xs + n);
  s.w = w;
  s.n = n;
  s.step = fast ? 2 : 1;
  s.rows = (h + s.step - 1) / s.step;
  s.fast = fast;
  s.shift = bitdepth - 8;
  s.out = out;
  const bool small = h * w <= kSmall;
  // CTAs: enough for the candidates (8 a pass where a warp takes one),
  // no more than kMaxCtas, and their staged blocks within kStageBytes;
  // but enough that no run is longer than kMaxRun
  const int per_pass = small ? kWarps : 1;
  const int block_bytes = s.rows * w * (int)sizeof(T);
  int ctas = (n + per_pass - 1) / per_pass;
  int cap = kStageBytes / block_bytes;
  if (cap > kMaxCtas) cap = kMaxCtas;
  if (cap < 1) cap = 1;
  if (ctas > cap) ctas = cap;
  const int least = (n + kMaxRun - 1) / kMaxRun;
  if (ctas < least) ctas = least;
  s.run = (n + ctas - 1) / ctas;
  ctas = (n + s.run - 1) / s.run;
  const size_t smem = (size_t)(s.rows * w + 2 * s.run) * sizeof(int);
  if (small)
    sad_warp<T><<<ctas, kThreads, smem, st>>>(s);
  else
    sad_cta<T><<<ctas, kThreads, smem, st>>>(s);
  return (int)cudaGetLastError();
}

}  // namespace

// plane: elem_bytes 2 (int16, bitdepth <= 15) or 4 (int32) elements,
// plane_h x plane_w of row stride `stride` elements; staging: int32 y
// [n], int32 x [n], then the block [h, w] in the plane's element type;
// out: int32 [n].  Both may be device memory or mapped host memory.
// Every candidate's block must lie in the plane (the wrapper checks it).
extern "C" int xvc_me_sad(const void* plane, int elem_bytes, int plane_h,
                          int plane_w, long long stride, int oy, int ox,
                          const void* staging, int h, int w, int n,
                          int fast, int bitdepth, void* out, void* stream) {
  if (n == 0) return 0;
  if (n < 0 || bitdepth < 8 || bitdepth > 16 || h < 1 || w < 1 ||
      h > kMaxSide || w > kMaxSide || h > plane_h || w > plane_w ||
      stride < plane_w || oy < 0 || ox < 0 || oy >= plane_h ||
      ox >= plane_w || (elem_bytes == 2 && bitdepth > 15))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int* dst = (int*)out;
  if (elem_bytes == 2)
    return launch<int16_t>(plane, stride, oy, ox, staging, h, w, n, fast,
                           bitdepth, dst, st);
  if (elem_bytes == 4)
    return launch<int32_t>(plane, stride, oy, ox, staging, h, w, n, fast,
                           bitdepth, dst, st);
  return (int)cudaErrorInvalidValue;
}

// Mapped pinned host memory for a sweep's staging and result: `bytes`
// at *host, which the card reads and writes at *dev (the same address
// under unified addressing).
extern "C" int xvc_host_alloc(long long bytes, void** host, void** dev) {
  void* p = nullptr;
  cudaError_t e = cudaHostAlloc(&p, (size_t)bytes, cudaHostAllocMapped);
  if (e != cudaSuccess) return (int)e;
  void* d = nullptr;
  e = cudaHostGetDevicePointer(&d, p, 0);
  if (e != cudaSuccess) {
    cudaFreeHost(p);
    return (int)e;
  }
  *host = p;
  *dev = d;
  return 0;
}

extern "C" int xvc_host_free(void* host) { return (int)cudaFreeHost(host); }
