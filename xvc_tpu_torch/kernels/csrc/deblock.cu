// The deblocking filters: luma edge walk and chroma edge pass, both
// directions on the plane as it lies in memory.
//
// Replaces, on the GPU, the device half of xvc_tpu/tpu/deblock_jax.py:
// make_luma_pass (:179), the lax.scan over 8-column edge strips with the
// HEVC-style strong/weak decision (ref: deblocking_filter.cc), and
// make_chroma_pass (:295), the masked one-sample update.  What the JAX
// package derives on the host for them (compute_edge_metadata :44,
// luma_edge_tensors :134, chroma_edge_tensors :150) is derived on the
// card by deblock_edges.cu, whose packed [edge][sub-block] entries
// (luma: beta << 16 | tc << 1 | mask; chroma: tc << 1 | apply) these
// kernels read as they are.
//
// luma_walk<DIR>
//   The dependency: an edge at x reads x-4..x+3 and writes x-3..x+2, and
//   the next edge, 4 further, reads three of the samples just written.
//   So the edges of one line (a row for vertical edges, DIR 0; a column
//   for horizontal ones, DIR 1) are a chain; lines interact only inside
//   a group of four, whose decision reads lines 0 and 3.
//   What bounds it on an H100: the latency of that chain, a few hundred
//   steps of about a hundred dependent integer operations; bytes and
//   operations are small (a 1280x720 plane is 1.8 MB).  The first
//   version made every step a round trip to device memory (32 strided
//   loads, then stores the next step reloads): 2.6 us a step.
//   Design: the chain stays, its memory trips go.
//   - A block owns one group of four lines and stages it whole in shared
//     memory, for either direction: rows go there as they lie by
//     asynchronous copies, all in flight at once; columns are read side
//     by side from each plane row and scattered.  No transposed copy of
//     the plane exists anywhere.  The block also stages its share of the
//     edge entries and the strip starts.  The stride between staged
//     lines is 2 mod 64 samples, so the lines fall into different banks.
//   - One warp walks the edges, its first four lanes one line each,
//     without touching device memory.  They exchange the second
//     differences of lines 0 and 3 by shuffle and the strong-filter test
//     by one ballot.  A sliding window keeps the q side of the strip a
//     step has just filtered in registers: when the next edge lies 4
//     further it is that step's p side, and the 4 fresh q samples were
//     loaded one step ahead (no step writes them before), as were the
//     step's entry and strip start, so a step is arithmetic only.  Any
//     other edge position (a pruned list, a clamped strip) reloads its 8
//     samples from shared memory, which every step keeps up to date.
//   - A masked-out entry is skipped by a warp vote: no host-side
//     pruning, no read-back of the masks.  With one group to a block the
//     vote skips every masked entry and no warp runs the strong and the
//     weak filter one after the other for different groups; on the
//     entries of a real 1280x720 picture that measured 20-24% faster on
//     an H100 than 32 lines to a block and one warp walking them.
//   - If no thread changed a sample the block writes nothing back.
//   The strip start is taken as lax.dynamic_slice takes it (x-4, a
//   negative start counts from the end, then clamped to [0, L-8]); only
//   4*(lines/4) lines are filtered.
//
// chroma_edges<DIR>
//   Chroma edges lie 8 samples apart, read 2 and write 1 sample a side,
//   so every (edge, sample along it) is independent: one thread each,
//   for U and V in one launch, bound by its launch (a 640x360 plane has
//   28,000 such entries).  DIR 1 indexes rows instead of transposing.
//   An edge position p is filtered when 2 <= p <= L-2; the positions
//   deblock_edges.cu implies (8, 16, ... below L) always are, so the
//   wrap-around that a negative index has in plane[:, idx] cannot occur.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLines = 4;         // lines of a luma block: one group
constexpr int kLumaThreads = 64;  // they stage; the first kLines walk
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxShared = 227 * 1024;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int absi(int x) { return x < 0 ? -x : x; }

struct LumaArgs {
  int H, W;
  int E;          // edges, walked in order
  int edge_step;  // edge e lies at edge_step * (e + 1) when xs is null
  int nsub;       // entries per edge in params
  int shift;      // line >> shift is a line's entry
  int stride;     // samples between two staged lines
  int bitdepth;
  int dis_initial, dis_strong, dis_weak, dis_weak_sample, dis_two_samples;
};

// Row stride of the staged lines: 2 mod 64 samples (1 mod 32 words).
__host__ __device__ inline int staged_stride(int L) {
  return ((L + 61) / 64) * 64 + 2;
}

// Entries a block stages per edge: one per sub-block its lines touch.
__host__ __device__ inline int staged_entries(int shift) {
  return (kLines >> shift) > 1 ? (kLines >> shift) : 1;
}

template <int DIR>
__global__ void __launch_bounds__(kLumaThreads)
luma_walk(int16_t* __restrict__ plane, const int32_t* __restrict__ xs,
          const int32_t* __restrict__ params, const LumaArgs A) {
  extern __shared__ int32_t smem[];
  const int L = DIR == 0 ? A.W : A.H;  // samples along a line
  const int tid = threadIdx.x;
  constexpr int nthreads = kLumaThreads, nwarps = kLumaThreads >> 5;
  const int line0 = blockIdx.x * kLines;
  const int sub0 = line0 >> A.shift;
  const int nsub_b = staged_entries(A.shift);
  int32_t* sx0 = smem;                        // [E] strip starts
  int32_t* sp = smem + A.E;                   // [E][nsub_b] entries
  int16_t* tile = (int16_t*)(sp + (size_t)A.E * nsub_b);  // [kLines][stride]

  for (int e = tid; e < A.E; e += nthreads) {
    const int xe = (xs ? xs[e] : A.edge_step * (e + 1)) - 4;
    sx0[e] = clampi(xe < 0 ? xe + L : xe, 0, L - 8);
  }
  for (int i = tid; i < A.E * nsub_b; i += nthreads) {
    const int e = i / nsub_b, sub = sub0 + i - e * nsub_b;
    sp[i] = sub < A.nsub ? params[(size_t)e * A.nsub + sub] : 0;
  }
  // Two samples at a time where the plane allows it (even width, base
  // aligned to 4 bytes; line0 is a multiple of 4).  Rows go straight to
  // shared memory with asynchronous copies, all of them in flight at
  // once; columns pass through registers, 32 abreast per plane row.
  const bool pairs = (A.W & 1) == 0 &&
                     (reinterpret_cast<uintptr_t>(plane) & 3) == 0;
  if (DIR == 0 && pairs) {
    for (int ln = tid >> 5; ln < kLines; ln += nwarps) {
      const uint32_t* g = reinterpret_cast<const uint32_t*>(
          plane + (size_t)(line0 + ln) * A.W);
      uint32_t* t = reinterpret_cast<uint32_t*>(tile + ln * A.stride);
      for (int x = tid & 31; x < (L >> 1); x += 32)
        __pipeline_memcpy_async(t + x, g + x, 4);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
  } else if (DIR == 0) {
    for (int ln = tid >> 5; ln < kLines; ln += nwarps) {
      const int16_t* g = plane + (size_t)(line0 + ln) * A.W;
      int16_t* t = tile + ln * A.stride;
      for (int x = tid & 31; x < L; x += 32) t[x] = g[x];
    }
  } else if (pairs) {
#pragma unroll 8
    for (int i = tid; i < L * (kLines / 2); i += nthreads) {
      const int y = i / (kLines / 2), ln = 2 * (i % (kLines / 2));
      const uint32_t v = *reinterpret_cast<const uint32_t*>(
          plane + (size_t)y * A.W + line0 + ln);
      tile[ln * A.stride + y] = (int16_t)(v & 0xffffu);
      tile[(ln + 1) * A.stride + y] = (int16_t)(v >> 16);
    }
  } else {
    for (int i = tid; i < L * kLines; i += nthreads) {
      const int y = i / kLines, ln = i % kLines;
      tile[ln * A.stride + y] = plane[(size_t)y * A.W + line0 + ln];
    }
  }
  __syncthreads();

  bool dirty = false;
  if (tid < 32) {
    // The whole warp goes along, lanes kLines.. as shadows of line 0 that
    // never filter: votes and shuffles under the full mask need no
    // re-convergence, which under a 4-lane mask cost up to 30% of the walk.
    const bool walks = tid < kLines;
    const int ln = walks ? tid : 0;
    int16_t* row = tile + ln * A.stride;
    const int32_t* prow = sp + (((line0 + ln) >> A.shift) - sub0);
    const int max_val = (1 << A.bitdepth) - 1;
    int w0 = 0, w1 = 0, w2 = 0, w3 = 0;  // q side of the last strip
    int f0 = 0, f1 = 0, f2 = 0, f3 = 0;  // q side loaded ahead
    int ahead_for = -1;                  // the edge f0..f3 belong to
    int pk_next = prow[0], x0_next = sx0[0];  // read one step ahead
    for (int e = 0; e < A.E; ++e) {
      const int pk = pk_next, x0 = x0_next;
      const bool more = e + 1 < A.E;
      if (more) {
        pk_next = prow[(e + 1) * nsub_b];
        x0_next = sx0[e + 1];
      }
      const bool on = walks && (pk & 1);
      if (!__any_sync(kFull, on)) continue;
      int s[8];  // p3 p2 p1 p0 | q0 q1 q2 q3
      if (ahead_for == e) {
        s[0] = w0; s[1] = w1; s[2] = w2; s[3] = w3;
        s[4] = f0; s[5] = f1; s[6] = f2; s[7] = f3;
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) s[c] = row[x0 + c];
      }
      const int beta = (pk >> 16) & 0xffff;
      const int tc = (pk >> 1) & 0x7fff;
      const int dp = absi(s[1] - 2 * s[2] + s[3]);
      const int dq = absi(s[4] - 2 * s[5] + s[6]);
      const int dp0 = __shfl_sync(kFull, dp, 0);
      const int dp3 = __shfl_sync(kFull, dp, 3);
      const int dq0 = __shfl_sync(kFull, dq, 0);
      const int dq3 = __shfl_sync(kFull, dq, 3);
      const bool chk = (absi(s[0] - s[3]) + absi(s[4] - s[7])) < (beta >> 3)
                       && absi(s[3] - s[4]) < ((tc * 5 + 1) >> 1);
      const unsigned votes = __ballot_sync(kFull, chk);
      if (more && x0_next == x0 + 4) {  // no step writes these before
        f0 = row[x0 + 8]; f1 = row[x0 + 9];
        f2 = row[x0 + 10]; f3 = row[x0 + 11];
        ahead_for = e + 1;
      }
      const int d0 = dp0 + dq0, d3 = dp3 + dq3;
      const bool act = on && (d0 + d3 < beta || A.dis_initial);
      const bool strong = !A.dis_strong && (d0 << 1) < (beta >> 2) &&
                          (d3 << 1) < (beta >> 2) &&
                          (votes & 9u) == 9u;
      if (act && strong) {
        const int tc2 = 2 * tc;
        const int p3 = s[0], p2 = s[1], p1 = s[2], p0 = s[3];
        const int q0 = s[4], q1 = s[5], q2 = s[6], q3 = s[7];
        const int n[6] = {(2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
                          (p2 + p1 + p0 + q0 + 2) >> 2,
                          (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                          (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3,
                          (p0 + q0 + q1 + q2 + 2) >> 2,
                          (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3};
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          const int o = s[c + 1];
          s[c + 1] = (int16_t)(o + clampi(n[c] - o, -tc2, tc2));
          row[x0 + c + 1] = (int16_t)s[c + 1];
        }
        dirty = true;
      } else if (act && !A.dis_weak) {
        const int p2 = s[1], p1 = s[2], p0 = s[3];
        const int q0 = s[4], q1 = s[5], q2 = s[6];
        const int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
        if (absi(delta) < tc * 10 || A.dis_weak_sample) {
          const int side_thr = (beta + (beta >> 1)) >> 3;
          const int half_tc = tc >> 1;
          const int dlt = clampi(delta, -tc, tc);
          s[3] = (int16_t)clampi(p0 + dlt, 0, max_val);
          s[4] = (int16_t)clampi(q0 - dlt, 0, max_val);
          row[x0 + 3] = (int16_t)s[3];
          row[x0 + 4] = (int16_t)s[4];
          if (!A.dis_two_samples && (dp0 + dp3) < side_thr) {
            const int d = clampi((((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1,
                                 -half_tc, half_tc);
            s[2] = (int16_t)clampi(p1 + d, 0, max_val);
            row[x0 + 2] = (int16_t)s[2];
          }
          if (!A.dis_two_samples && (dq0 + dq3) < side_thr) {
            const int d = clampi((((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1,
                                 -half_tc, half_tc);
            s[5] = (int16_t)clampi(q1 + d, 0, max_val);
            row[x0 + 5] = (int16_t)s[5];
          }
          dirty = true;
        }
      }
      w0 = s[4]; w1 = s[5]; w2 = s[6]; w3 = s[7];
    }
  }
  if (!__syncthreads_or(dirty)) return;

  if (DIR == 0 && pairs) {
    for (int ln = tid >> 5; ln < kLines; ln += nwarps) {
      uint32_t* g = reinterpret_cast<uint32_t*>(
          plane + (size_t)(line0 + ln) * A.W);
      const uint32_t* t =
          reinterpret_cast<const uint32_t*>(tile + ln * A.stride);
      for (int x = tid & 31; x < (L >> 1); x += 32) g[x] = t[x];
    }
  } else if (DIR == 0) {
    for (int ln = tid >> 5; ln < kLines; ln += nwarps) {
      int16_t* g = plane + (size_t)(line0 + ln) * A.W;
      const int16_t* t = tile + ln * A.stride;
      for (int x = tid & 31; x < L; x += 32) g[x] = t[x];
    }
  } else if (pairs) {
    for (int i = tid; i < L * (kLines / 2); i += nthreads) {
      const int y = i / (kLines / 2), ln = 2 * (i % (kLines / 2));
      *reinterpret_cast<uint32_t*>(plane + (size_t)y * A.W + line0 + ln) =
          (uint32_t)(uint16_t)tile[ln * A.stride + y] |
          ((uint32_t)(uint16_t)tile[(ln + 1) * A.stride + y] << 16);
    }
  } else {
    for (int i = tid; i < L * kLines; i += nthreads) {
      const int y = i / kLines, ln = i % kLines;
      plane[(size_t)y * A.W + line0 + ln] = tile[ln * A.stride + y];
    }
  }
}

template <int DIR>
__global__ void __launch_bounds__(kThreads)
chroma_edges(int16_t* __restrict__ plane_a, int16_t* __restrict__ plane_b,
             int H, int W, const int32_t* __restrict__ edges, int edge_step,
             const int32_t* __restrict__ params, int E, int nsub, int shift,
             int bitdepth) {
  const int L = DIR == 0 ? W : H;   // samples across the edges
  const int NL = DIR == 0 ? H : W;  // samples along an edge
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= E * NL) return;
  int e, r;
  if (DIR == 0) {  // neighbouring threads on neighbouring edges of a row
    r = t / E;
    e = t - r * E;
  } else {  // neighbouring threads on neighbouring columns
    e = t / NL;
    r = t - e * NL;
  }
  const int sub = r >> shift;
  if (sub >= nsub) return;
  const int pk = params[(size_t)e * nsub + sub];
  if (!(pk & 1)) return;
  const int pos = edges ? edges[e] : edge_step * (e + 1);
  if (pos < 2 || pos > L - 2) return;
  const int tc = pk >> 1;
  int16_t* plane = blockIdx.y == 0 ? plane_a : plane_b;
  const size_t step = DIR == 0 ? 1 : (size_t)W;
  int16_t* q = plane + (DIR == 0 ? (size_t)r * W + pos : (size_t)pos * W + r);
  const int p1 = *(q - 2 * step), p0 = *(q - step), q0 = *q, q1 = *(q + step);
  const int max_val = (1 << bitdepth) - 1;
  const int delta = clampi((((q0 - p0) * 4) + p1 - q1 + 4) >> 3, -tc, tc);
  *(q - step) = (int16_t)clampi(p0 + delta, 0, max_val);
  *q = (int16_t)clampi(q0 - delta, 0, max_val);
}

// Strip starts, entries and lines that a block of luma_walk stages.
inline int luma_shared_bytes(const LumaArgs& A) {
  return 4 * A.E + 4 * A.E * staged_entries(A.shift) +
         2 * kLines * A.stride;
}

template <int DIR>
int launch_luma(int16_t* plane, const int32_t* xs, const int32_t* params,
                LumaArgs A, cudaStream_t s) {
  const int L = DIR == 0 ? A.W : A.H;
  const int lines = 4 * ((DIR == 0 ? A.H : A.W) / 4);
  A.stride = staged_stride(L);
  const int bytes = luma_shared_bytes(A);
  if (bytes > kMaxShared) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {  // above what a kernel may ask for unprompted
    cudaError_t err = cudaFuncSetAttribute(
        luma_walk<DIR>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  luma_walk<DIR><<<lines / kLines, kLumaThreads, bytes, s>>>(
      plane, xs, params, A);
  return (int)cudaGetLastError();
}

}  // namespace

// One luma direction in place.  plane (H, W) int16; direction 0 filters
// across columns (vertical edges), 1 across rows, on the plane as it
// lies.  params [E][nsub] packed entries; the entry of line i (a row for
// direction 0, a column for 1) is params[e][i >> shift].  xs: E edge
// positions, or null for edge_step * (e + 1).
extern "C" int xvc_deblock_luma(void* plane, int H, int W, int direction,
                                const void* xs, int edge_step,
                                const void* params, int E, int nsub,
                                int shift, int bitdepth, int dis_initial,
                                int dis_strong, int dis_weak,
                                int dis_weak_sample, int dis_two_samples,
                                void* stream) {
  const int L = direction == 0 ? W : H;
  const int across = direction == 0 ? H : W;
  if (E <= 0 || across < 4) return 0;
  if (L < 8 || nsub <= 0 || shift < 0 || shift > 5 || bitdepth < 1 ||
      bitdepth > 15 || (direction != 0 && direction != 1))
    return (int)cudaErrorInvalidValue;
  LumaArgs A;
  A.H = H;
  A.W = W;
  A.E = E;
  A.edge_step = edge_step;
  A.nsub = nsub;
  A.shift = shift;
  A.stride = 0;
  A.bitdepth = bitdepth;
  A.dis_initial = dis_initial;
  A.dis_strong = dis_strong;
  A.dis_weak = dis_weak;
  A.dis_weak_sample = dis_weak_sample;
  A.dis_two_samples = dis_two_samples;
  return direction == 0
             ? launch_luma<0>((int16_t*)plane, (const int32_t*)xs,
                              (const int32_t*)params, A,
                              (cudaStream_t)stream)
             : launch_luma<1>((int16_t*)plane, (const int32_t*)xs,
                              (const int32_t*)params, A,
                              (cudaStream_t)stream);
}

// One chroma direction in place, for one plane (plane_b null) or two of
// one shape.  params [E][nsub] packed entries (tc << 1 | apply); the
// entry of sample r along the edge is params[e][r >> shift].  edges: E
// positions, or null for edge_step * (e + 1).
extern "C" int xvc_deblock_chroma(void* plane_a, void* plane_b, int H, int W,
                                  int direction, const void* edges,
                                  int edge_step, const void* params, int E,
                                  int nsub, int shift, int bitdepth,
                                  void* stream) {
  if (E <= 0 || H <= 0 || W <= 0) return 0;
  if (nsub <= 0 || shift < 0 || shift > 5 || bitdepth < 1 || bitdepth > 15 ||
      (direction != 0 && direction != 1))
    return (int)cudaErrorInvalidValue;
  const int along = direction == 0 ? H : W;
  dim3 grid((E * along + kThreads - 1) / kThreads, plane_b ? 2 : 1);
  if (direction == 0)
    chroma_edges<0><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (int16_t*)plane_a, (int16_t*)plane_b, H, W, (const int32_t*)edges,
        edge_step, (const int32_t*)params, E, nsub, shift, bitdepth);
  else
    chroma_edges<1><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (int16_t*)plane_a, (int16_t*)plane_b, H, W, (const int32_t*)edges,
        edge_step, (const int32_t*)params, E, nsub, shift, bitdepth);
  return (int)cudaGetLastError();
}
