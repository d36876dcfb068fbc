// Luma deblocking along one direction: the sequential edge scan.
//
// Replaces, on the GPU: xvc_tpu/tpu/deblock_jax.py make_luma_pass, the
// lax.scan over vertical edge strips (HEVC-style strong/weak decision and
// filters, ref: deblocking_filter.cc; host twin xvc_tpu/ops/deblock.py).
// Horizontal edges run on a contiguous transpose of the plane, as in the
// JAX version.
//
// The dependency: an edge's decision reads samples that the previous
// edge of the same rows has already filtered (edges 4 apart overlap by
// up to 3 columns per side), so edges must be filtered in order along
// the direction; rows never interact, and the filter works on groups of
// four rows.
//
// What bounds it on an H100: latency.  The work per picture is small
// (a few hundred edges x a few hundred row groups, ~100 operations
// each), but each step of a thread depends on its previous step, so the
// time is the length of the longest chain: the number of edges times
// one load-decide-filter-store round.
//
// Design: one thread per 4-row group, walking the pruned edge list in
// order.  This reproduces the scan's read-after-write order exactly:
// the only samples a step reads that an earlier step wrote were written
// by the same thread, so program order makes them visible.  The strip
// start is taken as lax.dynamic_slice takes it (negative from the end,
// then clamped to [0, W-8]).  Later work: keep the 4 x 8 working set of
// consecutive edges in registers instead of reloading it, and cover both
// directions in one launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int absi(int x) { return x < 0 ? -x : x; }

__global__ void __launch_bounds__(kThreads)
luma_edge_scan(int16_t* __restrict__ plane, int H, int W,
               const int32_t* __restrict__ xs,
               const int32_t* __restrict__ mask,
               const int32_t* __restrict__ tcs,
               const int32_t* __restrict__ betas, int E, int G, int bitdepth,
               int dis_initial, int dis_strong, int dis_weak,
               int dis_weak_sample, int dis_two_samples) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const int max_val = (1 << bitdepth) - 1;
  for (int e = 0; e < E; ++e) {
    const size_t me = (size_t)e * G + g;
    if (!mask[me]) continue;
    const int beta = betas[me];
    const int tc = tcs[me];
    const int xe = xs[e] - 4;
    const int x0 = clampi(xe < 0 ? xe + W : xe, 0, W - 8);
    int16_t* base = plane + (size_t)(4 * g) * W + x0;
    int s[4][8];
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 8; ++c) s[r][c] = base[(size_t)r * W + c];
    // columns: p3 p2 p1 p0 | q0 q1 q2 q3
    const int dp0 = absi(s[0][1] - 2 * s[0][2] + s[0][3]);
    const int dp3 = absi(s[3][1] - 2 * s[3][2] + s[3][3]);
    const int dq0 = absi(s[0][4] - 2 * s[0][5] + s[0][6]);
    const int dq3 = absi(s[3][4] - 2 * s[3][5] + s[3][6]);
    const int d0 = dp0 + dq0;
    const int d3 = dp3 + dq3;
    if (!(d0 + d3 < beta || dis_initial)) continue;
    bool strong = false;
    if (!dis_strong) {
      strong = ((d0 << 1) < (beta >> 2)) && ((d3 << 1) < (beta >> 2));
      for (int r = 0; r < 4 && strong; r += 3) {
        const bool t2 = (absi(s[r][0] - s[r][3]) + absi(s[r][4] - s[r][7])) <
                        (beta >> 3);
        const bool t3 = absi(s[r][3] - s[r][4]) < ((tc * 5 + 1) >> 1);
        strong = t2 && t3;
      }
    }
    if (strong) {
      const int tc2 = 2 * tc;
      for (int r = 0; r < 4; ++r) {
        const int p3 = s[r][0], p2 = s[r][1], p1 = s[r][2], p0 = s[r][3];
        const int q0 = s[r][4], q1 = s[r][5], q2 = s[r][6], q3 = s[r][7];
        const int n[6] = {(2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
                          (p2 + p1 + p0 + q0 + 2) >> 2,
                          (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                          (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3,
                          (p0 + q0 + q1 + q2 + 2) >> 2,
                          (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3};
        for (int c = 0; c < 6; ++c) {
          const int o = s[r][c + 1];
          base[(size_t)r * W + c + 1] =
              (int16_t)(o + clampi(n[c] - o, -tc2, tc2));
        }
      }
      continue;
    }
    if (dis_weak) continue;
    const int side_thr = (beta + (beta >> 1)) >> 3;
    const bool fp1 = !dis_two_samples && (dp0 + dp3) < side_thr;
    const bool fq1 = !dis_two_samples && (dq0 + dq3) < side_thr;
    const int half_tc = tc >> 1;
    for (int r = 0; r < 4; ++r) {
      const int p2 = s[r][1], p1 = s[r][2], p0 = s[r][3];
      const int q0 = s[r][4], q1 = s[r][5], q2 = s[r][6];
      const int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
      if (!(absi(delta) < tc * 10 || dis_weak_sample)) continue;
      const int dlt = clampi(delta, -tc, tc);
      int16_t* row = base + (size_t)r * W;
      row[3] = (int16_t)clampi(p0 + dlt, 0, max_val);
      row[4] = (int16_t)clampi(q0 - dlt, 0, max_val);
      if (fp1) {
        const int d = clampi((((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1,
                             -half_tc, half_tc);
        row[2] = (int16_t)clampi(p1 + d, 0, max_val);
      }
      if (fq1) {
        const int d = clampi((((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1,
                             -half_tc, half_tc);
        row[5] = (int16_t)clampi(q1 + d, 0, max_val);
      }
    }
  }
}

}  // namespace

extern "C" int xvc_deblock_luma(void* plane, int H, int W, const void* xs,
                                const void* mask, const void* tc,
                                const void* beta, int E, int G, int bitdepth,
                                int dis_initial, int dis_strong,
                                int dis_weak, int dis_weak_sample,
                                int dis_two_samples, void* stream) {
  if (E <= 0 || G <= 0) return 0;
  if (W < 8 || 4 * G > H) return (int)cudaErrorInvalidValue;
  luma_edge_scan<<<(G + kThreads - 1) / kThreads, kThreads, 0,
                   (cudaStream_t)stream>>>(
      (int16_t*)plane, H, W, (const int32_t*)xs, (const int32_t*)mask,
      (const int32_t*)tc, (const int32_t*)beta, E, G, bitdepth, dis_initial,
      dis_strong, dis_weak, dis_weak_sample, dis_two_samples);
  return (int)cudaGetLastError();
}
