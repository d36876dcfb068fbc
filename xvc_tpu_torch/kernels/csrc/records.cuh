// Column layout of the native parse's record table (one int32 row per CU
// node of either tree; xvc_tpu_torch/gpu/records.py is the Python twin,
// native/csrc/xvcn_pic.inc xvcn_export_parse the writer), and what the
// picture kernels (itx.cu xvc_itx_picture, mc.cu xvc_mc_picture) share to
// read it: a row is read from device memory by the work item that needs
// it, and every index taken from a row is bounded before it is used.
#pragma once
#include <stdint.h>

namespace rec {

enum Column {
  kTree = 0, kX = 2, kY = 3, kW = 4, kH = 5, kSplit = 6, kPred = 11,
  kQp = 12, kDir = 16, kAffine = 18, kCbf0 = 21, kTskip0 = 24,
  kDconly0 = 27, kTt00 = 30, kTt01 = 31, kTt10 = 32, kTt11 = 33, kRef0 = 35, kMv = 41, kCoeff0 = 65,
  kMinCols = 71
};

// log2 of a side that is a power of two in [lo, hi], else -1
__device__ __forceinline__ int log2_side(int v, int lo, int hi) {
  return v >= lo && v <= hi && (v & (v - 1)) == 0 ? __ffs(v) - 1 : -1;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// A group of threads that works on one job together: a warp (kWarp) or
// the whole thread block.  tid / n index the group's threads.
struct WarpGroup {
  int tid;
  static constexpr int n = 32;
  __device__ void sync() const { __syncwarp(); }
};
template <int kThreads>
struct BlockGroup {
  int tid;
  static constexpr int n = kThreads;
  __device__ void sync() const { __syncthreads(); }
};

}  // namespace rec
