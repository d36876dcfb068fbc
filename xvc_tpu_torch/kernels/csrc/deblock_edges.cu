// Deblocking edge decisions on the card: the per-4x4 CU map and, from it,
// the boundary strength, tc, beta and chroma gating of every (edge
// position, sub-block along the edge) of a picture, both directions.
//
// Replaces, on the GPU, the host derivation that feeds the JAX filter:
// the CU-map paint of xvc_tpu/ops/deblock.py _build_cu_maps_from_records,
// and xvc_tpu/tpu/deblock_jax.py compute_edge_metadata (:44),
// luma_edge_tensors (:134) and chroma_edge_tensors (:150).  The filter
// kernels that read its output are in deblock.cu.
//
// What bounds it on an H100: nothing but its launches.  A 1280x720
// picture has 3,000-15,000 CUs, 57,600 map cells and 2 x 57,000 edge
// entries of about 100 operations and two 108-byte attribute rows each;
// no entry depends on another.  The work is a few microseconds of a
// card that the host version kept waiting for 38 ms per picture.
//
// Design: two kernels behind one entry point, enqueued back to back on
// the caller's stream, nothing read back.
//   paint_cu_map: one warp per CU writes its index into the cells its
//     rectangle covers.  The leaves of one tree do not overlap, so the
//     order of the writes does not matter (cells no CU covers stay -1,
//     which indexes the last attribute row as numpy's -1 does).
//   derive_edges: one thread per (direction, edge position, sub-block).
//     It reads the two CU indices across the edge, the two attribute
//     rows, picks the motion-vector corner by the position along the
//     edge, and writes one packed int32 per luma entry
//     (beta << 16 | tc << 1 | bs > 0) and, at every chroma edge
//     position, one per chroma entry (tc << 1 | bs == 2), laid out
//     [edge][sub-block] for each direction: the order in which a block
//     of the filter kernels stages them.  TC_TABLE and BETA_TABLE sit
//     in constant memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAttrCols = 27;
constexpr int kThreads = 128;

__constant__ int kTc[54] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                            0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2,
                            2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6,
                            7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24};
__constant__ int kBeta[64] = {
    0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,
    6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24,
    26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56,
    58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88};

// One direction's share of the output (see gpu/deblock.py EdgeLayout).
struct DirGeom {
  int nx;             // edge positions: sbs, 2 sbs, ... below the extent
  int ny;             // sub-blocks along an edge
  int chroma_stride;  // every chroma_stride-th position is a chroma edge
  int luma_off;       // offset of the luma entries in out, -1: none
  int chroma_off;     // offset of the chroma entries in out, -1: none
};

struct EdgeArgs {
  int map_w, rows, sbs, beta_off, tc_off, shift, pred_bi, bs_base,
      bs_one_is_two, fixed_qp;
  DirGeom g[2];
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ bool far_apart(int a, int b) {
  const int d = a - b;
  return (d < 0 ? -d : d) >= 16;  // one_step of compute_edge_metadata
}

__global__ void __launch_bounds__(32)
paint_cu_map(int32_t* __restrict__ cu_map, const int32_t* __restrict__ attrs,
             int map_w, int map_h) {
  const int i = blockIdx.x;
  const int32_t* a = attrs + (size_t)i * kAttrCols;
  const int x0 = a[0] >> 2, y0 = a[1] >> 2;
  const int x1 = min(map_w, (a[0] + a[2] + 3) >> 2);
  const int y1 = min(map_h, (a[1] + a[3] + 3) >> 2);
  const int w = x1 - x0, h = y1 - y0;
  if (w <= 0 || h <= 0) return;
  for (int c = threadIdx.x; c < w * h; c += 32)
    cu_map[(size_t)(y0 + c / w) * map_w + x0 + c % w] = i;
}

__global__ void __launch_bounds__(kThreads)
derive_edges(const int32_t* __restrict__ cu_map,
             const int32_t* __restrict__ attrs, int32_t* __restrict__ out,
             const EdgeArgs A) {
  const int d = blockIdx.y;
  const DirGeom G = A.g[d];
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= G.nx * G.ny) return;
  const int ex = t / G.ny, ey = t - ex * G.ny;
  const int xe = A.sbs * (ex + 1);  // position across the edge
  const int ye = A.sbs * ey;        // position along the edge
  int iq, ip;
  if (d == 0) {
    iq = cu_map[(size_t)(ye >> 2) * A.map_w + (xe >> 2)];
    ip = cu_map[(size_t)(ye >> 2) * A.map_w + (xe >> 2) - 1];
  } else {
    iq = cu_map[(size_t)(xe >> 2) * A.map_w + (ye >> 2)];
    ip = cu_map[(size_t)((xe >> 2) - 1) * A.map_w + (ye >> 2)];
  }
  const bool same_cu = ip == iq;
  if (iq < 0) iq += A.rows;
  if (ip < 0) ip += A.rows;
  const int32_t* ap = attrs + (size_t)ip * kAttrCols;
  const int32_t* aq = attrs + (size_t)iq * kAttrCols;
  // columns: 0-3 x y w h, 4 intra, 5 cbf, 6-7 qp luma chroma, 8-9 ref
  // poc l0 l1, 10 ref idx l0, 11.. mv[list][corner][xy]
  int cp, cq;
  if (d == 0) {
    cp = (ye - ap[1]) < (ap[3] >> 1) ? 1 : 3;
    cq = (ye - aq[1]) < (aq[3] >> 1) ? 0 : 2;
  } else {
    cp = (ye - ap[0]) < (ap[2] >> 1) ? 2 : 3;
    cq = (ye - aq[0]) < (aq[2] >> 1) ? 0 : 1;
  }
  const int p0x = ap[11 + 2 * cp], p0y = ap[12 + 2 * cp];
  const int q0x = aq[11 + 2 * cq], q0y = aq[12 + 2 * cq];
  int bs_mv;
  if (A.pred_bi) {
    const int rp0 = ap[8], rp1 = ap[9], rq0 = aq[8], rq1 = aq[9];
    const int p1x = ap[19 + 2 * cp], p1y = ap[20 + 2 * cp];
    const int q1x = aq[19 + 2 * cq], q1y = aq[20 + 2 * cq];
    const bool match = (rp0 == rq0 && rp1 == rq1) ||
                       (rp0 == rq1 && rp1 == rq0);
    const bool cond1 = far_apart(p0x, q0x) || far_apart(p0y, q0y) ||
                       far_apart(p1x, q1x) || far_apart(p1y, q1y);
    const bool cond2 = far_apart(p0x, q1x) || far_apart(p0y, q1y) ||
                       far_apart(p1x, q0x) || far_apart(p1y, q0y);
    const bool inner = rp0 != rp1 ? (rp0 == rq0 ? cond1 : cond2)
                                  : (cond1 && cond2);
    bs_mv = match ? (inner ? 1 : A.bs_base) : 1;
  } else {
    const bool diff = far_apart(p0x, q0x) || far_apart(p0y, q0y);
    bs_mv = (ap[10] != aq[10] || diff) ? 1 : A.bs_base;
  }
  int bs = (ap[4] != 0 || aq[4] != 0) ? 2
           : ((ap[5] != 0 || aq[5] != 0) ? 1 : bs_mv);
  if (A.bs_one_is_two && bs == 1) bs = 2;
  if (same_cu) bs = 0;
  int qp_l = (ap[6] + aq[6] + 1) >> 1;
  int qp_c = (ap[7] + aq[7] + 1) >> 1;
  if (A.fixed_qp) {
    qp_l = 32;
    qp_c = 31;
  }
  if (G.luma_off >= 0) {
    const int beta = kBeta[clampi(qp_l + A.beta_off, 0, 63)] << A.shift;
    const int tc = kTc[clampi(qp_l + A.tc_off + 2 * (bs - 1), 0, 53)]
                   << A.shift;
    out[G.luma_off + t] = (beta << 16) | (tc << 1) | (bs > 0 ? 1 : 0);
  }
  if (G.chroma_off >= 0 && (ex + 1) % G.chroma_stride == 0) {
    const int ce = (ex + 1) / G.chroma_stride - 1;
    const int tc = kTc[clampi(qp_c + A.tc_off + 2, 0, 53)] << A.shift;
    out[G.chroma_off + ce * G.ny + ey] = (tc << 1) | (bs == 2 ? 1 : 0);
  }
}

}  // namespace

// cfg (host memory, int32): 0 width, 1 height, 2 CUs to paint, 3 rows of
// attrs, 4 sub-block size, 5 beta offset, 6 tc offset, 7 bitdepth - 8,
// 8 bi-predicted picture, 9 boundary strength where motion agrees (0, or
// 1 under disable_deblock_boundary_strength_zero), 10 strength 1 counts
// as 2, 11 fixed qp; then for each direction nx, ny, chroma stride,
// luma offset, chroma offset.
extern "C" int xvc_deblock_edges(void* cu_map, const void* attrs, void* out,
                                 const int* cfg, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int W = cfg[0], H = cfg[1], n_cus = cfg[2];
  const int map_w = (W + 3) >> 2, map_h = (H + 3) >> 2;
  if (W <= 0 || H <= 0 || n_cus < 0 || cfg[3] < 1 || cfg[3] < n_cus ||
      (cfg[4] != 4 && cfg[4] != 8))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(cu_map, 0xff,
                                    (size_t)map_w * map_h * 4, s);
  if (err != cudaSuccess) return (int)err;
  if (n_cus > 0) {
    paint_cu_map<<<n_cus, 32, 0, s>>>((int32_t*)cu_map,
                                      (const int32_t*)attrs, map_w, map_h);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  EdgeArgs A;
  A.map_w = map_w;
  A.rows = cfg[3];
  A.sbs = cfg[4];
  A.beta_off = cfg[5];
  A.tc_off = cfg[6];
  A.shift = cfg[7];
  A.pred_bi = cfg[8];
  A.bs_base = cfg[9];
  A.bs_one_is_two = cfg[10];
  A.fixed_qp = cfg[11];
  int most = 0;
  for (int d = 0; d < 2; ++d) {
    const int* c = cfg + 12 + 5 * d;
    A.g[d].nx = c[0];
    A.g[d].ny = c[1];
    A.g[d].chroma_stride = c[2] > 0 ? c[2] : 1;
    A.g[d].luma_off = c[3];
    A.g[d].chroma_off = c[2] > 0 ? c[4] : -1;
    if (c[0] < 0 || c[1] < 0) return (int)cudaErrorInvalidValue;
    if (c[0] * c[1] > most) most = c[0] * c[1];
  }
  if (most == 0) return 0;
  dim3 grid((most + kThreads - 1) / kThreads, 2);
  derive_edges<<<grid, kThreads, 0, s>>>((const int32_t*)cu_map,
                                         (const int32_t*)attrs,
                                         (int32_t*)out, A);
  return (int)cudaGetLastError();
}
