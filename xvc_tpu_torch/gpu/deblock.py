"""In-loop deblocking on the device: edge decisions, luma edge walk and
chroma pass, each a hand-written kernel with its plain version beside it.

Port of ``xvc_tpu/tpu/deblock_jax.py``, redesigned for the card: the JAX
package derives the boundary strengths and the per-edge tc/beta/chroma
gating on the host with numpy and uploads them; here the host uploads
only the per-CU attribute table (``ops.deblock.build_cu_attrs``) and the
card derives the rest, so between the parse and the picture's download
the stage never waits for the host.

- ``edge_params`` paints the per-4x4 CU map and derives one packed int32
  per (edge position, sub-block along the edge) for both directions
  (``kernels/csrc/deblock_edges.cu``); ``edge_params_plain`` is the numpy
  derivation of the JAX module (``compute_edge_metadata``,
  ``luma_edge_tensors``, ``chroma_edge_tensors``) packed the same way.
  ``EdgeLayout`` says where each direction's entries lie;
  ``luma_tensors`` / ``chroma_tensors`` unpack them into the tensors the
  JAX functions return.
- ``luma_pass`` filters one direction in place with the JAX twin's
  arguments (``xs, mask, tc, beta``); ``luma_filter`` does the same from
  the packed entries.  On the card both launch ``luma_walk`` of
  ``kernels/csrc/deblock.cu``, for either direction on the plane as it
  lies; on the CPU they run ``luma_pass_plain``, the edge loop of the JAX
  ``lax.scan`` with all row groups vectorized per step.
- ``chroma_pass`` / ``chroma_filter`` likewise launch ``chroma_edges`` or
  run ``chroma_pass_plain``, one masked update per direction.
- ``deblock_picture`` drives a picture through them.

Packed entries: luma ``beta << 16 | tc << 1 | mask``, chroma
``tc << 1 | apply``; tc and beta are table values shifted by the bit
depth, so they fit.
"""
import numpy as np
import torch

from .. import constants as k
from .. import kernels
from ..ops import deblock as dbk
from ..profiling import span
from . import dsp


# ---------------------------------------------------------------------------
# Plain edge derivation (numpy, as the JAX module has it on the host)
# ---------------------------------------------------------------------------

def paint_cu_map_plain(attrs, n_cus, map_h, map_w):
    """Per-4x4 map of CU indices from the rectangles in ``attrs[:, 0:4]``
    (x, y, w, h); -1 where no CU lies.  The leaves of one tree do not
    overlap, so the order of painting does not matter."""
    cu_map = np.full((map_h, map_w), -1, np.int32)
    a = attrs[:n_cus].astype(np.int64)
    x0, y0 = a[:, 0] >> 2, a[:, 1] >> 2
    w = np.maximum(np.minimum(map_w, (a[:, 0] + a[:, 2] + 3) >> 2) - x0, 0)
    h = np.maximum(np.minimum(map_h, (a[:, 1] + a[:, 3] + 3) >> 2) - y0, 0)
    cells = w * h
    idx = np.repeat(np.arange(n_cus), cells)
    c = np.arange(int(cells.sum())) - np.repeat(np.cumsum(cells) - cells,
                                                cells)
    cu_map[y0[idx] + c // w[idx], x0[idx] + c % w[idx]] = idx
    return cu_map


def _gather_mv(attrs, idx, lst, corner):
    """corner is an (ny, nx) array; returns (mvx, mvy) arrays."""
    base = attrs[idx]  # (ny, nx, 27)
    cx = 11 + lst * 8 + corner * 2
    mvx = np.take_along_axis(base, cx[..., None], axis=-1)[..., 0]
    mvy = np.take_along_axis(base, (cx + 1)[..., None], axis=-1)[..., 0]
    return mvx, mvy


def compute_edge_metadata(width, height, pred_bi, cu_map, attrs, direction,
                          subblock_size, restr_flags):
    """Vectorized _get_boundary_strength over the whole picture
    (ref: deblocking_filter.cc:154-241).  Returns dict with per-subblock
    (ny, nx) arrays: bs, qp_luma, qp_chroma (x = edge positions along
    the filter direction, y = along the edge).  For direction 1 the
    arrays are in transposed coordinates (x = vertical edge position in
    the transposed plane).  ``restr_flags`` = (disable_deblock_boundary_
    strength_zero, ..._one, disable_deblock_depending_on_qp)."""
    bs_zero_off, bs_one_off, fixed_qp = restr_flags
    W, H = width, height
    if direction == 1:
        W, H = H, W
    one_step = 16
    xs = np.arange(subblock_size, W, subblock_size)
    ys = np.arange(0, H, subblock_size)
    if direction == 0:
        # p is the CU at (x-1, y): x is a multiple of sbs>=4 so
        # (x-1)>>2 == (x>>2) - 1
        iq = cu_map[np.ix_(ys >> 2, xs >> 2)]
        ip = cu_map[np.ix_(ys >> 2, (xs >> 2) - 1)]
    else:
        iq = cu_map[np.ix_(xs >> 2, ys >> 2)].T
        ip = cu_map[np.ix_((xs >> 2) - 1, ys >> 2)].T
    a_p = attrs[ip]
    a_q = attrs[iq]
    skip = ip == iq

    ycoord = ys[:, None].astype(np.int64)
    if direction == 0:
        # vertical edge: corner from y offset within CU
        corner_p = np.where((ycoord - a_p[..., 1]) < (a_p[..., 3] >> 1), 1, 3)
        corner_q = np.where((ycoord - a_q[..., 1]) < (a_q[..., 3] >> 1), 0, 2)
    else:
        # horizontal edge: corner from x offset within CU; in transposed
        # coords the edge position is xcoord (= y in picture coords) and
        # ycoord runs along the edge (= x in picture coords)
        corner_p = np.where((ycoord - a_p[..., 0]) < (a_p[..., 2] >> 1), 2, 3)
        corner_q = np.where((ycoord - a_q[..., 0]) < (a_q[..., 2] >> 1), 0, 1)

    base = np.int32(1 if bs_zero_off else 0)
    if pred_bi:
        rp0, rp1 = a_p[..., 8], a_p[..., 9]
        rq0, rq1 = a_q[..., 8], a_q[..., 9]
        match = ((rp0 == rq0) & (rp1 == rq1)) | ((rp0 == rq1) & (rp1 == rq0))
        p0x, p0y = _gather_mv(attrs, ip, 0, corner_p)
        p1x, p1y = _gather_mv(attrs, ip, 1, corner_p)
        q0x, q0y = _gather_mv(attrs, iq, 0, corner_q)
        q1x, q1y = _gather_mv(attrs, iq, 1, corner_q)
        cond1 = ((np.abs(p0x - q0x) >= one_step) |
                 (np.abs(p0y - q0y) >= one_step) |
                 (np.abs(p1x - q1x) >= one_step) |
                 (np.abs(p1y - q1y) >= one_step))
        cond2 = ((np.abs(p0x - q1x) >= one_step) |
                 (np.abs(p0y - q1y) >= one_step) |
                 (np.abs(p1x - q0x) >= one_step) |
                 (np.abs(p1y - q0y) >= one_step))
        inner = np.where(rp0 != rp1,
                         np.where(rp0 == rq0, cond1, cond2),
                         cond1 & cond2)
        bs_mv = np.where(match, np.where(inner, 1, base), 1).astype(np.int32)
    else:
        p0x, p0y = _gather_mv(attrs, ip, 0, corner_p)
        q0x, q0y = _gather_mv(attrs, iq, 0, corner_q)
        diff = (np.abs(p0x - q0x) >= one_step) | (np.abs(p0y - q0y) >=
                                                  one_step)
        bs_mv = np.where((a_p[..., 10] != a_q[..., 10]) | diff, 1,
                         base).astype(np.int32)

    intra_m = (a_p[..., 4] != 0) | (a_q[..., 4] != 0)
    cbf_m = (a_p[..., 5] != 0) | (a_q[..., 5] != 0)
    bs = np.where(intra_m, 2, np.where(cbf_m, 1, bs_mv))
    if bs_one_off:
        bs = np.where(bs == 1, 2, bs)
    bs = np.where(skip, 0, bs)

    qp_l = (a_p[..., 6] + a_q[..., 6] + 1) >> 1
    qp_c = (a_p[..., 7] + a_q[..., 7] + 1) >> 1
    if fixed_qp:
        qp_l = np.full_like(qp_l, 32)
        qp_c = np.full_like(qp_c, 31)
    return {"bs": bs, "qp_l": qp_l.astype(np.int32),
            "qp_c": qp_c.astype(np.int32), "xs": xs}


_TC = np.asarray(dbk.TC_TABLE, np.int32)
_BETA = np.asarray(dbk.BETA_TABLE, np.int32)


def luma_edge_tensors(meta, subblock_size, beta_offset, tc_offset, bitdepth):
    """Expand per-subblock metadata to per-4-row filter groups, oriented
    (n_edges, n_groups)."""
    bs, qp = meta["bs"], meta["qp_l"]
    sh = bitdepth - 8
    idx_b = np.clip(qp + beta_offset, 0, len(_BETA) - 1)
    beta = _BETA[idx_b] << sh
    idx_t = np.clip(qp + tc_offset + 2 * (bs - 1), 0, len(_TC) - 1)
    tc = _TC[idx_t] << sh
    rep = subblock_size // dbk.FILTER_GROUP_SIZE
    mask = (bs > 0)
    expand = lambda a: np.repeat(a, rep, axis=0).T.copy()
    return (expand(mask), expand(tc.astype(np.int32)),
            expand(beta.astype(np.int32)))


def chroma_edge_tensors(meta, direction, subblock_size, tc_offset,
                        bitdepth, csx, csy):
    """Per chroma (edge, row) apply mask + tc, in (transposed-for-dir1)
    chroma coords.  Returns (edges, apply (E, Hc), tc (E, Hc)) or None
    if no chroma edges exist."""
    bs, qp = meta["bs"], meta["qp_c"]
    # scale along the filter direction / along the edge
    es = csx if direction == 0 else csy      # edge-position scale
    rs = csy if direction == 0 else csx      # along-edge (row) scale
    stride_luma = dbk.CHROMA_FILTER_RESOLUTION << es
    col_stride = stride_luma // subblock_size
    if col_stride < 1 or bs.shape[1] < col_stride:
        return None
    sub_bs = bs[:, col_stride - 1::col_stride]
    sub_qp = qp[:, col_stride - 1::col_stride]
    ssb = subblock_size >> rs
    apply = np.repeat(sub_bs == 2, ssb, axis=0).T.copy()
    sh = bitdepth - 8
    idx_t = np.clip(sub_qp + tc_offset + 2, 0, len(_TC) - 1)
    tc = np.repeat(_TC[idx_t] << sh, ssb, axis=0).T.copy()
    edges = (meta["xs"][col_stride - 1::col_stride] >> es).astype(np.int32)
    return edges, apply, tc.astype(np.int32)


# ---------------------------------------------------------------------------
# The packed edge entries of one CU tree
# ---------------------------------------------------------------------------

class EdgeLayout:
    """Where the entries of one CU tree's two directions lie in the int32
    vector that ``edge_params`` returns.  For direction ``d`` (0 vertical
    edges, 1 horizontal): ``nx[d]`` edge positions ``sbs * (e + 1)``,
    ``ny[d]`` sub-blocks of ``sbs`` samples along an edge, luma entries
    ``[nx][ny]`` at ``luma_off[d]`` (-1: none), every
    ``chroma_stride[d]``-th position a chroma edge, ``nce[d]`` of them,
    entries ``[nce][ny]`` at ``chroma_off[d]`` (-1: none)."""

    def __init__(self, width, height, sbs, csx, csy, do_luma, do_chroma):
        if sbs not in (4, 8):
            raise ValueError("sub-block size %r" % (sbs,))
        self.width, self.height, self.sbs = width, height, sbs
        self.csx, self.csy = csx, csy
        self.map_w, self.map_h = (width + 3) >> 2, (height + 3) >> 2
        self.nx, self.ny, self.chroma_stride, self.nce = [], [], [], []
        self.luma_off, self.chroma_off = [], []
        total = 0
        for d, (across, along) in enumerate(((width, height),
                                             (height, width))):
            nx, ny = (across - 1) // sbs, (along + sbs - 1) // sbs
            es = csx if d == 0 else csy
            stride = (dbk.CHROMA_FILTER_RESOLUTION << es) // sbs
            nce = nx // stride if do_chroma and stride >= 1 else 0
            self.nx.append(nx)
            self.ny.append(ny)
            self.chroma_stride.append(stride if nce else 0)
            self.nce.append(nce)
            self.luma_off.append(total if do_luma and nx else -1)
            total += nx * ny if do_luma else 0
            self.chroma_off.append(total if nce else -1)
            total += nce * ny
        self.total = total

    def luma_shift(self):
        """A line's luma entry is ``line >> luma_shift()``."""
        return self.sbs.bit_length() - 1

    def chroma_shift(self, d):
        """A chroma sample's entry along an edge of direction ``d``."""
        rs = self.csy if d == 0 else self.csx
        return (self.sbs >> rs).bit_length() - 1


def pack_luma(mask, tc, beta):
    return (beta << 16) | (tc << 1) | (mask != 0).to(torch.int32)


def pack_chroma(apply, tc):
    return (tc << 1) | (apply != 0).to(torch.int32)


def luma_tensors(params, lay, d):
    """The luma entries of direction ``d`` as the JAX module's tensors:
    ``xs`` (E,), ``mask``, ``tc``, ``beta`` (E, groups) int32, one column
    per 4-line group as ``luma_edge_tensors`` expands them."""
    nx, ny = lay.nx[d], lay.ny[d]
    p = params[lay.luma_off[d]:lay.luma_off[d] + nx * ny].view(nx, ny)
    p = p.repeat_interleave(lay.sbs // dbk.FILTER_GROUP_SIZE, dim=1)
    xs = torch.arange(1, nx + 1, dtype=torch.int32,
                      device=params.device) * lay.sbs
    return xs, p & 1, (p >> 1) & 0x7fff, (p >> 16) & 0xffff


def chroma_tensors(params, lay, d):
    """The chroma entries of direction ``d`` as ``chroma_edge_tensors``
    returns them: ``edges`` (E,), ``apply``, ``tc`` (E, samples along the
    edge) int32."""
    nce, ny = lay.nce[d], lay.ny[d]
    p = params[lay.chroma_off[d]:lay.chroma_off[d] + nce * ny].view(nce, ny)
    p = p.repeat_interleave(1 << lay.chroma_shift(d), dim=1)
    edges = torch.arange(1, nce + 1, dtype=torch.int32,
                         device=params.device) * dbk.CHROMA_FILTER_RESOLUTION
    return edges, p & 1, p >> 1


def edge_params(attrs, n_cus, lay, beta_offset, tc_offset, bitdepth,
                pred_bi, restr_flags):
    """The CU map and the packed edge entries of one CU tree, both
    directions.  attrs (rows, 27) int32, of which the first ``n_cus`` are
    CUs to paint (``ops.deblock.build_cu_attrs``); ``restr_flags`` as in
    ``compute_edge_metadata``.  Returns (cu_map (map_h, map_w) int32,
    params (lay.total,) int32) on the device of ``attrs``."""
    kernels.require(attrs, torch.int32, 2, "attrs")
    if attrs.shape[1] != 27 or not 0 <= n_cus <= attrs.shape[0] or \
            attrs.shape[0] < 1:
        raise ValueError("attrs %r with %d CUs" % (tuple(attrs.shape), n_cus))
    args = (attrs, n_cus, lay, beta_offset, tc_offset, bitdepth, pred_bi,
            restr_flags)
    if not kernels.on_cuda(attrs):
        return edge_params_plain(*args)
    from ..kernels import build
    cu_map = torch.empty((lay.map_h, lay.map_w), dtype=torch.int32,
                         device=attrs.device)
    params = torch.empty(lay.total, dtype=torch.int32, device=attrs.device)
    cfg = [lay.width, lay.height, n_cus, attrs.shape[0], lay.sbs,
           beta_offset, tc_offset, bitdepth - 8, int(bool(pred_bi))]
    cfg += [int(bool(f)) for f in restr_flags]
    for d in (0, 1):
        cfg += [lay.nx[d], lay.ny[d], lay.chroma_stride[d], lay.luma_off[d],
                lay.chroma_off[d]]
    cfg = np.asarray(cfg, np.int32)
    rc = build.lib().xvc_deblock_edges(
        build.ptr(cu_map), build.ptr(attrs), build.ptr(params),
        cfg.ctypes.data, build.stream_of(attrs))
    build.check(rc, "deblock_edges")
    kernels.count_launch("deblock_edges")
    return cu_map, params


def edge_params_plain(attrs, n_cus, lay, beta_offset, tc_offset, bitdepth,
                      pred_bi, restr_flags):
    """Plain version of ``edge_params``: the numpy derivation behind
    tensor arguments, packed into the same layout."""
    a = attrs.cpu().numpy()
    cu_map = paint_cu_map_plain(a, n_cus, lay.map_h, lay.map_w)
    out = np.zeros(lay.total, np.int32)
    T = torch.from_numpy
    for d in (0, 1):
        if not lay.nx[d]:
            continue
        meta = compute_edge_metadata(lay.width, lay.height, pred_bi, cu_map,
                                     a, d, lay.sbs, restr_flags)
        ny = lay.ny[d]
        if lay.luma_off[d] >= 0:
            mask, tc, beta = luma_edge_tensors(meta, lay.sbs, beta_offset,
                                               tc_offset, bitdepth)
            rep = lay.sbs // dbk.FILTER_GROUP_SIZE
            packed = pack_luma(*(T(np.ascontiguousarray(t[:, ::rep]).astype(
                np.int32)) for t in (mask, tc, beta)))
            out[lay.luma_off[d]:lay.luma_off[d] + lay.nx[d] * ny] = \
                packed.numpy().reshape(-1)
        if lay.chroma_off[d] >= 0:
            _, apply, tc = chroma_edge_tensors(meta, d, lay.sbs, tc_offset,
                                               bitdepth, lay.csx, lay.csy)
            ssb = 1 << lay.chroma_shift(d)
            packed = pack_chroma(*(T(np.ascontiguousarray(
                t[:, ::ssb]).astype(np.int32)) for t in (apply, tc)))
            out[lay.chroma_off[d]:lay.chroma_off[d] + lay.nce[d] * ny] = \
                packed.numpy().reshape(-1)
    return T(cu_map).to(attrs.device), T(out).to(attrs.device)


# ---------------------------------------------------------------------------
# Luma
# ---------------------------------------------------------------------------

def _flag_ints(flags):
    if len(flags) != 5:
        raise ValueError("five luma restriction flags, got %r" % (flags,))
    return [1 if f else 0 for f in flags]


def _launch_luma(plane, direction, xs, edge_step, params, E, nsub, shift,
                 bitdepth, flags):
    """Launch ``luma_walk`` unless there is nothing to filter."""
    H, W = plane.shape
    across, L = (H, W) if direction == 0 else (W, H)
    if E == 0 or across < dbk.FILTER_GROUP_SIZE:
        return
    if L < 8:
        raise ValueError("a luma strip is 8 samples, the plane has %d" % L)
    from ..kernels import build
    rc = build.lib().xvc_deblock_luma(
        build.ptr(plane), H, W, direction,
        None if xs is None else build.ptr(xs), edge_step, build.ptr(params),
        E, nsub, shift, bitdepth, *_flag_ints(flags), build.stream_of(plane))
    build.check(rc, "deblock_luma")
    kernels.count_launch("deblock_luma")


def luma_pass(plane, xs, mask, tc, beta, bitdepth, flags, direction=0):
    """One luma filter direction, in place.  plane (H, W) int16.
    Direction 0 filters across columns: xs (E,) edge columns in scan
    order; mask, tc, beta (E, H/4) int32, one column per 4-row group, tc
    and beta as the tables give them (0 <= tc < 2^15, 0 <= beta < 2^16).
    Direction 1 filters across rows of the plane as it lies: xs are edge
    rows and the tensors are (E, W/4), one column per 4-column group;
    the result is that of direction 0 on the transposed plane.
    flags = (disable_initial_decision, disable_strong, disable_weak,
    disable_weak_sample_decision, disable_two_samples_weak)."""
    kernels.require(plane, torch.int16, 2, "plane")
    kernels.require(xs, torch.int32, 1, "xs")
    for t, name in ((mask, "mask"), (tc, "tc"), (beta, "beta")):
        kernels.require(t, torch.int32, 2, name)
    if direction not in (0, 1):
        raise ValueError("direction %r" % (direction,))
    E, G = mask.shape
    if xs.shape[0] != E or tc.shape != (E, G) or beta.shape != (E, G) or \
            G != plane.shape[direction] // dbk.FILTER_GROUP_SIZE:
        raise ValueError("luma edge tensors disagree with the plane")
    if not kernels.on_cuda(plane, xs, mask, tc, beta):
        luma_pass_plain(plane, xs, mask, tc, beta, bitdepth, flags, direction)
        return
    if G:
        _launch_luma(plane, direction, xs, 0, pack_luma(mask, tc, beta), E,
                     G, 2, bitdepth, flags)


def luma_filter(plane, params, lay, direction, bitdepth, flags):
    """``luma_pass`` from the packed entries of ``edge_params``: the edges
    of ``direction`` at ``lay.sbs * (e + 1)``, every position walked, an
    edge whose groups are all masked out skipped on the card."""
    kernels.require(plane, torch.int16, 2, "plane")
    kernels.require(params, torch.int32, 1, "params")
    if tuple(plane.shape) != (lay.height, lay.width) or \
            params.shape[0] != lay.total:
        raise ValueError("plane or entries disagree with the layout")
    if lay.luma_off[direction] < 0:
        return
    if not kernels.on_cuda(plane, params):
        xs, mask, tc, beta = luma_tensors(params, lay, direction)
        G = plane.shape[direction] // dbk.FILTER_GROUP_SIZE
        live = mask.any(dim=1)  # inactive edges are no-op steps
        luma_pass_plain(plane, xs[live], mask[live, :G], tc[live, :G],
                        beta[live, :G], bitdepth, flags, direction)
        return
    nx, ny = lay.nx[direction], lay.ny[direction]
    off = lay.luma_off[direction]
    _launch_luma(plane, direction, None, lay.sbs, params[off:off + nx * ny],
                 nx, ny, lay.luma_shift(), bitdepth, flags)


def luma_pass_plain(plane, xs, mask, tc, beta, bitdepth, flags, direction=0):
    """Plain PyTorch version of ``luma_pass``: the scan body of
    deblock_jax.make_luma_pass, one edge at a time; direction 1 runs it
    on the transposed view of the plane."""
    if direction == 1:
        plane = plane.t()
    (dis_initial, dis_strong, dis_weak, dis_weak_sample,
     dis_two_samples) = flags
    H, W = plane.shape
    groups = H // dbk.FILTER_GROUP_SIZE
    max_val = (1 << bitdepth) - 1
    for e, xe in enumerate(xs.tolist()):
        x0 = dsp.ds_start(xe - 4, W, 8)
        strip = plane[:groups * 4, x0:x0 + 8]
        s = strip.reshape(groups, 4, 8).to(torch.int32)
        p3, p2, p1, p0 = s[:, :, 0], s[:, :, 1], s[:, :, 2], s[:, :, 3]
        q0, q1, q2, q3 = s[:, :, 4], s[:, :, 5], s[:, :, 6], s[:, :, 7]
        dp = (p2 - 2 * p1 + p0).abs()
        dq = (q0 - 2 * q1 + q2).abs()
        dp0, dp3 = dp[:, 0], dp[:, 3]
        dq0, dq3 = dq[:, 0], dq[:, 3]
        d0 = dp0 + dq0
        d3 = dp3 + dq3
        bt = beta[e]
        tcv = tc[e]
        act = (mask[e] != 0) & ((d0 + d3 < bt) | bool(dis_initial))

        def chk_strong(i):
            t2 = ((s[:, i, 0] - s[:, i, 3]).abs() +
                  (s[:, i, 4] - s[:, i, 7]).abs()) < (bt >> 3)
            t3 = (s[:, i, 3] - s[:, i, 4]).abs() < ((tcv * 5 + 1) >> 1)
            return t2 & t3

        strong = (((d0 << 1) < (bt >> 2)) & ((d3 << 1) < (bt >> 2)) &
                  chk_strong(0) & chk_strong(3))
        if dis_strong:
            strong = torch.zeros_like(strong)
        tc2 = (2 * tcv)[:, None]
        np2 = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3
        np1 = (p2 + p1 + p0 + q0 + 2) >> 2
        np0 = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3
        nq0 = (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3
        nq1 = (p0 + q0 + q1 + q2 + 2) >> 2
        nq2 = (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3

        def cl(n, o):
            return o + torch.maximum(torch.minimum(n - o, tc2), -tc2)

        strong_cols = [cl(np2, p2), cl(np1, p1), cl(np0, p0), cl(nq0, q0),
                       cl(nq1, q1), cl(nq2, q2)]
        tcc = tcv[:, None]
        delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
        wmask = (delta.abs() < tcc * 10) | bool(dis_weak_sample)
        dlt = torch.maximum(torch.minimum(delta, tcc), -tcc)
        wp0 = (p0 + dlt).clamp(0, max_val)
        wq0 = (q0 - dlt).clamp(0, max_val)
        side_thr = (bt + (bt >> 1)) >> 3
        half_tc = (tcv >> 1)[:, None]
        fp1 = ((dp0 + dp3) < side_thr)[:, None]
        fq1 = ((dq0 + dq3) < side_thr)[:, None]
        dp1 = torch.maximum(torch.minimum(
            (((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1, half_tc), -half_tc)
        dq1 = torch.maximum(torch.minimum(
            (((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1, half_tc), -half_tc)
        wp1 = (p1 + dp1).clamp(0, max_val)
        wq1 = (q1 + dq1).clamp(0, max_val)
        if dis_two_samples:
            fp1 = torch.zeros_like(fp1)
            fq1 = torch.zeros_like(fq1)
        actv = act[:, None]
        do_strong = actv & strong[:, None]
        if dis_weak:
            do_weak = torch.zeros_like(wmask)
        else:
            do_weak = actv & ~strong[:, None] & wmask
        cols = {1: p2, 2: p1, 3: p0, 4: q0, 5: q1, 6: q2}
        new = {j: torch.where(do_strong, sc, cols[j])
               for j, sc in zip((1, 2, 3, 4, 5, 6), strong_cols)}
        new[2] = torch.where(do_weak & fp1, wp1, new[2])
        new[3] = torch.where(do_weak, wp0, new[3])
        new[4] = torch.where(do_weak, wq0, new[4])
        new[5] = torch.where(do_weak & fq1, wq1, new[5])
        out = s.clone()
        for j in range(1, 7):
            out[:, :, j] = new[j]
        strip.copy_(out.reshape(groups * 4, 8))


# ---------------------------------------------------------------------------
# Chroma
# ---------------------------------------------------------------------------

def _launch_chroma(planes, direction, edges, edge_step, params, E, nsub,
                   shift, bitdepth):
    """Launch ``chroma_edges`` on one plane or two of one shape."""
    H, W = planes[0].shape
    if E == 0 or H == 0 or W == 0:
        return
    from ..kernels import build
    rc = build.lib().xvc_deblock_chroma(
        build.ptr(planes[0]),
        build.ptr(planes[1]) if len(planes) > 1 else None, H, W, direction,
        None if edges is None else build.ptr(edges), edge_step,
        build.ptr(params), E, nsub, shift, bitdepth,
        build.stream_of(planes[0]))
    build.check(rc, "deblock_chroma")
    kernels.count_launch("deblock_chroma")


def chroma_pass(plane, edges, apply, tc, bitdepth, direction=0):
    """One chroma filter direction, one masked parallel update, in
    place.  plane (H, W) int16.  Direction 0: edges (E,) columns, at
    least 4 apart and in [2, W - 2]; apply, tc (E, H) int32 with
    0 <= tc < 2^30.  Direction 1 filters across rows of the plane as it
    lies: edges are rows and the tensors are (E, W)."""
    kernels.require(plane, torch.int16, 2, "plane")
    kernels.require(edges, torch.int32, 1, "edges")
    kernels.require(apply, torch.int32, 2, "apply")
    kernels.require(tc, torch.int32, 2, "tc")
    if direction not in (0, 1):
        raise ValueError("direction %r" % (direction,))
    E, N = apply.shape
    if edges.shape[0] != E or tc.shape != (E, N) or \
            N != plane.shape[direction]:
        raise ValueError("chroma edge tensors disagree with the plane")
    if not kernels.on_cuda(plane, edges, apply, tc):
        chroma_pass_plain(plane, edges, apply, tc, bitdepth, direction)
        return
    if N:
        _launch_chroma([plane], direction, edges, 0, pack_chroma(apply, tc),
                       E, N, 0, bitdepth)


def chroma_filter(planes, params, lay, direction, bitdepth):
    """``chroma_pass`` on the U and V planes from the packed entries of
    ``edge_params`` (chroma edges at 8, 16, ...)."""
    for plane in planes:
        kernels.require(plane, torch.int16, 2, "plane")
        if plane.shape != planes[0].shape:
            raise ValueError("chroma planes of two shapes")
    kernels.require(params, torch.int32, 1, "params")
    if params.shape[0] != lay.total:
        raise ValueError("entries disagree with the layout")
    if lay.chroma_off[direction] < 0:
        return
    nce, ny = lay.nce[direction], lay.ny[direction]
    shift = lay.chroma_shift(direction)
    if planes[0].shape[direction] > ny << shift:
        raise ValueError("chroma plane longer than its edges")
    if not kernels.on_cuda(params, *planes):
        edges, apply, tc = chroma_tensors(params, lay, direction)
        N = planes[0].shape[direction]
        if apply.any():
            for plane in planes:
                chroma_pass_plain(plane, edges, apply[:, :N], tc[:, :N],
                                  bitdepth, direction)
        return
    off = lay.chroma_off[direction]
    _launch_chroma(planes, direction, None, dbk.CHROMA_FILTER_RESOLUTION,
                   params[off:off + nce * ny], nce, ny, shift, bitdepth)


def chroma_pass_plain(plane, edges, apply, tc, bitdepth, direction=0):
    """Plain PyTorch version of ``chroma_pass``
    (deblock_jax.make_chroma_pass); direction 1 runs it on the
    transposed view of the plane."""
    if direction == 1:
        plane = plane.t()
    max_val = (1 << bitdepth) - 1
    dev = plane.device
    idx = edges.long()[:, None] + torch.arange(-2, 2, device=dev)[None, :]
    win = plane[:, idx].to(torch.int32)                  # (H, E, 4)
    p1, p0 = win[:, :, 0], win[:, :, 1]
    q0, q1 = win[:, :, 2], win[:, :, 3]
    tcv = tc.t()
    delta = torch.maximum(torch.minimum(
        (((q0 - p0) * 4) + p1 - q1 + 4) >> 3, tcv), -tcv)
    m = apply.t() != 0
    np0 = torch.where(m, (p0 + delta).clamp(0, max_val), p0)
    nq0 = torch.where(m, (q0 - delta).clamp(0, max_val), q0)
    rows = torch.arange(plane.shape[0], device=dev)[:, None]
    plane[rows, (edges.long() - 1)[None, :]] = np0.to(plane.dtype)
    plane[rows, edges.long()[None, :]] = nq0.to(plane.dtype)


# ---------------------------------------------------------------------------
# A picture
# ---------------------------------------------------------------------------

def picture_passes(filt):
    """The CU trees a picture's deblocking reads, as (cu_tree, EdgeLayout)
    in filter order, and its luma flags."""
    pic, rec, r = filt.pic, filt.rec, filt.restr
    sbs = dbk.SUBBLOCK_SIZE if r.disable_ext_deblock_subblock_size_4 \
        else dbk.SUBBLOCK_SIZE_EXT
    chroma_ok = (pic.max_num_components > 1 and
                 not r.disable_deblock_chroma_filter)
    csx, csy = (rec.shift_x[1], rec.shift_y[1]) if chroma_ok else (0, 0)
    mk = lambda s, luma, chroma: EdgeLayout(pic.width, pic.height, s, csx,
                                            csy, luma, chroma)
    if pic.has_secondary_cu_tree():
        passes = [(k.CuTree.PRIMARY, mk(sbs, True, False)),
                  (k.CuTree.SECONDARY, mk(dbk.SUBBLOCK_SIZE, False,
                                          chroma_ok))]
    else:
        passes = [(k.CuTree.PRIMARY, mk(sbs, True, chroma_ok))]
    flags = (bool(r.disable_deblock_initial_sample_decision),
             bool(r.disable_deblock_strong_filter),
             bool(r.disable_deblock_weak_filter),
             bool(r.disable_deblock_weak_sample_decision),
             bool(r.disable_deblock_two_samples_weak_filter))
    return passes, flags


def deblock_picture(filt, planes, device):
    """Deblock a whole picture on ``device``.  ``filt`` is the host
    ``DeblockingFilter`` (picture data, offsets, restrictions);
    ``planes`` maps component -> visible (H, W) int16 device plane,
    filtered in place.  The host builds the per-CU attribute tables and
    uploads them at once; the edge decisions and both filter directions
    run on the device with nothing read back."""
    pic, r = filt.pic, filt.restr
    passes, flags = picture_passes(filt)
    restr_flags = (r.disable_deblock_boundary_strength_zero,
                   r.disable_deblock_boundary_strength_one,
                   r.disable_deblock_depending_on_qp)
    pred_bi = pic.get_prediction_type() == k.PicturePredictionType.BI
    bd = pic.bitdepth

    batch = dsp.DevBatch()
    with span("deblock.meta"):
        tables = []
        for cu_tree, lay in passes:
            attrs, n_cus = filt.build_cu_attrs(cu_tree)
            tables.append((batch.add(attrs), n_cus, lay))
    with span("deblock.upload"):
        batch.upload(device)

    with span("deblock.passes"):
        with span("deblock.edges"):
            derived = [(lay, edge_params(
                batch.get(handle), n_cus, lay, filt.beta_offset,
                filt.tc_offset, bd, pred_bi, restr_flags)[1])
                for handle, n_cus, lay in tables]
        for direction in (0, 1):
            for lay, params in derived:
                luma_filter(planes[0], params, lay, direction, bd, flags)
                if lay.chroma_off[direction] >= 0:
                    chroma_filter([planes[1], planes[2]], params, lay,
                                  direction, bd)
    return planes
