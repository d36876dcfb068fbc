"""In-loop deblocking on the device: luma edge scan (kernel 3) and the
chroma pass.

Port of ``xvc_tpu/tpu/deblock_jax.py``.  The boundary strengths and the
per-edge tc/beta/chroma gating are state independent, so they are
computed on the host with numpy (``compute_edge_metadata``,
``luma_edge_tensors``, ``chroma_edge_tensors``, copied from the JAX
module), fed by the CU maps of
``ops.deblock.DeblockingFilter._build_cu_maps``.

- ``luma_pass`` filters one direction in place.  On the card it launches
  ``kernels/csrc/deblock.cu`` (one thread per 4-row group walking the
  edges in order); on the CPU it runs ``luma_pass_plain``, the edge loop
  of the JAX ``lax.scan`` with all row groups vectorized per step.
- ``chroma_pass`` is one masked update per direction (plain PyTorch).
- Horizontal edges run on a contiguous transpose of the plane.
"""
import numpy as np
import torch

from .. import constants as k
from .. import kernels
from ..ops import deblock as dbk
from ..profiling import span
from . import dsp


# ---------------------------------------------------------------------------
# Host-side metadata (vectorized boundary-strength derivation)
# ---------------------------------------------------------------------------

def _gather_mv(attrs, idx, lst, corner):
    """corner is an (ny, nx) array; returns (mvx, mvy) arrays."""
    base = attrs[idx]  # (ny, nx, 27)
    cx = 11 + lst * 8 + corner * 2
    mvx = np.take_along_axis(base, cx[..., None], axis=-1)[..., 0]
    mvy = np.take_along_axis(base, (cx + 1)[..., None], axis=-1)[..., 0]
    return mvx, mvy


def compute_edge_metadata(pic, cu_map, attrs, direction, subblock_size,
                          beta_offset, tc_offset, restr):
    """Vectorized _get_boundary_strength over the whole picture
    (ref: deblocking_filter.cc:154-241).  Returns dict with per-subblock
    (ny, nx) arrays: bs, qp_luma, qp_chroma (x = edge positions along
    the filter direction, y = along the edge).  For direction 1 the
    arrays are in transposed coordinates (x = vertical edge position in
    the transposed plane)."""
    W, H = pic.width, pic.height
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

    base = np.int32(1 if restr.disable_deblock_boundary_strength_zero else 0)
    bs = np.full(iq.shape, base, np.int32)

    pred_bi = pic.get_prediction_type() == k.PicturePredictionType.BI
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
    if restr.disable_deblock_boundary_strength_one:
        bs = np.where(bs == 1, 2, bs)
    bs = np.where(skip, 0, bs)

    qp_l = (a_p[..., 6] + a_q[..., 6] + 1) >> 1
    qp_c = (a_p[..., 7] + a_q[..., 7] + 1) >> 1
    if restr.disable_deblock_depending_on_qp:
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
# Device passes
# ---------------------------------------------------------------------------

def luma_pass(plane, xs, mask, tc, beta, bitdepth, flags):
    """One luma filter direction over vertical edges, in place.
    plane (H, W) int16; xs (E,) edge columns in scan order; mask, tc,
    beta (E, H/4) int32.  flags = (disable_initial_decision,
    disable_strong, disable_weak, disable_weak_sample_decision,
    disable_two_samples_weak)."""
    kernels.require(plane, torch.int16, 2, "plane")
    kernels.require(xs, torch.int32, 1, "xs")
    for t, name in ((mask, "mask"), (tc, "tc"), (beta, "beta")):
        kernels.require(t, torch.int32, 2, name)
    H, W = plane.shape
    E, G = mask.shape
    if xs.shape[0] != E or tc.shape != (E, G) or beta.shape != (E, G) or \
            G != H // dbk.FILTER_GROUP_SIZE:
        raise ValueError("luma edge tensors disagree with the plane")
    if not kernels.on_cuda(plane, xs, mask, tc, beta):
        luma_pass_plain(plane, xs, mask, tc, beta, bitdepth, flags)
        return
    from ..kernels import build
    rc = build.lib().xvc_deblock_luma(
        build.ptr(plane), H, W, build.ptr(xs), build.ptr(mask),
        build.ptr(tc), build.ptr(beta), E, G, bitdepth,
        *[1 if f else 0 for f in flags], build.stream_of(plane))
    build.check(rc, "deblock_luma")
    kernels.LAUNCHES["deblock_luma"] += 1


def luma_pass_plain(plane, xs, mask, tc, beta, bitdepth, flags):
    """Plain PyTorch version of ``luma_pass``: the scan body of
    deblock_jax.make_luma_pass, one edge at a time."""
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


def chroma_pass(plane, edges, apply, tc, bitdepth):
    """One chroma filter direction, one masked parallel update, in
    place.  plane (H, W) int16; edges (E,); apply, tc (E, H) int32."""
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


def deblock_picture(filt, planes, device):
    """Deblock a whole picture on ``device``.  ``filt`` is the host
    ``DeblockingFilter`` (picture data, offsets, restrictions);
    ``planes`` maps component -> visible (H, W) int16 device plane and is
    updated.  Mirrors deblock_jax.deblock_picture_jax without the mesh:
    all edge metadata is computed on the host and uploaded at once."""
    pic, rec, r = filt.pic, filt.rec, filt.restr
    subblock_size = dbk.SUBBLOCK_SIZE if \
        r.disable_ext_deblock_subblock_size_4 else dbk.SUBBLOCK_SIZE_EXT
    chroma_ok = (pic.max_num_components > 1 and
                 not r.disable_deblock_chroma_filter)
    if pic.has_secondary_cu_tree():
        passes = [(k.CuTree.PRIMARY, subblock_size, True, False),
                  (k.CuTree.SECONDARY, dbk.SUBBLOCK_SIZE, False, chroma_ok)]
    else:
        passes = [(k.CuTree.PRIMARY, subblock_size, True, chroma_ok)]
    flags = (bool(r.disable_deblock_initial_sample_decision),
             bool(r.disable_deblock_strong_filter),
             bool(r.disable_deblock_weak_filter),
             bool(r.disable_deblock_weak_sample_decision),
             bool(r.disable_deblock_two_samples_weak_filter))
    bd = pic.bitdepth
    csx, csy = rec.shift_x[1], rec.shift_y[1]

    built = {}
    work = []
    batch = dsp.DevBatch()
    with span("deblock.meta"):
        for direction in (0, 1):
            for cu_tree, sbs, do_luma, do_chroma in passes:
                if cu_tree not in built:
                    built[cu_tree] = filt._build_cu_maps(cu_tree)
                cu_map, attrs = built[cu_tree]
                meta = compute_edge_metadata(
                    pic, cu_map, attrs, direction, sbs, filt.beta_offset,
                    filt.tc_offset, r)
                if meta["xs"].size == 0:
                    continue
                if do_luma:
                    mask, tc, beta = luma_edge_tensors(
                        meta, sbs, filt.beta_offset, filt.tc_offset, bd)
                    # fully inactive edges are no-op steps: prune them
                    act = mask.any(axis=1)
                    xs = meta["xs"].astype(np.int32)[act]
                    if len(xs):
                        work.append((direction, "luma", batch.add(xs),
                                     batch.add(mask[act].astype(np.int32)),
                                     batch.add(tc[act]), batch.add(beta[act])))
                if do_chroma:
                    ct = chroma_edge_tensors(meta, direction, sbs,
                                             filt.tc_offset, bd, csx, csy)
                    if ct is None:
                        continue
                    edges, apply, tc = ct
                    if not apply.any():
                        continue
                    work.append((direction, "chroma", batch.add(edges),
                                 batch.add(apply.astype(np.int32)),
                                 batch.add(tc)))
    with span("deblock.upload"):
        batch.upload(device)

    with span("deblock.passes"):
        for item in work:
            direction, kind = item[0], item[1]
            args = [batch.get(h) for h in item[2:]]
            comps = (0,) if kind == "luma" else (1, 2)
            for comp in comps:
                pl = planes[comp].t().contiguous() if direction == 1 \
                    else planes[comp]
                if kind == "luma":
                    luma_pass(pl, *args, bd, flags)
                else:
                    chroma_pass(pl, *args, bd)
                if direction == 1:
                    planes[comp] = pl.t().contiguous()
    return planes
