"""In-loop deblocking on the device: luma edge scan (kernel 3) and the
chroma pass.

Port of ``xvc_tpu/tpu/deblock_jax.py``.  The boundary strengths and the
per-edge tc/beta/chroma gating are state independent, so they come from
the same numpy code as the JAX version (``compute_edge_metadata``,
``luma_edge_tensors``, ``chroma_edge_tensors``), fed by the CU maps of
``xvc_tpu.ops.deblock.DeblockingFilter._build_cu_maps``.

- ``luma_pass`` filters one direction in place.  On the card it launches
  ``kernels/csrc/deblock.cu`` (one thread per 4-row group walking the
  edges in order); on the CPU it runs ``luma_pass_plain``, the edge loop
  of the JAX ``lax.scan`` with all row groups vectorized per step.
- ``chroma_pass`` is one masked update per direction (plain PyTorch).
- Horizontal edges run on a contiguous transpose of the plane.
"""
import numpy as np
import torch

from xvc_tpu import constants as k
from xvc_tpu.ops import deblock as dbk
from xvc_tpu.tpu.deblock_jax import (chroma_edge_tensors,
                                     compute_edge_metadata,
                                     luma_edge_tensors)
from .. import kernels
from . import dsp


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
    for direction in (0, 1):
        for cu_tree, sbs, do_luma, do_chroma in passes:
            if cu_tree not in built:
                built[cu_tree] = filt._build_cu_maps(cu_tree)
            cu_map, attrs = built[cu_tree]
            meta = compute_edge_metadata(pic, cu_map, attrs, direction, sbs,
                                         filt.beta_offset, filt.tc_offset, r)
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
    batch.upload(device)

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
