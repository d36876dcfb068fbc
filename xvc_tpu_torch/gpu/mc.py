"""Batched sub-pel motion compensation + scatter (kernel 1).

``mc_picture`` is the decode path's: every inter prediction of a
picture in one launch, each job derived on the card from the parse's
record table (the work of ``xvc_tpu/tpu/flat_recon.py``
``_build_mc_groups``, its row emitters and its affine expansion, which
here is done by no host code), with ``mc_picture_plain`` beside it.

The group entry point ``mc_scatter`` ports ``xvc_tpu/tpu/pallas_mc.py`` (the Pallas MC kernel), of the MC
core of ``xvc_tpu/tpu/dsp.py`` and of the scatter in
``xvc_tpu/tpu/flat_recon.py make_mc_scatter``.  ``mc_scatter`` launches
``kernels/csrc/mc.cu`` for tensors on the card and runs
``mc_scatter_plain`` for tensors on the CPU.  Both read the frame-store
stack directly (luma (S, Hp, Wp), chroma reshaped to (2S, Hp, Wp)) and
the job parameters (10, B) int32 ``[stack_idx, ypad, xpad, fx, fy, chan,
cy, cx, w, h]``, and write the valid w x h region of each prediction
into ``pred[chan]``.  Lanes carrying the ``_BIG`` sentinel write nothing.
"""
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import constants as k
from ..codec import inter_mc as mc_tab
from ..codec import inter_mv as mv_mod
from .. import kernels
from . import dsp
from .itx import log2_sides
from .records import (C_AFFINE, C_DIR, C_H, C_MV, C_PRED, C_REF0, C_SPLIT,
                      C_TREE, C_W, C_X, C_Y, MIN_COLS)


def _check(pred, mask, planes, params):
    kernels.require(pred, torch.int16, 3, "pred")
    kernels.require(mask, torch.int16, 3, "mask")
    kernels.require(planes, torch.int16, 3, "planes")
    kernels.require(params, torch.int32, 2, "params")
    if params.shape[0] != 10:
        raise ValueError("params must be (10, B), got %r"
                         % (tuple(params.shape),))
    if pred.shape[1:] != mask.shape[1:] or \
            pred.shape[0] != 2 * mask.shape[0]:
        raise ValueError("pred (2n, H, W) and mask (n, H, W) disagree: %r %r"
                         % (tuple(pred.shape), tuple(mask.shape)))


def _check_staging(planes):
    """The kernels stage windows 16 bytes a lane: a reference stack's rows
    must be a multiple of 8 samples and its data 16-byte aligned (the
    frame store's rows are multiples of 128)."""
    if planes.shape[-1] % 8 or planes.data_ptr() % 16:
        raise ValueError("reference stack rows of %d samples at %#x: the "
                         "kernel needs a multiple of 8, 16-byte aligned"
                         % (planes.shape[-1], planes.data_ptr()))


def mc_scatter(pred, mask, planes, params, wb, hb, luma, bitdepth,
               high_prec, short_out):
    """In place: predict the jobs of one (wb, hb, luma, short) group and
    store them into ``pred`` (2*nplanes, H, W) int16; in short groups
    slot-1 jobs also set ``mask`` (nplanes, H, W) to 1."""
    _check(pred, mask, planes, params)
    if not kernels.on_cuda(pred, mask, planes, params):
        mc_scatter_plain(pred, mask, planes, params, wb, hb, luma, bitdepth,
                         high_prec, short_out)
        return
    from ..kernels import build
    _check_staging(planes)
    taps = mc_tab.NUM_TAPS_LUMA if luma else mc_tab.NUM_TAPS_CHROMA
    table = dsp._filter_table(luma, high_prec)
    R, Hp, Wp = planes.shape
    nchan, H, W = pred.shape
    if Hp < hb + taps - 1 or Wp < wb + taps - 1:
        raise ValueError("reference planes %r smaller than a window"
                         % ((Hp, Wp),))
    rc = build.lib().xvc_mc_scatter(
        build.ptr(planes), R, Hp, Wp, build.ptr(params), params.shape[1],
        wb, hb, taps, table.shape[0], table.ctypes.data, bitdepth,
        1 if short_out else 0, build.ptr(pred), nchan, H, W,
        build.ptr(mask), mask.shape[0], build.stream_of(pred))
    build.check(rc, "mc_scatter")
    kernels.count_launch("mc")


def mc_scatter_plain(pred, mask, planes, params, wb, hb, luma, bitdepth,
                     high_prec, short_out):
    """Plain PyTorch version of ``mc_scatter`` (same result)."""
    core = dsp._mc_core_builder(wb, hb, luma, bitdepth, high_prec,
                                short_out)
    out = core(planes, params[0], params[1], params[2], params[3],
               params[4])
    nchan, H, W = pred.shape
    nplanes = mask.shape[0]
    p = params.long()
    chan, cy, cx, w, h = p[5], p[6], p[7], p[8], p[9]
    dev = pred.device
    ar_h = torch.arange(hb, device=dev)
    ar_w = torch.arange(wb, device=dev)
    yy = cy[:, None] + ar_h[None, :]
    xx = cx[:, None] + ar_w[None, :]
    ok_y = (ar_h[None, :] < h[:, None]) & (yy >= 0) & (yy < H)
    ok_x = (ar_w[None, :] < w[:, None]) & (xx >= 0) & (xx < W)
    lane = (chan >= 0) & (chan < nchan)
    keep = lane[:, None, None] & ok_y[:, :, None] & ok_x[:, None, :]
    b, i, j = keep.nonzero(as_tuple=True)
    pred[chan[b], yy[b, i], xx[b, j]] = out[b, i, j]
    if short_out:
        sel = chan[b] >= nplanes
        b, i, j = b[sel], i[sel], j[sel]
        mask[chan[b] - nplanes, yy[b, i], xx[b, j]] = 1



# ---------------------------------------------------------------------------
# The whole picture in one launch
# ---------------------------------------------------------------------------

MAX_REFS = 5   # reference table entries per list


@dataclass(frozen=True)
class McFlags:
    """What a picture's MC needs besides its records and reference table:
    bit depth, high-precision MVs, chroma sub-pel (off when the segment
    disables it), the chroma shifts, the frame store's margins (pad_x,
    pad_y of luma and of chroma) and the luma picture size (the affine
    MV limits)."""
    bitdepth: int
    hp_mv: bool
    chroma_subpel: bool
    sx: int
    sy: int
    pad: tuple          # (pad_x luma, pad_y luma, pad_x chroma, pad_y chroma)
    luma_w: int
    luma_h: int

    def cfg(self):
        """The flags as the int32 header of ``xvc_mc_picture``'s config."""
        return [self.bitdepth, int(self.hp_mv), int(self.chroma_subpel),
                self.sx, self.sy] + list(self.pad) + [self.luma_w,
                                                      self.luma_h]


def _bucket(n):
    """The window height / width class of a job (8, 16, 32, 64): its
    window start is clamped as for a window of that size
    (``flat_recon._bucket`` of the JAX package)."""
    return torch.where(n <= 8, 8, torch.where(n <= 16, 16, torch.where(
        n <= 32, 32, 64)))


def _clip_mv(mvx, mvy, posx, posy, rw, rh):
    """clip_mv (ref: inter_prediction.cc:769-782)."""
    sh = mv_mod.MV_PRECISION_SHIFT
    mvx = torch.minimum(torch.maximum(
        mvx, -((k.MAX_BLOCK_SIZE + 8 + posx - 1) << sh)),
        (rw + 8 - posx - 1) << sh)
    mvy = torch.minimum(torch.maximum(
        mvy, -((k.MAX_BLOCK_SIZE + 8 + posy - 1) << sh)),
        (rh + 8 - posy - 1) << sh)
    return mvx, mvy


def _pel_frac(mvx, mvy, comp, flags):
    """Full-pel offset and filter phase of one component
    (ref: inter_prediction.cc:1174-1205 GetFullpelRef)."""
    sx = 0 if comp == 0 else flags.sx
    sy = 0 if comp == 0 else flags.sy
    shift_x = mv_mod.MV_PRECISION_SHIFT + sx
    shift_y = mv_mod.MV_PRECISION_SHIFT + sy
    if comp != 0 and not flags.chroma_subpel:
        pel_x = (mvx + (1 << (shift_x - 1))) >> shift_x
        pel_y = (mvy + (1 << (shift_y - 1))) >> shift_y
        fx, fy = mvx * 0, mvy * 0
    else:
        pel_x, pel_y = mvx >> shift_x, mvy >> shift_y
        fx = (mvx & ((1 << shift_x) - 1)) << (0 if comp == 0 else 1 - sx)
        fy = (mvy & ((1 << shift_y) - 1)) << (0 if comp == 0 else 1 - sy)
    if not flags.hp_mv:
        fx = fx >> mv_mod.HIGH_TO_NORMAL_DELTA
        fy = fy >> mv_mod.HIGH_TO_NORMAL_DELTA
    return pel_x, pel_y, fx, fy


def _leaves(records, refs, nstack, dims, flags):
    """The (leaf, dslot) pairs of the tree-0 inter leaves, guarded: per
    pair its record index, list, dslot, clipped corner MVs (3, 2) and
    reference slot; a pair whose reference index is outside 0..4, whose
    reference slot is missing (-1) or not below ``nstack``, or whose
    luma block is no power of two in 4..64 or starts outside the plane,
    is dropped."""
    r = records.long()
    BI, L1 = int(k.InterDir.BI), int(k.InterDir.L1)
    H, W = dims[0]
    inter = ((r[:, C_SPLIT] == 0) & (r[:, C_TREE] == 0) &
             (r[:, C_PRED] == 1) & (log2_sides(r[:, C_W], 4, 64) > 0) &
             (log2_sides(r[:, C_H], 4, 64) > 0) & (r[:, C_X] >= 0) &
             (r[:, C_X] < W) & (r[:, C_Y] >= 0) & (r[:, C_Y] < H))
    out = []
    refs = refs.long()
    for dslot in (0, 1):
        d = r[:, C_DIR]
        sel = inter & (d == BI) if dslot else inter
        lst = torch.ones_like(d) if dslot else (d == L1).long()
        ridx = r.gather(1, (C_REF0 + lst)[:, None])[:, 0]
        ok = sel & (ridx >= 0) & (ridx < MAX_REFS)
        ent = refs[lst, ridx.clamp(0, MAX_REFS - 1)]
        ok &= (ent[:, 0] >= 0) & (ent[:, 0] < nstack)
        i = ok.nonzero()[:, 0]
        lst, ent = lst[i], ent[i]
        mvs = []
        for c in range(3):
            col = (C_MV + 8 * lst + 2 * c)[:, None]
            mvs.append(torch.stack(_clip_mv(
                r[i].gather(1, col)[:, 0], r[i].gather(1, col + 1)[:, 0],
                r[i, C_X], r[i, C_Y], ent[:, 1], ent[:, 2]), 1))
        out.append(dict(i=i, dslot=dslot, lst=lst, slot=ent[:, 0],
                        short=r[i, C_DIR] == BI, mv=torch.stack(mvs, 1),
                        affine=r[i, C_AFFINE] != 0))
    return out


def _job_rows(comp, dslot, slot, short, x0, y0, fx, fy, cx, cy, w, h,
              flags):
    """Rows (luma, short, stack_idx, ypad, xpad, fx, fy, chan, cy, cx, w,
    h) of jobs whose reference block starts at (x0, y0) (component
    coordinates, before the margin and the filter's half length)."""
    luma = comp == 0
    half = (mc_tab.NUM_TAPS_LUMA if luma else mc_tab.NUM_TAPS_CHROMA) // 2 - 1
    px, py = flags.pad[0:2] if luma else flags.pad[2:4]
    stack_idx = slot if luma else slot * 2 + (comp - 1)
    chan = dslot if luma else dslot * 2 + (comp - 1)
    full = lambda v: torch.full_like(cx, v)
    return torch.stack([full(int(luma)), short.long(), stack_idx,
                        py + y0 - half, px + x0 - half, fx, fy, full(chan),
                        cy, cx, w, h])


def mc_jobs(records, refs, nstack, dims, flags):
    """The MC jobs of a picture, derived from its record table as
    ``_build_mc_groups`` derives them: (12, J) int64 rows as
    ``_job_rows`` gives them, plain leaves first (per dslot, per
    component), then the affine CUs, expanded in Python.  refs: int32
    (2, 5, 3) per (list, ref_idx) [frame-store slot (-1: none), ref luma
    width, ref luma height]; nstack: the store's slot count; dims: [(H,
    W)] of luma, then chroma (absent for monochrome)."""
    r = records.long()
    ncomp = 1 if len(dims) == 1 else 3
    rows = []
    affine = []
    for p in _leaves(records, refs, nstack, dims, flags):
        i, plain = p["i"], ~p["affine"]
        mv = p["mv"][plain]
        for comp in range(ncomp):
            csx, csy = (0, 0) if comp == 0 else (flags.sx, flags.sy)
            pel_x, pel_y, fx, fy = _pel_frac(mv[:, 0, 0], mv[:, 0, 1],
                                             comp, flags)
            cx, cy = r[i[plain], C_X] >> csx, r[i[plain], C_Y] >> csy
            rows.append(_job_rows(
                comp, p["dslot"], p["slot"][plain], p["short"][plain],
                cx + pel_x, cy + pel_y, fx, fy, cx, cy,
                r[i[plain], C_W] >> csx, r[i[plain], C_H] >> csy, flags))
        for j in p["affine"].nonzero()[:, 0].tolist():
            affine.append((int(i[j]), p["dslot"], int(p["slot"][j]),
                           bool(p["short"][j]), p["mv"][j].tolist()))
    one = lambda v: torch.tensor([v], dtype=torch.int64,
                                 device=records.device)
    for n, dslot, slot, short, mv3 in sorted(affine, key=lambda a: a[:2]):
        posx, posy = int(r[n, C_X]), int(r[n, C_Y])
        for comp in range(ncomp):
            csx, csy = (0, 0) if comp == 0 else (flags.sx, flags.sy)
            cw, ch = int(r[n, C_W]) >> csx, int(r[n, C_H]) >> csy
            ccx, ccy = posx >> csx, posy >> csy
            if mv3[0] == mv3[1]:
                # uniform: plain MC of the whole CU with the first MV
                pel_x, pel_y, fx, fy = _pel_frac(one(mv3[0][0]),
                                                 one(mv3[0][1]), comp, flags)
                rows.append(_job_rows(comp, dslot, one(slot), one(short),
                                      ccx + pel_x, ccy + pel_y, fx, fy,
                                      one(ccx), one(ccy), one(cw), one(ch),
                                      flags))
                continue
            jobs, sw, shh = mc_tab.affine_subblocks(
                mv3, posx, posy, cw, ch, csx, csy, flags.luma_w,
                flags.luma_h)
            x0, y0, fx, fy, dx, dy = torch.tensor(
                jobs, dtype=torch.int64, device=records.device).T
            rows.append(_job_rows(comp, dslot, one(slot).expand_as(x0),
                                  one(short).expand_as(x0), x0, y0, fx, fy,
                                  ccx + dx, ccy + dy, torch.full_like(x0, sw),
                                  torch.full_like(x0, shh), flags))
    if not rows:
        return torch.zeros((12, 0), dtype=torch.int64, device=records.device)
    return torch.cat(rows, 1)


@functools.lru_cache(maxsize=None)
def _picture_tables(hp_mv):
    """The luma then the chroma filter table of an MV precision, one int32
    array (``xvc_mc_picture``'s ``tables``)."""
    return np.ascontiguousarray(np.concatenate(
        [dsp._filter_table(True, hp_mv).reshape(-1),
         dsp._filter_table(False, hp_mv).reshape(-1)]), np.int32)


def _check_picture(pred_l, mask_l, pred_c, mask_c, records, refs,
                   luma_stack, chroma_stack):
    planes = [(pred_l, mask_l, luma_stack, 1)]
    if pred_c is not None:
        planes.append((pred_c, mask_c, chroma_stack, 2))
    for pred, mask, stack, n in planes:
        kernels.require(pred, torch.int16, 3, "pred")
        kernels.require(mask, torch.int16, 3, "mask")
        kernels.require(stack, torch.int16, 3, "stack")
        if tuple(pred.shape) != (2 * n,) + tuple(mask.shape[1:]) or \
                mask.shape[0] != n or stack.shape[0] != \
                n * luma_stack.shape[0]:
            raise ValueError("mc_picture: pred %r, mask %r, stack %r"
                             % (tuple(pred.shape), tuple(mask.shape),
                                tuple(stack.shape)))
    kernels.require(records, torch.int32, 2, "records")
    kernels.require(refs, torch.int32, 3, "refs")
    if records.shape[1] < MIN_COLS or tuple(refs.shape) != (2, MAX_REFS, 3):
        raise ValueError("mc_picture: records %r, refs %r" % (
            tuple(records.shape), tuple(refs.shape)))


def mc_picture(pred_l, mask_l, pred_c, mask_c, records, refs, luma_stack,
               chroma_stack, flags):
    """In place: predict every inter leaf of the picture whose parse gave
    ``records`` (int32 (N, >= 71); the tree-0 inter leaves; affine CUs
    expanded into their subblocks) from the frame-store stacks
    ``luma_stack`` (S, Hp, Wp) and ``chroma_stack`` (2S, Hpc, Wpc) int16,
    into ``pred_l`` (2, H, W) / ``mask_l`` (1, H, W) and ``pred_c`` (4,
    Hc, Wc) / ``mask_c`` (2, Hc, Wc) int16 as ``mc_scatter`` stores them
    (chroma None for monochrome).  refs: int32 (2, 5, 3), as ``mc_jobs``
    reads it; flags: ``McFlags``.  One launch of ``xvc_mc_picture`` on
    the card; ``mc_picture_plain`` on the CPU."""
    _check_picture(pred_l, mask_l, pred_c, mask_c, records, refs,
                   luma_stack, chroma_stack)
    tensors = [pred_l, mask_l, records, refs, luma_stack]
    if pred_c is not None:
        tensors += [pred_c, mask_c, chroma_stack]
    if not kernels.on_cuda(*tensors):
        mc_picture_plain(pred_l, mask_l, pred_c, mask_c, records, refs,
                         luma_stack, chroma_stack, flags)
        return
    if records.shape[0] == 0:
        return
    from ..kernels import build
    _check_staging(luma_stack)
    if pred_c is not None:
        _check_staging(chroma_stack)
    S, Hp, Wp = luma_stack.shape
    Hpc, Wpc = chroma_stack.shape[1:] if pred_c is not None else (0, 0)
    if min(Hp, Wp) < 64 + 8 - 1 or \
            (pred_c is not None and min(Hpc, Wpc) < 64 + 4 - 1):
        raise ValueError("frame store %r / %r smaller than a window"
                         % ((Hp, Wp), (Hpc, Wpc)))
    _, H, W = pred_l.shape
    Hc, Wc = pred_c.shape[1:] if pred_c is not None else (0, 0)
    cfg = np.array([records.shape[0], records.shape[1],
                    1 if pred_c is None else 3, S, Hp, Wp, Hpc, Wpc, H, W,
                    Hc, Wc] + flags.cfg(), np.int32)
    tables = _picture_tables(bool(flags.hp_mv))
    none = lambda t: None if t is None else build.ptr(t)
    rc = build.lib().xvc_mc_picture(
        build.ptr(records), build.ptr(refs), build.ptr(luma_stack),
        none(chroma_stack), build.ptr(pred_l), build.ptr(mask_l),
        none(pred_c), none(mask_c), cfg.ctypes.data, cfg.size,
        tables.ctypes.data, tables.size, build.stream_of(pred_l))
    build.check(rc, "mc_picture")
    kernels.count_launch("mc_picture")


def mc_picture_plain(pred_l, mask_l, pred_c, mask_c, records, refs,
                     luma_stack, chroma_stack, flags):
    """Plain PyTorch version of ``mc_picture``: the jobs of ``mc_jobs``,
    grouped by (luma, short, window class), through
    ``mc_scatter_plain``."""
    dims = [tuple(pred_l.shape[1:])]
    if pred_c is not None:
        dims.append(tuple(pred_c.shape[1:]))
    rows = mc_jobs(records, refs, luma_stack.shape[0], dims, flags)
    if not rows.shape[1]:
        return
    keys = torch.stack([rows[0], rows[1], _bucket(rows[10]),
                        _bucket(rows[11])], 1)
    for luma, short, wb, hb in sorted({tuple(v) for v in keys.tolist()}):
        m = (keys == torch.tensor([luma, short, wb, hb],
                                  device=keys.device)).all(1)
        params = rows[2:, m].to(torch.int32).contiguous()
        if luma:
            mc_scatter_plain(pred_l, mask_l, luma_stack, params, wb, hb,
                             True, flags.bitdepth, flags.hp_mv, bool(short))
        else:
            mc_scatter_plain(pred_c, mask_c, chroma_stack, params, wb, hb,
                             False, flags.bitdepth, flags.hp_mv, bool(short))
