"""Dequant + inverse transform + scatter (kernel 2).

``itx_picture`` is the decode path's: every coded block of a picture in
one launch, each derived on the card from the parse's record table and
coefficient arena (the work of ``xvc_tpu/tpu/flat_recon.py``
``_build_itx_groups``, which here is done by no host code), with
``itx_picture_plain`` beside it.

The group entry points port ``xvc_tpu/tpu/flat_recon.py``
``make_itx_scatter_gen`` and ``make_itx_scatter`` (with
``_fam_stacks``); both kernels share one per-block device function.
``itx_scatter_gen`` runs
blocks of one shape whose vertical and horizontal transform families
are per-block data (params rows ``[pidx, cy, cx, fam_v, fam_h]``);
``itx_scatter`` runs one fixed variant (``gen`` with fixed families,
``dst4``, ``dc`` or ``skip``; params rows ``[pidx, cy, cx]``).  Both
write the residual into the int32 plane stack ``resi`` (nplanes, H, W)
in place; lanes carrying the ``_BIG`` sentinel and samples outside the
plane are dropped.  On the card they launch ``kernels/csrc/itx.cu``; on
the CPU they run the plain version, ``itx_scatter_plain``.
"""
import functools

import numpy as np
import torch

from .. import constants as k
from ..ops import transform as tx
from ..ops.quant import Qp
from .. import kernels
from . import dsp
from .records import (C_CBF0, C_COEFF0, C_DCONLY0, C_H, C_PRED, C_QP,
                      C_SPLIT, C_TSKIP0, C_TT00, C_TT01, C_TT10, C_TT11,
                      C_W, C_X, C_Y, MIN_COLS)

_MODE = {"gen": 0, "dst4": 0, "dc": 2, "skip": 3}


@functools.lru_cache(maxsize=None)
def _fam_stacks(size, high_precision):
    """Stacked inverse-transform bases for all 5 families at one size,
    plus per-family shifts (mirrors dsp._matrices semantics).  Families
    that do not exist at this size stay zero (never selected).  The JAX
    twin takes two more arguments that it does not read."""
    in_rows = min(size, k.TRANSFORM_ZERO_OUT_MIN_SIZE)
    M = np.zeros((5, in_rows, size), np.int32)
    S = np.zeros((5,), np.int32)
    hp = high_precision or size >= 64 or size == 2
    for fi, tt in enumerate((k.TransformType.DCT2, k.TransformType.DCT5,
                             k.TransformType.DCT8, k.TransformType.DST1,
                             k.TransformType.DST7)):
        try:
            m, adj = tx.get_matrix(tt, size, hp)
        except KeyError:
            S[fi] = 7
            continue
        M[fi] = np.asarray(m, np.int64)[:in_rows, :].astype(np.int32)
        S[fi] = 7 + (2 if hp else 0) + adj
    return M, S


@functools.lru_cache(maxsize=None)
def _bases_np(width, height, bitdepth, high_precision, variant, txv, txh):
    """(M1 (F, in1, h), S1 (F,), M2 (F, cols, w), S2 (F,)) int32 numpy:
    all five families for per-block 'gen' (variant None), one family
    otherwise.  S2 already has the bitdepth folded in."""
    if variant is None:
        M1, S1 = _fam_stacks(height, high_precision)
        M2, S2 = _fam_stacks(width, high_precision)
        return M1, S1, M2, S2 + 13 - bitdepth
    if variant == "dst4":
        m = tx._DST4.astype(np.int32)[None]
        return m, np.array([7], np.int32), m, \
            np.array([20 - bitdepth], np.int32)
    m1, m2, s1, s2 = dsp._matrices(txv, txh, height, width, high_precision)
    in1 = min(height, k.TRANSFORM_ZERO_OUT_MIN_SIZE)
    cols = min(width, k.TRANSFORM_ZERO_OUT_MIN_SIZE)
    return (np.ascontiguousarray(m1[None, :in1, :]),
            np.array([s1], np.int32),
            np.ascontiguousarray(m2[None, :cols, :]),
            np.array([s2 - bitdepth], np.int32))


_DEV_BASES = {}


def _bases(device, *key):
    """The bases of ``_bases_np`` as tensors on ``device`` (cached; the
    workers of a threaded decode keep the first one made)."""
    dkey = (str(device),) + key
    t = _DEV_BASES.get(dkey)
    if t is None:
        t = _DEV_BASES.setdefault(dkey, tuple(
            torch.as_tensor(a, device=device) for a in _bases_np(*key)))
    return t


def itx_scatter_gen(resi, coeff, scale, params, width, height, bitdepth,
                    high_precision):
    """Merged 'gen'/'dc' blocks: families are per-block data."""
    _run(resi, coeff, scale, params, width, height, bitdepth,
         high_precision, None, 0, 0)


def itx_scatter(resi, coeff, scale, params, width, height, bitdepth, txv,
                txh, variant, high_precision):
    """One fixed variant: 'gen' (families txv/txh), 'dst4', 'dc' or
    'skip'."""
    _run(resi, coeff, scale, params, width, height, bitdepth,
         high_precision, variant, txv, txh)


def _run(resi, coeff, scale, params, width, height, bitdepth,
         high_precision, variant, txv, txh):
    kernels.require(resi, torch.int32, 3, "resi")
    kernels.require(coeff, torch.int16, 3, "coeff")
    kernels.require(scale, torch.int32, 1, "scale")
    kernels.require(params, torch.int32, 2, "params")
    B = coeff.shape[0]
    rows = 5 if variant is None else 3
    if coeff.shape[1:] != (height, width) or scale.shape != (B,) or \
            params.shape != (rows, B):
        raise ValueError("itx group shapes disagree: coeff %r scale %r "
                         "params %r for %dx%d" % (
                             tuple(coeff.shape), tuple(scale.shape),
                             tuple(params.shape), width, height))
    if not kernels.on_cuda(resi, coeff, scale, params):
        itx_scatter_plain(resi, coeff, scale, params, width, height,
                          bitdepth, high_precision, variant, txv, txh)
        return
    from ..kernels import build
    mode = _MODE[variant or "gen"]
    aux_shift, aux_scale = 0, 1
    if variant == "skip":
        aux_shift, aux_scale = dsp.skip_params(width, height, bitdepth)
    elif variant == "dc":
        aux_shift = 14 - bitdepth
    M1, S1, M2, S2 = _bases(resi.device, width, height, bitdepth,
                            high_precision, variant,
                            txv if variant == "gen" else 0,
                            txh if variant == "gen" else 0)
    nplanes, H, W = resi.shape
    rc = build.lib().xvc_itx_scatter(
        build.ptr(coeff), build.ptr(scale), build.ptr(params), B,
        params.shape[0], width, height, bitdepth, mode,
        1 if variant is None else 0,
        dsp.dequant_shift(width, height, bitdepth), aux_shift, aux_scale,
        build.ptr(M1), build.ptr(S1), build.ptr(M2), build.ptr(S2),
        M1.shape[0], build.ptr(resi), nplanes, H, W, build.stream_of(resi))
    build.check(rc, "itx_scatter")
    kernels.count_launch("itx")


def itx_scatter_plain(resi, coeff, scale, params, width, height, bitdepth,
                      high_precision, variant=None, txv=0, txh=0):
    """Plain PyTorch version of the ITX scatter (variant None: per-block
    families, as ``itx_scatter_gen``)."""
    if variant is None:
        M1, S1, M2, S2 = _bases(resi.device, width, height, bitdepth,
                                high_precision, None, 0, 0)
        nf = M1.shape[0]
        f1 = params[3].long().clamp(0, nf - 1)
        f2 = params[4].long().clamp(0, nf - 1)
        dq = dsp._dequant_expr(coeff, scale, width, height, bitdepth)
        in1 = min(height, k.TRANSFORM_ZERO_OUT_MIN_SIZE)
        cols = min(width, k.TRANSFORM_ZERO_OUT_MIN_SIZE)
        out = dsp.transform_2d(dq, M1[f1], M2[f2], S1[f1], S2[f2], in1,
                               cols)
    else:
        out = dsp._itx_core(coeff, scale, width, height, bitdepth, txv, txh,
                            variant, high_precision).to(torch.int32)
    nplanes, H, W = resi.shape
    p = params.long()
    pidx, cy, cx = p[0], p[1], p[2]
    dev = resi.device
    yy = cy[:, None] + torch.arange(height, device=dev)[None, :]
    xx = cx[:, None] + torch.arange(width, device=dev)[None, :]
    keep = (((pidx >= 0) & (pidx < nplanes))[:, None, None] &
            ((yy >= 0) & (yy < H))[:, :, None] &
            ((xx >= 0) & (xx < W))[:, None, :])
    b, i, j = keep.nonzero(as_tuple=True)
    resi[pidx[b], yy[b, i], xx[b, j]] = out[b, i, j]


# ---------------------------------------------------------------------------
# The whole picture in one launch
# ---------------------------------------------------------------------------

QP_MIN = k.MIN_ALLOWED_QP                        # column 0 of qp_scales
QP_COUNT = k.MAX_ALLOWED_QP - k.MIN_ALLOWED_QP + 1
_SIZES = (2, 4, 8, 16, 32, 64)                  # block sides, log2 1..6
_NFAM = 5


@functools.lru_cache(maxsize=None)
def qp_scale_table(chroma_format, bitdepth, offset_table, offset_u,
                   offset_v):
    """(3, QP_COUNT) int32: ``Qp.get_inv_scale(comp)`` of every raw qp
    ``QP_MIN + i`` of a segment (what the JAX package's per-leaf
    ``_qp_scales`` gives, made once per segment)."""
    out = np.zeros((3, QP_COUNT), np.int32)
    for i in range(QP_COUNT):
        qp = Qp(QP_MIN + i, chroma_format, bitdepth, 0.0, offset_table,
                offset_u, offset_v)
        out[:, i] = [qp.get_inv_scale(c) for c in range(3)]
    return out


@functools.lru_cache(maxsize=None)
def picture_bases_np(high_precision):
    """The inverse bases of every block side 2..64 and all five
    families, and the DST-4 matrix, in one int32 array, with an index:
    row ``(log2(side) - 1) * 5 + family`` of ``info`` holds [offset,
    shift] of that min(side, 32) x side matrix (``_fam_stacks``), the
    last row those of DST-4 (shift 7)."""
    mats, info = [], []
    off = 0
    for size in _SIZES:
        M, S = _fam_stacks(size, high_precision)
        for f in range(_NFAM):
            mats.append(M[f].reshape(-1))
            info.append((off, int(S[f])))
            off += M[f].size
    mats.append(tx._DST4.astype(np.int32).reshape(-1))
    info.append((off, 7))
    return (np.ascontiguousarray(np.concatenate(mats), np.int32),
            np.asarray(info, np.int32))


def _picture_bases(device, high_precision):
    key = (str(device), "picture", bool(high_precision))
    t = _DEV_BASES.get(key)
    if t is None:
        t = tuple(dsp.upload(torch.from_numpy(a), device)
                  for a in picture_bases_np(bool(high_precision)))
        _DEV_BASES[key] = t
    return t


def log2_sides(v, lo, hi):
    """log2 of each side that is a power of two in [lo, hi], else -1."""
    out = torch.full_like(v, -1)
    for s in range(lo.bit_length() - 1, hi.bit_length()):
        out = torch.where(v == (1 << s), s, out)
    return out


def itx_jobs(records, ncoeff, qp_scales, bitdepth, no_dst, sx, sy, dims):
    """The coded blocks of a picture, derived from its record table as
    ``_build_itx_groups`` derives them, one dict of int64 tensors per
    component: a leaf of either tree for each component with its CBF set
    and a coefficient offset.  dims: [(H, W)] of the luma plane, then
    of the chroma planes (absent for monochrome).  A record that fails a
    guard (a side that is no power of two in 2..64, coefficients past the
    arena, an origin outside the plane, a qp outside the table) drops its
    block, as the kernel does; so does a DC-only block of the DCT-2
    family above 14 bit, whose residual is 0."""
    r = records.long()
    leaf = r[:, C_SPLIT] == 0
    DEFAULT = int(k.TransformType.DEFAULT)
    DCT2 = int(k.TransformType.DCT2)
    jobs = []
    for comp in range(1 if len(dims) == 1 else 3):
        csx, csy = (0, 0) if comp == 0 else (sx, sy)
        H, W = dims[min(comp, 1)]
        x, y = r[:, C_X] >> csx, r[:, C_Y] >> csy
        w, h = r[:, C_W] >> csx, r[:, C_H] >> csy
        wl2, hl2 = log2_sides(w, 2, 64), log2_sides(h, 2, 64)
        off = r[:, C_COEFF0 + comp]
        qi = r[:, C_QP] - QP_MIN
        keep = (leaf & (r[:, C_CBF0 + comp] != 0) & (off >= 0) &
                (wl2 > 0) & (hl2 > 0) & (off + w * h <= ncoeff) &
                (x >= 0) & (x < W) & (y >= 0) & (y < H) &
                (qi >= 0) & (qi < QP_COUNT))
        i = keep.nonzero()[:, 0]
        t0 = r[i, C_TT00 if comp == 0 else C_TT10]
        t1 = r[i, C_TT01 if comp == 0 else C_TT11]
        w, h, wl2, hl2 = w[i], h[i], wl2[i], hl2[i]
        scale = qp_scales[comp].long()[qi[i]]
        scale = dsp._wrap32(torch.where((wl2 + hl2) % 2 != 0, scale * 181,
                                        scale)).long()
        tskip = r[i, C_TSKIP0 + comp] != 0
        dst4 = ((comp == 0) & (r[i, C_PRED] == 0) & (t0 == DEFAULT) &
                (t1 == DEFAULT) & (w == 4) & (h == 4) & (not no_dst))
        # 0 gen (DC-only blocks too), 1 dst4, 3 skip: as in the JAX package
        var = torch.where(tskip, 3, torch.where(dst4, 1, 0))
        # above 14 bit a DC-only block of the DCT-2 family has a residual
        # of 0 (dsp.dc_only_residual): no job
        sel = torch.ones_like(tskip)
        if bitdepth > 14:
            sel = ~((var == 0) & (r[i, C_DCONLY0 + comp] != 0) &
                    (t0 <= DCT2) & (t1 <= DCT2))
        jobs.append(dict(comp=comp, x=x[i][sel], y=y[i][sel], w=w[sel],
                         h=h[sel], var=var[sel], scale=scale[sel],
                         off=off[i][sel], fam1=t0[sel].clamp(min=1) - 1,
                         fam2=t1[sel].clamp(min=1) - 1))
    return jobs


def _check_picture(resi_l, resi_c, records, coeff, qp_scales):
    kernels.require(resi_l, torch.int32, 3, "resi_l")
    if resi_c is not None:
        kernels.require(resi_c, torch.int32, 3, "resi_c")
        if resi_c.shape[0] != 2:
            raise ValueError("resi_c must be (2, Hc, Wc), got %r"
                             % (tuple(resi_c.shape),))
    kernels.require(records, torch.int32, 2, "records")
    kernels.require(coeff, torch.int32, 1, "coeff")
    kernels.require(qp_scales, torch.int32, 2, "qp_scales")
    if resi_l.shape[0] != 1 or records.shape[1] < MIN_COLS or \
            tuple(qp_scales.shape) != (3, QP_COUNT):
        raise ValueError("itx_picture: resi_l %r, records %r, qp_scales %r"
                         % (tuple(resi_l.shape), tuple(records.shape),
                            tuple(qp_scales.shape)))


def itx_picture(resi_l, resi_c, records, coeff, qp_scales, bitdepth,
                high_precision, no_dst, sx, sy):
    """In place: dequantize, inverse-transform and store every coded
    block of the picture whose parse gave ``records`` (int32 (N, >= 71))
    and ``coeff`` (the int32 coefficient arena) into ``resi_l`` (1, H, W)
    and ``resi_c`` (2, Hc, Wc; None for monochrome), int32.  qp_scales:
    ``qp_scale_table`` of the segment, on the same device.  One launch of
    ``xvc_itx_picture`` on the card; ``itx_picture_plain`` on the CPU."""
    _check_picture(resi_l, resi_c, records, coeff, qp_scales)
    tensors = [resi_l, records, coeff, qp_scales]
    if resi_c is not None:
        tensors.append(resi_c)
    if not kernels.on_cuda(*tensors):
        itx_picture_plain(resi_l, resi_c, records, coeff, qp_scales,
                          bitdepth, high_precision, no_dst, sx, sy)
        return
    if records.shape[0] == 0:
        return
    from ..kernels import build
    mats, info = _picture_bases(resi_l.device, high_precision)
    _, H, W = resi_l.shape
    Hc, Wc = resi_c.shape[1:] if resi_c is not None else (0, 0)
    cfg = np.array([records.shape[0], records.shape[1], coeff.numel(),
                    bitdepth, int(bool(no_dst)), sx, sy,
                    1 if resi_c is None else 3, H, W, Hc, Wc, QP_MIN,
                    QP_COUNT], np.int32)
    rc = build.lib().xvc_itx_picture(
        build.ptr(records), build.ptr(coeff), build.ptr(qp_scales),
        build.ptr(mats), build.ptr(info), build.ptr(resi_l),
        None if resi_c is None else build.ptr(resi_c), cfg.ctypes.data,
        cfg.size, build.stream_of(resi_l))
    build.check(rc, "itx_picture")
    kernels.count_launch("itx_picture")


def itx_picture_plain(resi_l, resi_c, records, coeff, qp_scales, bitdepth,
                      high_precision, no_dst, sx, sy):
    """Plain PyTorch version of ``itx_picture``: the blocks of
    ``itx_jobs``, grouped by (w, h, variant), through
    ``itx_scatter_plain``."""
    dims = [tuple(resi_l.shape[1:])]
    if resi_c is not None:
        dims.append(tuple(resi_c.shape[1:]))
    names = {0: None, 1: "dst4", 3: "skip"}
    for job in itx_jobs(records, coeff.numel(), qp_scales, bitdepth,
                        no_dst, sx, sy, dims):
        resi = resi_l if job["comp"] == 0 else resi_c
        pidx = 0 if job["comp"] == 0 else job["comp"] - 1
        keys = torch.stack([job["w"], job["h"], job["var"]], 1)
        for w, h, var in sorted({tuple(v) for v in keys.tolist()}):
            m = (keys == torch.tensor([w, h, var],
                                      device=keys.device)).all(1)
            offs = job["off"][m]
            idx = offs[:, None] + torch.arange(w * h, device=offs.device)
            cf = coeff.long()[idx].to(torch.int16).reshape(-1, h, w)
            rows = [torch.full_like(offs, pidx), job["y"][m], job["x"][m]]
            if var == 0:
                rows += [job["fam1"][m], job["fam2"][m]]
            params = torch.stack(rows).to(torch.int32)
            itx_scatter_plain(resi, cf, job["scale"][m].to(torch.int32),
                              params, w, h, bitdepth, high_precision,
                              names[var])
