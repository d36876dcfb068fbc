"""Dequant + inverse transform + scatter (kernel 2).

Port of ``xvc_tpu/tpu/flat_recon.py`` ``make_itx_scatter_gen`` and
``make_itx_scatter`` (with ``_fam_stacks``).  ``itx_scatter_gen`` runs
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
from .. import kernels
from . import dsp

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
    """The bases of ``_bases_np`` as tensors on ``device`` (cached)."""
    dkey = (str(device),) + key
    t = _DEV_BASES.get(dkey)
    if t is None:
        t = tuple(torch.as_tensor(a, device=device)
                  for a in _bases_np(*key))
        _DEV_BASES[dkey] = t
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
    kernels.LAUNCHES["itx"] += 1


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
