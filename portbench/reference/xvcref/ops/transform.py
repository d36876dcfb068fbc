"""Separable integer transforms (DCT-2/5/8, DST-1/7) as matrix products.

Behavioral equivalent of the reference transforms
(ref: src/xvc_common_lib/transform.cc).  The reference uses butterflies;
those are exact algebraic factorizations of the basis-matrix product, so
both stages here are plain integer GEMMs — the natural TPU formulation
(MXU) — with the same rounding, zero-out, and int16 clipping semantics:

  inverse: R = clip16((M1^T C  + add1) >> shift1) then
               clip16((.. M2  + add2) >> shift2)   (column pass first)
  forward: C = M_v ((M_h R^T) ...)                 (row pass first)

Zero-out: only the first 32 input rows of a 64-pt inverse stage carry
energy; stage-1 inverse / stage-2 forward only produce the first 32
lines/rows (ref: transform.cc InvDct2Transform64:699, FwdGeneric:1589).
"""
import os

import numpy as np

from .. import constants as k

with np.load(os.path.join(os.path.dirname(__file__),
                          "transform_tables.npz")) as _npz:
    _TABLES = {name: _npz[name].astype(np.int64) for name in _npz.files}

_FAMILY = {
    k.TransformType.DEFAULT: "dct2",
    k.TransformType.DCT2: "dct2",
    k.TransformType.DCT5: "dct5",
    k.TransformType.DCT8: "dct8",
    k.TransformType.DST1: "dst1",
    k.TransformType.DST7: "dst7",
}

_HIGH_PREC_SHIFT = 2  # 8-bit matrices instead of 6-bit


def get_matrix(tx_type, size, high_prec=True):
    """Returns (matrix int64 (size,size), shift_adjust).

    All non-DCT2 families only exist at 8-bit precision; when the legacy
    6-bit path is selected their shift is adjusted instead
    (ref: transform.cc:293-298 etc.).
    """
    fam = _FAMILY[tx_type]
    if fam == "dct2":
        if not high_prec and size in (4, 8, 16, 32):
            return _TABLES[f"dct2lo_{size}"], 0
        # 2 and 64 only exist in high precision
        adjust = _HIGH_PREC_SHIFT if (not high_prec and
                                      size in (2, 64)) else 0
        return _TABLES[f"dct2_{size}"], adjust
    adjust = _HIGH_PREC_SHIFT if not high_prec else 0
    return _TABLES[f"{fam}_{size}"], adjust


def _clip16(x):
    return np.clip(x, k.INT16_MIN, k.INT16_MAX)



def inverse_transform_np(coeff, tx_ver, tx_hor, bitdepth, high_precision,
                         dc_only=False):
    """Exact inverse 2-D transform of an (h, w) int coefficient block."""
    height, width = coeff.shape
    high_prec1 = high_precision or height >= 64 or height == 2
    high_prec2 = high_precision or width >= 64 or width == 2
    shift1 = 7 + (_HIGH_PREC_SHIFT if high_prec1 else 0)
    shift2 = 20 - bitdepth + (_HIGH_PREC_SHIFT if high_prec2 else 0)

    if dc_only and tx_ver in (k.TransformType.DEFAULT, k.TransformType.DCT2) \
            and tx_hor in (k.TransformType.DEFAULT, k.TransformType.DCT2):
        shift = 14 - bitdepth
        add = 1 << (shift - 1)
        val = (((int(coeff[0, 0]) + 1) >> 1) + add) >> shift
        return np.full((height, width), val, dtype=np.int32)


    c = coeff.astype(np.int64)
    m1, adj1 = get_matrix(tx_ver, height, high_prec1)
    m2, adj2 = get_matrix(tx_hor, width, high_prec2)
    shift1 += adj1
    shift2 += adj2

    # stage 1 (vertical): temp = M1^T @ C, using only first min(h,32) rows
    in_rows1 = min(height, k.TRANSFORM_ZERO_OUT_MIN_SIZE)
    tx_cols1 = min(width, k.TRANSFORM_ZERO_OUT_MIN_SIZE)
    add1 = 1 << (shift1 - 1)
    temp = np.zeros((height, width), dtype=np.int64)
    part = m1[:in_rows1, :].T @ c[:in_rows1, :tx_cols1]
    temp[:, :tx_cols1] = _clip16((part + add1) >> shift1)

    # stage 2 (horizontal): resi = temp @ M2 (using first min(w,32) cols)
    in_rows2 = min(width, k.TRANSFORM_ZERO_OUT_MIN_SIZE)
    add2 = 1 << (shift2 - 1)
    resi = _clip16((temp[:, :in_rows2] @ m2[:in_rows2, :] + add2) >> shift2)
    return resi.astype(np.int32)


# 4x4 DST-7 basis at 6-bit precision (the classic HEVC 29/55/74/84 set);
# the butterfly in the reference is an exact factorization of this matrix
_DST4 = np.array([[29, 55, 74, 84],
                  [74, 74, 0, -74],
                  [84, -29, -74, 55],
                  [55, -84, 74, -29]], dtype=np.int64)


def inverse_transform_dst4_np(coeff, bitdepth, high_precision):
    """Inverse 4x4 DST-7 fast path (ref: transform.cc:217-242).

    Always runs at 6-bit precision regardless of the high-precision flag.
    """
    shift1, shift2 = 7, 20 - bitdepth
    c = coeff.astype(np.int64)
    add1 = 1 << (shift1 - 1)
    s1 = _clip16((_DST4.T @ c + add1) >> shift1)
    add2 = 1 << (shift2 - 1)
    resi = _clip16((s1 @ _DST4 + add2) >> shift2)
    return resi.astype(np.int32)


def transform_skip_inverse_np(coeff, bitdepth):
    """(ref: transform.cc:184-215)"""
    height, width = coeff.shape
    wl2, hl2 = width.bit_length() - 1, height.bit_length() - 1
    size_rounding_bias = ((wl2 + hl2) % 2) != 0
    transform_shift = k.MAX_TR_DYNAMIC_RANGE - bitdepth - ((wl2 + hl2) >> 1)
    shift = transform_shift + (7 if size_rounding_bias else 0)
    scale = 181 if size_rounding_bias else 1
    c = coeff.astype(np.int64)
    if shift > 0:
        offset = 1 << (shift - 1)
        out = (c * scale + offset) >> shift
    else:
        out = (c * scale) << (-shift)
    return out.astype(np.int32)
