"""Integer transform basis matrices (DCT-2/5/8, DST-1/7).

The tables of the reference transforms (ref:
src/xvc_common_lib/transform.cc) as matrices, with the precision rule
that picks the 6-bit or 8-bit set.  Copy of the table half of
``xvc_tpu/ops/transform.py`` (with ``_matrix_i32``, which the
transform-RD prepass reads its forward bases from), and of the forward
transforms the Python CU encoder's transform search runs on the host
(the general one through the native library, the 4x4 DST and transform
skip in numpy).  The decode's transforms run on the device
(``gpu/dsp.py``, ``gpu/itx.py``, ``gpu/txrd_prepass.py``), the encoder's
inverse ones in the native library (``xvcn_recon_dist``).
"""
import functools
import os

import numpy as np

from .. import constants as k
from .. import native

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


@functools.lru_cache(maxsize=None)
def _matrix_i32(tx_type, size, high_prec):
    """Contiguous int32 copy of a basis matrix."""
    m, adjust = get_matrix(k.TransformType(tx_type), size, high_prec)
    return np.ascontiguousarray(m, dtype=np.int32), adjust


# 4x4 DST-7 basis at 6-bit precision (the classic HEVC 29/55/74/84 set);
# the butterfly in the reference is an exact factorization of this matrix
_DST4 = np.array([[29, 55, 74, 84],
                  [74, 74, 0, -74],
                  [84, -29, -74, 55],
                  [55, -84, 74, -29]], dtype=np.int64)


# ---------------------------------------------------------------------------
# The forward transforms of the Python CU encoder
# ---------------------------------------------------------------------------

def forward_transform(resi, tx_ver, tx_hor, bitdepth, high_precision):
    """Exact forward 2-D transform of an (h, w) int residual block: one
    call of the native library's ``xvcn_fwd_transform`` (row pass, then
    the column pass with the zero-out of both dimensions)."""
    height, width = resi.shape
    high_prec1 = high_precision or width >= 64 or width == 2
    high_prec2 = high_precision or height >= 64 or height == 2
    wl2 = width.bit_length() - 1
    hl2 = height.bit_length() - 1
    shift1 = wl2 + bitdepth - 9 + (_HIGH_PREC_SHIFT if high_prec1 else 0)
    shift2 = hl2 + 6 + (_HIGH_PREC_SHIFT if high_prec2 else 0)
    mhn, adj1 = _matrix_i32(int(tx_hor), width, high_prec1)
    mvn, adj2 = _matrix_i32(int(tx_ver), height, high_prec2)
    rr = resi if (resi.dtype == np.int32 and resi.flags.c_contiguous) \
        else np.ascontiguousarray(resi, np.int32)
    out = np.empty((height, width), dtype=np.int32)
    native.lib().xvcn_fwd_transform(
        rr.ctypes.data, height, width, mhn.ctypes.data, mvn.ctypes.data,
        shift1 + adj1, shift2 + adj2, k.TRANSFORM_ZERO_OUT_MIN_SIZE,
        out.ctypes.data)
    return out


def forward_transform_dst4_np(resi, bitdepth, high_precision):
    """Forward 4x4 DST-7 fast path (ref: transform.cc:997-1017)."""
    shift1 = 2 + bitdepth - 9
    shift2 = 2 + 6
    r = resi.astype(np.int64)
    add1 = 1 << (shift1 - 1)
    temp = (_DST4 @ r.T + add1) >> shift1    # row pass, stored transposed
    add2 = 1 << (shift2 - 1)
    coeff = (_DST4 @ temp.T + add2) >> shift2
    return coeff.astype(np.int32)


def transform_skip_forward_np(resi, bitdepth):
    """(ref: transform.cc:963-995)"""
    height, width = resi.shape
    wl2, hl2 = width.bit_length() - 1, height.bit_length() - 1
    size_rounding_bias = ((wl2 + hl2) % 2) != 0
    transform_shift = k.MAX_TR_DYNAMIC_RANGE - bitdepth - ((wl2 + hl2) >> 1)
    shift = transform_shift + (-8 if size_rounding_bias else 0)
    scale = 181 if size_rounding_bias else 1
    r = resi.astype(np.int64)
    if shift > 0:
        out = (r * scale) << shift
    else:
        offset = 1 << (-shift - 1)
        out = (r * scale + offset) >> (-shift)
    return out.astype(np.int32)
