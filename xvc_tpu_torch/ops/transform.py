"""Integer transform basis matrices (DCT-2/5/8, DST-1/7).

The tables of the reference transforms (ref:
src/xvc_common_lib/transform.cc) as matrices, with the precision rule
that picks the 6-bit or 8-bit set.  Copy of the table half of
``xvc_tpu/ops/transform.py`` (with ``_matrix_i32``, which the
transform-RD prepass reads its forward bases from); the host transforms
themselves are not here: the port transforms on the device
(``gpu/dsp.py``, ``gpu/itx.py``, ``gpu/txrd_prepass.py``).
"""
import functools
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
