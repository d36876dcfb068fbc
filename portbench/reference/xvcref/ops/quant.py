"""Quantization parameter derivation + inverse quantization.

Behavioral equivalent of the reference quantizer
(ref: src/xvc_common_lib/quantize.{h,cc}).  The inverse quant is pure
elementwise integer math; `dequant_np` is the host reference and
`dequant_jax` the TPU kernel (identical integer semantics).
"""
import math

import numpy as np

from .. import constants as k

CHROMA_SCALE = np.array([
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 29, 30, 31, 32, 33, 33, 34, 34,
    35, 35, 36, 36, 37, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49,
    50, 51], dtype=np.int32)
CHROMA_QP_MAX = 57

FWD_QUANT_SCALES = (26214, 23302, 20560, 18396, 16384, 14564)
INV_QUANT_SCALES = (40, 45, 51, 57, 64, 72)
NUM_SCALING_LIST_REM = 6
QUANT_SHIFT = 14
IQUANT_SHIFT = 6


def _scale_chroma_qp(qp, chroma_format, chroma_scaling_table, offset):
    chroma_qp = min(max(qp + offset, 0), CHROMA_QP_MAX)
    if chroma_format == k.ChromaFormat.YUV420 and chroma_scaling_table == 1:
        chroma_qp = int(CHROMA_SCALE[chroma_qp])
    return chroma_qp


def _chroma_dist_weight(qp, chroma_format, chroma_scaling_table, offset):
    chroma_qp = min(max(qp, 0), CHROMA_QP_MAX)
    chroma_qp_with_offset = min(max(qp + offset, 0), CHROMA_QP_MAX)
    comp_qp_offset = chroma_qp_with_offset - chroma_qp
    if chroma_format == k.ChromaFormat.YUV420 and chroma_scaling_table == 1:
        comp_qp_offset = int(CHROMA_SCALE[chroma_qp_with_offset]) - chroma_qp
    return 2.0 ** (-comp_qp_offset / 3.0)


class Qp:
    """Per-CU quantization parameters for all three components."""
    __slots__ = ("qp_raw", "qp_bitdepth", "distortion_weight", "lambda_",
                 "lambda_sqrt")

    def __init__(self, qp, chroma_format, bitdepth, lambda_=0.0,
                 chroma_offset_table=0, chroma_offset_u=0, chroma_offset_v=0):
        self.qp_raw = [
            qp,
            _scale_chroma_qp(qp, chroma_format, chroma_offset_table,
                             chroma_offset_u),
            _scale_chroma_qp(qp, chroma_format, chroma_offset_table,
                             chroma_offset_v),
        ]
        self.qp_bitdepth = [
            max(0, self.qp_raw[c] + NUM_SCALING_LIST_REM * (bitdepth - 8))
            for c in range(3)]
        dw_u = _chroma_dist_weight(qp, chroma_format, chroma_offset_table,
                                   chroma_offset_u)
        dw_v = _chroma_dist_weight(qp, chroma_format, chroma_offset_table,
                                   chroma_offset_v)
        self.distortion_weight = [1.0, dw_u, dw_v]
        self.lambda_ = [lambda_, lambda_ / dw_u, lambda_ / dw_v]
        self.lambda_sqrt = math.sqrt(lambda_)

    def get_qp_raw(self, comp):
        return self.qp_raw[comp]

    def get_qp_per(self, comp):
        return self.qp_bitdepth[comp] // NUM_SCALING_LIST_REM

    def get_fwd_scale(self, comp):
        return FWD_QUANT_SCALES[self.qp_bitdepth[comp] % NUM_SCALING_LIST_REM]

    def get_inv_scale(self, comp):
        return INV_QUANT_SCALES[self.qp_bitdepth[comp] %
                                NUM_SCALING_LIST_REM] << \
            (self.qp_bitdepth[comp] // NUM_SCALING_LIST_REM)

    def get_lambda(self):
        return self.lambda_[0]

    def get_lambda_scaled(self, comp):
        return self.lambda_[comp]


def get_transform_shift(width, height, bitdepth):
    tr_size_log2 = ((width.bit_length() - 1) + (height.bit_length() - 1)) >> 1
    return k.MAX_TR_DYNAMIC_RANGE - bitdepth - tr_size_log2


def dequant_np(coeff, comp, qp: Qp, width, height, bitdepth):
    """Inverse quantization, exact integer (ref: quantize.cc:94-125)."""
    wl2, hl2 = width.bit_length() - 1, height.bit_length() - 1
    size_rounding_bias = ((wl2 + hl2) % 2) != 0
    transform_shift = get_transform_shift(width, height, bitdepth)
    shift = IQUANT_SHIFT - transform_shift + (8 if size_rounding_bias else 0)
    scale = qp.get_inv_scale(comp) * (181 if size_rounding_bias else 1)
    c = coeff.astype(np.int64)
    if shift > 0:
        offset = 1 << (shift - 1)
        out = (c * scale + offset) >> shift
    else:
        out = (c * scale) << (-shift)
    return np.clip(out, k.INT16_MIN, k.INT16_MAX).astype(np.int32)
