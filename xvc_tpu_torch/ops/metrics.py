"""Distortion metrics of the encoder: the block metrics of the Python CU
encoder's RD search and the picture PSNR of its statistics.

Behavioral equivalent of the reference metrics (ref:
src/xvc_enc_lib/sample_metric.cc, picture_encoder.cc CalculatePsnr).
Copy of ``MetricType``, ``SampleMetric`` and ``compute_picture_psnr`` of
``xvc_tpu/ops/metrics.py``; a block metric is one call of the native
library's ``xvcn_metric`` (the JAX module's numpy twins are not copied).
"""
import numpy as np

from .. import native


class MetricType:
    SSD = 0
    SATD = 1
    SAD = 2
    SAD_FAST = 3
    SAD_AC_ONLY = 4
    SAD_AC_ONLY_FAST = 5
    SATD_AC_ONLY = 6
    STRUCTURAL_SSD = 7


class SampleMetric:
    """Metric dispatcher bound to a type + qp weighting."""

    def __init__(self, bitdepth, metric_type, structural_strength=1.0):
        self.bitdepth = bitdepth
        self.type = metric_type
        self.structural_strength = structural_strength

    def compare(self, qp, comp, src1, src2):
        """src1/src2: (h, w) integer arrays of identical shape."""
        a, b = src1, src2
        if a.dtype != np.int32 or a.strides[1] != 4:
            a = np.ascontiguousarray(a, np.int32)
        if b.dtype != np.int32 or b.strides[1] != 4:
            b = np.ascontiguousarray(b, np.int32)
        mt = self.type
        if mt == MetricType.STRUCTURAL_SSD and comp != 0:
            mt = MetricType.SSD
        dist = native.lib().xvcn_metric(
            mt, a.ctypes.data, a.strides[0] // 4, b.ctypes.data,
            b.strides[0] // 4, a.shape[1], a.shape[0], self.bitdepth,
            qp.get_qp_raw(0), float(self.structural_strength))
        return int(dist * qp.distortion_weight[comp])


def compute_picture_psnr(rec_view, orig_view):
    """PSNR against 8-bit max like the reference (max=255)."""
    diff = rec_view.astype(np.int64) - orig_view.astype(np.int64)
    mse = float((diff * diff).sum()) / diff.size if diff.size else 0.0
    if mse > 0:
        return 10 * np.log10(255 * 255 / mse)
    return 99.999
