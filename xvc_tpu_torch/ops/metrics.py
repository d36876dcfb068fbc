"""Picture quality metric of the encoder's statistics.

Copy of ``compute_picture_psnr`` of ``xvc_tpu/ops/metrics.py`` (ref:
src/xvc_enc_lib/picture_encoder.cc CalculatePsnr), the one metric the
port's picture encoder reports; the block distortion metrics of the RD
search live in the native encoder (``native/csrc/xvcn_enc.inc``).
"""
import numpy as np


def compute_picture_psnr(rec_view, orig_view):
    """PSNR against 8-bit max like the reference (max=255)."""
    diff = rec_view.astype(np.int64) - orig_view.astype(np.int64)
    mse = float((diff * diff).sum()) / diff.size if diff.size else 0.0
    if mse > 0:
        return 10 * np.log10(255 * 255 / mse)
    return 99.999
