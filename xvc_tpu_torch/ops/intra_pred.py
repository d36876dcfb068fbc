"""Intra prediction: planar, DC, 33/65-direction angular, LM-chroma.

Behavioral equivalent of the reference intra predictor
(ref: src/xvc_common_lib/intra_prediction.cc).  Copy of
``xvc_tpu/ops/intra_pred.py``: the exact-integer host path, which the
replay path's sequential tail runs (``codec/intra_recon.py``) and whose
reference-sample gathering the lookahead's block extraction uses.  The
filter and the three predictors call the port's native library (the
same exports as the JAX package's); the JAX module's numpy twins of them
are not copied.  The decode's other intra blocks are predicted on the
device (``gpu/intra_scan.py``; ``gpu/intra_batch.py`` for the encoder's
lookahead).

Reference sample layout matches the reference codec: a top row of
width+height+1 samples (index 0 = above-left) and a left column of
height+width samples.
"""
import numpy as np

from .. import constants as k
from .. import native

ANGLE_TABLE_EXT = (-32, -29, -26, -23, -21, -19, -17, -15, -13, -11, -9, -7,
                   -5, -3, -2, -1, 0, 1, 2, 3, 5, 7, 9, 11, 13, 15, 17, 19,
                   21, 23, 26, 29, 32)
INV_ANGLE_TABLE_EXT = (8192, 4096, 2731, 1638, 1170, 910, 745, 630, 546, 482,
                       431, 390, 356, 315, 282, 256)

# intra angle -> extended (67) mode number (ref: intra_prediction.cc:322-327)
ANGLE_TO_MODE_EXT = (0, 1, 2, 4, 6, 8, 10, 12, 14, 16,
                     18, 20, 22, 24, 26, 28, 30, 32,
                     34, 36, 38, 40, 42, 44, 46, 48,
                     50, 52, 54, 56, 58, 60, 62, 64, 66)


def convert_angle(intra_angle, restrictions):
    if restrictions.disable_ext2_intra_67_modes:
        return int(intra_angle)
    return ANGLE_TO_MODE_EXT[int(intra_angle)]


def use_filtered_ref_samples(width, height, intra_mode, restrictions):
    """(ref: intra_prediction.cc:342-363)"""
    if restrictions.disable_intra_ref_sample_filter:
        return False
    thr = (0, 20, 10, 7, 1, 0, 10, 0)
    thr_ext = (0, 20, 20, 14, 2, 0, 20, 0)
    size = ((width.bit_length() - 1) + (height.bit_length() - 1)) >> 1
    hor = convert_angle(k.IntraAngle.HORIZONTAL, restrictions)
    ver = convert_angle(k.IntraAngle.VERTICAL, restrictions)
    mode_diff = min(abs(intra_mode - hor), abs(intra_mode - ver))
    if restrictions.disable_ext2_intra_67_modes:
        return mode_diff > thr[size]
    return mode_diff > thr_ext[size]


def compute_ref_samples(width, height, rec, px, py,
                        has_left, has_above, has_above_left,
                        size_below_left, size_above_right,
                        bitdepth, restrictions):
    """Gather + pad reference samples (ref: intra_prediction.cc:707-848).

    rec: full reconstructed plane (2-D array); (px, py) block position.
    Returns (top, left) int32 arrays.
    """
    dc_val = 1 << (bitdepth - 1)
    top_size = width + height
    left_size = width + height
    top = np.full(top_size + 1, dc_val, dtype=np.int32)
    left = np.full(left_size, dc_val, dtype=np.int32)

    has_any = has_left or has_above or has_above_left or \
        size_below_left > 0 or size_above_right > 0
    if not has_any:
        return top, left

    if (has_above_left and has_above and has_left and
            size_below_left == width and size_above_right == height):
        top[0] = rec[py - 1, px - 1]
        top[1:top_size + 1] = rec[py - 1, px:px + top_size]
        left[:left_size] = rec[py:py + left_size, px - 1]
        return top, left

    # Partial neighbors: line buffer runs bottom-left -> top-right
    # [0 .. left_size) = left side bottom-up, [left_size .. +width) =
    # above-left corner run, then top row left-to-right.
    top_left_size = width
    total = left_size + top_left_size + top_size
    line = np.full(total, dc_val, dtype=np.int32)

    if has_above_left:
        line[left_size:left_size + top_left_size] = rec[py - 1, px - 1]
    if has_left:
        for i in range(height):
            line[left_size - 1 - i] = rec[py + i, px - 1]
        if size_below_left:
            for i in range(size_below_left):
                line[left_size - 1 - height - i] = rec[py + height + i,
                                                       px - 1]
            pad_val = line[left_size - height - size_below_left]
            for i in range(size_below_left, width):
                line[left_size - 1 - height - i] = pad_val
    if has_above:
        base = left_size + top_left_size
        line[base:base + width] = rec[py - 1, px:px + width]
        if size_above_right:
            for i in range(size_above_right):
                line[base + width + i] = rec[py - 1, px + width + i]
            pad_val = line[base + width + size_above_right - 1]
            for i in range(size_above_right, height):
                line[base + width + i] = pad_val

    if not restrictions.disable_intra_ref_padding:
        if not size_below_left:
            if has_left:
                ref = line[width]
            elif has_above_left:
                ref = line[left_size]
            elif has_above:
                ref = line[left_size + top_left_size]
            else:
                ref = line[left_size + top_left_size + width]
            line[:width] = ref
        if not has_left:
            line[width:width + height] = line[width - 1]
        if not has_above_left:
            line[left_size:left_size + top_left_size] = line[left_size - 1]
        if not has_above:
            base = left_size + top_left_size
            line[base:base + width] = line[base - 1]
        if not size_above_right:
            base = left_size + top_left_size + width
            line[base:base + height] = line[base - 1]

    top[:] = line[left_size + top_left_size - 1:
                  left_size + top_left_size + top_size]
    left[:] = line[left_size - 1::-1][:left_size]
    return top, left


def filter_ref_samples(width, height, top, left):
    """[1 2 1] reference filter (ref: intra_prediction.cc:850-871)."""
    ftop = np.empty_like(top)
    fleft = np.empty_like(left)
    native.lib().xvcn_intra_filter_ref(
        top.ctypes.data, left.ctypes.data, width, height,
        ftop.ctypes.data, fleft.ctypes.data)
    return ftop, fleft


def pred_dc(width, height, top, left, dc_filter, restrictions):
    """(ref: intra_prediction.cc:365-399). Uses UNfiltered refs."""
    out = np.empty((height, width), dtype=np.int32)
    do_filter = dc_filter and not restrictions.disable_intra_dc_post_filter
    native.lib().xvcn_intra_pred_dc(
        top.ctypes.data, left.ctypes.data, width, height,
        1 if do_filter else 0, out.ctypes.data)
    return out


def pred_planar(width, height, top, left):
    """(ref: intra_prediction.cc:401-423)"""
    out = np.empty((height, width), dtype=np.int32)
    native.lib().xvcn_intra_pred_planar(
        top.ctypes.data, left.ctypes.data, width, height, out.ctypes.data)
    return out


def pred_angular(width, height, mode, top, left, post_filter, bitdepth,
                 restrictions):
    """(ref: intra_prediction.cc:425-558)"""
    ext = not restrictions.disable_ext2_intra_67_modes
    out = np.empty((height, width), dtype=np.int32)
    native.lib().xvcn_intra_pred_angular(
        top.ctypes.data, left.ctypes.data, width, height, int(mode),
        1 if ext else 0, 1 if post_filter else 0,
        1 if restrictions.disable_intra_ver_hor_post_filter else 0,
        bitdepth, out.ctypes.data)
    return out


def derive_lm_params(width, height, has_above, has_left,
                     src_above, src_left, ref_above, ref_left, bitdepth):
    """Least-squares LM-chroma model (ref: intra_prediction.cc:587-686).

    src_* are chroma reference samples, ref_* downscaled-luma samples at
    the same positions.  Returns (scale, offset, shift).
    """
    MODEL_QUANT_SHIFT = 15
    MODEL_UPSCALE_SHIFT = 13
    MODEL_MIN_RES_SHIFT = 5
    MODEL_PRECISION_SHIFT = 7
    if not has_above and not has_left:
        return 0, 1 << (bitdepth - 1), 0
    sum_x = sum_y = sum_xx = sum_xy = 0
    nbr = 0
    if has_above:
        dx = max(1, width // height) if has_left else 1
        for x in range(0, width, dx):
            a = int(ref_above[x])
            b = int(src_above[x])
            sum_x += a
            sum_y += b
            sum_xx += a * a
            sum_xy += a * b
            nbr += 1
    if has_left:
        dy = max(1, height // width) if has_above else 1
        for y in range(0, height, dy):
            a = int(ref_left[y])
            b = int(src_left[y])
            sum_x += a
            sum_y += b
            sum_xx += a * a
            sum_xy += a * b
            nbr += 1
    size_shift = nbr.bit_length() - 1
    if (1 << size_shift) < nbr:
        size_shift += 1
    # SizeToLog2 semantics: smallest log2 (>=1) with 1<<log2 >= nbr
    size_shift = max(size_shift, 1)
    if size_shift > MODEL_QUANT_SHIFT - bitdepth:
        shift = size_shift + bitdepth - MODEL_QUANT_SHIFT
        rnd = 1 << (shift - 1)
        sum_x = (sum_x + rnd) >> shift
        sum_y = (sum_y + rnd) >> shift
        sum_xx = (sum_xx + rnd) >> shift
        sum_xy = (sum_xy + rnd) >> shift
        size_shift -= shift
    avg_x = sum_x >> size_shift
    avg_y = sum_y >> size_shift
    x_frac = sum_x & ((1 << size_shift) - 1)
    y_frac = sum_y & ((1 << size_shift) - 1)
    stddev_xy = sum_xy - ((avg_x * avg_y) << size_shift) \
        - (avg_x * y_frac) - (avg_y * x_frac)
    stddev_xx = sum_xx - ((avg_x * avg_x) << size_shift) \
        - 2 * avg_x * x_frac

    def log2floor(v):
        return max(v, 1).bit_length() - 1

    shift_xy = 0 if stddev_xy == 0 else \
        max(0, log2floor(abs(stddev_xy)) - bitdepth + 2)
    shift_xx = 0 if stddev_xx == 0 else \
        max(0, log2floor(abs(stddev_xx)) - MODEL_MIN_RES_SHIFT)
    stddev_xy_shifted = stddev_xy >> shift_xy
    shift_xx_shifted = stddev_xx >> shift_xx
    total_shift = bitdepth + shift_xx + 4 + MODEL_PRECISION_SHIFT - \
        MODEL_UPSCALE_SHIFT - shift_xy
    if shift_xx_shifted < (1 << MODEL_MIN_RES_SHIFT):
        return 0, avg_y, 0
    scale = stddev_xy_shifted * (
        ((1 << (bitdepth + 4)) + (shift_xx_shifted // 2)) // shift_xx_shifted)
    scale = scale >> total_shift if shift_xy >= 0 else scale << -total_shift
    lim = 1 << (MODEL_QUANT_SHIFT - MODEL_PRECISION_SHIFT)
    scale = (1 << MODEL_PRECISION_SHIFT) * min(max(scale, -lim), lim - 1)
    base_shift = log2floor(abs(scale) + (-1 if scale < 0 else 0)) - \
        (MODEL_MIN_RES_SHIFT if scale else 0)
    shift = MODEL_UPSCALE_SHIFT - base_shift
    if base_shift >= 0:
        scale >>= base_shift
    else:
        scale <<= -base_shift
    offset = avg_y - ((scale * avg_x) >> shift)
    return scale, offset, shift
