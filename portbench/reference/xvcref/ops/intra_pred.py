"""Intra prediction: planar, DC, 33/65-direction angular, LM-chroma.

Behavioral equivalent of the reference intra predictor
(ref: src/xvc_common_lib/intra_prediction.cc).  This module is the exact
integer host/reference path; a batched JAX formulation lives in
intra_pred_jax.py and is validated against this one.

Reference sample layout matches the reference codec: a top row of
width+height+1 samples (index 0 = above-left) and a left column of
height+width samples.
"""
import numpy as np

from .. import constants as k

ANGLE_TABLE = (-32, -26, -21, -17, -13, -9, -5, -2, 0,
               2, 5, 9, 13, 17, 21, 26, 32)
ANGLE_TABLE_EXT = (-32, -29, -26, -23, -21, -19, -17, -15, -13, -11, -9, -7,
                   -5, -3, -2, -1, 0, 1, 2, 3, 5, 7, 9, 11, 13, 15, 17, 19,
                   21, 23, 26, 29, 32)
INV_ANGLE_TABLE = (4096, 1638, 910, 630, 482, 390, 315, 256)
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


class RefState:
    __slots__ = ("top", "left", "top_filt", "left_filt")

    def __init__(self):
        self.top = None        # int array, len width+height+1 (0=above-left)
        self.left = None       # int array, len height+width
        self.top_filt = None
        self.left_filt = None


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
    n = width + height
    ftop = top.copy()
    fleft = left.copy()
    ftop[0] = ((top[0] << 1) + top[1] + left[0] + 2) >> 2
    for x in range(1, n):
        ftop[x] = ((top[x] << 1) + top[x - 1] + top[x + 1] + 2) >> 2
    ftop[n] = top[n]
    fleft[0] = ((left[0] << 1) + top[0] + left[1] + 2) >> 2
    for y in range(1, n - 1):
        fleft[y] = ((left[y] << 1) + left[y - 1] + left[y + 1] + 2) >> 2
    fleft[n - 1] = left[n - 1]
    return ftop, fleft


def pred_dc(width, height, top, left, dc_filter, restrictions):
    """(ref: intra_prediction.cc:365-399). Uses UNfiltered refs."""
    ssum = int(np.sum(top[1:1 + width])) + int(np.sum(left[:height]))
    total = width + height
    dc_val = (ssum + (total >> 1)) // total
    out = np.full((height, width), dc_val, dtype=np.int32)
    if dc_filter and not restrictions.disable_intra_dc_post_filter:
        for y in range(height - 1, 0, -1):
            out[y, 0] = (int(left[y]) + 3 * int(out[y, 0]) + 2) >> 2
        for x in range(1, width):
            out[0, x] = (int(top[1 + x]) + 3 * int(out[0, x]) + 2) >> 2
        out[0, 0] = (int(top[1]) + int(left[0]) + 2 * int(out[0, 0]) + 2) >> 2
    return out


def pred_planar(width, height, top, left):
    """(ref: intra_prediction.cc:401-423)"""
    wl2 = width.bit_length() - 1
    hl2 = height.bit_length() - 1
    above = top[1:1 + width].astype(np.int64)
    leftv = left[:height].astype(np.int64)
    top_right = int(top[1 + width])
    bottom_left = int(left[height])
    shift = wl2 + hl2 + 1
    offset = 1 << (shift - 1)
    y = np.arange(height, dtype=np.int64)[:, None]
    x = np.arange(width, dtype=np.int64)[None, :]
    hor = (height - 1 - y) * above[None, :] + (y + 1) * bottom_left
    ver = (width - 1 - x) * leftv[:, None] + (x + 1) * top_right
    pred = ((hor << wl2) + (ver << hl2) + offset) >> shift
    return pred.astype(np.int32)


def pred_angular(width, height, mode, top, left, post_filter, bitdepth,
                 restrictions):
    """(ref: intra_prediction.cc:425-558)"""
    ext = not restrictions.disable_ext2_intra_67_modes
    diag = convert_angle(k.IntraAngle.DIAGONAL, restrictions)
    hor_mode = convert_angle(k.IntraAngle.HORIZONTAL, restrictions)
    ver_mode = convert_angle(k.IntraAngle.VERTICAL, restrictions)
    is_horizontal = mode < diag

    if is_horizontal:
        # flip: treat left as top
        top_size = width + height
        f_top = np.empty(top_size + 1, dtype=np.int32)
        f_left = np.empty(top_size, dtype=np.int32)
        f_top[0] = top[0]
        f_top[1:1 + top_size] = left[:top_size]
        f_left[:top_size] = top[1:1 + top_size]
        t, l = f_top, f_left
        w, h = height, width
        angle_offset = hor_mode - mode
    else:
        t, l = top, left
        w, h = width, height
        angle_offset = mode - ver_mode
    angle = (ANGLE_TABLE_EXT[16 + angle_offset] if ext
             else ANGLE_TABLE[8 + angle_offset])

    out = np.empty((h, w), dtype=np.int32)
    max_val = (1 << bitdepth) - 1
    if angle == 0:
        out[:, :] = t[1:1 + w][None, :]
        if post_filter and not restrictions.disable_intra_ver_hor_post_filter:
            above_left = int(t[0])
            above = int(t[1])
            for y in range(h):
                val = above + ((int(l[y]) - above_left) >> 1)
                out[y, 0] = min(max(val, 0), max_val)
    else:
        inv_angle_tab = INV_ANGLE_TABLE_EXT if ext else INV_ANGLE_TABLE
        if angle < 0:
            num_projected = -((h * angle) >> 5) - 1
            ref_line = np.zeros(num_projected + 1 + w + h + 1,
                                dtype=np.int32)
            base = num_projected + 1
            # direct copies: indices -1..w-1 relative to base-1
            ref_line[base - 1:base + w] = t[:w + 1]
            inv_angle = inv_angle_tab[-angle_offset - 1]
            inv_angle_sum = 128
            for i in range(num_projected):
                inv_angle_sum += inv_angle
                ref_line[base - 2 - i] = l[(inv_angle_sum >> 8) - 1]
            ref_off = base  # index of "ref_line[0]" in reference code
        else:
            ref_line = t
            ref_off = 1

        angle_sum = 0
        for y in range(h):
            angle_sum += angle
            offset = angle_sum >> 5
            iw = angle_sum & 31
            seg = ref_line[ref_off + offset:ref_off + offset + w + 1]
            if iw:
                out[y, :] = ((32 - iw) * seg[:w].astype(np.int64) +
                             iw * seg[1:w + 1].astype(np.int64) + 16) >> 5
            else:
                out[y, :] = seg[:w]
        if (post_filter and abs(angle) <= 1 and ext and
                not restrictions.disable_intra_ver_hor_post_filter):
            for y in range(h):
                val = int(out[y, 0]) + ((int(l[y]) - int(t[0])) >> 2)
                out[y, 0] = min(max(val, 0), max_val)

    if is_horizontal:
        out = out.T.copy()
    return out.astype(np.int32)


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
