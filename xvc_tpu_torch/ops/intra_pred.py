"""Intra prediction tables and reference-sample gathering.

Behavioral equivalent of the reference intra predictor's reference
handling (ref: src/xvc_common_lib/intra_prediction.cc:707-848) and its
angle tables for the 67-mode set.  Copy of those parts of
``xvc_tpu/ops/intra_pred.py``; prediction itself runs on the device
(``gpu/intra_scan.py`` for decode, ``gpu/intra_batch.py`` for the
encoder's lookahead).

Reference sample layout matches the reference codec: a top row of
width+height+1 samples (index 0 = above-left) and a left column of
height+width samples.
"""
import numpy as np


ANGLE_TABLE_EXT = (-32, -29, -26, -23, -21, -19, -17, -15, -13, -11, -9, -7,
                   -5, -3, -2, -1, 0, 1, 2, 3, 5, 7, 9, 11, 13, 15, 17, 19,
                   21, 23, 26, 29, 32)
INV_ANGLE_TABLE_EXT = (8192, 4096, 2731, 1638, 1170, 910, 745, 630, 546, 482,
                       431, 390, 356, 315, 282, 256)


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
