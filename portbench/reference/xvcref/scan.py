"""Coefficient scan order tables and derivation.

(ref: src/xvc_common_lib/transform.cc:47-76 scan tables,
 transform.cc:1614-1680 scan-order derivation and subblock scan.)
"""
from functools import lru_cache

import numpy as np

from . import constants as k

LAST_POS_GROUP_IDX = np.array(
    [0, 1, 2, 3, 4, 4, 5, 5] + [6] * 4 + [7] * 4 + [8] * 8 + [9] * 8 +
    [10] * 16 + [11] * 16 + [12] * 32 + [13] * 32, dtype=np.int32)

LAST_POS_MIN_IN_GROUP = np.array(
    [0, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96], dtype=np.int32)

GOLOMB_RICE_RANGE_EXT = np.array([6, 5, 6, 3, 3, 3, 3, 3, 3, 3],
                                 dtype=np.int32)

# 2x2 and 4x4 coefficient scan tables per ScanOrder (diag, hor, ver)
SCAN_COEFF_2X2 = (
    (0, 2, 1, 3),
    (0, 1, 2, 3),
    (0, 2, 1, 3),
)
SCAN_COEFF_4X4 = (
    (0, 4, 1, 8, 5, 2, 12, 9, 6, 3, 13, 10, 7, 14, 11, 15),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (0, 4, 8, 12, 1, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15),
)


@lru_cache(maxsize=None)
def derive_subblock_scan(scan_order, width, height):
    """Subblock scan table: scan index -> raster subblock index."""
    n = width * height
    table = [0] * n
    pos_x = pos_y = 0
    if scan_order == k.ScanOrder.DIAGONAL:
        for i in range(n):
            table[i] = pos_y * width + pos_x
            if pos_x == width - 1 or pos_y == 0:
                pos_y += pos_x + 1
                pos_x = 0
                if pos_y >= height:
                    pos_x += pos_y - (height - 1)
                    pos_y = height - 1
            else:
                pos_x += 1
                pos_y -= 1
    elif scan_order == k.ScanOrder.HORIZONTAL:
        for i in range(n):
            table[i] = pos_y * width + pos_x
            if pos_x == width - 1:
                pos_x = 0
                pos_y += 1
            else:
                pos_x += 1
    else:  # vertical
        for i in range(n):
            table[i] = pos_y * width + pos_x
            if pos_y == height - 1:
                pos_x += 1
                pos_y = 0
            else:
                pos_y += 1
    return tuple(table)


def determine_scan_order(cu, comp_is_luma, intra_mode, restrictions):
    """(ref: transform.cc:1614-1637)"""
    size_threshold = 16
    angle_threshold = 10 if not restrictions.disable_ext2_intra_67_modes else 5
    if (cu.pred_mode != k.PredictionMode.INTRA or
            restrictions.disable_transform_adaptive_scan_order):
        return k.ScanOrder.DIAGONAL
    if cu.width >= size_threshold or cu.height >= size_threshold:
        return k.ScanOrder.DIAGONAL
    if restrictions.disable_ext2_intra_67_modes:
        vertical_mode, horizontal_mode = 26, 10
    else:
        vertical_mode, horizontal_mode = 50, 18
    if abs(intra_mode - vertical_mode) < angle_threshold:
        return k.ScanOrder.HORIZONTAL
    if abs(intra_mode - horizontal_mode) < angle_threshold:
        return k.ScanOrder.VERTICAL
    return k.ScanOrder.DIAGONAL
