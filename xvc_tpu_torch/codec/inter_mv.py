"""Motion vector precision constants and the MV clip.

Motion vectors are (x, y) in 1/16-pel units (ref:
src/xvc_common_lib/inter_prediction.cc).  Copy of the constants and of
``clip_mv`` of ``xvc_tpu/codec/inter_mv.py``; MV derivation itself runs
in the native parse (``native/csrc/xvcn_pic.inc``), which hands the
reconstruction its final MVs.
"""
from .. import constants as k

MV_PRECISION_SHIFT = 4
MV_SCALE = 1 << MV_PRECISION_SHIFT
HIGH_TO_NORMAL_DELTA = MV_PRECISION_SHIFT - 2


def clip_mv(cu, ref_pic, mv):
    """(ref: inter_prediction.cc:769-782)"""
    offset = 8
    pos_x, pos_y = cu.pos_x, cu.pos_y
    pic_min_x = -((k.MAX_BLOCK_SIZE + offset + pos_x - 1) <<
                  MV_PRECISION_SHIFT)
    pic_min_y = -((k.MAX_BLOCK_SIZE + offset + pos_y - 1) <<
                  MV_PRECISION_SHIFT)
    pic_max_x = (ref_pic.width[0] + offset - pos_x - 1) << MV_PRECISION_SHIFT
    pic_max_y = (ref_pic.height[0] + offset - pos_y - 1) << MV_PRECISION_SHIFT
    return (min(max(mv[0], pic_min_x), pic_max_x),
            min(max(mv[1], pic_min_y), pic_max_y))
