"""Motion vector precision constants.

Motion vectors are (x, y) in 1/16-pel units (ref:
src/xvc_common_lib/inter_prediction.cc).  Copy of the constants of
``xvc_tpu/codec/inter_mv.py``; MV derivation itself runs in the native
parse (``native/csrc/xvcn_pic.inc``).
"""
MV_PRECISION_SHIFT = 4
HIGH_TO_NORMAL_DELTA = MV_PRECISION_SHIFT - 2
