"""Intra most-probable-mode and chroma predictor derivation.

Behavioral equivalent of the reference predictor derivation
(ref: src/xvc_common_lib/intra_prediction.cc:148-319).
"""
from .. import constants as k
from ..ops.intra_pred import convert_angle


class IntraPredictorLuma(list):
    def __init__(self):
        super().__init__([0] * k.NUM_INTRA_MPM_EXT)
        self.num_neighbor_modes = 0


def get_predictor_luma(cu, restrictions):
    r = restrictions
    max_modes = k.NBR_INTRA_MODES_EXT if not r.disable_ext2_intra_67_modes \
        else k.NBR_INTRA_MODES - 1
    offset = (k.NBR_INTRA_MODES_EXT - 5) \
        if not r.disable_ext2_intra_67_modes else k.NBR_INTRA_MODES - 6
    mpm = IntraPredictorLuma()
    if r.disable_intra_mpm_prediction:
        mpm.num_neighbor_modes = 1
        mpm[0] = 0  # planar
        mpm[1] = 1  # dc
        mpm[2] = convert_angle(k.IntraAngle.VERTICAL, r)
        if not r.disable_ext2_intra_6_predictors:
            mpm[3] = convert_angle(k.IntraAngle.HORIZONTAL, r)
            mpm[4] = convert_angle(k.IntraAngle.DIAGONAL, r)
            mpm[5] = 2
        return mpm
    if r.disable_ext2_intra_6_predictors:
        _fill_predictor_luma_default(cu, mpm, r, max_modes, offset)
        return mpm

    added = [False] * k.NBR_INTRA_MODES_EXT
    index = 0

    def add_from_cu(tmp):
        nonlocal index
        if tmp is not None and tmp.is_intra():
            mode = tmp.intra_mode_luma
            if not added[mode]:
                added[mode] = True
                mpm[index] = mode
                index += 1

    def add_if_new(mode):
        nonlocal index
        if not added[mode]:
            added[mode] = True
            mpm[index] = mode
            index += 1

    if index < k.NUM_INTRA_MPM_EXT:
        add_from_cu(cu.get_cu_left_corner())
    if index < k.NUM_INTRA_MPM_EXT:
        add_from_cu(cu.get_cu_above_corner())
    mpm.num_neighbor_modes = 3 if index > 1 else 2
    if index < k.NUM_INTRA_MPM_EXT:
        add_if_new(0)
    if index < k.NUM_INTRA_MPM_EXT:
        add_if_new(1)
    if index < k.NUM_INTRA_MPM_EXT:
        add_from_cu(cu.get_cu_left_below())
    if index < k.NUM_INTRA_MPM_EXT:
        add_from_cu(cu.get_cu_above_right())
    if index < k.NUM_INTRA_MPM_EXT:
        add_from_cu(cu.get_cu_above_left())
    current_added = index
    for i in range(current_added):
        if index == k.NUM_INTRA_MPM_EXT:
            break
        mode = mpm[i]
        if mode <= 1:
            continue
        predictor = ((mode + offset) % (max_modes - 2)) + 2
        add_if_new(predictor)
        if index == k.NUM_INTRA_MPM_EXT:
            break
        predictor = ((mode - 1) % (max_modes - 2)) + 2
        add_if_new(predictor)
    for pred_angle in (k.IntraAngle.VERTICAL, k.IntraAngle.HORIZONTAL,
                      k.IntraAngle.FIRST, k.IntraAngle.DIAGONAL):
        if index == k.NUM_INTRA_MPM_EXT:
            break
        add_if_new(convert_angle(pred_angle, r))
    return mpm


def _fill_predictor_luma_default(cu, mpm, r, max_modes, offset):
    cu_left = cu.get_cu_left()
    left = 1
    if cu_left is not None and cu_left.is_intra():
        left = cu_left.intra_mode_luma
    if r.disable_ext_intra_unrestricted_predictor:
        cu_above = cu.get_cu_above_if_same_ctu()
    else:
        cu_above = cu.get_cu_above()
    above = 1
    if cu_above is not None and cu_above.is_intra():
        above = cu_above.intra_mode_luma
    if left == above:
        mpm.num_neighbor_modes = 1
        if left > 1:
            mpm[0] = left
            mpm[1] = ((left + offset) % (max_modes - 2)) + 2
            mpm[2] = ((left - 1) % (max_modes - 2)) + 2
        else:
            mpm[0] = 0
            mpm[1] = 1
            mpm[2] = convert_angle(k.IntraAngle.VERTICAL, r)
    else:
        mpm.num_neighbor_modes = 2
        mpm[0] = left
        mpm[1] = above
        if left > 0 and above > 0:
            mpm[2] = 0
        else:
            mpm[2] = convert_angle(k.IntraAngle.VERTICAL, r) \
                if (left + above) < 2 else 1


def get_predictors_chroma(luma_mode, restrictions):
    """(ref: intra_prediction.cc:296-319)"""
    r = restrictions
    preds = [0] * 6
    preds[0] = 0  # planar
    preds[1] = convert_angle(k.IntraAngle.VERTICAL, r)
    preds[2] = convert_angle(k.IntraAngle.HORIZONTAL, r)
    preds[3] = 1  # dc
    if not r.disable_ext2_intra_chroma_from_luma:
        preds[4] = k.INTRA_MODE_LM_CHROMA
        preds[5] = k.INTRA_CHROMA_DM
    else:
        preds[4] = k.INTRA_CHROMA_DM
        preds[5] = 99  # invalid
    from ..ops.intra_pred import ANGLE_TO_MODE_EXT
    ver_plus8 = ANGLE_TO_MODE_EXT[34] \
        if not r.disable_ext2_intra_67_modes else 34
    for i in range(4):
        if preds[i] == luma_mode:
            preds[i] = ver_plus8
            break
    return preds
