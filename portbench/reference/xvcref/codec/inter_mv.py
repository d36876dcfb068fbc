"""Inter MV derivation: AMVP, merge candidates, TMVP, affine models.

Behavioral equivalent of the reference MV derivation
(ref: src/xvc_common_lib/inter_prediction.cc:144-1009).  Motion vectors
are (x, y) tuples in 1/16-pel units.
"""
from .. import constants as k

MV_PRECISION_SHIFT = 4
MV_SCALE = 1 << MV_PRECISION_SHIFT
MVD_PRECISION_SHIFT = 2
HIGH_TO_NORMAL_DELTA = MV_PRECISION_SHIFT - 2

MERGE_CAND_L0L1_IDX = ((0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1),
                       (0, 3), (3, 0), (1, 3), (3, 1), (2, 3), (3, 2))


def round_to_fullpel(mv):
    return (((mv[0] + (1 << 3)) >> 4) * MV_SCALE,
            ((mv[1] + (1 << 3)) >> 4) * MV_SCALE)


def _round_comp_normal(v):
    if v < 0:
        return -(((-v + 2) >> 2) * 4)
    return ((v + 2) >> 2) * 4


def round_to_normal_precision(mv):
    return (_round_comp_normal(mv[0]), _round_comp_normal(mv[1]))


def add_mvd(mv, mvd, fullpel=False):
    scale = MV_SCALE if fullpel else \
        (1 << (MV_PRECISION_SHIFT - MVD_PRECISION_SHIFT))
    return (mv[0] + mvd[0] * scale, mv[1] + mvd[1] * scale)


class MergeCand:
    __slots__ = ("inter_dir", "mv", "ref_idx", "use_lic")

    def __init__(self):
        self.inter_dir = k.InterDir.L0
        self.mv = [(0, 0), (0, 0)]
        self.ref_idx = [0, 0]
        self.use_lic = False


class AffineMergeCand:
    __slots__ = ("inter_dir", "mv", "ref_idx")

    def __init__(self):
        self.inter_dir = k.InterDir.L0
        self.mv = [[(0, 0)] * 3, [(0, 0)] * 3]
        self.ref_idx = [0, 0]


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


def scale_mv(restrictions, poc_current1, poc_ref1, poc_current2, poc_ref2,
             mv):
    """(ref: inter_prediction.cc:819-843)"""
    if poc_current2 == poc_ref2:
        return mv
    diff1 = min(max(poc_current1 - poc_ref1, -128), 127)
    diff2 = min(max(poc_current2 - poc_ref2, -128), 127)
    ix = (16384 + abs(_cdiv2(diff2))) // diff2 if diff2 > 0 else \
        -((16384 + abs(_cdiv2(diff2))) // -diff2)
    scale_factor = min(max((diff1 * ix + 32) >> 6, -4096), 4095)
    x, y = mv
    if restrictions.disable_ext2_inter_high_precision_mv:
        x >>= HIGH_TO_NORMAL_DELTA
        y >>= HIGH_TO_NORMAL_DELTA
    x = min(max((scale_factor * x + 127 +
                 (1 if scale_factor * x < 0 else 0)) >> 8, -32768), 32767)
    y = min(max((scale_factor * y + 127 +
                 (1 if scale_factor * y < 0 else 0)) >> 8, -32768), 32767)
    if restrictions.disable_ext2_inter_high_precision_mv:
        x *= 1 << HIGH_TO_NORMAL_DELTA
        y *= 1 << HIGH_TO_NORMAL_DELTA
    return (x, y)


def _cdiv2(v):
    # C integer division truncation for v/2
    return v // 2 if v >= 0 else -((-v) // 2)


def _get_mvp_cand(cu_this, direction, ref_list, ref_idx, ref_poc, mv_list,
                  index):
    cu, corner = cu_this.get_cu_with_corner(direction)
    if cu is None or not cu.is_inter():
        return False
    if cu.has_mv(ref_list) and cu.ref_idx[ref_list] == ref_idx:
        mv = cu.mv[ref_list][corner]
        if all(mv_list[i] != mv for i in range(index)):
            mv_list[index] = mv
            return True
    other_list = 1 - ref_list
    if cu.has_mv(other_list) and cu.get_ref_poc(other_list) == ref_poc:
        mv = cu.mv[other_list][corner]
        if all(mv_list[i] != mv for i in range(index)):
            mv_list[index] = mv
            return True
    return False


def _get_scaled_mvp_cand(restrictions, cu_this, direction, cu_ref_list,
                         ref_idx, mv_list, index):
    cu, corner = cu_this.get_cu_with_corner(direction)
    if cu is None or not cu.is_inter():
        return False
    for i in range(2):
        ref_list = cu_ref_list if i == 0 else 1 - cu_ref_list
        cu_ref_idx = cu.ref_idx[ref_list]
        if not cu.has_mv(ref_list):
            continue
        if (i == 0 and cu_ref_idx == ref_idx) or \
                restrictions.disable_inter_scaling_mvp:
            mv = cu.mv[ref_list][corner]
            if all(mv_list[j] != mv for j in range(index)):
                mv_list[index] = mv
                return True
        rpl = cu.pic.ref_pic_lists
        poc_current = cu.pic.poc
        poc_ref_1 = rpl.get_ref_poc(cu_ref_list, ref_idx)
        poc_ref_2 = rpl.get_ref_poc(ref_list, cu_ref_idx)
        mv = cu.mv[ref_list][corner]
        mv = scale_mv(restrictions, poc_current, poc_ref_1, poc_current,
                      poc_ref_2, mv)
        if all(mv_list[j] != mv for j in range(index)):
            mv_list[index] = mv
            return True
    return False


def get_temporal_mv_predictor(restrictions, cu, ref_list, ref_idx):
    """Returns (found, mv, use_lic) (ref: inter_prediction.cc:934-1009)."""
    cu_poc = cu.pic.poc
    rpl = cu.pic.ref_pic_lists
    cu_ref_poc = rpl.get_ref_poc(ref_list, ref_idx)
    tmvp_cu_ref_idx = cu.pic.tmvp_ref_idx
    tmvp_cu_ref_list = cu.pic.tmvp_ref_list
    tmvp_mv_ref_list = ref_list if rpl.has_only_back_references_flag() \
        else 1 - tmvp_cu_ref_list

    def get_temporal_mv(col_cu, col_ref_list, x, y):
        if not col_cu.is_inter():
            return None
        if not col_cu.has_mv(col_ref_list):
            col_ref_list = 1 - col_ref_list
        mv_corner = col_cu.get_mv_corner(x, y)
        col_ref_idx = col_cu.ref_idx[col_ref_list]
        col_poc = col_cu.pic.poc
        col_ref_poc = col_cu.pic.ref_pic_lists.get_ref_poc(col_ref_list,
                                                           col_ref_idx)
        col_mv = col_cu.mv[col_ref_list][mv_corner]
        return scale_mv(restrictions, cu_poc, cu_ref_poc, col_poc,
                        col_ref_poc, col_mv)

    # Bottom right CU
    col_x = cu.pos_x + cu.width
    col_y = cu.pos_y + cu.height
    if (cu.pos_y // k.MAX_BLOCK_SIZE) == (col_y // k.MAX_BLOCK_SIZE):
        valid = True
        if restrictions.disable_ext_tmvp_full_resolution:
            valid = col_x < cu.pic.width and col_y < cu.pic.height
            col_x = (col_x >> 4) << 4
            col_y = (col_y >> 4) << 4
        col_cu = rpl.get_coding_unit_at(tmvp_cu_ref_list, tmvp_cu_ref_idx,
                                        cu.cu_tree, col_x, col_y)
        if valid and col_cu is not None:
            mv = get_temporal_mv(col_cu, tmvp_mv_ref_list, col_x, col_y)
            if mv is not None:
                return True, mv, col_cu.use_lic

    # Center CU
    col_x = cu.pos_x + cu.width // 2
    col_y = cu.pos_y + cu.height // 2
    if restrictions.disable_ext_tmvp_full_resolution:
        col_x = (col_x >> 4) << 4
        col_y = (col_y >> 4) << 4
    col_cu = rpl.get_coding_unit_at(tmvp_cu_ref_list, tmvp_cu_ref_idx,
                                    cu.cu_tree, col_x, col_y)
    if col_cu is not None:
        mv = get_temporal_mv(col_cu, tmvp_mv_ref_list, col_x, col_y)
        if mv is not None:
            return True, mv, col_cu.use_lic
    return False, (0, 0), False


def get_mvp_list(restrictions, cu, ref_list, ref_idx):
    """2-candidate AMVP list (ref: inter_prediction.cc:144-249)."""
    r = restrictions
    if r.disable_inter_mvp:
        mvp = (0, 0)
        tmp, corner = cu.get_cu_with_corner("left")
        if tmp is not None and tmp.is_inter() and tmp.has_mv(ref_list):
            mvp = tmp.mv[ref_list][corner]
        else:
            tmp, corner = cu.get_cu_with_corner("above")
            if tmp is not None and tmp.is_inter() and tmp.has_mv(ref_list):
                mvp = tmp.mv[ref_list][corner]
        if cu.fullpel_mv:
            mvp = round_to_fullpel(mvp)
        mvp = round_to_normal_precision(mvp)
        return [mvp, mvp]
    ref_poc = cu.pic.ref_pic_lists.get_ref_poc(ref_list, ref_idx)
    mv_list = [(0, 0), (0, 0)]
    i = 0

    tmp = cu.get_cu_left_below()
    if tmp is None or not tmp.is_inter():
        tmp = cu.get_cu_left_corner()
    smvp_added = tmp is not None and tmp.is_inter()

    # Left
    if _get_mvp_cand(cu, "left_below", ref_list, ref_idx, ref_poc,
                     mv_list, 0):
        i += 1
    elif _get_mvp_cand(cu, "left_corner", ref_list, ref_idx, ref_poc,
                       mv_list, 0):
        i += 1
    elif _get_scaled_mvp_cand(r, cu, "left_below", ref_list, ref_idx,
                              mv_list, 0):
        i += 1
    elif _get_scaled_mvp_cand(r, cu, "left_corner", ref_list, ref_idx,
                              mv_list, 0):
        i += 1

    # Above (written at slot i; uniqueness window is empty like the
    # reference, which dedups [0]==[1] afterwards)
    slot = [(0, 0)]
    if _get_mvp_cand(cu, "above_right", ref_list, ref_idx, ref_poc,
                     slot, 0):
        mv_list[i] = slot[0]
        i += 1
    elif _get_mvp_cand(cu, "above_corner", ref_list, ref_idx, ref_poc,
                       slot, 0):
        mv_list[i] = slot[0]
        i += 1
    elif _get_mvp_cand(cu, "above_left", ref_list, ref_idx, ref_poc,
                       slot, 0):
        mv_list[i] = slot[0]
        i += 1
    if not smvp_added and i < 2:
        if _get_scaled_mvp_cand(r, cu, "above_right", ref_list, ref_idx,
                                slot, 0):
            mv_list[i] = slot[0]
            i += 1
        elif _get_scaled_mvp_cand(r, cu, "above_corner", ref_list, ref_idx,
                                  slot, 0):
            mv_list[i] = slot[0]
            i += 1
        elif _get_scaled_mvp_cand(r, cu, "above_left", ref_list, ref_idx,
                                  slot, 0):
            mv_list[i] = slot[0]
            i += 1

    if cu.fullpel_mv:
        for j in range(i):
            mv_list[j] = round_to_fullpel(mv_list[j])
    if i == 2 and mv_list[0] == mv_list[1]:
        i = 1
    if k.TEMPORAL_MV_PREDICTION and cu.pic.tmvp_valid and \
            not r.disable_inter_tmvp_mvp and i < 2:
        found, mv, _ = get_temporal_mv_predictor(r, cu, ref_list, ref_idx)
        if found:
            if cu.fullpel_mv:
                mv = round_to_fullpel(mv)
            mv_list[i] = mv
            i += 1
    if i == 2:
        mv_list[0] = round_to_normal_precision(mv_list[0])
        mv_list[1] = round_to_normal_precision(mv_list[1])
    elif i == 1:
        mv_list[0] = round_to_normal_precision(mv_list[0])
        mv_list[1] = (0, 0)
    else:
        mv_list[0] = (0, 0)
        mv_list[1] = (0, 0)
    return mv_list


def _has_different_motion(cu1, corner1, cu2, corner2):
    if cu1.inter_dir != cu2.inter_dir:
        return True
    if cu1.use_lic != cu2.use_lic:
        return True
    for ref_list in range(2):
        if not cu1.has_mv(ref_list):
            continue
        if cu1.ref_idx[ref_list] != cu2.ref_idx[ref_list] or \
                cu1.mv[ref_list][corner1] != cu2.mv[ref_list][corner2]:
            return True
    return False


def _merge_cand_from_cu(cu, corner):
    cand = MergeCand()
    cand.inter_dir = cu.inter_dir
    cand.mv[0] = cu.mv[0][corner]
    cand.mv[1] = cu.mv[1][corner]
    cand.ref_idx[0] = cu.ref_idx[0]
    cand.ref_idx[1] = cu.ref_idx[1]
    cand.use_lic = cu.use_lic
    return cand


def get_merge_candidates(restrictions, cu, merge_cand_idx=-1):
    """(ref: inter_prediction.cc:413-555)"""
    r = restrictions
    can_lic = cu.pic.lic_active
    pic_bipred = cu.pic.get_prediction_type() == k.PicturePredictionType.BI
    lst = [MergeCand() for _ in range(k.NUM_INTER_MERGE_CANDIDATES)]
    num = 0

    left_corner, left_corner_mv = cu.get_cu_with_corner("left_corner")
    has_a1 = left_corner is not None and left_corner.is_inter()
    if has_a1:
        lst[num] = _merge_cand_from_cu(left_corner, left_corner_mv)
        if num == merge_cand_idx:
            return lst
        num += 1

    above_corner, above_corner_mv = cu.get_cu_with_corner("above_corner")
    has_b1 = above_corner is not None and above_corner.is_inter()
    if has_b1 and (not has_a1 or _has_different_motion(
            left_corner, left_corner_mv, above_corner, above_corner_mv)):
        lst[num] = _merge_cand_from_cu(above_corner, above_corner_mv)
        if num == merge_cand_idx:
            return lst
        num += 1

    above_right, above_right_mv = cu.get_cu_with_corner("above_right")
    has_b0 = above_right is not None and above_right.is_inter()
    if has_b0 and (not has_b1 or _has_different_motion(
            above_corner, above_corner_mv, above_right, above_right_mv)):
        lst[num] = _merge_cand_from_cu(above_right, above_right_mv)
        if num == merge_cand_idx:
            return lst
        num += 1

    left_below, left_below_mv = cu.get_cu_with_corner("left_below")
    has_a0 = left_below is not None and left_below.is_inter()
    if has_a0 and (not has_a1 or _has_different_motion(
            left_corner, left_corner_mv, left_below, left_below_mv)):
        lst[num] = _merge_cand_from_cu(left_below, left_below_mv)
        if num == merge_cand_idx:
            return lst
        num += 1

    above_left, above_left_mv = cu.get_cu_with_corner("above_left")
    has_b2 = above_left is not None and above_left.is_inter()
    if has_b2 and num < 4 and \
            (not has_a1 or _has_different_motion(
                left_corner, left_corner_mv, above_left, above_left_mv)) \
            and (not has_b1 or _has_different_motion(
                above_corner, above_corner_mv, above_left, above_left_mv)):
        lst[num] = _merge_cand_from_cu(above_left, above_left_mv)
        if num == merge_cand_idx:
            return lst
        num += 1

    if k.TEMPORAL_MV_PREDICTION and num < len(lst) and \
            not r.disable_inter_tmvp_merge and cu.pic.tmvp_valid:
        use_lic = False
        found_any, mv0, lic0 = get_temporal_mv_predictor(r, cu, 0, 0)
        use_lic |= lic0 if found_any else False
        lst[num].mv[0] = mv0
        lst[num].ref_idx[0] = 0
        lst[num].inter_dir = k.InterDir.L0
        if pic_bipred:
            found_l1, mv1, lic1 = get_temporal_mv_predictor(r, cu, 1, 0)
            if found_l1:
                use_lic |= lic1
                lst[num].mv[1] = mv1
                lst[num].ref_idx[1] = 0
                lst[num].inter_dir = k.InterDir.BI if found_any else \
                    k.InterDir.L1
                found_any = True
        lst[num].use_lic = can_lic and use_lic
        if found_any:
            if num == merge_cand_idx:
                return lst
            num += 1

    if pic_bipred and not r.disable_inter_merge_bipred:
        rpl = cu.pic.ref_pic_lists
        max_num_bi_cand = num * (num - 1)
        for i in range(max_num_bi_cand):
            if num >= len(lst):
                break
            cand_l0_idx, cand_l1_idx = MERGE_CAND_L0L1_IDX[i]
            if lst[cand_l0_idx].inter_dir == k.InterDir.L1 or \
                    lst[cand_l1_idx].inter_dir == k.InterDir.L0:
                continue
            poc_l0 = rpl.get_ref_poc(0, lst[cand_l0_idx].ref_idx[0])
            poc_l1 = rpl.get_ref_poc(1, lst[cand_l1_idx].ref_idx[1])
            if poc_l0 != poc_l1 or \
                    lst[cand_l0_idx].mv[0] != lst[cand_l1_idx].mv[1]:
                lst[num].inter_dir = k.InterDir.BI
                lst[num].mv[0] = lst[cand_l0_idx].mv[0]
                lst[num].mv[1] = lst[cand_l1_idx].mv[1]
                lst[num].ref_idx[0] = lst[cand_l0_idx].ref_idx[0]
                lst[num].ref_idx[1] = lst[cand_l1_idx].ref_idx[1]
                lst[num].use_lic = lst[cand_l0_idx].use_lic or \
                    lst[cand_l1_idx].use_lic
                if num == merge_cand_idx:
                    return lst
                num += 1

    rpl = cu.pic.ref_pic_lists
    if not pic_bipred:
        max_num_refs = rpl.get_num_ref_pics(0)
    else:
        max_num_refs = min(rpl.get_num_ref_pics(0), rpl.get_num_ref_pics(1))
    ref_idx = 0
    while num < len(lst):
        lst[num].inter_dir = k.InterDir.BI if pic_bipred else k.InterDir.L0
        lst[num].mv[0] = (0, 0)
        lst[num].mv[1] = (0, 0)
        lst[num].ref_idx[0] = ref_idx if ref_idx < max_num_refs else 0
        lst[num].ref_idx[1] = ref_idx if ref_idx < max_num_refs else 0
        ref_idx += 1
        if num == merge_cand_idx:
            return lst
        num += 1
    return lst


def derive_mv_affine(cu, ref_pic, mv1, mv2):
    """(ref: inter_prediction.cc:615-630)"""
    out0 = clip_mv(cu, ref_pic, mv1)
    out1 = clip_mv(cu, ref_pic, mv2)
    # C integer division truncates toward zero
    dx = (out1[1] - out0[1]) * cu.height
    dy = (out1[0] - out0[0]) * cu.height
    tx = abs(dx) // cu.width * (-1 if dx < 0 else 1)
    ty = abs(dy) // cu.width * (-1 if dy < 0 else 1)
    out2 = clip_mv(cu, ref_pic, (out0[0] - tx, out0[1] + ty))
    return [out0, out1, out2]


def get_affine_merge_cand(cu):
    """(ref: inter_prediction.cc:557-613)"""
    neigh = cu.get_cu_left_corner()
    if neigh is None or not neigh.use_affine:
        neigh = cu.get_cu_above_corner()
    if neigh is None or not neigh.use_affine:
        neigh = cu.get_cu_above_right()
    if neigh is None or not neigh.use_affine:
        neigh = cu.get_cu_left_below()
    if neigh is None or not neigh.use_affine:
        neigh = cu.get_cu_above_left()
    scale_x = (cu.pos_x - neigh.pos_x) / neigh.width
    scale_y = (cu.pos_y - neigh.pos_y) / neigh.height
    scale_len_x = cu.width / neigh.width
    scale_len_y = cu.height / neigh.height

    def scale_mv3(ref):
        mv_x = int(ref[0][0] + (ref[2][0] - ref[0][0]) * scale_y +
                   (ref[1][0] - ref[0][0]) * scale_x)
        mv_y = int(ref[0][1] + (ref[2][1] - ref[0][1]) * scale_y +
                   (ref[1][1] - ref[0][1]) * scale_x)
        return [
            (mv_x, mv_y),
            (int(mv_x + (ref[1][0] - ref[0][0]) * scale_len_x),
             int(mv_y + (ref[1][1] - ref[0][1]) * scale_len_x)),
            (int(mv_x + (ref[2][0] - ref[0][0]) * scale_len_y),
             int(mv_y + (ref[2][1] - ref[0][1]) * scale_len_y)),
        ]

    cand = AffineMergeCand()
    cand.inter_dir = neigh.inter_dir
    if neigh.has_mv(0):
        cand.mv[0] = scale_mv3(neigh.mv[0][:3])
        cand.ref_idx[0] = neigh.ref_idx[0]
    if neigh.has_mv(1):
        cand.mv[1] = scale_mv3(neigh.mv[1][:3])
        cand.ref_idx[1] = neigh.ref_idx[1]
    if cu.width <= k.MIN_BLOCK_SIZE:
        cand.mv[0][1] = cand.mv[0][0]
        cand.mv[1][1] = cand.mv[1][0]
    if cu.height <= k.MIN_BLOCK_SIZE:
        cand.mv[0][2] = cand.mv[0][0]
        cand.mv[1][2] = cand.mv[1][0]
    return cand


def get_mvp_list_affine(restrictions, cu, ref_list, ref_idx, max_num_mvp):
    """(ref: inter_prediction.cc:251-390)"""
    r = restrictions
    rpl = cu.pic.ref_pic_lists
    ref_pic = rpl.get_ref_pic(ref_list, ref_idx)
    ref_poc = rpl.get_ref_poc(ref_list, ref_idx)
    width, height = cu.width, cu.height
    num_out = 2  # AffinePredictorList size
    if r.disable_ext2_inter_affine_mvp:
        mvp = [(0, 0), (0, 0), (0, 0)]
        tmp = cu.get_cu_left()
        if tmp is not None and tmp.use_affine and tmp.has_mv(ref_list):
            mvp = [tuple(m) for m in tmp.mv[ref_list][:3]]
        else:
            tmp = cu.get_cu_above()
            if tmp is not None and tmp.use_affine and tmp.has_mv(ref_list):
                mvp = [tuple(m) for m in tmp.mv[ref_list][:3]]
        mv0 = round_to_normal_precision(mvp[0])
        mv1 = round_to_normal_precision(mvp[1])
        out = derive_mv_affine(cu, ref_pic, mv0, mv1)
        return [out, out]

    list0 = [(0, 0)] * 3
    list1 = [(0, 0)] * 2
    list2 = [(0, 0)] * 2
    i0 = 0
    for d in ("above_left", "above", "left"):
        if _get_mvp_cand(cu, d, ref_list, ref_idx, ref_poc, list0, i0):
            i0 += 1
    for d in ("above_left", "above", "left"):
        if i0 < 3 and _get_scaled_mvp_cand(r, cu, d, ref_list, ref_idx,
                                           list0, i0):
            i0 += 1
    i1 = 0
    for d in ("above_corner", "above_right"):
        if _get_mvp_cand(cu, d, ref_list, ref_idx, ref_poc, list1, i1):
            i1 += 1
    for d in ("above_corner", "above_right"):
        if i1 < 2 and _get_scaled_mvp_cand(r, cu, d, ref_list, ref_idx,
                                           list1, i1):
            i1 += 1
    i2 = 0
    for d in ("left_corner", "left_below"):
        if _get_mvp_cand(cu, d, ref_list, ref_idx, ref_poc, list2, i2):
            i2 += 1
    for d in ("left_corner", "left_below"):
        if i2 < 2 and _get_scaled_mvp_cand(r, cu, d, ref_list, ref_idx,
                                           list2, i2):
            i2 += 1

    def get_length(mv0, mv1, mv2):
        max_x = width >> 1
        max_y = height >> 1
        hx, hy = mv1[0] - mv0[0], mv1[1] - mv0[1]
        vx, vy = mv2[0] - mv0[0], mv2[1] - mv0[1]
        if hx == 0 and hy == 0:
            return -1
        if abs(hx) > max_x or abs(hy) > max_y or \
                abs(vx) > max_x or abs(vy) > max_y:
            return -1
        return abs(hx * height - vy * width) + abs(hy * height + vx * width)

    comb_list = []
    comb_cost = []
    for j0 in range(i0):
        for j1 in range(i1):
            for j2 in range(i2):
                length = get_length(list0[j0], list1[j1], list2[j2])
                if length < 0:
                    continue
                comb_cost.append(length)
                comb_list.append((j0, j1, j2))
    out_list = [None, None]
    num_list = min(len(comb_list), num_out)
    costs = list(comb_cost)
    for out in range(num_list):
        best_i = 0
        for i in range(1, len(costs)):
            if costs[i] < costs[best_i]:
                best_i = i
        costs[best_i] = 1 << 60
        mv0 = round_to_normal_precision(list0[comb_list[best_i][0]])
        mv1 = round_to_normal_precision(list1[comb_list[best_i][1]])
        out_list[out] = derive_mv_affine(cu, ref_pic, mv0, mv1)
        if out >= max_num_mvp:
            return out_list
    if num_list < num_out:
        normal_mvp = get_mvp_list(r, cu, ref_list, ref_idx)
        for out in range(num_list, num_out):
            mvp = normal_mvp[out - num_list]
            out_list[out] = derive_mv_affine(cu, ref_pic, mvp, mvp)
    for out in range(num_out):
        if out_list[out] is None:
            out_list[out] = [(0, 0), (0, 0), (0, 0)]
    return out_list


def calculate_mv(predictor, cu):
    """(ref: inter_prediction.cc:632-687)"""
    r = predictor.restr
    if cu.merge_flag:
        merge_idx = cu.merge_idx
        if cu.use_affine:
            cand = get_affine_merge_cand(cu)
            apply_affine_merge_cand(cu, cand)
        else:
            merge_list = get_merge_candidates(r, cu, merge_idx)
            apply_merge_cand(cu, merge_list[merge_idx])
    elif cu.use_affine:
        for ref_list in range(2):
            if cu.has_mv(ref_list):
                ref_idx = cu.ref_idx[ref_list]
                mvp_idx = cu.mvp_idx[ref_list]
                ref_pic = cu.pic.ref_pic_lists.get_ref_pic(ref_list, ref_idx)
                mvd0 = cu.mvd[ref_list][0]
                mvd1 = cu.mvd[ref_list][1]
                mvp_list = get_mvp_list_affine(r, cu, ref_list, ref_idx,
                                               mvp_idx)
                mv3 = mvp_list[mvp_idx]
                mv0 = add_mvd(mv3[0], mvd0)
                mv1 = add_mvd(mv3[1], mvd1)
                out = derive_mv_affine(cu, ref_pic, mv0, mv1)
                set_mv3(cu, out, ref_list)
            else:
                cu.mv[ref_list] = [(0, 0)] * 4
                cu.ref_idx[ref_list] = -1
    else:
        for ref_list in range(2):
            if cu.has_mv(ref_list):
                ref_idx = cu.ref_idx[ref_list]
                mvp_idx = cu.mvp_idx[ref_list]
                mvd = cu.mvd[ref_list][0]
                mvp_list = get_mvp_list(r, cu, ref_list, ref_idx)
                mv = add_mvd(mvp_list[mvp_idx], mvd, fullpel=cu.fullpel_mv)
                cu.mv[ref_list] = [mv] * 4
            else:
                cu.mv[ref_list] = [(0, 0)] * 4
                cu.ref_idx[ref_list] = -1


def set_mv3(cu, mv3, ref_list):
    cu.mv[ref_list] = [
        mv3[0], mv3[1], mv3[2],
        (mv3[1][0] + mv3[2][0] - mv3[0][0],
         mv3[1][1] + mv3[2][1] - mv3[0][1])]


def apply_merge_cand(cu, cand):
    cu.inter_dir = cand.inter_dir
    cu.use_lic = cand.use_lic
    for ref_list in range(2):
        cu.mv[ref_list] = [cand.mv[ref_list]] * 4
        cu.ref_idx[ref_list] = cand.ref_idx[ref_list]


def apply_affine_merge_cand(cu, cand):
    cu.inter_dir = cand.inter_dir
    for ref_list in range(2):
        set_mv3(cu, cand.mv[ref_list], ref_list)
        cu.ref_idx[ref_list] = cand.ref_idx[ref_list]
