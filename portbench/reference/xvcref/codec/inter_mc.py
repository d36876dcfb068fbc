"""Motion compensation: sub-pel interpolation, bi-pred, affine, LIC.

Behavioral equivalent of the reference MC path
(ref: src/xvc_common_lib/inter_prediction.cc:710-1378,1387-1650).
Numpy exact-integer host path.
"""
import numpy as np

from .. import constants as k
from . import inter_mv as mv_mod


class InterPredictor:
    """Inter prediction facade: MV derivation + motion compensation
    (ref: src/xvc_common_lib/inter_prediction.{h,cc}).  MV derivation
    lives in codec.inter_mv; interpolation below in this module."""

    def __init__(self, pic_data, rec_pic, bitdepth, restrictions):
        self.pic = pic_data
        self.rec_pic = rec_pic
        self.bitdepth = bitdepth
        self.restr = restrictions

    def calculate_mv(self, cu):
        mv_mod.calculate_mv(self, cu)

    def motion_compensation(self, cu, comp):
        return motion_compensation(self, cu, comp)


NUM_TAPS_LUMA = 8
NUM_TAPS_CHROMA = 4
INTERNAL_PRECISION = 14
FILTER_PRECISION = 6
INTERNAL_OFFSET = 1 << (INTERNAL_PRECISION - 1)

LUMA_FILTER = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
], dtype=np.int64)

LUMA_FILTER_HIGH_PREC = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [0, 1, -3, 63, 4, -2, 1, 0],
    [-1, 2, -5, 62, 8, -3, 1, 0],
    [-1, 3, -8, 60, 13, -4, 1, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 52, 26, -8, 3, -1],
    [-1, 3, -9, 47, 31, -10, 4, -1],
    [-1, 4, -11, 45, 34, -10, 4, -1],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [-1, 4, -10, 34, 45, -11, 4, -1],
    [-1, 4, -10, 31, 47, -9, 3, -1],
    [-1, 3, -8, 26, 52, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
    [0, 1, -4, 13, 60, -8, 3, -1],
    [0, 1, -3, 8, 62, -5, 2, -1],
    [0, 1, -2, 4, 63, -3, 1, 0],
], dtype=np.int64)

CHROMA_FILTER = np.array([
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2],
], dtype=np.int64)

CHROMA_FILTER_HIGH_PREC = np.array([
    [0, 64, 0, 0], [-1, 63, 2, 0], [-2, 62, 4, 0], [-2, 60, 7, -1],
    [-2, 58, 10, -2], [-3, 57, 12, -2], [-4, 56, 14, -2], [-4, 55, 15, -2],
    [-4, 54, 16, -2], [-5, 53, 18, -2], [-6, 52, 20, -2], [-6, 49, 24, -3],
    [-6, 46, 28, -4], [-5, 44, 29, -4], [-4, 42, 30, -4], [-4, 39, 33, -4],
    [-4, 36, 36, -4], [-4, 33, 39, -4], [-4, 30, 42, -4], [-4, 29, 44, -5],
    [-4, 28, 46, -6], [-3, 24, 49, -6], [-2, 20, 52, -6], [-2, 18, 53, -5],
    [-2, 16, 54, -4], [-2, 15, 55, -4], [-2, 14, 56, -4], [-2, 12, 57, -3],
    [-2, 10, 58, -2], [-1, 7, 60, -2], [0, 4, 62, -2], [0, 2, 63, -1],
], dtype=np.int64)


def _conv_h(src, filt):
    """src: (h, w + taps - 1) -> (h, w)"""
    taps = len(filt)
    w = src.shape[1] - taps + 1
    out = np.zeros((src.shape[0], w), dtype=np.int64)
    for i in range(taps):
        out += filt[i] * src[:, i:i + w]
    return out

def _conv_v(src, filt):
    """src: (h + taps - 1, w) -> (h, w)"""
    taps = len(filt)
    h = src.shape[0] - taps + 1
    out = np.zeros((h, src.shape[1]), dtype=np.int64)
    for i in range(taps):
        out += filt[i] * src[i:i + h, :]
    return out


def _ref_block(ref_pic, comp, x0, y0, h, w):
    """Read (h, w) from the padded plane at visible coords (x0, y0)."""
    plane = ref_pic.padded_plane(comp)
    px, py = ref_pic.pad_x[comp], ref_pic.pad_y[comp]
    if READS is not None:
        READS(ref_pic, comp, py + y0, px + x0, h, w)
    return plane[py + y0:py + y0 + h, px + x0:px + x0 + w].astype(np.int64)


# None, or a callable told of every reference read as (picture, comp,
# row, column in the padded plane, rows, columns): the benchmark counts
# the reference samples a picture's motion compensation needs with it
READS = None


class McContext:
    """Per-call info: block position/size, ref picture, bitdepth."""
    __slots__ = ("ref_pic", "comp", "x", "y", "width", "height", "bitdepth",
                 "restr")

    def __init__(self, ref_pic, comp, x, y, width, height, bitdepth, restr):
        self.ref_pic = ref_pic
        self.comp = comp
        self.x = x
        self.y = y
        self.width = width
        self.height = height
        self.bitdepth = bitdepth
        self.restr = restr


def get_fullpel_ref(cu, comp, ref_pic, mv_x, mv_y, restr):
    """Returns (pel_x, pel_y, frac_x, frac_y)
    (ref: inter_prediction.cc:1174-1205)"""
    shift_x = mv_mod.MV_PRECISION_SHIFT + ref_pic.shift_x[comp]
    shift_y = mv_mod.MV_PRECISION_SHIFT + ref_pic.shift_y[comp]
    pel_x = mv_x >> shift_x
    pel_y = mv_y >> shift_y
    if comp == 0:
        frac_x = mv_x & ((1 << shift_x) - 1)
        frac_y = mv_y & ((1 << shift_y) - 1)
    elif restr.disable_inter_chroma_subpel:
        pel_x = (mv_x + (1 << (shift_x - 1))) >> shift_x
        pel_y = (mv_y + (1 << (shift_y - 1))) >> shift_y
        frac_x = frac_y = 0
    else:
        frac_x = (mv_x & ((1 << shift_x) - 1)) << (1 - ref_pic.shift_x[comp])
        frac_y = (mv_y & ((1 << shift_y) - 1)) << (1 - ref_pic.shift_y[comp])
    if restr.disable_ext2_inter_high_precision_mv:
        frac_x >>= mv_mod.HIGH_TO_NORMAL_DELTA
        frac_y >>= mv_mod.HIGH_TO_NORMAL_DELTA
    return pel_x, pel_y, frac_x, frac_y


def _filters(comp, restr):
    if comp == 0:
        return (LUMA_FILTER_HIGH_PREC, NUM_TAPS_LUMA) \
            if not restr.disable_ext2_inter_high_precision_mv \
            else (LUMA_FILTER, NUM_TAPS_LUMA)
    return (CHROMA_FILTER_HIGH_PREC, NUM_TAPS_CHROMA) \
        if not restr.disable_ext2_inter_high_precision_mv \
        else (CHROMA_FILTER, NUM_TAPS_CHROMA)



def mc_unipred_sample(ctx, x0, y0, frac_x, frac_y):
    """Sub-pel MC producing final samples (uni-pred path)."""
    w, h = ctx.width, ctx.height
    bd = ctx.bitdepth
    max_val = (1 << bd) - 1
    if frac_x == 0 and frac_y == 0:
        return np.clip(_ref_block(ctx.ref_pic, ctx.comp, x0, y0, h, w),
                       0, max_val).astype(np.int32)
    table, taps = _filters(ctx.comp, ctx.restr)
    half = taps // 2 - 1
    if frac_y == 0:
        src = _ref_block(ctx.ref_pic, ctx.comp, x0 - half, y0, h,
                         w + taps - 1)
        shift = FILTER_PRECISION
        offset = 1 << (shift - 1)
        out = (_conv_h(src, table[frac_x]) + offset) >> shift
        return np.clip(out, 0, max_val).astype(np.int32)
    if frac_x == 0:
        src = _ref_block(ctx.ref_pic, ctx.comp, x0, y0 - half,
                         h + taps - 1, w)
        shift = FILTER_PRECISION
        offset = 1 << (shift - 1)
        out = (_conv_v(src, table[frac_y]) + offset) >> shift
        # reference casts to int16 before final clip (FilterVerSampleSample)
        out = out.astype(np.int16).astype(np.int64)
        return np.clip(out, 0, max_val).astype(np.int32)
    # two-stage: horizontal to int16 intermediate, then vertical
    src = _ref_block(ctx.ref_pic, ctx.comp, x0 - half, y0 - half,
                     h + taps - 1, w + taps - 1)
    shift1 = FILTER_PRECISION - (INTERNAL_PRECISION - bd)
    offset1 = -(INTERNAL_OFFSET << shift1) if shift1 >= 0 else 0
    if shift1 >= 0:
        temp = (_conv_h(src, table[frac_x]) + offset1) >> shift1
    else:
        temp = (_conv_h(src, table[frac_x]) - (INTERNAL_OFFSET >> -shift1)) \
            << -shift1
    temp = temp.astype(np.int16).astype(np.int64)
    shift2 = FILTER_PRECISION + (INTERNAL_PRECISION - bd)
    offset2 = (INTERNAL_OFFSET << FILTER_PRECISION) + (1 << (shift2 - 1))
    out = (_conv_v(temp, table[frac_y]) + offset2) >> shift2
    out = out.astype(np.int16).astype(np.int64)
    return np.clip(out, 0, max_val).astype(np.int32)


def mc_unipred_short(ctx, x0, y0, frac_x, frac_y):
    """Sub-pel MC producing 14-bit intermediates (bi-pred path)."""
    w, h = ctx.width, ctx.height
    bd = ctx.bitdepth
    if frac_x == 0 and frac_y == 0:
        shift = INTERNAL_PRECISION - bd
        src = _ref_block(ctx.ref_pic, ctx.comp, x0, y0, h, w)
        return ((src << shift).astype(np.int16).astype(np.int64) -
                INTERNAL_OFFSET).astype(np.int16)
    table, taps = _filters(ctx.comp, ctx.restr)
    half = taps // 2 - 1
    shift1 = FILTER_PRECISION - (INTERNAL_PRECISION - bd)
    offset1 = -(INTERNAL_OFFSET << shift1)
    if frac_y == 0:
        src = _ref_block(ctx.ref_pic, ctx.comp, x0 - half, y0, h,
                         w + taps - 1)
        return ((_conv_h(src, table[frac_x]) + offset1) >>
                shift1).astype(np.int16)
    if frac_x == 0:
        src = _ref_block(ctx.ref_pic, ctx.comp, x0, y0 - half,
                         h + taps - 1, w)
        return ((_conv_v(src, table[frac_y]) + offset1) >>
                shift1).astype(np.int16)
    src = _ref_block(ctx.ref_pic, ctx.comp, x0 - half, y0 - half,
                     h + taps - 1, w + taps - 1)
    temp = ((_conv_h(src, table[frac_x]) + offset1) >>
            shift1).astype(np.int16).astype(np.int64)
    shift2 = FILTER_PRECISION
    out = (_conv_v(temp, table[frac_y])) >> shift2
    return out.astype(np.int16)


def filter_copy_bipred(ctx, pred_samples):
    """Sample block -> 14-bit intermediate (ref: FilterCopyBipred_c)."""
    shift = INTERNAL_PRECISION - ctx.bitdepth
    return ((pred_samples.astype(np.int64) << shift).astype(np.int16)
            .astype(np.int64) - INTERNAL_OFFSET).astype(np.int16)


def add_avg_bi(l0, l1, bitdepth):
    shift = max(2, INTERNAL_PRECISION - bitdepth) + 1
    offset = (1 << (shift - 1)) + 2 * INTERNAL_OFFSET
    max_val = (1 << bitdepth) - 1
    out = (l0.astype(np.int64) + l1.astype(np.int64) + offset) >> shift
    return np.clip(out, 0, max_val).astype(np.int32)


def motion_compensation(predictor, cu, comp):
    """(ref: inter_prediction.cc:710-738)"""
    restr = predictor.restr
    rpl = cu.pic.ref_pic_lists
    bitdepth = predictor.bitdepth
    if cu.inter_dir != k.InterDir.BI:
        ref_list = 0 if cu.inter_dir == k.InterDir.L0 else 1
        return _mc_ref_list(predictor, cu, comp, ref_list, post_filter=True)
    if cu.use_lic:
        p0 = _mc_ref_list(predictor, cu, comp, 0, post_filter=True)
        ctx = _make_ctx(predictor, cu, comp, rpl.get_ref_pic(0,
                        cu.ref_idx[0]))
        l0 = filter_copy_bipred(ctx, p0)
        p1 = _mc_ref_list(predictor, cu, comp, 1, post_filter=True)
        l1 = filter_copy_bipred(ctx, p1)
    else:
        l0 = _mc_ref_list(predictor, cu, comp, 0, post_filter=False,
                          short_out=True)
        l1 = _mc_ref_list(predictor, cu, comp, 1, post_filter=False,
                          short_out=True)
    return add_avg_bi(l0, l1, bitdepth)


def _make_ctx(predictor, cu, comp, ref_pic):
    cx, cy = cu.pos(comp)
    w, h = cu.size(comp)
    return McContext(ref_pic, comp, cx, cy, w, h, predictor.bitdepth,
                     predictor.restr)


def _mc_ref_list(predictor, cu, comp, ref_list, post_filter,
                 short_out=False):
    """(ref: inter_prediction.cc:1011-1042)"""
    restr = predictor.restr
    ref_idx = cu.ref_idx[ref_list]
    rpl = cu.pic.ref_pic_lists
    ref_pic = rpl.get_ref_pic(ref_list, ref_idx)
    ctx = _make_ctx(predictor, cu, comp, ref_pic)
    if cu.use_affine:
        mv3 = [cu.mv[ref_list][0], cu.mv[ref_list][1], cu.mv[ref_list][2]]
        return _mc_affine(predictor, cu, ctx, mv3, short_out)
    mv = mv_mod.clip_mv(cu, ref_pic, cu.mv[ref_list][0])
    pel_x, pel_y, frac_x, frac_y = get_fullpel_ref(cu, comp, ref_pic,
                                                   mv[0], mv[1], restr)
    cx, cy = cu.pos(comp)
    if short_out:
        return mc_unipred_short(ctx, cx + pel_x, cy + pel_y, frac_x, frac_y)
    pred = mc_unipred_sample(ctx, cx + pel_x, cy + pel_y, frac_x, frac_y)
    if post_filter and cu.use_lic:
        pred = local_illumination_comp(predictor, cu, comp, mv[0], mv[1],
                                       ref_pic, pred)
    return pred


def affine_subblock_jobs(cu, ctx, mv3):
    """Affine MC traversal as a job list (ref: inter_prediction.cc:
    1044-1136).  Returns either ("uniform", clipped_mv0) when all corner
    MVs collapse, or ("subblocks", sw, sh, jobs) with jobs =
    [(x0, y0, frac_x, frac_y, dst_x, dst_y), ...] in visible ref-plane
    coords.  Shared by the host executor and the batched device path."""
    AFFINE_PREC = 8
    comp = ctx.comp
    ref_pic = ctx.ref_pic
    width, height = ctx.width, ctx.height
    mv_shift_x = mv_mod.MV_PRECISION_SHIFT + ref_pic.shift_x[comp]
    mv_shift_y = mv_mod.MV_PRECISION_SHIFT + ref_pic.shift_y[comp]
    mv_scale = mv_mod.MV_SCALE
    mv = [mv_mod.clip_mv(cu, ref_pic, m) for m in mv3]
    cx, cy = cu.pos(comp)
    if mv[0] == mv[1]:
        return ("uniform", mv[0])

    def get_subblock_size(ref, mv_uni, size, scale):
        MIN_SUBBLOCK = 4
        SIZE_SHIFT = 6 - mv_mod.MV_PRECISION_SHIFT
        max_len = max(abs(mv_uni[0] - ref[0]), abs(mv_uni[1] - ref[1]))
        if not max_len:
            return size
        subblock_size = max(1, (size >> SIZE_SHIFT) // max_len)
        while size % subblock_size:
            subblock_size -= 1
        return max(MIN_SUBBLOCK, subblock_size) >> scale

    # note: subblock size derived on the *component* size like the
    # reference (width/height already scaled for chroma)
    subblock_width = get_subblock_size(mv[0], mv[1], width,
                                       ref_pic.shift_x[comp])
    subblock_height = get_subblock_size(mv[0], mv[2], height,
                                        ref_pic.shift_y[comp])
    luma_w = cu.pic.width
    luma_h = cu.pic.height
    mv_max_x = (luma_w - cu.pos_x + 8 - 1) * mv_scale
    mv_min_x = (-k.MAX_BLOCK_SIZE - cu.pos_x - 8 + 1) * mv_scale
    mv_max_y = (luma_h - cu.pos_y + 8 - 1) * mv_scale
    mv_min_y = (-k.MAX_BLOCK_SIZE - cu.pos_y - 8 + 1) * mv_scale
    delta_hor_x = _trunc_div((mv[1][0] - mv[0][0]) * (1 << AFFINE_PREC),
                             width)
    delta_hor_y = _trunc_div((mv[1][1] - mv[0][1]) * (1 << AFFINE_PREC),
                             width)
    delta_ver_x = -delta_hor_y
    delta_ver_y = delta_hor_x
    hor_x = mv[0][0] * (1 << AFFINE_PREC)
    hor_y = mv[0][1] * (1 << AFFINE_PREC)
    ver_x, ver_y = hor_x, hor_y

    jobs = []
    for sub_y in range(0, height, subblock_height):
        for sub_x in range(0, width, subblock_width):
            mv_x = min(max((hor_x + delta_hor_x * (subblock_width >> 1) +
                            delta_ver_x * (subblock_height >> 1)) >>
                           AFFINE_PREC, mv_min_x), mv_max_x)
            mv_y = min(max((hor_y + delta_hor_y * (subblock_width >> 1) +
                            delta_ver_y * (subblock_height >> 1)) >>
                           AFFINE_PREC, mv_min_y), mv_max_y)
            # NOTE: the reference affine loop indexes the filter phase
            # directly with the masked mv bits (no chroma-subpel or
            # precision-restriction adjustment) — mirror that exactly.
            mv_full_x = mv_x >> mv_shift_x
            mv_full_y = mv_y >> mv_shift_y
            frac_x = mv_x & ((1 << mv_shift_x) - 1)
            frac_y = mv_y & ((1 << mv_shift_y) - 1)
            x0 = cx + sub_x + mv_full_x
            y0 = cy + sub_y + mv_full_y
            jobs.append((x0, y0, frac_x, frac_y, sub_x, sub_y))
            hor_x += delta_hor_x * subblock_width
            hor_y += delta_hor_y * subblock_width
        ver_x += delta_ver_x * subblock_height
        ver_y += delta_ver_y * subblock_height
        hor_x, hor_y = ver_x, ver_y
    return ("subblocks", subblock_width, subblock_height, jobs)


def _mc_affine(predictor, cu, ctx, mv3, short_out):
    """(ref: inter_prediction.cc:1044-1136)"""
    plan = affine_subblock_jobs(cu, ctx, mv3)
    cx, cy = cu.pos(ctx.comp)
    if plan[0] == "uniform":
        mv = plan[1]
        pel_x, pel_y, frac_x, frac_y = get_fullpel_ref(
            cu, ctx.comp, ctx.ref_pic, mv[0], mv[1], ctx.restr)
        if short_out:
            return mc_unipred_short(ctx, cx + pel_x, cy + pel_y,
                                    frac_x, frac_y)
        return mc_unipred_sample(ctx, cx + pel_x, cy + pel_y, frac_x, frac_y)
    _, sw, sh, jobs = plan
    dtype = np.int16 if short_out else np.int32
    out = np.zeros((ctx.height, ctx.width), dtype=dtype)
    sub_ctx = McContext(ctx.ref_pic, ctx.comp, 0, 0, sw, sh,
                        ctx.bitdepth, ctx.restr)
    for (x0, y0, frac_x, frac_y, sub_x, sub_y) in jobs:
        if short_out:
            blk = mc_unipred_short(sub_ctx, x0, y0, frac_x, frac_y)
        else:
            blk = mc_unipred_sample(sub_ctx, x0, y0, frac_x, frac_y)
        out[sub_y:sub_y + sh, sub_x:sub_x + sw] = blk
    return out


def _trunc_div(a, b):
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def local_illumination_comp(predictor, cu, comp, mv_x, mv_y, ref_pic, pred):
    """(ref: inter_prediction.cc:1599-1650 + LocalIlluminationComp)"""
    shift_x = mv_mod.MV_PRECISION_SHIFT + ref_pic.shift_x[comp]
    shift_y = mv_mod.MV_PRECISION_SHIFT + ref_pic.shift_y[comp]
    max_val = (1 << predictor.bitdepth) - 1
    mv_fullpel = ((mv_x + (1 << (shift_x - 1))) >> shift_x,
                  (mv_y + (1 << (shift_y - 1))) >> shift_y)
    scale, offset, shift = derive_lic_params(predictor, cu, comp, mv_fullpel,
                                             ref_pic)
    out = ((scale * pred.astype(np.int64)) >> shift) + offset
    return np.clip(out, 0, max_val).astype(np.int32)


def derive_lic_params(predictor, cu, comp, mv_full, ref_pic):
    """Returns (scale, offset, shift=5)
    (ref: inter_prediction.cc DeriveLicParams)"""
    MODEL_QUANT_SHIFT = 15
    DEFAULT_SCALE_SHIFT = 5
    MODEL_MIN_RES_SHIFT = 6
    MODEL_PRECISION_SHIFT = 7
    bitdepth = predictor.bitdepth

    def get_msb(x):
        return x.bit_length()

    width, height = cu.size(comp)
    cu_above = cu.get_cu_above()
    cu_left = cu.get_cu_left()
    step_size = 2 if min(width, height) > 8 else 1
    cx, cy = cu.pos(comp)
    rec_plane = predictor.rec_pic.plane_view(comp)
    ref_plane = ref_pic.padded_plane(comp)
    rpx, rpy = ref_pic.pad_x[comp], ref_pic.pad_y[comp]
    sum_x = sum_y = sum_xx = sum_xy = 0
    nbr = 0
    if cu_above is None and cu_left is None:
        return 1 << DEFAULT_SCALE_SHIFT, 0, DEFAULT_SCALE_SHIFT
    if cu_above is not None:
        mvc = mv_mod.clip_mv(cu_above, ref_pic,
                             (mv_full[0] << mv_mod.MV_PRECISION_SHIFT,
                              mv_full[1] << mv_mod.MV_PRECISION_SHIFT))
        mvc = (mvc[0] >> mv_mod.MV_PRECISION_SHIFT,
               mvc[1] >> mv_mod.MV_PRECISION_SHIFT)
        dx = step_size * max(1, width // height)
        for x in range(0, width, dx):
            a = int(ref_plane[rpy + cy + mvc[1] - 1, rpx + cx + mvc[0] + x])
            b = int(rec_plane[cy - 1, cx + x])
            sum_x += a
            sum_y += b
            sum_xx += a * a
            sum_xy += a * b
            nbr += 1
    if cu_left is not None:
        mvc = mv_mod.clip_mv(cu_left, ref_pic,
                             (mv_full[0] << mv_mod.MV_PRECISION_SHIFT,
                              mv_full[1] << mv_mod.MV_PRECISION_SHIFT))
        mvc = (mvc[0] >> mv_mod.MV_PRECISION_SHIFT,
               mvc[1] >> mv_mod.MV_PRECISION_SHIFT)
        dy = step_size * max(1, height // width)
        for y in range(0, height, dy):
            a = int(ref_plane[rpy + cy + mvc[1] + y, rpx + cx + mvc[0] - 1])
            b = int(rec_plane[cy + y, cx - 1])
            sum_x += a
            sum_y += b
            sum_xx += a * a
            sum_xy += a * b
            nbr += 1
    size_shift = max(1, (nbr - 1).bit_length())
    base_shift = max(0, bitdepth + size_shift - MODEL_QUANT_SHIFT)
    avg_x = sum_x >> base_shift
    avg_y = sum_y >> base_shift
    xx_offset = sum_xx >> MODEL_PRECISION_SHIFT
    avg_xy = ((sum_xy + xx_offset) >> (2 * base_shift)) << size_shift
    avg_xx = ((sum_xx + xx_offset) >> (2 * base_shift)) << size_shift
    stddev_xy = avg_xy - avg_x * avg_y
    stddev_xx = avg_xx - avg_x * avg_x
    shift_xx_quant = max(0, get_msb(abs(stddev_xx)) - MODEL_MIN_RES_SHIFT)
    shift_xy = max(0, shift_xx_quant - 12)
    total_shift = MODEL_QUANT_SHIFT - DEFAULT_SCALE_SHIFT + \
        shift_xx_quant - shift_xy
    stddev_xy_shifted = stddev_xy >> shift_xy
    stddev_xx_shifted = min(max(stddev_xx >> shift_xx_quant, 0),
                            (1 << MODEL_MIN_RES_SHIFT) - 1)
    if stddev_xx_shifted == 0:
        return 1 << DEFAULT_SCALE_SHIFT, 0, DEFAULT_SCALE_SHIFT
    stddev_xx_scaled = ((1 << MODEL_QUANT_SHIFT) +
                        (stddev_xx_shifted // 2)) // stddev_xx_shifted
    scale = (stddev_xy_shifted * stddev_xx_scaled) >> total_shift
    scale = min(max(scale, 0), 1 << (DEFAULT_SCALE_SHIFT + 2))
    offset = (sum_y - ((scale * sum_x) >> DEFAULT_SCALE_SHIFT) +
              (1 << (size_shift - 1))) >> size_shift
    offset = min(max(offset, -(1 << (bitdepth - 1))),
                 (1 << (bitdepth - 1)) - 1)
    return scale, offset, DEFAULT_SCALE_SHIFT
