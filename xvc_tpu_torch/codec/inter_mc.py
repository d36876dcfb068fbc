"""Motion compensation: sub-pel interpolation tables, and the host MC
of the replay path's sequential tail and of the Python CU encoder's
motion search (bi-pred, affine, LIC).

Behavioral equivalent of the reference MC path
(ref: src/xvc_common_lib/inter_prediction.cc:710-1378,1387-1650).  Copy
of ``xvc_tpu/codec/inter_mc.py`` without MV derivation (the native parse
resolves every MV) and without the numpy twins of the interpolation: the
block filter is the port's native ``xvcn_mc_unipred``, as in the JAX
package.  The decode's other inter blocks are predicted on the device
(``gpu/mc.py``, ``kernels/csrc/mc.cu``); this host MC serves the LIC
leaves, whose prediction reads reconstructed neighbours, and the RD costs
of the Python CU encoder's inter search (``inter_me.py``), whose MC must
equal the JAX package's bit for bit (the same native filter).
"""
import numpy as np

from .. import constants as k
from .. import native
from . import inter_mv as mv_mod

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


class InterPredictor:
    """Inter prediction on the host: the picture, its reconstruction and
    the restrictions the MC reads (``motion_compensation``'s
    ``predictor``); the replay tail's, and the base of the encoder's
    ``inter_me.InterSearch``."""

    def __init__(self, pic_data, rec_pic, bitdepth, restrictions):
        self.pic = pic_data
        self.rec_pic = rec_pic
        self.bitdepth = bitdepth
        self.restr = restrictions


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


def _mc_native(ctx, x0, y0, frac_x, frac_y, mode):
    """mode 0: final samples (uni-pred); 1: 14-bit intermediates."""
    plane = ctx.ref_pic.padded_plane(ctx.comp)
    stride = plane.shape[1]
    base = plane.ctypes.data + \
        4 * (ctx.ref_pic.pad_y[ctx.comp] * stride +
             ctx.ref_pic.pad_x[ctx.comp])
    out = np.empty((ctx.height, ctx.width), dtype=np.int32)
    native.lib().xvcn_mc_unipred(
        mode, base, stride, x0, y0, ctx.width, ctx.height, frac_x, frac_y,
        ctx.bitdepth, 1 if ctx.comp == 0 else 0,
        0 if ctx.restr.disable_ext2_inter_high_precision_mv else 1,
        out.ctypes.data, ctx.width)
    return out


def mc_unipred_sample(ctx, x0, y0, frac_x, frac_y):
    """Sub-pel MC producing final samples (uni-pred path)."""
    return _mc_native(ctx, x0, y0, frac_x, frac_y, 0)


def mc_unipred_short(ctx, x0, y0, frac_x, frac_y):
    """Sub-pel MC producing 14-bit intermediates (bi-pred path)."""
    return _mc_native(ctx, x0, y0, frac_x, frac_y, 1).astype(np.int16)


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


def motion_compensation_mv(predictor, cu, comp, ref_pic, mv, post_filter):
    """MC for an explicit (non-stored) MV (ref: MotionCompensationMv)."""
    mv = mv_mod.clip_mv(cu, ref_pic, mv)
    pel_x, pel_y, frac_x, frac_y = get_fullpel_ref(cu, comp, ref_pic,
                                                   mv[0], mv[1],
                                                   predictor.restr)
    ctx = _make_ctx(predictor, cu, comp, ref_pic)
    cx, cy = cu.pos(comp)
    pred = mc_unipred_sample(ctx, cx + pel_x, cy + pel_y, frac_x, frac_y)
    if post_filter and cu.use_lic:
        pred = local_illumination_comp(predictor, cu, comp, mv[0], mv[1],
                                       ref_pic, pred)
    return pred


def motion_compensation_mv3(predictor, cu, comp, ref_pic, mv3, post_filter):
    """Affine MC for three explicit corner MVs."""
    ctx = _make_ctx(predictor, cu, comp, ref_pic)
    return _mc_affine(cu, ctx, list(mv3), False)


def motion_compensation(predictor, cu, comp):
    """(ref: inter_prediction.cc:710-738)"""
    rpl = cu.pic.ref_pic_lists
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
    return add_avg_bi(l0, l1, predictor.bitdepth)


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
        return _mc_affine(cu, ctx, mv3, short_out)
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


def affine_subblocks(mv, posx, posy, width, height, scale_x, scale_y,
                     luma_w, luma_h):
    """Subblock jobs (x0, y0, frac_x, frac_y, dst_x, dst_y) of an affine
    CU in component coordinates (visible ref-plane coords), with the
    subblock width and height, from its three clipped corner MVs, its
    luma position, its component size, the component's chroma shifts and
    the picture's luma size (ref: inter_prediction.cc:1044-1136).  The
    host tail's MC and the plain version of the MC kernel
    (``gpu/mc.py`` ``mc_jobs``) both use it."""
    AFFINE_PREC = 8
    sh = mv_mod.MV_PRECISION_SHIFT
    mv_scale = mv_mod.MV_SCALE
    mv_shift_x, mv_shift_y = sh + scale_x, sh + scale_y

    def get_subblock_size(ref, mv_uni, size, scale):
        MIN_SUBBLOCK = 4
        SIZE_SHIFT = 6 - sh
        max_len = max(abs(mv_uni[0] - ref[0]), abs(mv_uni[1] - ref[1]))
        if not max_len:
            return size
        sub = max(1, (size >> SIZE_SHIFT) // max_len)
        while size % sub:
            sub -= 1
        return max(MIN_SUBBLOCK, sub) >> scale

    # the subblock size is derived on the *component* size like the
    # reference (width/height already scaled for chroma)
    sw = get_subblock_size(mv[0], mv[1], width, scale_x)
    shh = get_subblock_size(mv[0], mv[2], height, scale_y)
    mv_max_x = (luma_w - posx + 8 - 1) * mv_scale
    mv_min_x = (-k.MAX_BLOCK_SIZE - posx - 8 + 1) * mv_scale
    mv_max_y = (luma_h - posy + 8 - 1) * mv_scale
    mv_min_y = (-k.MAX_BLOCK_SIZE - posy - 8 + 1) * mv_scale
    delta_hor_x = _trunc_div((mv[1][0] - mv[0][0]) * (1 << AFFINE_PREC),
                             width)
    delta_hor_y = _trunc_div((mv[1][1] - mv[0][1]) * (1 << AFFINE_PREC),
                             width)
    delta_ver_x, delta_ver_y = -delta_hor_y, delta_hor_x
    hor_x = mv[0][0] * (1 << AFFINE_PREC)
    hor_y = mv[0][1] * (1 << AFFINE_PREC)
    ver_x, ver_y = hor_x, hor_y
    ccx, ccy = posx >> scale_x, posy >> scale_y
    jobs = []
    for sub_y in range(0, height, shh):
        for sub_x in range(0, width, sw):
            mv_x = min(max((hor_x + delta_hor_x * (sw >> 1) +
                            delta_ver_x * (shh >> 1)) >> AFFINE_PREC,
                           mv_min_x), mv_max_x)
            mv_y = min(max((hor_y + delta_hor_y * (sw >> 1) +
                            delta_ver_y * (shh >> 1)) >> AFFINE_PREC,
                           mv_min_y), mv_max_y)
            # the reference affine loop indexes the filter phase directly
            # with the masked mv bits (no chroma-subpel or precision
            # adjustment): mirrored exactly
            jobs.append((ccx + sub_x + (mv_x >> mv_shift_x),
                         ccy + sub_y + (mv_y >> mv_shift_y),
                         mv_x & ((1 << mv_shift_x) - 1),
                         mv_y & ((1 << mv_shift_y) - 1), sub_x, sub_y))
            hor_x += delta_hor_x * sw
            hor_y += delta_hor_y * sw
        ver_x += delta_ver_x * shh
        ver_y += delta_ver_y * shh
        hor_x, hor_y = ver_x, ver_y
    return jobs, sw, shh


def affine_subblock_jobs(cu, ctx, mv3):
    """Affine MC traversal as a job list (ref: inter_prediction.cc:
    1044-1136).  Returns either ("uniform", clipped_mv0) when all corner
    MVs collapse, or ("subblocks", sw, sh, jobs) with the jobs of
    ``affine_subblocks``."""
    mv = [mv_mod.clip_mv(cu, ctx.ref_pic, m) for m in mv3]
    if mv[0] == mv[1]:
        return ("uniform", mv[0])
    jobs, sw, sh = affine_subblocks(
        mv, cu.pos_x, cu.pos_y, ctx.width, ctx.height,
        ctx.ref_pic.shift_x[ctx.comp], ctx.ref_pic.shift_y[ctx.comp],
        cu.pic.width, cu.pic.height)
    return ("subblocks", sw, sh, jobs)


def _mc_affine(cu, ctx, mv3, short_out):
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
