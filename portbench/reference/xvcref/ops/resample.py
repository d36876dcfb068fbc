"""Picture resampling (windowed-sinc + bilinear), exact integer.

Behavioral equivalent of the reference resampler core
(ref: src/xvc_common_lib/resample.cc:569-950, resample::Resample /
resample::BilinearResample).  Used for decoder output rescaling and
chroma-format conversion, encoder input rescaling, and cross-segment
reference rescaling (decoder scalability).  Expressed as batched
integer gathers + tap products over whole planes — the same formulation
the TPU kernel uses (vectorized over all output positions at once).
"""
import numpy as np

FILTER_PRECISION = 6
POSITION_PRECISION = 15
SCALE_FACTOR = 1 << POSITION_PRECISION
INTERNAL_PRECISION = 16

# Upsampling 8-tap filters, 16 phases (ref: resample.cc kUpsampleFilter)
UPSAMPLE_FILTER = np.array([
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

# Downsampling 12-tap windowed-sinc filters, 8 ratio classes x 16 phases
# (ref: resample.cc kDownsampleFilters)
DOWNSAMPLE_FILTERS = np.array([
    [[0, 0, 0, 0, 0, 128, 0, 0, 0, 0, 0, 0],
     [0, 0, 0, 2, -6, 127, 7, -2, 0, 0, 0, 0],
     [0, 0, 0, 3, -12, 125, 16, -5, 1, 0, 0, 0],
     [0, 0, 0, 4, -16, 120, 26, -7, 1, 0, 0, 0],
     [0, 0, 0, 5, -18, 114, 36, -10, 1, 0, 0, 0],
     [0, 0, 0, 5, -20, 107, 46, -12, 2, 0, 0, 0],
     [0, 0, 0, 5, -21, 99, 57, -15, 3, 0, 0, 0],
     [0, 0, 0, 5, -20, 89, 68, -18, 4, 0, 0, 0],
     [0, 0, 0, 4, -19, 79, 79, -19, 4, 0, 0, 0],
     [0, 0, 0, 4, -18, 68, 89, -20, 5, 0, 0, 0],
     [0, 0, 0, 3, -15, 57, 99, -21, 5, 0, 0, 0],
     [0, 0, 0, 2, -12, 46, 107, -20, 5, 0, 0, 0],
     [0, 0, 0, 1, -10, 36, 114, -18, 5, 0, 0, 0],
     [0, 0, 0, 1, -7, 26, 120, -16, 4, 0, 0, 0],
     [0, 0, 0, 1, -5, 16, 125, -12, 3, 0, 0, 0],
     [0, 0, 0, 0, -2, 7, 127, -6, 2, 0, 0, 0]],
    [[0, 2, 0, -14, 33, 86, 33, -14, 0, 2, 0, 0],
     [0, 1, 1, -14, 29, 85, 38, -13, -1, 2, 0, 0],
     [0, 1, 2, -14, 24, 84, 43, -12, -2, 2, 0, 0],
     [0, 1, 2, -13, 19, 83, 48, -11, -3, 2, 0, 0],
     [0, 0, 3, -13, 15, 81, 53, -10, -4, 3, 0, 0],
     [0, 0, 3, -12, 11, 79, 57, -8, -5, 3, 0, 0],
     [0, 0, 3, -11, 7, 76, 62, -5, -7, 3, 0, 0],
     [0, 0, 3, -10, 3, 73, 65, -2, -7, 3, 0, 0],
     [0, 0, 3, -9, 0, 70, 70, 0, -9, 3, 0, 0],
     [0, 0, 3, -7, -2, 65, 73, 3, -10, 3, 0, 0],
     [0, 0, 3, -7, -5, 62, 76, 7, -11, 3, 0, 0],
     [0, 0, 3, -5, -8, 57, 79, 11, -12, 3, 0, 0],
     [0, 0, 3, -4, -10, 53, 81, 15, -13, 3, 0, 0],
     [0, 0, 2, -3, -11, 48, 83, 19, -13, 2, 1, 0],
     [0, 0, 2, -2, -12, 43, 84, 24, -14, 2, 1, 0],
     [0, 0, 2, -1, -13, 38, 85, 29, -14, 1, 1, 0]],
    [[0, 5, -6, -10, 37, 76, 37, -10, -6, 5, 0, 0],
     [0, 5, -4, -11, 33, 76, 40, -9, -7, 5, 0, 0],
     [-1, 5, -3, -12, 29, 75, 45, -7, -8, 5, 0, 0],
     [-1, 4, -2, -13, 25, 75, 48, -5, -9, 5, 1, 0],
     [-1, 4, -1, -13, 22, 73, 52, -3, -10, 4, 1, 0],
     [-1, 4, 0, -13, 18, 72, 55, -1, -11, 4, 2, -1],
     [-1, 4, 1, -13, 14, 70, 59, 2, -12, 3, 2, -1],
     [-1, 3, 1, -13, 11, 68, 62, 5, -12, 3, 2, -1],
     [-1, 3, 2, -13, 8, 65, 65, 8, -13, 2, 3, -1],
     [-1, 2, 3, -12, 5, 62, 68, 11, -13, 1, 3, -1],
     [-1, 2, 3, -12, 2, 59, 70, 14, -13, 1, 4, -1],
     [-1, 2, 4, -11, -1, 55, 72, 18, -13, 0, 4, -1],
     [0, 1, 4, -10, -3, 52, 73, 22, -13, -1, 4, -1],
     [0, 1, 5, -9, -5, 48, 75, 25, -13, -2, 4, -1],
     [0, 0, 5, -8, -7, 45, 75, 29, -12, -3, 5, -1],
     [0, 0, 5, -7, -9, 40, 76, 33, -11, -4, 5, 0]],
    [[2, -3, -9, 6, 39, 58, 39, 6, -9, -3, 2, 0],
     [2, -3, -9, 4, 38, 58, 43, 7, -9, -4, 1, 0],
     [2, -2, -9, 2, 35, 58, 44, 9, -8, -4, 1, 0],
     [1, -2, -9, 1, 34, 58, 46, 11, -8, -5, 1, 0],
     [1, -1, -8, -1, 31, 57, 47, 13, -7, -5, 1, 0],
     [1, -1, -8, -2, 29, 56, 49, 15, -7, -6, 1, 1],
     [1, 0, -8, -3, 26, 55, 51, 17, -7, -6, 1, 1],
     [1, 0, -7, -4, 24, 54, 52, 19, -6, -7, 1, 1],
     [1, 0, -7, -5, 22, 53, 53, 22, -5, -7, 0, 1],
     [1, 1, -7, -6, 19, 52, 54, 24, -4, -7, 0, 1],
     [1, 1, -6, -7, 17, 51, 55, 26, -3, -8, 0, 1],
     [1, 1, -6, -7, 15, 49, 56, 29, -2, -8, -1, 1],
     [0, 1, -5, -7, 13, 47, 57, 31, -1, -8, -1, 1],
     [0, 1, -5, -8, 11, 46, 58, 34, 1, -9, -2, 1],
     [0, 1, -4, -8, 9, 44, 58, 35, 2, -9, -2, 2],
     [0, 1, -4, -9, 7, 43, 58, 38, 4, -9, -3, 2]],
    [[-2, -7, 0, 17, 35, 43, 35, 17, 0, -7, -5, 2],
     [-2, -7, -1, 16, 34, 43, 36, 18, 1, -7, -5, 2],
     [-1, -7, -1, 14, 33, 43, 36, 19, 1, -6, -5, 2],
     [-1, -7, -2, 13, 32, 42, 37, 20, 3, -6, -5, 2],
     [0, -7, -3, 12, 31, 42, 38, 21, 3, -6, -5, 2],
     [0, -7, -3, 11, 30, 42, 39, 23, 4, -6, -6, 1],
     [0, -7, -4, 10, 29, 42, 40, 24, 5, -6, -6, 1],
     [1, -7, -4, 9, 27, 41, 40, 25, 6, -5, -6, 1],
     [1, -6, -5, 7, 26, 41, 41, 26, 7, -5, -6, 1],
     [1, -6, -5, 6, 25, 40, 41, 27, 9, -4, -7, 1],
     [1, -6, -6, 5, 24, 40, 42, 29, 10, -4, -7, 0],
     [1, -6, -6, 4, 23, 39, 42, 30, 11, -3, -7, 0],
     [2, -5, -6, 3, 21, 38, 42, 31, 12, -3, -7, 0],
     [2, -5, -6, 3, 20, 37, 42, 32, 13, -2, -7, -1],
     [2, -5, -6, 1, 19, 36, 43, 33, 14, -1, -7, -1],
     [2, -5, -7, 1, 18, 36, 43, 34, 16, -1, -7, -2]],
    [[-6, -3, 5, 19, 31, 36, 31, 19, 5, -3, -6, 0],
     [-6, -4, 4, 18, 31, 37, 32, 20, 6, -3, -6, -1],
     [-6, -4, 4, 17, 30, 36, 33, 21, 7, -3, -6, -1],
     [-5, -5, 3, 16, 30, 36, 33, 22, 8, -2, -6, -2],
     [-5, -5, 2, 15, 29, 36, 34, 23, 9, -2, -6, -2],
     [-5, -5, 2, 15, 28, 36, 34, 24, 10, -2, -6, -3],
     [-4, -5, 1, 14, 27, 36, 35, 24, 10, -1, -6, -3],
     [-4, -5, 0, 13, 26, 35, 35, 25, 11, 0, -5, -3],
     [-4, -6, 0, 12, 26, 36, 36, 26, 12, 0, -6, -4],
     [-3, -5, 0, 11, 25, 35, 35, 26, 13, 0, -5, -4],
     [-3, -6, -1, 10, 24, 35, 36, 27, 14, 1, -5, -4],
     [-3, -6, -2, 10, 24, 34, 36, 28, 15, 2, -5, -5],
     [-2, -6, -2, 9, 23, 34, 36, 29, 15, 2, -5, -5],
     [-2, -6, -2, 8, 22, 33, 36, 30, 16, 3, -5, -5],
     [-1, -6, -3, 7, 21, 33, 36, 30, 17, 4, -4, -6],
     [-1, -6, -3, 6, 20, 32, 37, 31, 18, 4, -4, -6]],
    [[-9, 0, 9, 20, 28, 32, 28, 20, 9, 0, -9, 0],
     [-9, 0, 8, 19, 28, 32, 29, 20, 10, 0, -4, -5],
     [-9, -1, 8, 18, 28, 32, 29, 21, 10, 1, -4, -5],
     [-9, -1, 7, 18, 27, 32, 30, 22, 11, 1, -4, -6],
     [-8, -2, 6, 17, 27, 32, 30, 22, 12, 2, -4, -6],
     [-8, -2, 6, 16, 26, 32, 31, 23, 12, 2, -4, -6],
     [-8, -2, 5, 16, 26, 31, 31, 23, 13, 3, -3, -7],
     [-8, -3, 5, 15, 25, 31, 31, 24, 14, 4, -3, -7],
     [-7, -3, 4, 14, 25, 31, 31, 25, 14, 4, -3, -7],
     [-7, -3, 4, 14, 24, 31, 31, 25, 15, 5, -3, -8],
     [-7, -3, 3, 13, 23, 31, 31, 26, 16, 5, -2, -8],
     [-6, -4, 2, 12, 23, 31, 32, 26, 16, 6, -2, -8],
     [-6, -4, 2, 12, 22, 30, 32, 27, 17, 6, -2, -8],
     [-6, -4, 1, 11, 22, 30, 32, 27, 18, 7, -1, -9],
     [-5, -4, 1, 10, 21, 29, 32, 28, 18, 8, -1, -9],
     [-5, -4, 0, 10, 20, 29, 32, 28, 19, 8, 0, -9]],
    [[-8, 7, 13, 18, 22, 24, 22, 18, 13, 7, 2, -10],
     [-8, 7, 13, 18, 22, 23, 22, 19, 13, 7, 2, -10],
     [-8, 6, 12, 18, 22, 23, 22, 19, 14, 8, 2, -10],
     [-9, 6, 12, 17, 22, 23, 23, 19, 14, 8, 3, -10],
     [-9, 6, 12, 17, 21, 23, 23, 19, 14, 9, 3, -10],
     [-9, 5, 11, 17, 21, 23, 23, 20, 15, 9, 3, -10],
     [-9, 5, 11, 16, 21, 23, 23, 20, 15, 9, 4, -10],
     [-9, 5, 10, 16, 21, 23, 23, 20, 15, 10, 4, -10],
     [-10, 5, 10, 16, 20, 23, 23, 20, 16, 10, 5, -10],
     [-10, 4, 10, 15, 20, 23, 23, 21, 16, 10, 5, -9],
     [-10, 4, 9, 15, 20, 23, 23, 21, 16, 11, 5, -9],
     [-10, 3, 9, 15, 20, 23, 23, 21, 17, 11, 5, -9],
     [-10, 3, 9, 14, 19, 23, 23, 21, 17, 12, 6, -9],
     [-10, 3, 8, 14, 19, 23, 23, 22, 17, 12, 6, -9],
     [-10, 2, 8, 14, 19, 22, 23, 22, 18, 12, 6, -8],
     [-10, 2, 7, 13, 19, 22, 23, 22, 18, 13, 7, -8]],
], dtype=np.int64)


def get_filter_from_scale(scale):
    """(ref: resample.cc:741-759)"""
    if scale > 15 * SCALE_FACTOR // 4:
        return 7
    if scale > 20 * SCALE_FACTOR // 7:
        return 6
    if scale > 5 * SCALE_FACTOR // 2:
        return 5
    if scale > 2 * SCALE_FACTOR:
        return 4
    if scale > 5 * SCALE_FACTOR // 3:
        return 3
    if scale > 5 * SCALE_FACTOR // 4:
        return 2
    if scale > 20 * SCALE_FACTOR // 19:
        return 1
    return 0


def _axis_taps(scale, out_size):
    """Per-output-position (taps, sample offsets) for one axis.

    Returns (offsets (t,), taps (out_size, t), post_shift)."""
    pos = (np.arange(out_size, dtype=np.int64) * scale) >> \
        (POSITION_PRECISION - 4)
    sub_pel = pos & 15
    full_pel = pos >> 4
    if scale < SCALE_FACTOR:
        offsets = np.arange(-3, 5, dtype=np.int64)
        taps = UPSAMPLE_FILTER[sub_pel]
        post = 0
    elif scale == SCALE_FACTOR:
        offsets = np.arange(0, 1, dtype=np.int64)
        taps = np.full((out_size, 1), 64, dtype=np.int64)
        post = 0
    else:
        offsets = np.arange(-5, 7, dtype=np.int64)
        taps = DOWNSAMPLE_FILTERS[get_filter_from_scale(scale)][sub_pel]
        post = 1
    return full_pel, offsets, taps, post


def resample(padded_src, origin_y, origin_x, src_width, src_height,
             src_bitdepth, dst_width, dst_height, dst_bitdepth):
    """Exact mirror of resample::Resample (ref: resample.cc:786-852).

    padded_src: 2-D int array with at least 8 rows/cols of valid data
    around the (origin_y, origin_x, src_width, src_height) window (the
    reference reads tmp_pad=8 rows beyond the picture plus filter taps,
    supplied by the YuvPicture border padding).  Returns (dst_height,
    dst_width) int32.
    """
    tmp_pad = 8
    scale_x = ((src_width << POSITION_PRECISION) + (dst_width >> 1)) \
        // dst_width
    shift_hor = max(src_bitdepth - (INTERNAL_PRECISION - FILTER_PRECISION), 0)

    full_x, off_x, taps_x, post_x = _axis_taps(scale_x, dst_width)
    # horizontal pass over rows [-tmp_pad, src_height + tmp_pad)
    rows = np.arange(-tmp_pad, src_height + tmp_pad, dtype=np.int64) + \
        origin_y
    cols = full_x[None, :] + off_x[:, None] + origin_x      # (t, dst_w)
    src64 = padded_src.astype(np.int64)
    gathered = src64[rows[:, None, None], cols[None, :, :]]  # (r, t, dst_w)
    tmp = np.einsum("rtj,jt->rj", gathered, taps_x)
    if post_x:
        tmp >>= 1
    tmp = np.clip(tmp >> shift_hor, 0, 65535)                # FilterHor clip

    scale_y = ((src_height << POSITION_PRECISION) + (dst_height >> 1)) \
        // dst_height
    shift_ver = 2 * FILTER_PRECISION - shift_hor + src_bitdepth - dst_bitdepth
    maxv = (1 << dst_bitdepth) - 1

    full_y, off_y, taps_y, post_y = _axis_taps(scale_y, dst_height)
    rows2 = full_y[None, :] + off_y[:, None] + tmp_pad       # (t, dst_h)
    gathered2 = tmp[rows2]                                   # (t, dst_h, w)
    out = np.einsum("tiw,it->iw", gathered2, taps_y)
    if post_y:
        out >>= 1
    return np.clip(out >> shift_ver, 0, maxv).astype(np.int32)


def _shr(v, n):
    """Arithmetic shift by a possibly-negative count."""
    return v >> n if n >= 0 else v << (-n)


def bilinear_resample(window, src_height, src_width, src_bitdepth,
                      dst_bitdepth):
    """Exact 2x bilinear upsample (ref: resample.cc:855-900).

    window: 2-D int array of at least (src_height+1, src_width+1) whose
    extra row/column carries the neighboring (padded or coded) samples,
    exactly like the reference reading past the display edge of the
    padded plane.  Returns (2*h, 2*w) int32.
    """
    h, w = src_height, src_width
    s = np.asarray(window).astype(np.int64)
    a = s[:h, :w]
    b = s[:h, 1:w + 1]
    c = s[1:h + 1, :w]
    d = s[1:h + 1, 1:w + 1]
    out = np.zeros((2 * h, 2 * w), dtype=np.int64)
    shift = dst_bitdepth - src_bitdepth
    if shift > 1:
        out[0::2, 0::2] = a << shift
        out[0::2, 1::2] = (a + b) << (shift - 1)
        out[1::2, 0::2] = (a + c) << (shift - 1)
        out[1::2, 1::2] = (a + b + c + d + 2) << (shift - 2)
    else:
        shift = -shift
        out[0::2, 0::2] = _shr(a, shift)
        out[0::2, 1::2] = _shr(a + b, shift + 1)
        out[1::2, 0::2] = _shr(a + c, shift + 1)
        out[1::2, 1::2] = _shr(a + b + c + d + 2, shift + 2)
    return out.astype(np.int32)


def resample_pic_plane(dst_pic, comp, src_pic):
    """Rescale one plane of src_pic into dst_pic's plane (same chroma
    format) over the full *internal* areas, used for cross-segment
    reference rescaling (ref: picture_decoder.cc:242-293
    GenerateAlternativeRecPic, which passes GetWidth/GetHeight)."""
    dst = dst_pic.plane_view(comp)
    if dst_pic.width[comp] == src_pic.width[comp] and \
            dst_pic.height[comp] == src_pic.height[comp]:
        # Same size: the sinc pass degenerates to plain shifts
        # (truncating on downshift), reproduced directly.
        shift = dst_pic.bitdepth - src_pic.bitdepth
        src = src_pic.plane_view(comp)
        if shift >= 0:
            dst[:, :] = src << shift
        else:
            dst[:, :] = src >> (-shift)
        return
    out = resample(src_pic.padded_plane(comp), src_pic.pad_y[comp],
                   src_pic.pad_x[comp], src_pic.width[comp],
                   src_pic.height[comp], src_pic.bitdepth,
                   dst_pic.width[comp], dst_pic.height[comp],
                   dst_pic.bitdepth)
    dst[:, :] = out


# Backwards-compatible helper used by older call sites.
