"""Decoded-picture output conversion (resize / chroma / bitdepth / ARGB).

Behavioral equivalent of Resampler::ConvertTo + CopyToWithResize +
ConvertColorSpace (ref: src/xvc_common_lib/resample.cc:94-458): converts
a reconstructed YuvPicture to the requested output format, resampling
with the exact windowed-sinc / bilinear kernels when the resolution or
chroma format differs.
"""
import numpy as np

from .. import constants as k
from ..ops import resample as rs

COLOR_CONVERSION_BITDEPTH = 12

# (ref: resample.cc:407-427 kM; rows = R,G,B taps on (c,d,e))
_COLOR_MATRICES = np.array([
    [[1192, 0, 1877], [1192, -223, -558], [1192, 2212, 0]],      # default
    [[1192, 0, 1671], [1192, -410, -851], [1192, 2112, 0]],      # BT.601
    [[1192, 0, 1877], [1192, -223, -558], [1192, 2212, 0]],      # BT.709
    [[1192, 0, 1758], [1192, -196, -681], [1192, 2243, 0]],      # BT.2020
], dtype=np.int64)


def _scale_size_x(size, chroma_format, comp):
    return size if comp == 0 else size >> k.chroma_shift_x(chroma_format)


def _scale_size_y(size, chroma_format, comp):
    return size if comp == 0 else size >> k.chroma_shift_y(chroma_format)


def _planes_to_bytes(planes, src_bitdepth, out_bitdepth, dither):
    """CopyToBytesWithShift over all planes (ref: resample.cc:304-338).

    One cast pass per plane directly into a single packed output buffer
    (strided int32 views cast in place by np.copyto) — the output
    serialization is decode's largest host-side cost after the native
    call itself, so no intermediate plane copies."""
    dtype = np.uint8 if out_bitdepth <= 8 else np.uint16
    buf = np.empty(sum(p.size for p in planes), dtype)
    off = 0
    for plane in planes:
        if out_bitdepth == src_bitdepth:
            data = plane
        elif out_bitdepth > src_bitdepth:
            data = plane << (out_bitdepth - src_bitdepth)
        else:
            downshift = src_bitdepth - out_bitdepth
            maxv = (1 << out_bitdepth) - 1
            if dither:
                data = _downshift_dither(plane, downshift, maxv)
            else:
                add = 1 << (downshift - 1)
                data = np.minimum((plane + add) >> downshift, maxv)
        np.copyto(buf[off:off + plane.size].reshape(plane.shape), data,
                  casting="unsafe")
        off += plane.size
    return buf.tobytes()


def _downshift_dither(view, downshift, maxv):
    """Error-feedback dithering (ref: resample.cc:511-528)."""
    h, w = view.shape
    out = np.zeros((h, w), dtype=np.int32)
    mask = (1 << downshift) - 1
    sample = 0
    for y in range(h):
        for x in range(w):
            sample += int(view[y, x])
            out[y, x] = min(sample >> downshift, maxv)
            sample &= mask
    return out


def _resize_plane(pic, comp_src, dst_width, dst_height, dst_bitdepth):
    """Sinc or bilinear resize of one source plane to dst dims."""
    src_width = pic.get_display_width(comp_src)
    src_height = pic.get_display_height(comp_src)
    if comp_src != 0 and dst_width == 2 * src_width and \
            dst_height == 2 * src_height:
        py, px = pic.pad_y[comp_src], pic.pad_x[comp_src]
        window = pic.padded_plane(comp_src)[py:py + src_height + 1,
                                            px:px + src_width + 1]
        return rs.bilinear_resample(window, src_height, src_width,
                                    pic.bitdepth, dst_bitdepth)
    return rs.resample(pic.padded_plane(comp_src), pic.pad_y[comp_src],
                       pic.pad_x[comp_src], src_width, src_height,
                       pic.bitdepth, dst_width, dst_height, dst_bitdepth)


def _shift_plane(view, src_bitdepth, out_bitdepth, dither):
    """CopyToBytesWithShift sample math, kept as an int32 plane."""
    if out_bitdepth == src_bitdepth:
        return np.asarray(view, dtype=np.int32)
    if out_bitdepth > src_bitdepth:
        return (view << (out_bitdepth - src_bitdepth)).astype(np.int32)
    downshift = src_bitdepth - out_bitdepth
    maxv = (1 << out_bitdepth) - 1
    if dither:
        return _downshift_dither(view, downshift, maxv)
    add = 1 << (downshift - 1)
    return np.minimum((view + add) >> downshift, maxv).astype(np.int32)


def _copy_to_with_resize(pic, fmt, dst_bitdepth):
    """(ref: resample.cc:340-394); returns list of int32 planes carrying
    dst_bitdepth samples."""
    out_chroma = fmt["chroma_format"]
    num_out = k.num_components(out_chroma)
    num_src = k.num_components(pic.chroma_format)
    planes = []
    for c in range(num_out):
        dst_width = _scale_size_x(fmt["width"], out_chroma, c)
        dst_height = _scale_size_y(fmt["height"], out_chroma, c)
        if c < num_src:
            src_width = pic.get_display_width(c)
            src_height = pic.get_display_height(c)
            if dst_width == src_width and dst_height == src_height:
                view = pic.plane_view(c)[:src_height, :src_width]
                planes.append(_shift_plane(view, pic.bitdepth, dst_bitdepth,
                                           fmt.get("dither", False)))
            else:
                planes.append(_resize_plane(pic, c, dst_width, dst_height,
                                            dst_bitdepth))
        else:
            planes.append(np.full((dst_height, dst_width),
                                  1 << (fmt["bitdepth"] - 1), np.int32))
    return planes


def _convert_color_space(planes, width, height, bitdepth, color_matrix):
    """444 12-bit planes -> packed 4-channel output
    (ref: resample.cc:396-475)."""
    cbd = COLOR_CONVERSION_BITDEPTH
    mat = _COLOR_MATRICES[int(color_matrix)
                          if int(color_matrix) < len(_COLOR_MATRICES) else 0]
    maxv = (1 << bitdepth) - 1
    shift = 10 + cbd - bitdepth
    c = planes[0].astype(np.int64) - (16 << (cbd - 8))
    d = planes[1].astype(np.int64) - (128 << (cbd - 8))
    e = planes[2].astype(np.int64) - (128 << (cbd - 8))
    ch0 = np.clip((mat[0][0] * c + mat[0][2] * e) >> shift, 0, maxv)
    ch1 = np.clip((mat[1][0] * c + mat[1][1] * d + mat[1][2] * e) >> shift,
                  0, maxv)
    ch2 = np.clip((mat[2][0] * c + mat[2][1] * d) >> shift, 0, maxv)
    ch3 = np.full((height, width), maxv, np.int64)
    packed = np.stack([ch0, ch1, ch2, ch3], axis=-1)
    dtype = np.uint8 if bitdepth <= 8 else np.uint16
    return packed.astype(dtype).tobytes()


def convert_to(pic, fmt) -> bytes:
    """Resampler::ConvertTo equivalent (ref: resample.cc:94-150).

    fmt: dict with width, height, chroma_format, bitdepth, color_matrix,
    dither.  Zero/undefined fields must be resolved by the caller.
    """
    if pic.width[0] == 0 or pic.height[0] == 0:
        return b""
    out_chroma = fmt["chroma_format"]
    dst_bitdepth = fmt["bitdepth"]
    is_argb = out_chroma == k.ChromaFormat.ARGB
    if is_argb:
        dst_bitdepth = COLOR_CONVERSION_BITDEPTH

    src_width = pic.get_display_width(0)
    src_height = pic.get_display_height(0)
    needs_resize = (fmt["width"] != src_width or
                    fmt["height"] != src_height or
                    (out_chroma != pic.chroma_format and
                     out_chroma != k.ChromaFormat.MONOCHROME))
    if needs_resize or is_argb:
        work_chroma = k.ChromaFormat.YUV444 if is_argb else out_chroma
        work_fmt = dict(fmt)
        work_fmt["chroma_format"] = work_chroma
        planes = _copy_to_with_resize(pic, work_fmt, dst_bitdepth)
        if is_argb:
            return _convert_color_space(planes, fmt["width"], fmt["height"],
                                        fmt["bitdepth"],
                                        fmt.get("color_matrix", 0))
        return _planes_to_bytes(planes, fmt["bitdepth"], fmt["bitdepth"],
                                False)
    # Basic conversion without resolution or color space change; emits
    # only the output format's components (e.g. luma for monochrome out).
    views = [pic.plane_view(c)[:pic.get_display_height(c),
                               :pic.get_display_width(c)]
             for c in range(k.num_components(out_chroma))]
    return _planes_to_bytes(views, pic.bitdepth, fmt["bitdepth"],
                            fmt.get("dither", False))
