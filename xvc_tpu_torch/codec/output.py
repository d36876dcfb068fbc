"""Decoded-picture output conversion (resize / chroma / bitdepth / ARGB).

Behavioral equivalent of Resampler::ConvertTo + CopyToWithResize +
ConvertColorSpace (ref: src/xvc_common_lib/resample.cc:94-458): converts
a reconstructed YuvPicture to the requested output format, resampling
with the exact windowed-sinc / bilinear kernels when the resolution or
chroma format differs.  The windowed-sinc resizes of a picture run on the
picture decoder's device in one call (``gpu/resample.resample_to_buffer``:
one launch of the card's kernel, or its plain version on the CPU, reading
the picture's frame-store slot and writing the packed output bytes, then
one download); the bilinear 2x chroma upsample, the bit-depth shifts,
the dither and the colour conversion stay host numpy, as in ``xvc_tpu``.
"""
import numpy as np

from .. import constants as k
from ..gpu import resample as device_resample
from ..ops import resample as rs
from ..profiling import span

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


def _bilinear_2x(pic, comp_src, dst_width, dst_height):
    """True where the plane takes the bilinear 2x chroma upsample."""
    return comp_src != 0 and \
        dst_width == 2 * pic.get_display_width(comp_src) and \
        dst_height == 2 * pic.get_display_height(comp_src)


def _copy_to_with_resize(pic, fmt, dst_bitdepth, device, border_padded):
    """(ref: resample.cc:340-394); returns (buf, planes): the packed output
    buffer (uint8 at dst_bitdepth 8 or below, else uint16) and each output
    plane as a view of it, carrying dst_bitdepth samples.  Every plane that
    takes the windowed sinc is rescaled on ``device`` in one call that
    writes the buffer (``gpu/resample.resample_to_buffer``: one launch, one
    download); the bilinear 2x chroma upsample, the planes at their own
    size and the missing components are host numpy, cast into their place
    (span ``output.pack``)."""
    out_chroma = fmt["chroma_format"]
    num_out = k.num_components(out_chroma)
    num_src = k.num_components(pic.chroma_format)
    dims = [(_scale_size_x(fmt["width"], out_chroma, c),
             _scale_size_y(fmt["height"], out_chroma, c))
            for c in range(num_out)]
    offs = np.cumsum([0] + [w * h for w, h in dims])
    sinc = [(c, int(offs[c]), w, h) for c, (w, h) in enumerate(dims)
            if c < num_src and (w, h) != (pic.get_display_width(c),
                                          pic.get_display_height(c))
            and not _bilinear_2x(pic, c, w, h)]
    if sinc:
        buf = device_resample.resample_to_buffer(
            pic, sinc, pic.bitdepth, dst_bitdepth, int(offs[-1]), device,
            border_padded)
    else:
        buf = np.empty(int(offs[-1]),
                       np.uint8 if dst_bitdepth <= 8 else np.uint16)
    planes = [buf[offs[c]:offs[c + 1]].reshape(h, w)
              for c, (w, h) in enumerate(dims)]
    on_card = {c for c, _, _, _ in sinc}
    with span("output.pack"):
        for c, (w, h) in enumerate(dims):
            if c in on_card:
                continue
            if c >= num_src:
                planes[c][:] = 1 << (fmt["bitdepth"] - 1)
            elif (w, h) == (pic.get_display_width(c),
                            pic.get_display_height(c)):
                view = pic.plane_view(c)[:h, :w]
                np.copyto(planes[c], _shift_plane(
                    view, pic.bitdepth, dst_bitdepth,
                    fmt.get("dither", False)), casting="unsafe")
            else:
                py, px = pic.pad_y[c], pic.pad_x[c]
                sh, sw = h // 2, w // 2
                window = pic.padded_plane(c)[py:py + sh + 1, px:px + sw + 1]
                np.copyto(planes[c], rs.bilinear_resample(
                    window, sh, sw, pic.bitdepth, dst_bitdepth),
                    casting="unsafe")
    return buf, planes


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


def convert_to(pic, fmt, device=None, border_padded=False) -> bytes:
    """Resampler::ConvertTo equivalent (ref: resample.cc:94-150), its
    windowed-sinc resizes on ``device`` (None: the card), read from the
    picture's frame-store slot there (``border_padded``: the host padded
    the picture, so the slot's border is its border too).

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
        buf, planes = _copy_to_with_resize(pic, work_fmt, dst_bitdepth,
                                           device, border_padded)
        if is_argb:
            return _convert_color_space(planes, fmt["width"], fmt["height"],
                                        fmt["bitdepth"],
                                        fmt.get("color_matrix", 0))
        with span("output.pack"):
            return buf.tobytes()
    # Basic conversion without resolution or color space change; emits
    # only the output format's components (e.g. luma for monochrome out).
    views = [pic.plane_view(c)[:pic.get_display_height(c),
                               :pic.get_display_width(c)]
             for c in range(k.num_components(out_chroma))]
    with span("output.pack"):
        return _planes_to_bytes(views, pic.bitdepth, fmt["bitdepth"],
                                fmt.get("dither", False))
