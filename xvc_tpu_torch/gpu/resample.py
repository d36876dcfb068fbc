"""Windowed-sinc picture rescale on a torch device.

Port of ``xvc_tpu/tpu/resample_jax.py`` (``_tap_matrix``,
``_resample_fn``, ``resample``): the reference resampler core
(ref: src/xvc_common_lib/resample.cc:786-852 resample::Resample), a
separable polyphase filter with the reference's shift and clip between
its horizontal and vertical passes.  It serves decoder output resizing
(``codec/output.py``) and cross-segment reference rescaling
(``PictureDecoder.generate_alternative_rec_pic``).

``resample`` cuts the window (the source plane with 8 rows and columns
around it) from the host's padded plane, as the JAX version does, so
that its border holds what the reference reads there: coded samples
beyond the crop, then the border as this picture's buffer holds it
(edge-replicated only where ``pad_border`` ran for it).  It uploads the
window, and ``resample_window`` computes on the tensor's device: on the
card one launch of ``kernels/csrc/resample.cu`` (both passes, read
through per-axis tables of at most 12 taps instead of the JAX version's
dense tap matrices), on the CPU ``resample_plain``, the same sums as a
gather in PyTorch.  The per-axis tables (``axis_table``) are uploaded
once per geometry and device.
"""
import threading

import numpy as np
import torch

from .. import kernels
from ..engine import resolve_device
from ..ops import resample as rs

PAD = 8  # rows and columns of the window around the source plane


def geometry(src_width, src_height, src_bitdepth, dst_width, dst_height,
             dst_bitdepth):
    """(scale_x, scale_y, shift_hor, shift_ver, maxv) of a rescale, as
    ``_resample_fn`` computes them."""
    scale_x = ((src_width << rs.POSITION_PRECISION) + (dst_width >> 1)) \
        // dst_width
    scale_y = ((src_height << rs.POSITION_PRECISION) + (dst_height >> 1)) \
        // dst_height
    shift_hor = max(
        src_bitdepth - (rs.INTERNAL_PRECISION - rs.FILTER_PRECISION), 0)
    shift_ver = 2 * rs.FILTER_PRECISION - shift_hor + src_bitdepth \
        - dst_bitdepth
    return scale_x, scale_y, shift_hor, shift_ver, (1 << dst_bitdepth) - 1


def axis_table(scale, out_size, src_size):
    """One axis's filter as int32 [out_size, 1 + T]: the window index of
    each output position's first tap, then its T taps (T = 8, 1 or 12);
    and the ``post`` shift.  Raises if a tap would read outside the
    window [0, src_size + 2 * PAD)."""
    full, off, taps, post = rs._axis_taps(scale, out_size)
    table = np.empty((out_size, 1 + len(off)), np.int32)
    table[:, 0] = full + off[0] + PAD
    table[:, 1:] = taps
    first, last = table[:, 0].min(), table[:, 0].max() + len(off) - 1
    if first < 0 or last >= src_size + 2 * PAD:
        raise ValueError("taps read window indices %d..%d outside [0, %d)"
                         % (first, last, src_size + 2 * PAD))
    return table, post


_TABLES = {}
_TABLES_LOCK = threading.Lock()


def _tables_on(device, scale, out_size, src_size):
    """``axis_table`` as a tensor on ``device``, uploaded once."""
    key = (str(device), scale, out_size, src_size)
    with _TABLES_LOCK:
        ent = _TABLES.get(key)
        if ent is None:
            table, post = axis_table(scale, out_size, src_size)
            ent = _TABLES[key] = (torch.from_numpy(table).to(device), post)
    return ent


def cut_window(padded_src, origin_y, origin_x, src_width, src_height):
    """The int32 window [src_height + 16, src_width + 16] of a padded host
    plane around the source at (origin_y, origin_x)."""
    y0, x0 = origin_y - PAD, origin_x - PAD
    h, w = src_height + 2 * PAD, src_width + 2 * PAD
    if y0 < 0 or x0 < 0 or y0 + h > padded_src.shape[0] or \
            x0 + w > padded_src.shape[1]:
        raise ValueError("the window [%d:%d, %d:%d] leaves the padded plane "
                         "%r" % (y0, y0 + h, x0, x0 + w,
                                 tuple(padded_src.shape)))
    return np.ascontiguousarray(padded_src[y0:y0 + h, x0:x0 + w], np.int32)


def resample(padded_src, origin_y, origin_x, src_width, src_height,
             src_bitdepth, dst_width, dst_height, dst_bitdepth, device=None):
    """Rescale the source plane at (origin_y, origin_x) of the padded host
    plane ``padded_src`` to (dst_height, dst_width) int32 numpy, on
    ``device`` (None: the card; "cpu": the plain version).  The signature
    and result of ``xvc_tpu/tpu/resample_jax.resample``."""
    window = cut_window(padded_src, origin_y, origin_x, src_width,
                        src_height)
    dev = resolve_device(device)
    out = resample_window(torch.from_numpy(window).to(dev), src_bitdepth,
                          dst_width, dst_height, dst_bitdepth)
    return out.cpu().numpy()


def _check(window, dst_width, dst_height):
    kernels.require(window, torch.int32, 2, "window")
    if window.shape[0] <= 2 * PAD or window.shape[1] <= 2 * PAD or \
            dst_width <= 0 or dst_height <= 0:
        raise ValueError("window %r, output %dx%d" % (
            tuple(window.shape), dst_width, dst_height))
    return window.shape[1] - 2 * PAD, window.shape[0] - 2 * PAD


def resample_window(window, src_bitdepth, dst_width, dst_height,
                    dst_bitdepth):
    """Rescale the source of ``window`` (int32 [src_h + 16, src_w + 16],
    the source plane with 8 rows and columns around it) to [dst_height,
    dst_width] int32 on the window's device: on the card one launch of
    ``xvc_resample`` (both passes), on the CPU ``resample_plain``."""
    src_width, src_height = _check(window, dst_width, dst_height)
    if not kernels.on_cuda(window):
        return resample_plain(window, src_bitdepth, dst_width, dst_height,
                              dst_bitdepth)
    from ..kernels import build
    scale_x, scale_y, shift_hor, shift_ver, maxv = geometry(
        src_width, src_height, src_bitdepth, dst_width, dst_height,
        dst_bitdepth)
    if not 0 <= shift_ver <= 31:
        raise ValueError("bit depths %d -> %d give a vertical shift of %d"
                         % (src_bitdepth, dst_bitdepth, shift_ver))
    dev = window.device
    tab_x, post_x = _tables_on(dev, scale_x, dst_width, src_width)
    tab_y, post_y = _tables_on(dev, scale_y, dst_height, src_height)
    win_h, win_w = window.shape
    tmp = torch.empty((win_h, dst_width), dtype=torch.int32, device=dev)
    out = torch.empty((dst_height, dst_width), dtype=torch.int32,
                      device=dev)
    rc = build.lib().xvc_resample(
        build.ptr(window), win_h, win_w, build.ptr(tab_x),
        tab_x.shape[1] - 1, post_x, shift_hor, build.ptr(tab_y),
        tab_y.shape[1] - 1, post_y, shift_ver, maxv, dst_height, dst_width,
        build.ptr(tmp), build.ptr(out), build.stream_of(window))
    build.check(rc, "resample")
    kernels.count_launch("resample")
    return out


def resample_plain(window, src_bitdepth, dst_width, dst_height,
                   dst_bitdepth):
    """Plain PyTorch version of ``resample_window`` (same result): each
    pass gathers the taps of every output position and sums them in
    int64, as the host numpy resampler does."""
    src_width, src_height = _check(window, dst_width, dst_height)
    scale_x, scale_y, shift_hor, shift_ver, maxv = geometry(
        src_width, src_height, src_bitdepth, dst_width, dst_height,
        dst_bitdepth)
    dev = window.device
    tab_x, post_x = axis_table(scale_x, dst_width, src_width)
    tab_y, post_y = axis_table(scale_y, dst_height, src_height)

    def gather_index(table):
        idx = table[:, :1] + np.arange(table.shape[1] - 1, dtype=np.int32)
        return (torch.from_numpy(idx.astype(np.int64)).to(dev),
                torch.from_numpy(table[:, 1:].astype(np.int64)).to(dev))

    cols, taps_x = gather_index(tab_x)                 # (dst_w, T)
    tmp = (window.to(torch.int64)[:, cols] * taps_x).sum(-1)
    tmp = ((tmp >> post_x) >> shift_hor).clamp(0, 65535)
    rows, taps_y = gather_index(tab_y)                 # (dst_h, T)
    out = (tmp[rows] * taps_y[:, :, None]).sum(1)      # (dst_h, dst_w)
    return ((out >> post_y) >> shift_ver).clamp(0, maxv).to(torch.int32)


# Synthetic cases (src_w, src_h, src_bd, dst_w, dst_h, dst_bd), numpy only,
# shared by the tests and chip_smoke.py: the nine of
# tests/test_resample_device.py, then, at a bit depth, one square case per
# scale class to 32x32 (upsampling, equal size, and the eight downsampling
# classes 0-7 of get_filter_from_scale).
DEVICE_CASES = (
    (16, 16, 8, 24, 24, 8), (16, 16, 8, 32, 32, 8), (24, 16, 8, 24, 16, 10),
    (32, 32, 10, 24, 24, 8), (48, 48, 8, 32, 32, 8), (64, 48, 8, 24, 16, 8),
    (96, 96, 8, 16, 16, 8), (40, 24, 8, 56, 64, 10), (56, 64, 10, 40, 24, 8))
CLASS_SIZES = (24, 32, 33, 40, 48, 64, 72, 88, 112, 128)


def class_cases(bitdepth):
    return [(s, s, bitdepth, 32, 32, bitdepth) for s in CLASS_SIZES]


def synthetic_window(case, seed, full_scale=False):
    """An int32 window for ``case``: random samples of the source bit
    depth, its border random too (not edge-replicated); ``full_scale``
    draws only 0 and the largest sample, so that the sums reach their
    extremes."""
    src_w, src_h, bd = case[:3]
    rng = np.random.RandomState(seed)
    shape = (src_h + 2 * PAD, src_w + 2 * PAD)
    if full_scale:
        return (rng.randint(0, 2, shape) * ((1 << bd) - 1)).astype(np.int32)
    return rng.randint(0, 1 << bd, shape).astype(np.int32)
