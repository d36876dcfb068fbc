"""Windowed-sinc picture rescale on a torch device, a picture at a time.

Port of ``xvc_tpu/tpu/resample_jax.py`` (``_tap_matrix``,
``_resample_fn``, ``resample``): the reference resampler core
(ref: src/xvc_common_lib/resample.cc:786-852 resample::Resample), a
separable polyphase filter with the reference's shift and clip between
its horizontal and vertical passes.  It serves decoder output resizing
(``codec/output.py``) and cross-segment reference rescaling
(``PictureDecoder.generate_alternative_rec_pic``).

The unit of work is a picture: ``resample_picture`` rescales up to three
planes of one picture in one launch of ``kernels/csrc/resample.cu`` (both
passes fused, read through per-axis tables of at most 12 taps instead of
the JAX version's dense tap matrices), each plane's result written once
where its consumer wants it: ``resample_to_buffer`` into the packed
output bytes (one download), ``resample_to_store`` into a new frame-store
slot of the alternative reconstruction, edge-replicated into the store's
padded geometry (one download into its host planes).  On the CPU each
plane runs ``resample_plain`` on the same windows.

Each plane reads its window (the source plane with 8 rows and columns
around it) where the picture's samples already are:

- the picture's int16 frame-store slot on the device, when the host
  padded the picture (``border_padded``): the slot's border is the same
  edge replication (``flat_recon.device_pad_planes``), so the window is
  the host's, sample for sample;
- the slot's coded samples and, outside the coded plane, the host
  plane's border, uploaded and overlaid on the card, when the host did not
  pad the picture: a highest-layer picture with tid > 0 keeps its
  buffer's old border, and the reference reads it;
- the window cut from the host plane and uploaded, for a picture with no
  slot on this device (one decoded elsewhere).

The superstacks and the slot are taken under the store's lock
(``flat_recon._STORE_LOCK``), as MC takes them, and read only while the
picture owns its slot.  ``resample`` (the JAX package's signature: a host
plane in, an int32 plane out) and ``resample_window`` keep a plane's
host-window entry; both launch the same kernel with one plane.  The
per-axis tables (``axis_table``) and the tile plan are made once per
geometry; the tables are uploaded once per device.  Spans:
``resample.window`` (the host side of the windows), ``resample.upload``,
``resample.kernel``, ``resample.download``.
"""
import threading
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as k
from .. import kernels
from ..engine import resolve_device
from ..ops import resample as rs
from .. import profiling
from ..profiling import span
from . import dsp
from . import flat_recon

PAD = 8  # rows and columns of the window around the source plane

# The kernel's output tile (width, height) before shrinking, its
# shared-memory budget, and the fields of one plane descriptor in the
# order ``xvc_resample_picture`` reads them.
TILE = (64, 64)
SMEM_BUDGET = 64 * 1024
MAX_PLANES = 3
FIELDS = ("src", "src_stride", "y0", "x0", "tab_x", "tab_y", "tx", "ty",
          "post_x", "post_y", "shift_hor", "shift_ver", "maxv", "dst_w",
          "dst_h", "out", "out_stride", "esize", "out_w", "out_h", "off_x",
          "off_y", "tile_w", "tile_h", "rows_cap", "pitch_words")


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


def span_max(first, taps, tile):
    """The most window indices that ``tile`` consecutive output positions
    read (``first``: their first tap's index, monotone)."""
    n = len(first)
    t = min(tile, n)
    return int((first[t - 1:] - first[:n - t + 1]).max()) + taps


class TilePlan(NamedTuple):
    tile_w: int
    tile_h: int
    rows_cap: int      # window rows a tile's span may hold
    pitch_words: int   # 4-byte words a span row may hold
    smem: int          # bytes: the span, then the uint16 intermediate


def tile_plan(tab_x, tab_y):
    """The kernel's output tile for these axis tables: ``TILE``, shrunk
    (the height halved down to 8, the width cut to 8 and to 1: the kernel
    is compiled for widths 64, 8 and 1; then the height halved down to 1)
    until its
    largest window span and intermediate fit ``SMEM_BUDGET``.  A span row
    starts at the word that holds its first sample, so it holds at most
    span // 2 + 2 words."""
    tw, th = TILE
    while True:
        rows = span_max(tab_y[:, 0], tab_y.shape[1] - 1, th)
        pitch = span_max(tab_x[:, 0], tab_x.shape[1] - 1, tw) // 2 + 2
        smem = 4 * rows * pitch + 2 * rows * tw
        if smem <= SMEM_BUDGET or tw == th == 1:
            return TilePlan(tw, th, rows, pitch, smem)
        if th > 8 or (tw == 1 and th > 1):
            th //= 2
        elif tw > 1:
            tw //= 8
        else:
            th //= 2


class Plan(NamedTuple):
    key: tuple
    tab_x: np.ndarray
    post_x: int
    tab_y: np.ndarray
    post_y: int
    shift_hor: int
    shift_ver: int
    maxv: int
    tiles: TilePlan


_PLANS = {}
_TABLES = {}
_LOCK = threading.Lock()


def plan(src_width, src_height, src_bitdepth, dst_width, dst_height,
         dst_bitdepth):
    """Tables, shifts and tile plan of a rescale (made once)."""
    key = (src_width, src_height, src_bitdepth, dst_width, dst_height,
           dst_bitdepth)
    with _LOCK:
        ent = _PLANS.get(key)
    if ent is None:
        scale_x, scale_y, shift_hor, shift_ver, maxv = geometry(*key)
        tab_x, post_x = axis_table(scale_x, dst_width, src_width)
        tab_y, post_y = axis_table(scale_y, dst_height, src_height)
        ent = Plan(key, tab_x, post_x, tab_y, post_y, shift_hor, shift_ver,
                   maxv, tile_plan(tab_x, tab_y))
        with _LOCK:
            ent = _PLANS.setdefault(key, ent)
    return ent


def _tables_on(device, p):
    """The plan's axis tables on ``device`` as the kernel reads them (rows
    padded with zeros to a multiple of 4 int32, 16 bytes), uploaded
    once."""
    tkey = (str(device),) + p.key
    with _LOCK:
        ent = _TABLES.get(tkey)
        if ent is None:
            ent = _TABLES[tkey] = tuple(
                dsp.upload(torch.from_numpy(
                    np.pad(t, ((0, 0), (0, -t.shape[1] % 4)))), device)
                for t in (p.tab_x, p.tab_y))
    return ent


def cut_window(padded_src, origin_y, origin_x, src_width, src_height):
    """The int32 window [src_height + 16, src_width + 16] of a padded host
    plane around the source at (origin_y, origin_x)."""
    y0, x0 = _window_origin(padded_src.shape, origin_y, origin_x, src_width,
                            src_height)
    return np.ascontiguousarray(
        padded_src[y0:y0 + src_height + 2 * PAD,
                   x0:x0 + src_width + 2 * PAD], np.int32)


def _window_origin(plane_shape, origin_y, origin_x, src_width, src_height):
    y0, x0 = origin_y - PAD, origin_x - PAD
    h, w = src_height + 2 * PAD, src_width + 2 * PAD
    if y0 < 0 or x0 < 0 or y0 + h > plane_shape[0] or \
            x0 + w > plane_shape[1]:
        raise ValueError("the window [%d:%d, %d:%d] leaves the padded plane "
                         "%r" % (y0, y0 + h, x0, x0 + w, tuple(plane_shape)))
    return y0, x0


class PlaneJob(NamedTuple):
    """One plane of a picture's rescale: the source plane ``comp`` at
    (origin_y, origin_x) of the picture's padded plane, src_w x src_h,
    rescaled to dst_w x dst_h into ``out`` (a 2-d uint8, int16 or int32
    tensor whose rows are contiguous): out[y, x] is the rescaled sample at
    (clamp(y - off_y), clamp(x - off_x))."""
    comp: int
    origin_y: int
    origin_x: int
    src_w: int
    src_h: int
    dst_w: int
    dst_h: int
    out: torch.Tensor
    off_y: int = 0
    off_x: int = 0


def _even_window(h, w, device):
    """An int16 window [h, w] with an even row stride (its last column
    of padding never read)."""
    return torch.empty((h, w + (w & 1)), dtype=torch.int16,
                       device=device)[:, :w]


def store_windows(pic, jobs, device, border_padded):
    """The source window of every job as (tensor, y0, x0): window sample
    (0, 0) at tensor[y0, x0], int16 with an even row stride.  From the
    picture's frame-store slot on ``device`` (its border as the host's
    where ``border_padded``, else the host plane's border outside the
    coded plane overlaid on the card, one upload for all planes), or cut
    from the host plane (one upload) where it has no slot there.  Call
    under ``flat_recon._STORE_LOCK`` while the picture owns its slot."""
    ent = flat_recon._slot_map(pic).get(str(device))
    origins = [_window_origin(pic._plane_shapes[j.comp], j.origin_y,
                              j.origin_x, j.src_w, j.src_h) for j in jobs]
    planes = None
    if ent is not None:
        store, slot = ent[:2]
        luma, chroma = store.stacks()
        planes = [luma[slot] if j.comp == 0 else
                  chroma[2 * slot + j.comp - 1] for j in jobs]
        if border_padded:
            return [(p, y0, x0) for p, (y0, x0) in zip(planes, origins)]
    batch = dsp.DevBatch()
    out = []
    with span("resample.window"):
        for i, (job, (y0, x0)) in enumerate(zip(jobs, origins)):
            h, w = job.src_h + 2 * PAD, job.src_w + 2 * PAD
            host = pic.padded_plane(job.comp)[y0:y0 + h, x0:x0 + w]
            if planes is None:
                win = np.empty((h, w + (w & 1)), np.int16)
                win[:, :w] = host
                out.append((batch.add(win), w))
                continue
            win = _even_window(h, w, device)
            ry0, ry1, rx0, rx1 = _coded_rect(pic, job.comp, y0, x0, h, w)
            win[ry0:ry1, rx0:rx1] = planes[i][y0 + ry0:y0 + ry1,
                                              x0 + rx0:x0 + rx1]
            ring = [(r, c) for r, c in ((slice(0, ry0), slice(0, w)),
                                        (slice(ry1, h), slice(0, w)),
                                        (slice(ry0, ry1), slice(0, rx0)),
                                        (slice(ry0, ry1), slice(rx1, w)))
                    if host[r, c].size]
            out.append((win, [(r, c, batch.add(host[r, c].astype(np.int16)))
                              for r, c in ring]))
    with span("resample.upload"):
        batch.upload(device)
    if planes is None:
        return [(batch.get(h)[:, :w], 0, 0) for h, w in out]
    for win, ring in out:
        for r, c, handle in ring:
            win[r, c] = batch.get(handle)
    return [(win, 0, 0) for win, _ in out]


def _coded_rect(pic, comp, y0, x0, h, w):
    """The coded plane's rows [ry0, ry1) and columns [rx0, rx1) inside the
    window [h, w] at (y0, x0) of the padded plane."""
    py, px = pic.pad_y[comp], pic.pad_x[comp]
    ry0 = min(max(py - y0, 0), h)
    ry1 = min(max(py + pic.height[comp] - y0, ry0), h)
    rx0 = min(max(px - x0, 0), w)
    rx1 = min(max(px + pic.width[comp] - x0, rx0), w)
    return ry0, ry1, rx0, rx1


def resample_picture(pic, jobs, src_bitdepth, dst_bitdepth, device,
                     border_padded=False):
    """Rescale the planes ``jobs`` (``PlaneJob``, at most three) of
    ``pic`` into their ``out`` tensors on ``device``: on the card one
    launch of ``xvc_resample_picture``, on the CPU ``resample_plain``
    per plane.  The windows come from ``store_windows``."""
    with flat_recon._STORE_LOCK:
        windows = store_windows(pic, jobs, device, border_padded)
        run_planes(jobs, windows, src_bitdepth, dst_bitdepth)


_ESIZE = {torch.uint8: 1, torch.int16: 2, torch.int32: 4}


def run_planes(jobs, windows, src_bitdepth, dst_bitdepth):
    """The rescale of ``jobs`` from ``windows`` ((tensor, y0, x0) each),
    every tensor on one device."""
    if not 1 <= len(jobs) <= MAX_PLANES:
        raise ValueError("%d planes in one launch" % len(jobs))
    tensors = [w[0] for w in windows] + [j.out for j in jobs]
    plans = [plan(j.src_w, j.src_h, src_bitdepth, j.dst_w, j.dst_h,
                  dst_bitdepth) for j in jobs]
    for job, (win, y0, x0) in zip(jobs, windows):
        if win.dim() != 2 or win.stride(1) != 1 or \
                y0 + job.src_h + 2 * PAD > win.shape[0] or \
                x0 + job.src_w + 2 * PAD > win.shape[1]:
            raise ValueError("a window of %dx%d at (%d, %d) in %r" % (
                job.src_w + 2 * PAD, job.src_h + 2 * PAD, y0, x0,
                tuple(win.shape)))
        out = job.out
        if out.dtype not in _ESIZE or out.dim() != 2 or out.stride(1) != 1:
            raise ValueError("out must be a 2-d uint8, int16 or int32 "
                             "tensor with contiguous rows, got %s %r" % (
                                 out.dtype, tuple(out.shape)))
    on_card = kernels.on_cuda(*tensors)
    with span("resample.kernel"):
        if not on_card:
            for job, win, p in zip(jobs, windows, plans):
                _plain_into(job, win, p, src_bitdepth, dst_bitdepth)
            return
        _launch(jobs, windows, plans)



def _launch(jobs, windows, plans):
    from ..kernels import build
    desc = np.zeros((len(jobs), len(FIELDS)), np.int64)
    smem = 0
    for row, job, (win, y0, x0), p in zip(desc, jobs, windows, plans):
        if win.dtype != torch.int16 or win.stride(0) % 2 or \
                win.data_ptr() % 4:
            raise ValueError("a window must be int16 with an even row "
                             "stride on a 4-byte boundary")
        if not 0 <= p.shift_ver <= 31:
            raise ValueError("a vertical shift of %d" % p.shift_ver)
        tab_x, tab_y = _tables_on(win.device, p)
        t = p.tiles
        row[:] = (win.data_ptr(), win.stride(0), y0, x0, tab_x.data_ptr(),
                  tab_y.data_ptr(), p.tab_x.shape[1] - 1,
                  p.tab_y.shape[1] - 1, p.post_x, p.post_y, p.shift_hor,
                  p.shift_ver, p.maxv, job.dst_w, job.dst_h,
                  job.out.data_ptr(), job.out.stride(0),
                  _ESIZE[job.out.dtype], job.out.shape[1],
                  job.out.shape[0], job.off_x, job.off_y, t.tile_w,
                  t.tile_h, t.rows_cap, t.pitch_words)
        smem = max(smem, t.smem)
    rc = build.lib().xvc_resample_picture(
        desc.ctypes.data, len(jobs), smem, build.stream_of(jobs[0].out))
    build.check(rc, "resample")
    kernels.count_launch("resample")


def _plain_into(job, window, p, src_bitdepth, dst_bitdepth):
    win, y0, x0 = window
    res = resample_plain(
        win[y0:y0 + job.src_h + 2 * PAD,
            x0:x0 + job.src_w + 2 * PAD].to(torch.int32).contiguous(),
        src_bitdepth, job.dst_w, job.dst_h, dst_bitdepth)
    out_h, out_w = job.out.shape
    if (job.off_y, job.off_x, out_h, out_w) != (0, 0, job.dst_h, job.dst_w):
        rows = (torch.arange(out_h) - job.off_y).clamp(0, job.dst_h - 1)
        cols = (torch.arange(out_w) - job.off_x).clamp(0, job.dst_w - 1)
        res = res[rows][:, cols]
    job.out.copy_(res.to(job.out.dtype))


def resample_to_buffer(pic, planes, src_bitdepth, dst_bitdepth, size,
                       device, border_padded=False):
    """The planes ``planes`` ((comp, offset, dst_w, dst_h): the display
    area of ``pic``'s plane comp rescaled to dst_w x dst_h at ``offset``
    samples) written into one packed buffer of ``size`` samples, uint8 at
    ``dst_bitdepth`` 8 or below, else uint16, in one launch and one
    download.  Returns the host buffer (numpy); what no plane covers is
    left for the caller."""
    dev = resolve_device(device)
    dtype = torch.uint8 if dst_bitdepth <= 8 else torch.int16
    buf = torch.empty(size, dtype=dtype, device=dev)
    jobs = [PlaneJob(c, pic.pad_y[c], pic.pad_x[c],
                     pic.get_display_width(c), pic.get_display_height(c),
                     w, h, buf[off:off + w * h].view(h, w))
            for c, off, w, h in planes]
    resample_picture(pic, jobs, src_bitdepth, dst_bitdepth, dev,
                     border_padded)
    with span("resample.download"):
        host = download(buf)
    return host if dtype == torch.uint8 else host.view(np.uint16)


def download(t):
    """``t`` on the host as numpy, one copy (pinned from the card),
    counted and waited for as ``dsp.download`` does."""
    if t.device.type != "cuda":
        return dsp.download(t).numpy()
    profiling.wait_device(t)
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    profiling.count("xfer.dtoh", 1, host.numel() * host.element_size())
    return host.numpy()


def resample_to_store(dst_pic, src_pic, device, border_padded=False):
    """The alternative reconstruction ``dst_pic`` of ``src_pic`` (every
    plane of ``src_pic``'s internal area rescaled to ``dst_pic``'s; planes
    of equal size through the one-tap filter, which is the reference's
    shift): one launch into a new slot of ``dst_pic``'s frame store on
    ``device``, edge-replicated into the store's padded geometry, then
    one download into ``dst_pic``'s padded host planes (what its
    ``pad_border`` would leave).  Chroma of a monochrome source is the
    mid value, as in the reference."""
    dev = resolve_device(device)
    ncomp = k.num_components(dst_pic.chroma_format)
    mono = src_pic.chroma_format == k.ChromaFormat.MONOCHROME
    mid = 1 << (dst_pic.bitdepth - 1)
    with flat_recon._STORE_LOCK:
        flat_recon.release_slot(dst_pic)
        store = flat_recon.get_store(dst_pic, dev)
        slot = store.reserve()
        luma, chroma = store.stacks()
        outs = [luma[slot]] + ([] if ncomp == 1 else
                               [chroma[2 * slot], chroma[2 * slot + 1]])
        jobs = []
        for c in range(ncomp):
            if mono and c:
                outs[c].fill_(mid)
                continue
            jobs.append(PlaneJob(
                c, src_pic.pad_y[c], src_pic.pad_x[c], src_pic.width[c],
                src_pic.height[c], dst_pic.width[c], dst_pic.height[c],
                outs[c], dst_pic.pad_y[c], dst_pic.pad_x[c]))
        resample_picture(src_pic, jobs, src_pic.bitdepth, dst_pic.bitdepth,
                         dev, border_padded)
        flat_recon._register(dst_pic, store, slot)
    shapes = [dst_pic._plane_shapes[c] for c in range(ncomp)]
    with span("resample.download"):
        flat = download(torch.cat([o[:h, :w].reshape(-1) for o, (h, w) in
                                   zip(outs, shapes)]))
    off = 0
    for c, (h, w) in enumerate(shapes):
        dst_pic.padded_plane(c)[:] = flat[off:off + h * w].reshape(h, w)
        off += h * w
    return slot


def resample(padded_src, origin_y, origin_x, src_width, src_height,
             src_bitdepth, dst_width, dst_height, dst_bitdepth, device=None):
    """Rescale the source plane at (origin_y, origin_x) of the padded host
    plane ``padded_src`` to (dst_height, dst_width) int32 numpy, on
    ``device`` (None: the card; "cpu": the plain version).  The signature
    and result of ``xvc_tpu/tpu/resample_jax.resample``: the window is cut
    on the host and uploaded, one plane a launch."""
    with span("resample.window"):
        window = cut_window(padded_src, origin_y, origin_x, src_width,
                            src_height)
    dev = resolve_device(device)
    with span("resample.upload"):
        window = dsp.upload(torch.from_numpy(window), dev)
    out = resample_window(window, src_bitdepth, dst_width, dst_height,
                          dst_bitdepth)
    with span("resample.download"):
        return dsp.download(out).numpy()


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
    the source plane with 8 rows and columns around it, samples of at most
    16 bit) to [dst_height, dst_width] int32 on the window's device: on the
    card one launch of ``xvc_resample_picture`` with one plane (the window
    copied to int16 first), on the CPU ``resample_plain``."""
    src_width, src_height = _check(window, dst_width, dst_height)
    if not kernels.on_cuda(window):
        return resample_plain(window, src_bitdepth, dst_width, dst_height,
                              dst_bitdepth)
    if src_bitdepth > 16:
        raise ValueError("samples of %d bit" % src_bitdepth)
    win = _even_window(window.shape[0], window.shape[1], window.device)
    win.copy_(window)  # 16-bit samples keep their bits; the kernel reads
    # them unsigned
    out = torch.empty((dst_height, dst_width), dtype=torch.int32,
                      device=window.device)
    run_planes([PlaneJob(0, PAD, PAD, src_width, src_height, dst_width,
                         dst_height, out)], [(win, 0, 0)], src_bitdepth,
               dst_bitdepth)
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
# ratios far from the bench's: a tile shrinks until its span fits
EXTREME_CASES = ((512, 16, 8, 8, 16, 8), (16, 8, 8, 512, 8, 8),
                 (8, 300, 10, 8, 6, 10), (600, 600, 8, 5, 7, 8),
                 (6, 5, 14, 200, 150, 14))


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
