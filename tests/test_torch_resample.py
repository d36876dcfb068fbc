"""The port's resampler (xvc_tpu_torch/gpu/resample.py) against the JAX
package's, exactly (tolerance 0: every stage is integer).

- ``resample_plain`` and ``ops.resample.resample(..., device="cpu")`` equal
  ``xvc_tpu.tpu.resample_jax.resample`` (the device twin, XLA on the CPU)
  and the JAX package's host path (``XVC_DSP=host``) on the nine cases of
  tests/test_resample_device.py, on every scale class of
  get_filter_from_scale at 8, 10 and 14 bit at full scale, on windows
  whose origin is not the pad (a crop), and on a window whose border holds
  values that are not the edge's (what a picture whose border was not
  padded holds).
- The int32 range of ``resample.cu``: from the filter tables, the sum of
  |taps| times the largest sample stays below 2^31 in both passes, and a
  numpy model of the kernel's int32 sums equals ``resample_plain``.
- The wrapper refuses windows that leave the plane and taps that would
  read outside the window.
"""
import numpy as np
import pytest
import torch

from xvc_tpu.ops import resample as jrs
from xvc_tpu.tpu import resample_jax
from xvc_tpu_torch import constants as k
from xvc_tpu_torch import profiling
from xvc_tpu_torch.codec.yuv import YuvPicture
from xvc_tpu_torch.gpu import flat_recon
from xvc_tpu_torch.gpu import resample as gres
from xvc_tpu_torch.ops import resample as rs


def _host_resample(monkeypatch, *args):
    """The JAX package's host path (bypasses its engine dispatch)."""
    monkeypatch.setenv("XVC_DSP", "host")
    return jrs.resample(*args)


def _all_equal(monkeypatch, padded, origin_y, origin_x, case):
    src_w, src_h, src_bd, dst_w, dst_h, dst_bd = case
    args = (padded, origin_y, origin_x, src_w, src_h, src_bd, dst_w, dst_h,
            dst_bd)
    want = resample_jax.resample(*args)
    assert want.shape == (dst_h, dst_w)
    assert np.array_equal(_host_resample(monkeypatch, *args), want)
    port = rs.resample(*args, device="cpu")
    assert port.dtype == np.int32 and np.array_equal(port, want)
    window = torch.from_numpy(gres.cut_window(padded, origin_y, origin_x,
                                              src_w, src_h))
    plain = gres.resample_plain(window, src_bd, dst_w, dst_h, dst_bd)
    assert plain.dtype == torch.int32
    assert np.array_equal(plain.numpy(), want)


@pytest.mark.parametrize("case", gres.DEVICE_CASES,
                         ids=["%dx%d_%d-%dx%d_%d" % c
                              for c in gres.DEVICE_CASES])
def test_device_cases_equal_the_jax_package(monkeypatch, case):
    src_w, src_h, src_bd, dst_w = case[:4]
    rng = np.random.RandomState(src_w * 31 + dst_w)
    pad = 16
    padded = rng.randint(0, 1 << src_bd, (src_h + 2 * pad, src_w + 2 * pad)
                         ).astype(np.int32)
    _all_equal(monkeypatch, padded, pad, pad, case)


@pytest.mark.parametrize("bd", [8, 10, 14])
@pytest.mark.parametrize("size", gres.CLASS_SIZES)
def test_every_scale_class_at_full_scale(monkeypatch, bd, size):
    case = (size, size, bd, 32, 32, bd)
    window = gres.synthetic_window(case, size + bd, full_scale=True)
    _all_equal(monkeypatch, window, gres.PAD, gres.PAD, case)


def test_the_classes_cover_every_filter():
    kinds = set()
    for size in gres.CLASS_SIZES:
        scale = gres.geometry(size, size, 8, 32, 32, 8)[0]
        kinds.add("up" if scale < rs.SCALE_FACTOR else "equal"
                  if scale == rs.SCALE_FACTOR
                  else rs.get_filter_from_scale(scale))
    assert kinds == {"up", "equal"} | set(range(8))


@pytest.mark.parametrize("case", [(40, 24, 8, 56, 64, 8),
                                  (72, 40, 10, 48, 24, 8),
                                  (33, 30, 14, 32, 20, 10)])
def test_crop_window_not_at_the_pad(monkeypatch, case):
    """A source that starts inside a larger plane (the display window of a
    cropped picture): its 8-sample border is coded samples."""
    src_w, src_h, bd = case[:3]
    rng = np.random.RandomState(src_w + src_h)
    padded = rng.randint(0, 1 << bd, (src_h + 41, src_w + 37)).astype(
        np.int32)
    _all_equal(monkeypatch, padded, 13, 21, case)


def test_border_that_is_not_the_edge(monkeypatch):
    """The border around the source holds values unlike its edge, as the
    recycled buffer of a picture that was not padded does: both packages
    read them as they are."""
    rng = np.random.RandomState(4)
    src_w, src_h, bd = 48, 32, 10
    padded = np.zeros((src_h + 32, src_w + 32), np.int32)
    padded[16:16 + src_h, 16:16 + src_w] = rng.randint(0, 1 << bd,
                                                       (src_h, src_w))
    border = np.ones(padded.shape, bool)
    border[16:16 + src_h, 16:16 + src_w] = False
    padded[border] = rng.randint(0, 1 << bd, border.sum())
    for case in [(src_w, src_h, bd, 32, 24, bd), (src_w, src_h, bd, 72, 48,
                                                   8)]:
        _all_equal(monkeypatch, padded, 16, 16, case)
    # the border matters: edge-replicated, the result differs
    edge = np.pad(padded[16:16 + src_h, 16:16 + src_w], 16, mode="edge")
    case = (src_w, src_h, bd, 32, 24, bd)
    a = rs.resample(padded, 16, 16, *case, device="cpu")
    b = rs.resample(edge, 16, 16, *case, device="cpu")
    assert not np.array_equal(a, b)


def test_int32_range_of_the_kernel_sums():
    """Sum of |taps| times the largest sample below 2^31 in both passes:
    the window's samples (at most 14 bit, the deepest picture the port
    decodes; 16 bit is checked) and the intermediate (clipped to 65535)."""
    filters = [rs.UPSAMPLE_FILTER, np.full((1, 1), 64)] + \
        list(rs.DOWNSAMPLE_FILTERS)
    worst = max(int(np.abs(f).sum(axis=1).max()) for f in filters)
    assert worst == 204  # class 0 of the downsampling filters
    assert worst * ((1 << 14) - 1) < 2 ** 31     # pass 1, 14-bit samples
    assert worst * 65535 < 2 ** 31               # pass 2 (and 16 bit)


def _kernel_model(window, src_bd, dst_w, dst_h, dst_bd):
    """The arithmetic of resample.cu in numpy int32: per-axis tables, T
    products summed in int32, the arithmetic shifts, then the clips."""
    src_h, src_w = window.shape[0] - 16, window.shape[1] - 16
    scale_x, scale_y, shift_hor, shift_ver, maxv = gres.geometry(
        src_w, src_h, src_bd, dst_w, dst_h, dst_bd)
    tab_x, post_x = gres.axis_table(scale_x, dst_w, src_w)
    tab_y, post_y = gres.axis_table(scale_y, dst_h, src_h)
    win = window.astype(np.int32)
    tmp = np.zeros((window.shape[0], dst_w), np.int32)
    for k in range(tab_x.shape[1] - 1):
        tmp += win[:, tab_x[:, 0] + k] * tab_x[:, 1 + k][None, :]
    tmp = np.clip((tmp >> post_x) >> shift_hor, 0, 65535).astype(np.int32)
    out = np.zeros((dst_h, dst_w), np.int32)
    for k in range(tab_y.shape[1] - 1):
        out += tmp[tab_y[:, 0] + k, :] * tab_y[:, 1 + k][:, None]
    return np.clip((out >> post_y) >> shift_ver, 0, maxv)


@pytest.mark.parametrize("bd", [8, 14])
def test_kernel_model_in_int32_equals_plain(bd):
    for case in list(gres.DEVICE_CASES) + gres.class_cases(bd):
        case = case[:2] + (bd,) + case[3:5] + (bd,)
        window = gres.synthetic_window(case, 7, full_scale=True)
        plain = gres.resample_plain(torch.from_numpy(window), bd, case[3],
                                    case[4], bd)
        model = _kernel_model(window, bd, case[3], case[4], bd)
        assert np.array_equal(plain.numpy(), model), case


def test_wrapper_refuses_what_it_cannot_read():
    plane = np.zeros((40, 40), np.int32)
    with pytest.raises(ValueError, match="leaves the padded plane"):
        gres.resample(plane, 4, 8, 24, 24, 8, 16, 16, 8, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        gres.axis_table(gres.geometry(8, 8, 8, 64, 64, 8)[0], 64, 1)
    with pytest.raises(ValueError):
        gres.resample_window(torch.zeros((20, 20), dtype=torch.int16), 8,
                             8, 8, 8)


# ---- the per-picture path: windows from the frame store, one launch a
# picture (gpu/resample.py resample_picture), and the kernel's tiling ------

CPU = torch.device("cpu")


def _stored_picture(seed, width, height, bd, chroma=k.ChromaFormat.YUV420,
                    padded=True, crop=(0, 0), stored=True):
    """A port picture with random coded samples, written to the CPU frame
    store as the decoder writes it (``device_pad_planes`` from the coded
    planes) unless not ``stored``; its host border edge-replicated where
    ``padded``, else random (a buffer that kept an older picture's
    border)."""
    rng = np.random.RandomState(seed)
    pic = YuvPicture(chroma, width, height, bd, True, *crop)
    ncomp = k.num_components(chroma)
    for c in range(ncomp):
        plane = pic.padded_plane(c)
        plane[:] = rng.randint(0, 1 << bd, plane.shape)
    if padded:
        pic.pad_border()
    if not stored:
        return pic
    flat_recon.frame_store_put(pic, flat_recon.device_pad_planes(
        pic, {c: torch.from_numpy(pic.plane_view(c).astype(np.int16))
              for c in range(ncomp)}), CPU)
    return pic


def _jobs(pic, windows):
    """PlaneJobs for (comp, origin_y, origin_x, src_w, src_h) windows
    (the output unused)."""
    return [gres.PlaneJob(c, oy, ox, w, h, 8, 8,
                          torch.empty((8, 8), dtype=torch.int32))
            for c, oy, ox, w, h in windows]


def _window_cases(pic):
    """Windows on every plane: the display area at the pad, the crop cases
    of test_crop_window_not_at_the_pad inside the plane, one that is mostly
    border (the plane's corner) and one reaching 8 past the coded plane's
    far corner."""
    out = []
    for c in range(k.num_components(pic.chroma_format)):
        py, px = pic.pad_y[c], pic.pad_x[c]
        h, w = pic.height[c], pic.width[c]
        out.append((c, py, px, pic.get_display_width(c),
                    pic.get_display_height(c)))
        for sw, sh in ((40, 24), (72, 40), (33, 30)):
            sw, sh = min(sw, w), min(sh, h)
            out.append((c, py + 5, px + 13, sw, sh))
            out.append((c, py + h - sh, px + w - sw, sw, sh))
        out.append((c, 8, 8, w // 2, h // 2))
    return out


@pytest.mark.parametrize("bd", [8, 10, 14])
@pytest.mark.parametrize("padded", [True, False], ids=["padded", "ring"])
def test_store_window_equals_the_host_cut(bd, padded):
    """The window each plane reads on the device equals ``cut_window`` of
    the host plane, sample for sample: straight from the slot where the
    host padded the picture, the slot's coded samples with the host's
    border overlaid (the ring) where it did not."""
    pic = _stored_picture(bd, 96, 64, bd, padded=padded, crop=(8, 6))
    cases = _window_cases(pic)
    uploads = profiling.counted("xfer.htod")
    windows = gres.store_windows(pic, _jobs(pic, cases), CPU, padded)
    # padded: the slot planes themselves; else one upload of every ring
    assert profiling.counted("xfer.htod") == uploads + (not padded)
    store = flat_recon.get_store(pic, CPU)
    for (c, oy, ox, w, h), (win, y0, x0) in zip(cases, windows):
        assert win.dtype == torch.int16 and win.stride(0) % 2 == 0
        stack = store.luma if c == 0 else store.chroma
        assert (win.untyped_storage().data_ptr() ==
                stack.untyped_storage().data_ptr()) == padded
        got = win[y0:y0 + h + 16, x0:x0 + w + 16].numpy()
        want = gres.cut_window(pic.padded_plane(c), oy, ox, w, h)
        assert np.array_equal(got, want), (c, oy, ox, w, h)


def test_the_ring_is_what_the_unpadded_border_holds(monkeypatch):
    """test_border_that_is_not_the_edge through the per-picture path: a
    picture whose host border holds values unlike its edge resizes, from
    the store and the ring, to the JAX package's result on the host plane;
    read from the slot alone (the edge) the result differs."""
    pic = _stored_picture(4, 48, 32, 10, chroma=k.ChromaFormat.MONOCHROME,
                          padded=False)
    for case in [(48, 32, 10, 32, 24, 10), (48, 32, 10, 72, 48, 8)]:
        want = resample_jax.resample(pic.padded_plane(0), pic.pad_y[0],
                                     pic.pad_x[0], *case)
        args = (pic, [(0, 0, case[3], case[4])], 10, case[5],
                case[3] * case[4], CPU)
        got = gres.resample_to_buffer(*args, border_padded=False)
        assert np.array_equal(got.reshape(want.shape), want)
        edge = gres.resample_to_buffer(*args, border_padded=True)
        assert not np.array_equal(edge.reshape(want.shape), want)


@pytest.mark.parametrize("src,dst,bd", [
    ((96, 64), (64, 48), (8, 8)), ((48, 32), (72, 48), (10, 10)),
    ((64, 48), (40, 24), (14, 10)), ((40, 36), (96, 64), (8, 12))])
@pytest.mark.parametrize("padded,stored", [(True, True), (False, True),
                                           (False, False)],
                         ids=["padded", "ring", "no_slot"])
def test_resample_picture_equals_the_jax_package(monkeypatch, src, dst, bd,
                                                 padded, stored):
    """Every plane of a 4:2:0 picture (cropped) in one call into one packed
    buffer, against the JAX package's ``resample`` of each plane on the
    host planes: from the store slot, with the ring, and cut from the host
    planes where the picture has no slot; and the per-plane host entry
    ``resample`` on the same."""
    pic = _stored_picture(sum(src), src[0], src[1], bd[0], padded=padded,
                          crop=(4, 2), stored=stored)
    planes, off = [], 0
    for c in range(3):
        w, h = (dst[0], dst[1]) if c == 0 else (dst[0] // 2, dst[1] // 2)
        planes.append((c, off, w, h))
        off += w * h
    got = gres.resample_to_buffer(pic, planes, bd[0], bd[1], off, CPU,
                                  padded)
    assert got.dtype == (np.uint8 if bd[1] <= 8 else np.uint16)
    for c, o, w, h in planes:
        args = (pic.padded_plane(c), pic.pad_y[c], pic.pad_x[c],
                pic.get_display_width(c), pic.get_display_height(c), bd[0],
                w, h, bd[1])
        want = resample_jax.resample(*args)
        assert np.array_equal(got[o:o + w * h].reshape(h, w), want), c
        assert np.array_equal(gres.resample(*args, device="cpu"), want)


@pytest.mark.parametrize("src,dst", [
    ((64, 48, 8, 1), (96, 64, 8, 1)), ((96, 64, 10, 1), (64, 48, 8, 1)),
    ((64, 48, 8, 1), (64, 48, 10, 1)), ((64, 48, 10, 1), (64, 48, 8, 1)),
    ((64, 48, 8, 1), (32, 24, 8, 3)), ((64, 48, 8, 0), (48, 32, 8, 1))],
    ids=["up", "down", "same_size_up", "same_size_down", "to_444",
         "mono_source"])
def test_resample_to_store_equals_the_jax_alternative(monkeypatch, src, dst):
    """The alternative reconstruction in one call: the slot it writes
    holds the store's padded geometry of the JAX package's alternative
    picture (``resample_pic_plane`` of each plane, the mid value for the
    chroma of a monochrome source, then ``pad_border``), and its host
    planes equal that picture's padded planes."""
    from xvc_tpu.codec.yuv import YuvPicture as JaxYuvPicture
    monkeypatch.setenv("XVC_DSP", "host")
    (sw, sh, sbd, sfmt), (dw, dh, dbd, dfmt) = src, dst
    pic = _stored_picture(sw + dw, sw, sh, sbd, chroma=sfmt)
    jsrc = JaxYuvPicture(sfmt, sw, sh, sbd, True)
    for c in range(k.num_components(sfmt)):
        jsrc.padded_plane(c)[:] = pic.padded_plane(c)
    jalt = JaxYuvPicture(dfmt, dw, dh, dbd, True)
    for c in range(k.num_components(dfmt)):
        if sfmt == k.ChromaFormat.MONOCHROME and c:
            jalt.plane_view(c)[:] = 1 << (dbd - 1)
        else:
            jrs.resample_pic_plane(jalt, c, jsrc)
    jalt.pad_border()
    alt = YuvPicture(dfmt, dw, dh, dbd, True)
    before = profiling.counted("xfer.htod")
    slot = rs.resample_pic(alt, pic, CPU, border_padded=True)
    assert profiling.counted("xfer.htod") == before
    assert flat_recon.ensure_slot(alt, CPU) == slot
    luma, chroma = flat_recon.get_store(alt, CPU).stacks()
    for c in range(k.num_components(dfmt)):
        assert np.array_equal(alt.padded_plane(c), jalt.padded_plane(c)), c
        stored = (luma[slot] if c == 0 else chroma[2 * slot + c - 1]).numpy()
        want = np.pad(jalt.padded_plane(c), [
            (0, n - m) for n, m in zip(stored.shape,
                                       jalt.padded_plane(c).shape)],
            mode="edge")
        assert np.array_equal(stored, want), c
    assert profiling.counted("xfer.htod") == before


def _tiling_model(window, y0, x0, case, out_shape=None, off=(0, 0)):
    """The arithmetic of resample.cu's fused kernel in numpy, tile by tile:
    each tile's span of window rows and columns from the axis tables (the
    span's words from the one that holds its first sample), the
    horizontal pass over the span's rows (halo included) in int32, then the
    vertical pass out of it, each output at (clamp(y - off_y),
    clamp(x - off_x)) of the rescaled plane.  ``window`` is the source
    (uint16 samples, even width), window sample (0, 0) at [y0, x0]."""
    p = gres.plan(*case)
    t = p.tiles
    dst_w, dst_h = case[3], case[4]
    out_h, out_w = out_shape or (dst_h, dst_w)
    tx, ty = p.tab_x.shape[1] - 1, p.tab_y.shape[1] - 1
    fx, fy = p.tab_x[:, 0], p.tab_y[:, 0]
    src = window.astype(np.int32)
    assert src.shape[1] % 2 == 0
    out = np.zeros((out_h, out_w), np.int32)
    for oy0 in range(0, out_h, t.tile_h):
        for ox0 in range(0, out_w, t.tile_w):
            ny, nx = min(t.tile_h, out_h - oy0), min(t.tile_w, out_w - ox0)
            vy0, vy1 = np.clip([oy0 - off[0], oy0 + ny - 1 - off[0]], 0,
                               dst_h - 1)
            vx0, vx1 = np.clip([ox0 - off[1], ox0 + nx - 1 - off[1]], 0,
                               dst_w - 1)
            ry0, nrows = fy[vy0], fy[vy1] + ty - fy[vy0]
            cx0, cx1 = fx[vx0], fx[vx1] + tx
            e0 = x0 + cx0
            w0 = e0 >> 1
            nwords = ((x0 + cx1 - 1) >> 1) - w0 + 1
            assert nrows <= t.rows_cap and nwords <= t.pitch_words
            assert 2 * (w0 + nwords) <= src.shape[1]
            span = src[y0 + ry0:y0 + ry0 + nrows, 2 * w0:2 * (w0 + nwords)]
            vxs = np.arange(vx0, vx1 + 1)
            cols = fx[vxs] - cx0 + (e0 & 1)
            tmp = np.zeros((nrows, len(vxs)), np.int32)
            for kk in range(tx):
                tmp += span[:, cols + kk] * p.tab_x[vxs, 1 + kk][None, :]
            tmp = np.clip((tmp >> p.post_x) >> p.shift_hor, 0, 65535)
            vys = np.clip(np.arange(oy0, oy0 + ny) - off[0], 0, dst_h - 1)
            js = np.clip(np.arange(ox0, ox0 + nx) - off[1], 0,
                         dst_w - 1) - vx0
            rows = fy[vys] - ry0
            acc = np.zeros((ny, nx), np.int32)
            for kk in range(ty):
                acc += tmp[rows + kk][:, js] * p.tab_y[vys, 1 + kk][:, None]
            out[oy0:oy0 + ny, ox0:ox0 + nx] = np.clip(
                (acc >> p.post_y) >> p.shift_ver, 0, p.maxv)
    return out


TILING_CASES = list(gres.DEVICE_CASES) + [
    c for bd in (8, 10, 14) for c in gres.class_cases(bd)] + \
    list(gres.EXTREME_CASES)


@pytest.mark.parametrize("case", TILING_CASES,
                         ids=["%dx%d_%d-%dx%d_%d" % c for c in TILING_CASES])
def test_tiling_model_equals_plain(case):
    """The kernel's tiles, halos and spans (the numpy model above) equal
    ``resample_plain`` on random and full-scale samples, with the window at
    an odd and at an even column of its source (the span's first word then
    starts a sample early or on it), and written with the store's edge
    replication around it."""
    for full_scale in (False, True):
        window = gres.synthetic_window(case, sum(case), full_scale)
        want = gres.resample_plain(torch.from_numpy(window), case[2],
                                   case[3], case[4], case[5]).numpy()
        h, w = window.shape
        for y0, x0 in ((0, 0), (3, 1)):
            src = np.zeros((y0 + h + 2, x0 + w + 2 + ((x0 + w) & 1)),
                           np.uint16)
            src[y0:y0 + h, x0:x0 + w] = window
            got = _tiling_model(src, y0, x0, case)
            assert np.array_equal(got, want), (full_scale, y0, x0)
        off = (5, 9)
        shape = (case[4] + 13, case[3] + 20)
        rows = np.clip(np.arange(shape[0]) - off[0], 0, case[4] - 1)
        cols = np.clip(np.arange(shape[1]) - off[1], 0, case[3] - 1)
        even = np.zeros((h, w + (w & 1)), np.uint16)
        even[:, :w] = window
        got = _tiling_model(even, 0, 0, case, shape, off)
        assert np.array_equal(got, want[rows][:, cols])


def test_tile_plan_fits_every_ratio():
    """Every plan's span and intermediate fit the shared-memory budget,
    and the full-width bench geometries keep the 64 x 64 tile."""
    for case in TILING_CASES + [(1920, 1080, 8, 1280, 720, 8),
                                (960, 540, 8, 640, 360, 8),
                                (1280, 720, 8, 1920, 1080, 8)]:
        t = gres.plan(*case).tiles
        assert t.smem <= gres.SMEM_BUDGET, case
        assert t.smem == 4 * t.rows_cap * t.pitch_words + \
            2 * t.rows_cap * t.tile_w
    assert gres.plan(1920, 1080, 8, 1280, 720, 8).tiles[:2] == (64, 64)
