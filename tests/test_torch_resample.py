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
