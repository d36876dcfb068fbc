"""The motion search's resident reference plane (xvc_tpu_torch/gpu/me.py
``reference_luma``) and its counts, on the CPU device:

- the resident plane equals the picture's ``padded_plane(0)`` byte for
  byte, in the kernel's element type, for a padded picture and for one
  whose border was never padded and holds its buffer's old samples; the
  sweeps that read that border give the JAX function's SADs on the
  window cut from the host plane;
- ``PictureEncoder.init_pic`` (a recycled buffer) and a new border
  (``pad_border``) drop it, and the next sweep reads the new content;
- one upload a picture however many sweeps and tables read it, and one
  when threads race for it;
- ``STATS`` loses no update when many threads count at once.

No whole encode: the encodes of the inter half are in
tests/test_torch_python_cu_inter*.py, tests/test_torch_me_golden.py and
tests/test_torch_me_ra64x48.py.
"""
import sys
import threading

import numpy as np
import pytest
import torch

from xvc_tpu.tpu import me as jme
from xvc_tpu_torch import constants as k
from xvc_tpu_torch import segment as seg
from xvc_tpu_torch.codec.picture_encoder import PictureEncoder
from xvc_tpu_torch.codec.yuv import YuvPicture
from xvc_tpu_torch.gpu import me
from xvc_tpu_torch.ops import metrics as met
from xvc_tpu_torch.restrictions import Restrictions

W, H = 256, 192  # the coded luma; padded by 80 on every side


def _fill(pic, rng, bitdepth):
    """New coded samples, then the border padded from them."""
    pic.plane_view(0)[:] = rng.randint(0, 1 << bitdepth, (H, W))
    pic.pad_border()


def _stale(pic, rng, bitdepth):
    """The buffer's old content everywhere, then new coded samples and no
    padding: the border keeps the old samples (ROADMAP hazard 10)."""
    pic.planes[0][:] = rng.randint(0, 1 << bitdepth, pic.planes[0].shape)
    pic.plane_view(0)[:] = rng.randint(0, 1 << bitdepth, (H, W))


class _Cu:
    def __init__(self, x, y, w, h):
        self.pos_x, self.pos_y, self.width, self.height = x, y, w, h

    def pos(self, comp):
        return self.pos_x, self.pos_y


class _Qp:
    distortion_weight = [1.0, 1.0, 1.0]


class _HostSearch:
    def _make_dist_fullpel(self, *args):
        raise AssertionError("a prefetched vector went to the host")


def _table(pic, x, y, w, h, orig, metric="SAD"):
    return me.DeviceSadTable(
        _HostSearch(), _Cu(x, y, w, h),
        met.SampleMetric(pic.bitdepth, getattr(met.MetricType, metric)),
        pic, orig, "cpu")


@pytest.mark.parametrize("bitdepth", (8, 10, 15, 16))
@pytest.mark.parametrize("padded", (True, False))
def test_the_resident_plane_is_the_padded_plane(bitdepth, padded):
    rng = np.random.RandomState(bitdepth + 100 * padded)
    pic = YuvPicture(1, W, H, bitdepth)
    (_fill if padded else _stale)(pic, rng, bitdepth)
    me.reset_stats()
    plane = me.reference_luma(pic, "cpu")
    host = pic.padded_plane(0)
    assert plane.dtype == me.packed_dtype(bitdepth)
    assert tuple(plane.shape) == host.shape
    assert plane.numpy().tobytes() == host.astype(
        np.int16 if bitdepth <= 15 else np.int32).tobytes()
    assert me.STATS["reference_uploads"] == 1
    # a copy: the host plane's later writes do not reach it
    host[0, 0] ^= 1
    assert int(plane[0, 0]) != int(host[0, 0])
    # the sweeps that read the border: the JAX function on the window cut
    # from the host plane (the window's top-left and bottom-right corners)
    host[0, 0] ^= 1
    orig = rng.randint(0, 1 << bitdepth, (16, 8)).astype(np.int32)
    oy, ox = 0, host.shape[1] - me.WIN
    cands = np.array([[0, me.WIN - 16, 40, 3], [0, me.WIN - 8, 60, 100]],
                     np.int32)
    for fast in (False, True):
        want = np.asarray(jme.make_sad_fn(8, 16, fast, bitdepth, 4)(
            np.ascontiguousarray(host[oy:oy + me.WIN, ox:ox + me.WIN]),
            orig, cands))
        np.testing.assert_array_equal(
            me.sad_sweep(plane, oy, ox, orig, cands, fast, bitdepth), want)


def _segment():
    return seg.SegmentHeader(soc=0, max_sub_gop_length=1, low_delay=True,
                             num_ref_pics=1)


def test_init_pic_drops_the_resident_plane():
    """A recycled picture: ``init_pic`` drops the copy, and the next sweep
    reads the buffer's new content, not the copy of the old."""
    rng = np.random.RandomState(3)
    enc = PictureEncoder(k.ChromaFormat.YUV420, W, H, 8)
    ref = enc.rec_pic
    _fill(ref, rng, 8)
    me.reset_stats()
    orig = rng.randint(0, 256, (8, 8)).astype(np.int32)
    mvs = me.tz_initial_candidates((0, 0), 16)
    old = _table(ref, 16, 16, 8, 8, orig)
    old.prefetch(_Qp(), mvs)
    first = me.reference_luma(ref, "cpu")
    assert me.STATS["reference_uploads"] == 1
    enc.init_pic(_segment(), 1, 1, 0, False, Restrictions())
    assert ref.device_luma is None
    # the buffer's new content, and no border padding yet
    ref.plane_view(0)[:] = rng.randint(0, 256, (H, W))
    new = _table(ref, 16, 16, 8, 8, orig)
    new.prefetch(_Qp(), mvs)
    assert me.STATS["reference_uploads"] == 2
    np.testing.assert_array_equal(me.reference_luma(ref, "cpu").numpy(),
                                  ref.padded_plane(0))
    assert not torch.equal(first, me.reference_luma(ref, "cpu"))
    host = ref.padded_plane(0)
    for (mx, my), sad in new.cache.items():
        y0, x0 = 80 + 16 + my, 80 + 16 + mx
        assert sad == int(np.abs(orig - host[y0:y0 + 8, x0:x0 + 8]).sum())
    assert new.cache != old.cache
    # padding writes the border: the copy goes again
    ref.pad_border()
    assert ref.device_luma is None
    me.reference_luma(ref, "cpu")
    assert me.STATS["reference_uploads"] == 3


def test_one_upload_a_picture_however_many_sweeps():
    rng = np.random.RandomState(4)
    refs = [YuvPicture(1, W, H, 10) for _ in range(2)]
    for ref in refs:
        _fill(ref, rng, 10)
    me.reset_stats()
    orig = rng.randint(0, 1024, (8, 16)).astype(np.int32)
    calls = 0
    for ref in refs:
        for x, y in ((0, 0), (16, 8), (48, 40), (32, 16)):
            for metric in ("SAD", "SAD_FAST"):
                tab = _table(ref, x, y, 16, 8, orig, metric)
                tab.prefetch(_Qp(), me.tz_initial_candidates((1, -2), 32))
                tab.prefetch(_Qp(), [(5, 5), (-5, 7)])
                calls += 2
    assert me.STATS["device_calls"] == calls
    assert me.STATS["reference_uploads"] == len(refs)


def test_counts_and_the_copy_under_contention():
    """More threads than cores and a short switch interval: every count
    of ``STATS`` lands, and threads that race for one picture's copy make
    it once."""
    rng = np.random.RandomState(5)
    pic = YuvPicture(1, W, H, 8)
    _fill(pic, rng, 8)
    orig = rng.randint(0, 256, (8, 8)).astype(np.int32)
    threads = 16
    rounds = 200
    me.reset_stats()
    planes = []

    def work():
        planes.append(me.reference_luma(pic, "cpu"))
        for _ in range(rounds):
            # a metric the routing leaves to the host: two counts a call
            _table(pic, 8, 8, 8, 8, orig, "SATD").prefetch(_Qp(), [(0, 0)])
            me._count(host_dists=1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=work) for _ in range(threads)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(60)
        assert not any(t.is_alive() for t in workers)
    finally:
        sys.setswitchinterval(interval)
    assert me.STATS["prefetches"] == threads * rounds
    assert me.STATS["host_routed"] == threads * rounds
    assert me.STATS["host_dists"] == threads * rounds
    assert me.STATS["reference_uploads"] == 1
    assert len(planes) == threads and all(p is planes[0] for p in planes)
