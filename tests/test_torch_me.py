"""The port's device motion estimation (xvc_tpu_torch/gpu/me.py) against
the JAX package's (xvc_tpu/tpu/me.py), on the CPU:

- ``sad_sweep_plain``, which reads a plane at an origin, against
  ``make_sad_fn`` on the window cut from the same plane at that origin,
  bit for bit: every CU shape from 4x4 to 64x64 (the non-square ones
  included), SAD and SAD_FAST, 8, 10, 12 and 16 bit, N = 1, 44, 86 and
  754 candidates, always with the window's four corners among them;
  the same through ``sad_sweep`` on the CPU device;
- the staging layout the kernel reads (the offsets as int32, then the
  block: int16 to 15 bit, int32 above) and the checks of ``sad_sweep``;
- ``tz_initial_candidates`` for every search range from 1 to 256;
- ``DeviceSadTable.prefetch`` against the JAX table on a 1280x720
  reference picture: CU positions and candidate lists that take each of
  the three host routes (a metric other than SAD, a box over the window,
  a window outside the padded plane) and the device route, with the
  same cache, the same ``dist`` values, the routes counted in ``STATS``
  and the device route reading the picture's resident padded luma;
- the block metrics the inter search picks (``ops/metrics.py``
  ``SampleMetric``, the native ``xvcn_metric``) against the JAX package's
  numpy metrics.

The port's encode of ra64x48_me is in tests/test_torch_me_ra64x48.py, the
resident reference plane and the counts' lock in
tests/test_torch_me_resident.py.
"""
import numpy as np
import pytest
import torch

from xvc_tpu.ops import metrics as jmet
from xvc_tpu.tpu import me as jme
from xvc_tpu_torch.codec.yuv import YuvPicture
from xvc_tpu_torch.gpu import me
from xvc_tpu_torch.ops import metrics as met

SIZES = (4, 8, 16, 32, 64)
BITDEPTHS = (8, 10, 12, 16)
COUNTS = (1, 44, 86, 754)


def _sweep_cases():
    cases = []
    i = 0
    for w in SIZES:
        for h in SIZES:
            for fast in (False, True):
                cases.append((w, h, fast, BITDEPTHS[i % 4],
                              COUNTS[(i // 4) % 4]))
                i += 1
    return cases


# where the 192 x 192 window lies in the plane of ``_inputs``
_OY, _OX = 13, 27


def _inputs(w, h, bitdepth, n, seed):
    """A plane that holds a 192 x 192 window at (_OY, _OX), an h x w
    block and n offsets into the window (its four corners first)."""
    rng = np.random.RandomState(seed)
    plane = rng.randint(0, 1 << bitdepth, (me.WIN + 40, me.WIN + 56)) \
        .astype(np.int32)
    orig = rng.randint(0, 1 << bitdepth, (h, w)).astype(np.int32)
    # a run of extreme samples, so that the sums are as large as they get
    plane[_OY:_OY + h, _OX:_OX + w] = (1 << bitdepth) - 1
    orig[::3] = 0
    ys = rng.randint(0, me.WIN - h + 1, n)
    xs = rng.randint(0, me.WIN - w + 1, n)
    corners = [(0, 0), (0, me.WIN - w), (me.WIN - h, 0),
               (me.WIN - h, me.WIN - w)]
    for j, (y, x) in enumerate(corners[:n]):
        ys[j], xs[j] = y, x
    return plane, orig, np.stack([ys, xs]).astype(np.int32)


def _window(plane):
    return np.ascontiguousarray(plane[_OY:_OY + me.WIN, _OX:_OX + me.WIN])


def _resident(plane, bitdepth):
    return torch.from_numpy(plane).to(me.packed_dtype(bitdepth))


@pytest.mark.parametrize("w,h,fast,bitdepth,n", _sweep_cases())
def test_sad_sweep_plain_equals_make_sad_fn(w, h, fast, bitdepth, n):
    """The plane-reading plain version against the JAX function on the
    window cut from the same plane at the same origin."""
    plane, orig, cands = _inputs(w, h, bitdepth, n, seed=w * 131 + h + fast)
    want = np.asarray(jme.make_sad_fn(w, h, fast, bitdepth, n)(
        _window(plane), orig, cands))
    got = me.sad_sweep_plain(torch.from_numpy(plane), _OY, _OX,
                             torch.from_numpy(orig), torch.from_numpy(cands),
                             fast, bitdepth)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the call on the CPU device: the resident plane's element type
    np.testing.assert_array_equal(
        me.sad_sweep(_resident(plane, bitdepth), _OY, _OX, orig, cands,
                     fast, bitdepth), want)


@pytest.mark.parametrize("bitdepth", BITDEPTHS)
def test_the_staging_holds_the_offsets_and_the_block(bitdepth):
    """The offsets y and x as int32, then the block in the plane's
    element type (int16 up to 15 bit, int32 above)."""
    _, orig, cands = _inputs(8, 4, bitdepth, 44, seed=bitdepth)
    dt = me.packed_dtype(bitdepth)
    assert dt == (torch.int16 if bitdepth <= 15 else torch.int32)
    size = me.staging_bytes(4, 8, 44, bitdepth)
    assert size == 8 * 44 + 4 * 8 * (2 if bitdepth <= 15 else 4)
    buf = np.full(size + 16, 0xA5, np.uint8)
    assert me.stage_sweep(buf, orig, cands, bitdepth) == size
    np.testing.assert_array_equal(buf[:8 * 44].view(np.int32).reshape(2, 44),
                                  cands)
    np.testing.assert_array_equal(
        buf[8 * 44:size].view(np.int16 if bitdepth <= 15 else np.int32)
        .reshape(4, 8), orig)
    assert (buf[size:] == 0xA5).all()


def test_sad_sweep_checks_its_inputs():
    plane, orig, cands = _inputs(8, 8, 8, 4, seed=1)
    res = _resident(plane, 8)
    with pytest.raises(ValueError):  # a block leaves the plane
        bad = cands.copy()
        bad[1, 0] = plane.shape[1] - _OX - 7
        me.sad_sweep(res, _OY, _OX, orig, bad, False, 8)
    with pytest.raises(ValueError):  # ... above its top
        me.sad_sweep(res, -1, _OX, orig, cands, False, 8)
    with pytest.raises(ValueError):  # a bit depth the kernel lacks
        me.sad_sweep(res.int(), _OY, _OX, orig, cands, False, 17)
    with pytest.raises(ValueError):  # not the resident element type
        me.sad_sweep(res.int(), _OY, _OX, orig, cands, False, 8)
    with pytest.raises(ValueError):  # a block wider than a CU
        me.sad_sweep(res, _OY, _OX, np.zeros((4, 65), np.int32), cands[:, :1],
                     False, 8)
    with pytest.raises(ValueError):  # neither the CPU nor the card
        me.sad_sweep(res.to("meta"), _OY, _OX, orig, cands, False, 8)
    assert me.sad_sweep(res, _OY, _OX, orig, cands[:, :0], True, 8).shape \
        == (0,)
    np.testing.assert_array_equal(
        me.sad_sweep(res, _OY, _OX, orig, cands, True, 8),
        me.sad_sweep_plain(torch.from_numpy(plane), _OY, _OX,
                           torch.from_numpy(orig), torch.from_numpy(cands),
                           True, 8).numpy())


def test_tz_initial_candidates_equal_the_jax_list():
    for rng in range(1, 257):
        for base in ((0, 0), (-7, 3), (12, -40)):
            assert me.tz_initial_candidates(base, rng) == \
                jme.tz_initial_candidates(base, rng)


class _Cu:
    def __init__(self, x, y, w, h):
        self.pos_x, self.pos_y, self.width, self.height = x, y, w, h

    def pos(self, comp):
        return self.pos_x, self.pos_y


def _ref_picture(plane, bitdepth):
    """A 1280x720 picture (padding 80, as the encoder's) whose padded
    luma is ``plane``."""
    pic = YuvPicture(1, 1280, 720, bitdepth)
    pic.planes[0][:] = plane
    return pic


class _Qp:
    distortion_weight = [0.75, 1.0, 1.0]

    @staticmethod
    def get_qp_raw(comp):
        return 32


class _Search:
    """The host route of both tables: the JAX package's SAD of the block
    at the vector, as its ``_make_dist_fullpel`` gives it."""

    def __init__(self, bitdepth):
        self.bitdepth = bitdepth

    def _make_dist_fullpel(self, cu, qp, metric, ref_pic, orig):
        plane = ref_pic.padded_plane(0)
        cx, cy = cu.pos(0)

        def dist(mv_x, mv_y):
            y0 = ref_pic.pad_y[0] + cy + mv_y
            x0 = ref_pic.pad_x[0] + cx + mv_x
            blk = plane[y0:y0 + cu.height, x0:x0 + cu.width]
            return metric.compare(qp, 0, orig, blk)
        return dist


# (CU x, y, w, h, metric, candidate list, the route the port must take)
_TABLE_CASES = [
    (600, 300, 16, 16, "SAD", jme.tz_initial_candidates((3, -2), 64),
     "device"),
    (600, 300, 8, 16, "SAD_FAST", jme.tz_initial_candidates((-5, 9), 64),
     "device"),
    (640, 360, 32, 8, "SAD",
     [(x, y) for y in range(-64, 65, 5) for x in range(-64, 65, 5)],
     "device"),
    (200, 200, 64, 64, "SAD_FAST", jme.tz_initial_candidates((0, 0), 32),
     "device"),
    (600, 300, 16, 16, "SATD", jme.tz_initial_candidates((0, 0), 8),
     "host"),  # a metric other than SAD
    (600, 300, 16, 16, "SAD", jme.tz_initial_candidates((0, 0), 128),
     "host"),  # the box is wider than the window
    (0, 0, 16, 16, "SAD", jme.tz_initial_candidates((-30, -30), 64),
     "host"),  # the window starts left of and above the padded plane
    (1264, 704, 16, 16, "SAD", jme.tz_initial_candidates((0, 0), 64),
     "host"),  # ... and ends right of and below it
]


@pytest.mark.parametrize("bitdepth", (8, 10))
@pytest.mark.parametrize("case", range(len(_TABLE_CASES)))
def test_device_sad_table_fills_the_jax_cache(case, bitdepth):
    x, y, w, h, mt, mvs, route = _TABLE_CASES[case]
    rng = np.random.RandomState(case)
    plane = rng.randint(0, 1 << bitdepth, (720 + 160, 1280 + 160)) \
        .astype(np.int32)
    ref, cu, qp = _ref_picture(plane, bitdepth), _Cu(x, y, w, h), _Qp()
    orig = np.ascontiguousarray(
        plane[80 + y + 3:80 + y + 3 + h, 80 + x - 2:80 + x - 2 + w]) ^ 5
    jtab = jme.DeviceSadTable(
        _Search(bitdepth), cu,
        jmet.SampleMetric(bitdepth, getattr(jmet.MetricType, mt)), ref,
        orig)
    me.reset_stats()
    tab = me.DeviceSadTable(
        _Search(bitdepth), cu,
        met.SampleMetric(bitdepth, getattr(met.MetricType, mt)), ref, orig,
        "cpu")
    for t in (jtab, tab):
        t.prefetch(qp, mvs)
    assert tab.cache == jtab.cache
    if route == "device":
        assert len(tab.cache) == len(set(mvs))
        assert me.STATS["device_calls"] == 1
        assert me.STATS["device_candidates"] == len(set(mvs))
        assert me.STATS["host_routed"] == 0
        # the sweep read the reference's padded luma, copied once
        assert me.STATS["reference_uploads"] == 1
        # one copy a device: (generation, {device: plane})
        assert list(ref.device_luma[1]) == [torch.device("cpu")]
        np.testing.assert_array_equal(
            ref.device_luma[1][torch.device("cpu")].numpy(), plane)
    else:
        assert not tab.cache
        assert me.STATS["device_calls"] == 0
        assert me.STATS["host_routed"] == 1
        assert me.STATS["reference_uploads"] == 0
        assert ref.device_luma is None
    for t in (jtab, tab):  # mostly cached, or a box that fits
        t.prefetch(qp, mvs[:5] + [(1, 1)])
    assert tab.cache == jtab.cache
    assert me.STATS["prefetches"] == 2
    # one copy of the reference however many sweeps read it
    assert me.STATS["reference_uploads"] == min(1, me.STATS["device_calls"])
    for mv in mvs[::7] + [(2, -3)]:
        assert tab.dist(qp, *mv) == jtab.dist(qp, *mv)


@pytest.mark.parametrize("bitdepth", (8, 10, 12))
@pytest.mark.parametrize("name", ["SAD", "SAD_FAST", "SATD", "SATD_AC_ONLY",
                                  "SAD_AC_ONLY", "SAD_AC_ONLY_FAST", "SSD",
                                  "STRUCTURAL_SSD"])
def test_inter_metrics_equal_the_jax_numpy_metrics(name, bitdepth):
    """The port's SampleMetric (native) against the JAX package's numpy
    twins, on every block shape the inter search measures."""
    rng = np.random.RandomState(bitdepth)
    for w in SIZES:
        for h in SIZES:
            a = rng.randint(0, 1 << bitdepth, (h, w)).astype(np.int32)
            b = np.clip(a + rng.randint(-40, 41, (h, w)), 0,
                        (1 << bitdepth) - 1).astype(np.int32)
            diff = a.astype(np.int64) - b
            if name == "SAD":
                want = jmet.compute_sad(diff, bitdepth)
            elif name == "SAD_FAST":
                want = jmet.compute_sad_fast(diff, bitdepth)
            elif name == "SATD":
                want = jmet.compute_satd(diff, bitdepth)
            elif name == "SATD_AC_ONLY":
                want = jmet.compute_satd_ac_only(diff, bitdepth)
            elif name == "SAD_AC_ONLY":
                want = jmet.compute_sad_ac_only(diff, bitdepth, 0)
            elif name == "SAD_AC_ONLY_FAST":
                want = jmet.compute_sad_ac_only(diff, bitdepth, 1)
            elif name == "SSD":
                want = jmet.compute_ssd(diff, bitdepth)
            else:
                want = jmet.compute_structural_ssd(32, 1.0, a, b, bitdepth)
            metric = met.SampleMetric(bitdepth, getattr(met.MetricType,
                                                        name), 1.0)
            assert metric.compare(_Qp2(), 0, a, b) == want, (w, h)


class _Qp2:
    distortion_weight = [1.0, 1.0, 1.0]

    @staticmethod
    def get_qp_raw(comp):
        return 32
