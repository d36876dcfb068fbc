"""The port's device motion estimation (xvc_tpu_torch/gpu/me.py) against
the JAX package's (xvc_tpu/tpu/me.py), on the CPU:

- ``sad_sweep_plain`` against ``make_sad_fn`` bit for bit: every CU shape
  from 4x4 to 64x64 (the non-square ones included), SAD and SAD_FAST,
  8, 10, 12 and 16 bit, N = 1, 44, 86 and 754 candidates, always with the
  window's four corners among them;
- the packed buffer the kernel reads (int16 to 15 bit, int32 above),
  through ``device_sads`` on the CPU device, and the checks of the
  wrapper (``sad_sweep``) and of the per-prefetch call;
- ``tz_initial_candidates`` for every search range from 1 to 256;
- ``DeviceSadTable.prefetch`` against the JAX table on a 1280x720
  reference plane: CU positions and candidate lists that take each of
  the three host routes (a metric other than SAD, a box over the window,
  a window outside the padded plane) and the device route, with the
  same cache, the same ``dist`` values and the routes counted in
  ``STATS``;
- the block metrics the inter search picks (``ops/metrics.py``
  ``SampleMetric``, the native ``xvcn_metric``) against the JAX package's
  numpy metrics.

The port's encode of ra64x48_me is in tests/test_torch_me_ra64x48.py.
"""
import numpy as np
import pytest
import torch

from xvc_tpu.ops import metrics as jmet
from xvc_tpu.tpu import me as jme
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


def _inputs(w, h, bitdepth, n, seed):
    rng = np.random.RandomState(seed)
    win = rng.randint(0, 1 << bitdepth, (me.WIN, me.WIN)).astype(np.int32)
    orig = rng.randint(0, 1 << bitdepth, (h, w)).astype(np.int32)
    # a run of extreme samples, so that the sums are as large as they get
    win[:h, :w] = (1 << bitdepth) - 1
    orig[::3] = 0
    ys = rng.randint(0, me.WIN - h + 1, n)
    xs = rng.randint(0, me.WIN - w + 1, n)
    corners = [(0, 0), (0, me.WIN - w), (me.WIN - h, 0),
               (me.WIN - h, me.WIN - w)]
    for j, (y, x) in enumerate(corners[:n]):
        ys[j], xs[j] = y, x
    return win, orig, np.stack([ys, xs]).astype(np.int32)


@pytest.mark.parametrize("w,h,fast,bitdepth,n", _sweep_cases())
def test_sad_sweep_plain_equals_make_sad_fn(w, h, fast, bitdepth, n):
    win, orig, cands = _inputs(w, h, bitdepth, n, seed=w * 131 + h + fast)
    want = np.asarray(jme.make_sad_fn(w, h, fast, bitdepth, n)(
        win, orig, cands))
    got = me.sad_sweep_plain(torch.from_numpy(win), torch.from_numpy(orig),
                             torch.from_numpy(cands), fast, bitdepth)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the packed route: the kernel's buffer on the CPU device
    packed = me.device_sads(win, orig, cands, fast, bitdepth, "cpu")
    np.testing.assert_array_equal(packed, want)


@pytest.mark.parametrize("bitdepth", BITDEPTHS)
def test_the_packed_buffer_holds_the_samples(bitdepth):
    """int16 up to 15 bit, int32 above, the layout window, orig, y, x."""
    win, orig, cands = _inputs(8, 4, bitdepth, 44, seed=bitdepth)
    dt = me.packed_dtype(bitdepth)
    assert dt == (torch.int16 if bitdepth <= 15 else torch.int32)
    size = me.packed_size(me.WIN, me.WIN, 4, 8, 44)
    buf = torch.empty(size, dtype=dt)
    me.pack(win, orig, cands, buf.numpy())
    views = me.unpack(buf, me.WIN, me.WIN, 4, 8, 44)
    for got, want in zip(views, (win, orig, cands)):
        np.testing.assert_array_equal(got.to(torch.int32).numpy(), want)


def test_sad_sweep_checks_its_inputs():
    win, orig, cands = _inputs(8, 8, 8, 4, seed=1)
    with pytest.raises(ValueError):  # a block leaves the window
        bad = cands.copy()
        bad[1, 0] = me.WIN - 7
        me.device_sads(win, orig, bad, False, 8, "cpu")
    with pytest.raises(ValueError):  # a bit depth the kernel lacks
        me.device_sads(win, orig, cands, False, 17, "cpu")
    dims = (me.WIN, me.WIN, 8, 8, 4)
    buf = torch.empty(me.packed_size(*dims), dtype=me.packed_dtype(8))
    me.pack(win, orig, cands, buf.numpy())
    with pytest.raises(ValueError):  # neither the CPU nor the card
        me.sad_sweep(buf.to("meta"), dims, False, 8)
    with pytest.raises(ValueError):  # not the packed element type
        me.sad_sweep(buf.int(), dims, False, 8)
    with pytest.raises(ValueError):  # shorter than its dimensions
        me.sad_sweep(buf[:-1], dims, False, 8)
    t = [torch.from_numpy(a) for a in (win, orig, cands)]
    np.testing.assert_array_equal(
        me.sad_sweep(buf, dims, True, 8).numpy(),
        me.sad_sweep_plain(*t, True, 8).numpy())


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


class _Ref:
    """A padded 1280x720 luma plane (padding 80, as the encoder's)."""

    def __init__(self, plane):
        self._plane = plane
        self.pad_x = [80, 40, 40]
        self.pad_y = [80, 40, 40]

    def padded_plane(self, comp):
        return self._plane


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
    ref, cu, qp = _Ref(plane), _Cu(x, y, w, h), _Qp()
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
    else:
        assert not tab.cache
        assert me.STATS["device_calls"] == 0
        assert me.STATS["host_routed"] == 1
    for t in (jtab, tab):  # mostly cached, or a box that fits
        t.prefetch(qp, mvs[:5] + [(1, 1)])
    assert tab.cache == jtab.cache
    assert me.STATS["prefetches"] == 2
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
