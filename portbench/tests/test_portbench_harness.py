"""The harness's data and arithmetic."""
import math
import os
import types

import numpy as np
import pytest

from portbench import harness, spec, stats
from portbench.metrics import picture_kernels_roofline
from portbench.reference import work
from portbench.reference.xvcref import constants as k
from portbench.trace import Trace, kernel_name

BENCH = spec.load_benchmark()


def test_every_entry_resolves_by_name():
    """A cell, a configuration, a mix and a metric are files found by the
    names in BENCHMARK.json."""
    for cfg in BENCH["configs"]:
        assert os.path.join(spec.ROOT, cfg["file"]) == \
            spec.config_file(cfg["name"])
        loaded = spec.load_config(cfg["name"])
        assert os.path.exists(loaded["stream_path"])
        assert os.path.exists(loaded["hashes_path"])
        assert os.path.exists(loaded["work_path"])
        assert len(harness.expected_pictures(loaded)) == loaded["pictures"]
        assert set(harness.read_work(loaded)) == set(work.KINDS)
        assert loaded["reduced"] == cfg["reduced"]
    for cell in BENCH["workloads"]:
        c, cfg, traffic, e2e, per_layer = spec.cell_spec(BENCH, cell["name"])
        assert cfg["name"] == cell["config"]
        assert traffic["loop"] in ("closed", "open")
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert per_layer
    for m in BENCH["per_layer"]:
        assert callable(spec.reader(m["name"]))
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
    assert spec.reader_module("parse_ms.farm") == "portbench.metrics.parse_ms"


def test_rate_is_all_pictures_over_the_window():
    assert stats.rate(3 * 1920 * 1080, 2.0) == 3 * 1920 * 1080 / 2.0
    with pytest.raises(ValueError):
        stats.rate(1, 0)


def client(schedule, delivered, in_window=None):
    return types.SimpleNamespace(
        schedule=schedule, in_window=len(schedule) if in_window is None
        else in_window, delivered=[(t, None) for t in delivered])


def test_tail_counts_late_and_missing_pictures():
    # 20 pictures due at 0..19 s, each handed out 0.01 s late but the 5th
    # 3 s late; the last two never come: the check gave up at 100 s
    c = client([float(i) for i in range(20)],
               [i + (3.0 if i == 4 else 0.01) for i in range(18)])
    lat = harness._live_latencies([c], 100.0)
    assert len(lat) == 20
    assert lat[18] == 100.0 - 18 and lat[19] == 100.0 - 19
    # nearest rank: the 19th of 20 values
    assert stats.tail(lat) == pytest.approx(100.0 - 19)
    assert stats.tail([1.0] * 19 + [math.inf]) == 1.0
    assert stats.tail([1.0] * 18 + [math.inf] * 2) == math.inf
    # only the pictures due inside the window
    c2 = client([0.0, 1.0, 2.0], [0.5, 1.5, 2.5], in_window=2)
    assert harness._live_latencies([c2], 9.0) == [0.5, 0.5]


def test_idle_share_is_the_union_of_overlapping_intervals():
    iv = [(0.0, 1.0), (0.5, 1.5), (3.0, 4.0), (3.2, 3.4), (9.0, 12.0)]
    assert stats.union_seconds(iv) == pytest.approx(1.5 + 1.0 + 3.0)
    assert stats.union_seconds(iv, 0.25, 10.0) == pytest.approx(
        1.25 + 1.0 + 1.0)
    assert stats.gaps(iv, 0.0, 10.0) == [(4.0, 9.0), (1.5, 3.0)]
    tr = Trace([("a", 0.0, 1.0), ("b", 0.5, 1.5), ("c", 3.0, 4.0)],
               (0.0, 5.0))
    assert tr.busy_s() == pytest.approx(2.5)
    tr.add_host(0, [("decode_nal", 0.0, 2.5), ("flat.build", 1.6, 1.7),
                    ("decode.parse", 1.55, 2.2)])
    tr.add_host(1, [("sleep", 1.0, 4.0)])
    # the idle stretches (1.5, 3.0) and (4.0, 5.0), named at 2.25 and 4.5
    assert tr.idle_by_host() == {"decode_nal x1 + sleep x1": 1.5,
                                 "no client in a call": 1.0}
    # the innermost range open: the one that opened last
    assert tr.host_at(1.65) == "flat.build x1 + sleep x1"
    assert tr.host_at(1.8) == "decode.parse x1 + sleep x1"


def test_trace_is_put_on_the_host_clock(tmp_path):
    """A client's trace, on the profiler's clock, moves onto
    ``perf_counter``'s by the mark it holds."""
    import json
    from portbench import client
    events = [{"ph": "X", "cat": "user_annotation", "name": client.MARK,
               "ts": 1000000.0, "dur": 1.0},
              {"ph": "X", "cat": "kernel", "name": "luma_walk<0>",
               "ts": 1500000.0, "dur": 2000.0},
              {"ph": "X", "cat": "user_annotation", "name": "flat.build",
               "ts": 1400000.0, "dur": 300000.0},
              {"ph": "X", "cat": "cpu_op", "name": "aten::add",
               "ts": 1400000.0, "dur": 10.0}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    device, host = client.read_trace(str(path), 50.0)
    assert device == [["luma_walk<0>", pytest.approx(50.5),
                       pytest.approx(50.502)]]
    assert host == [["flat.build", pytest.approx(50.4), pytest.approx(50.7)]]
    assert not path.exists()


def test_kernel_names():
    assert kernel_name("void (anonymous namespace)::luma_walk<1>(short*, "
                       "int const*)") == "luma_walk"
    assert kernel_name("(anonymous namespace)::itx_picture_kernel(int "
                       "const*, (anonymous namespace)::ItxCfg)") == \
        "itx_picture_kernel"
    assert kernel_name("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"


class _Cu:
    def __init__(self, x, y, w, h, cbf, inter=False, lists=0):
        self.pos_x, self.pos_y, self.width, self.height = x, y, w, h
        self.cbf = cbf
        self.split = k.SplitType.NONE
        self.inter = inter
        self.lists = lists

    def pos(self, comp):
        return (self.pos_x, self.pos_y) if comp == 0 else \
            (self.pos_x // 2, self.pos_y // 2)

    def size(self, comp):
        return (self.width, self.height) if comp == 0 else \
            (self.width // 2, self.height // 2)

    def is_inter(self):
        return self.inter

    def has_mv(self, ref_list):
        return ref_list < self.lists


def test_roofline_bytes_agree_with_a_hand_count():
    """A 72x40 picture of one CTU with three leaves; the reads of two
    overlapping 8x8 windows in one reference plane."""
    leaves = [_Cu(0, 0, 64, 32, [True, True, False]),       # intra
              _Cu(64, 0, 16, 16, [True, False, False], True, 2),  # bi
              _Cu(0, 32, 8, 8, [False, False, False], True, 1)]
    root = _Cu(0, 0, 128, 128, None)
    root.split = k.SplitType.QUAD
    root.sub_cus = leaves
    rec = types.SimpleNamespace(width=[72, 36, 36], height=[40, 20, 20],
                                chroma_format=k.ChromaFormat.YUV420,
                                plane_view=lambda c: np.zeros((1, 1)))
    pd = types.SimpleNamespace(
        poc=0, deblock=True, has_secondary_cu_tree=lambda: False,
        get_components=lambda tree: [0, 1, 2],
        get_number_of_ctus=lambda: 1, get_ctu=lambda tree, i: root)
    counter = work._Counter()
    ref_pic = types.SimpleNamespace(padded_plane=lambda c: np.zeros((64, 96)))
    counter.read(ref_pic, 0, 10, 10, 8, 8)
    counter.read(ref_pic, 0, 14, 14, 8, 8)
    counter.parsed(types.SimpleNamespace(pic_data=pd, rec_pic=rec))
    w, _ = counter.pending[0]
    # ITX: the 64x32 luma block (32x32 coefficients, all 64x32 residual
    # samples inside), its 32x16 U block; the 16x16 luma block, 8 of its
    # 16 columns inside the picture
    assert w["itx"] == (32 * 32 * 4 + 64 * 32 * 4) + \
        (32 * 16 * 4 + 32 * 16 * 4) + (16 * 16 * 4 + 8 * 16 * 4)
    # MC: the window union (64 + 64 - 16 samples), the bi leaf's two
    # predictions of each component inside (8x16, 4x8, 4x8) and the uni
    # leaf's one (8x8, 4x4, 4x4), int16
    assert w["mc"] == (64 + 64 - 16) * 2 + \
        2 * (8 * 16 + 2 * 4 * 8) * 2 + (8 * 8 + 2 * 4 * 4) * 2
    assert w["deblock_edges"] == 3 * 16


def test_roofline_share_of_a_trace():
    """Two pictures' bytes over the kernels' device time."""
    tr = Trace([("(anonymous namespace)::itx_picture_kernel(int*)", 1.0,
                 1.0 + 2e-5),
                ("(anonymous namespace)::itx_picture_kernel(int*)", 2.0,
                 2.0 + 2e-5),
                ("void (anonymous namespace)::luma_walk<0>(short*)", 3.0,
                 3.0 + 6e-5),
                ("void at::native::elementwise_kernel<4>(int)", 4.0, 5.0)],
               (0.0, 10.0))
    run = harness.Run(trace=tr, work={"itx": 1e6, "mc": 2e6,
                                      "deblock_luma": 5e5,
                                      "deblock_chroma": 0,
                                      "deblock_edges": 1e4})
    expect = 100.0 * 2 * 3.51e6 / 3.35e12 / 1e-4
    assert picture_kernels_roofline.read(run) == pytest.approx(expect)
    assert picture_kernels_roofline.read(harness.Run()) is None


def test_spread_is_the_interquartile_share_of_the_median():
    v = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = 10.75, 12.5, 14.25
    assert stats.spread(v) == pytest.approx((q3 - q1) / med)
