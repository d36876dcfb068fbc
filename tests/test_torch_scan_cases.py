"""The synthetic scan inputs of xvc_tpu_torch/gpu/scan_cases.py hold what
they claim: every mode and LM pair per shape with an inactive row in the
middle, leaves at the far corner of the smallest canvas, LM sums that
wrap int32, and CTUs tiled in z-order as the codec lays them out (inside
the scans' dependency contract, with holes, every mode and LM), also with
the leaves of two CTUs taken in turn (still inside the contract, but not
in the kernels' wavefront ticket order)."""
import numpy as np
import pytest

from xvc_tpu_torch.gpu import scan_deps
from xvc_tpu_torch.gpu.scan_cases import (CHROMA_DIMS, CHROMA_LAY, LUMA_DIMS,
                                          LUMA_LAY, TILED_CTUS, corner_case,
                                          lm_wrap_case, shape_case,
                                          tiled_case)


# ---------------------------------------------------------------------------
# The families hold what they claim
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,lay,dims", [("luma", LUMA_LAY, LUMA_DIMS),
                                           ("chroma", CHROMA_LAY,
                                            CHROMA_DIMS)])
def test_shape_case_covers_every_mode_with_an_inactive_row(kind, lay, dims):
    for w, h in ((dims[0], dims[4]), (dims[2], dims[2])):
        case = shape_case(kind, w, h, 8)
        meta = case["meta"]
        live = meta[meta[:, lay["active"]] != 0]
        assert (live[:, lay["w"]] == w).all() and \
            (live[:, lay["h"]] == h).all()
        plain = live if kind == "luma" else live[live[:, lay["is_lm"]] == 0]
        assert sorted(plain[:, lay["mode"]]) == list(range(67))
        dead = np.flatnonzero(meta[:, lay["active"]] == 0)
        assert len(dead) == 1 and 0 < dead[0] < len(meta) - 1
        assert case["plane"].dtype == np.int16 and \
            case["resi"].dtype == np.int32 and meta.dtype == np.int32
        if kind == "chroma":
            lm = live[live[:, lay["is_lm"]] != 0]
            pairs = {(int(r[lay["has_l"]]), int(r[lay["has_a"]]),
                      int(r[lay["plane"]])) for r in lm}
            assert len(pairs) == 8
            assert case["luma"].shape[0] >= 2 * case["plane"].shape[1] - 64


def test_shape_case_is_reproducible_and_differs_by_bitdepth():
    a, b = shape_case("luma", 8, 16, 8), shape_case("luma", 8, 16, 8)
    c = shape_case("luma", 8, 16, 10)
    assert all(np.array_equal(a[k], b[k]) for k in ("plane", "resi", "meta"))
    assert int(c["plane"].max()) > 255 >= int(a["plane"].max())


@pytest.mark.parametrize("kind,lay", [("luma", LUMA_LAY),
                                      ("chroma", CHROMA_LAY)])
def test_corner_case_reaches_the_far_corner(kind, lay):
    case = corner_case(kind, 8)
    meta = case["meta"]
    hp, wp = case["plane"].shape[-2:]
    far = (meta[:, lay["px"]] + meta[:, lay["w"]] == wp - 8) & \
        (meta[:, lay["py"]] + meta[:, lay["h"]] == hp - 8)
    assert far.sum() == len(meta) // 2
    assert (meta[:, lay["mode"]] < 0).any()
    assert meta[-1, lay["active"]] == 0
    if kind == "chroma":
        assert set(meta[:, lay["plane"]]) >= {-1, 0, 1, 2}
        assert (meta[:, lay["is_lm"]] != 0).any()


def test_lm_wrap_case_has_every_pair_on_square_and_flat_blocks():
    case = lm_wrap_case(10)
    meta = case["meta"]
    lay = CHROMA_LAY
    assert (meta[:, lay["is_lm"]] == 1).all()
    shapes = {(int(r[lay["w"]]), int(r[lay["h"]])) for r in meta}
    assert any(w > h for w, h in shapes) and any(w < h for w, h in shapes)
    for w, h in shapes:
        rows = meta[(meta[:, lay["w"]] == w) & (meta[:, lay["h"]] == h)]
        assert {(int(r[lay["has_l"]]), int(r[lay["has_a"]]))
                for r in rows} == {(0, 0), (0, 1), (1, 0), (1, 1)}
    assert case["plane"].min() < -30000 and case["plane"].max() > 30000


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("kind,lay", [("luma", LUMA_LAY),
                                      ("chroma", CHROMA_LAY)])
def test_tiled_case_is_a_picture_in_contract_with_holes(kind, lay, bd):
    case = tiled_case(kind, bd)
    meta = case["meta"]
    U, ctu = (4, 64) if kind == "luma" else (2, 32)
    H, W = case["picture"]
    assert (H, W) == (TILED_CTUS[1] * ctu, TILED_CTUS[0] * ctu)
    assert (meta[:, lay["active"]] == 1).all()
    # inside the contract, with leaves that wait for others
    scheds = scan_deps.analyse(kind, meta, case["plane"].shape)
    for s in (scheds,) if kind == "luma" else scheds:
        assert s.in_contract, s.breach
        assert 1 < s.longest < len(s.rows) and s.widest > 1
    # every mode (chroma: among the rows that are not LM)
    plain = meta if kind == "luma" else meta[meta[:, lay["is_lm"]] == 0]
    assert set(plain[:, lay["mode"]]) == set(range(67))
    # holes: picture units that no row writes
    covered = np.zeros((H // U, W // U), bool)
    for r in meta:
        x, y = r[lay["px"]] // U, r[lay["py"]] // U
        covered[y:y + r[lay["h"]] // U, x:x + r[lay["w"]] // U] = True
    assert 0.05 < 1 - covered.mean() < 0.5
    # mixed shapes; flags as the codec sets them; below-left and
    # above-right runs up to w / h
    assert len({(int(r[lay["w"]]), int(r[lay["h"]])) for r in meta}) >= 6
    assert (meta[:, lay["has_l"]] == (meta[:, lay["px"]] > 0)).all()
    assert (meta[:, lay["has_a"]] == (meta[:, lay["py"]] > 0)).all()
    assert (meta[:, lay["sbl"]] <= meta[:, lay["w"]]).all()
    assert (meta[:, lay["sar"]] <= meta[:, lay["h"]]).all()
    assert (meta[:, lay["sbl"]] > 0).any() and (meta[:, lay["sar"]] > 0).any()
    if kind == "chroma":
        assert (meta[0::2, lay["plane"]] == 0).all() and \
            (meta[1::2, lay["plane"]] == 1).all()
        assert (meta[0::2, 1:] == meta[1::2, 1:]).all()
        assert (meta[:, lay["is_lm"]] != 0).any()


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("kind,lay", [("luma", LUMA_LAY),
                                      ("chroma", CHROMA_LAY)])
def test_interleaved_tiled_case_keeps_the_contract_not_the_tiles(kind, lay,
                                                                 bd):
    """The tiled case's rows in another order: the leaves of CTUs 3 and 4
    (the last of the first CTU row, the first of the second) in turn;
    inside the contract, but no wavefront ticket order."""
    case, base = tiled_case(kind, bd, interleave=True), tiled_case(kind, bd)
    meta = case["meta"]
    assert not np.array_equal(meta, base["meta"])
    assert sorted(map(tuple, meta)) == sorted(map(tuple, base["meta"]))
    for k in ("plane", "resi"):
        np.testing.assert_array_equal(case[k], base[k])
    U, ctu = (4, 64) if kind == "luma" else (2, 32)
    ctus = (meta[:, lay["py"]] // ctu) * TILED_CTUS[0] + \
        meta[:, lay["px"]] // ctu
    runs = [c for k, c in enumerate(ctus) if k == 0 or c != ctus[k - 1]]
    assert runs.count(3) > 1 and runs.count(4) > 1
    assert sorted(set(runs)) == list(range(TILED_CTUS[0] * TILED_CTUS[1]))
    scheds = scan_deps.analyse(kind, meta, case["plane"].shape)
    for s in (scheds,) if kind == "luma" else scheds:
        assert s.in_contract, s.breach
        assert 1 < s.longest < len(s.rows)
        assert scan_deps.wavefront_order(kind, meta, case["plane"].shape,
                                         s) is None
    if kind == "chroma":
        assert (meta[0::2, lay["plane"]] == 0).all() and \
            (meta[1::2, lay["plane"]] == 1).all()
