"""The synthetic scan inputs of xvc_tpu_torch/gpu/scan_cases.py hold what
they claim: every mode and LM pair per shape with an inactive row in the
middle, leaves at the far corner of the smallest canvas, LM sums that
wrap int32."""
import numpy as np
import pytest

from xvc_tpu_torch.gpu.scan_cases import (CHROMA_DIMS, CHROMA_LAY, LUMA_DIMS,
                                          LUMA_LAY, corner_case,
                                          lm_wrap_case, shape_case)


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
