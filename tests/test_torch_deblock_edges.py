"""The port's deblocking edge derivation (xvc_tpu_torch) against the JAX
package's host derivation: equal exactly (integers, tolerance 0).

The same picture goes through ``xvc_tpu.ops.deblock.DeblockingFilter.
_build_cu_maps`` + ``xvc_tpu.tpu.deblock_jax.compute_edge_metadata`` /
``luma_edge_tensors`` / ``chroma_edge_tensors`` and through the port's
``build_cu_attrs`` + ``edge_params`` (on the CPU its plain version, map
paint included), whose packed entries ``luma_tensors`` /
``chroma_tensors`` unpack into the JAX tensors:

- synthetic pictures tiled with random CUs (``gpu/deblock_cases.py``),
  over both directions, sub-block 4 and 8, bi- and uni-predicted and
  intra pictures, the three restriction flags, 8 and 10 bit, 4:2:0, and
  picture sizes that are no multiple of 8;
- the real parse records of every picture of ai64x48, ai64x48b10 and
  sp_fast, captured while the port decodes them;
- on those records, the map paint does not depend on the order of the
  CUs: every cell is covered by exactly one leaf.
"""
import numpy as np
import pytest
import torch

from xvc_tpu import constants as jk
from xvc_tpu.ops import deblock as jdbk
from xvc_tpu.restrictions import Restrictions as JRestrictions
from xvc_tpu.tpu import deblock_jax as jdb
from xvc_tpu_torch.codec import picture_decoder
from xvc_tpu_torch.codec.decoder import decode_stream
from xvc_tpu_torch.gpu import deblock
from xvc_tpu_torch.gpu import deblock_cases as cases
from xvc_tpu_torch.ops import deblock as dbk

from .util import read_data

RESTR = {"none": (), "bs_zero": ("disable_deblock_boundary_strength_zero",),
         "bs_one": ("disable_deblock_boundary_strength_one",),
         "fixed_qp": ("disable_deblock_depending_on_qp",)}


def _restr_flags(restr):
    return (restr.disable_deblock_boundary_strength_zero,
            restr.disable_deblock_boundary_strength_one,
            restr.disable_deblock_depending_on_qp)


def _assert_edges_equal(pic, cu_tree, sbs, beta_off, tc_off, bd, restr,
                        csx, csy, do_luma, do_chroma):
    """One CU tree of ``pic`` through both packages; returns how many
    (luma, chroma) entries were compared."""
    jfilt = jdbk.DeblockingFilter(pic, None, beta_off, tc_off, restr)
    cu_map, attrs = jfilt._build_cu_maps(cu_tree)
    pattrs, n_cus = dbk.DeblockingFilter(
        pic, None, beta_off, tc_off, restr).build_cu_attrs(cu_tree)
    np.testing.assert_array_equal(pattrs, attrs)
    lay = deblock.EdgeLayout(pic.width, pic.height, sbs, csx, csy, do_luma,
                             do_chroma)
    pred_bi = pic.get_prediction_type() == jk.PicturePredictionType.BI
    pmap, params = deblock.edge_params(
        torch.from_numpy(pattrs), n_cus, lay, beta_off, tc_off, bd, pred_bi,
        _restr_flags(restr))
    np.testing.assert_array_equal(pmap.numpy(), cu_map)
    assert params.dtype == torch.int32 and params.shape == (lay.total,)
    compared = [0, 0]
    for d in (0, 1):
        meta = jdb.compute_edge_metadata(pic, cu_map, attrs, d, sbs,
                                         beta_off, tc_off, restr)
        assert len(meta["xs"]) == lay.nx[d]
        if not lay.nx[d]:
            continue
        if do_luma:
            want = jdb.luma_edge_tensors(meta, sbs, beta_off, tc_off, bd)
            xs, *got = deblock.luma_tensors(params, lay, d)
            np.testing.assert_array_equal(xs.numpy(), meta["xs"])
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), w.astype(np.int32))
            compared[0] += want[0].size
        else:
            assert lay.luma_off[d] < 0
        want = jdb.chroma_edge_tensors(meta, d, sbs, tc_off, bd, csx, csy) \
            if do_chroma else None
        if want is None:
            assert lay.chroma_off[d] < 0
            continue
        got = deblock.chroma_tensors(params, lay, d)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.astype(np.int32))
        compared[1] += want[1].size
    return compared


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("restr_name", sorted(RESTR))
@pytest.mark.parametrize("pred_type", [0, 1, 2], ids=["bi", "uni", "intra"])
@pytest.mark.parametrize("sbs", [4, 8])
@pytest.mark.parametrize("size", cases.EDGE_SIZES,
                         ids=["%dx%d" % s for s in cases.EDGE_SIZES])
def test_edge_params_match_jax_on_tiled_pictures(size, sbs, pred_type,
                                                 restr_name, bd):
    restr = JRestrictions()
    for name in RESTR[restr_name]:
        setattr(restr, name, True)
    pic = cases.tiled_picture(sum(size) + sbs + pred_type, *size, pred_type)
    n_luma, n_chroma = _assert_edges_equal(
        pic, 0, sbs, beta_off=2 - sbs // 4, tc_off=sbs // 4 - 3, bd=bd,
        restr=restr, csx=1, csy=1, do_luma=True, do_chroma=True)
    assert n_luma > 0 and n_chroma > 0


def test_tiled_pictures_reach_every_branch():
    """The synthetic pictures are worth the name: every boundary
    strength, both sides of each motion test and every corner occur."""
    pic = cases.tiled_picture(3, 64, 48, 0)
    filt = dbk.DeblockingFilter(pic, None, 0, 0, None)
    attrs, n = filt.build_cu_attrs(0)
    cu_map = deblock.paint_cu_map_plain(attrs, n, 12, 16)
    assert (cu_map >= 0).all()
    for d in (0, 1):
        for bi in (False, True):
            meta = deblock.compute_edge_metadata(64, 48, bi, cu_map, attrs,
                                                 d, 4, (False, False, False))
            assert set(np.unique(meta["bs"])) == {0, 1, 2}
    inter = attrs[attrs[:, 4] == 0]
    assert (inter[:, 8] != inter[:, 9]).any()
    assert (inter[:, 8] == inter[:, 9]).any()
    assert (attrs[:, 3] > 8).any() and (attrs[:, 2] > 8).any()


def _capture_pictures(name, check):
    """Decode ``name`` with the port on the CPU and call ``check(filt)``
    for every picture before it is deblocked."""
    orig = picture_decoder.deblock_picture
    seen = []

    def hook(filt, planes, device):
        seen.append(check(filt))
        return orig(filt, planes, device)

    mp = pytest.MonkeyPatch()
    mp.setattr(picture_decoder, "deblock_picture", hook)
    try:
        pics = decode_stream(read_data(name + ".xvc"), device="cpu")
    finally:
        mp.undo()
    assert pics and all(p.conforming for p in pics)
    assert len(seen) == len(pics)
    return seen


@pytest.mark.parametrize("name", ["ai64x48", "ai64x48b10", "sp_fast"])
def test_edge_params_match_jax_on_parsed_pictures(name):
    def check(filt):
        pic, rec = filt.pic, filt.rec
        passes, _ = deblock.picture_passes(filt)
        total = [0, 0]
        for cu_tree, lay in passes:
            got = _assert_edges_equal(
                pic, cu_tree, lay.sbs, filt.beta_offset, filt.tc_offset,
                pic.bitdepth, filt.restr, rec.shift_x[1], rec.shift_y[1],
                lay.luma_off[0] >= 0, lay.chroma_off[0] >= 0)
            total = [a + b for a, b in zip(total, got)]
        return total

    seen = _capture_pictures(name, check)
    assert all(n_luma > 0 and n_chroma > 0 for n_luma, n_chroma in seen)


@pytest.mark.parametrize("name", ["ai64x48", "sp_fast"])
def test_leaves_of_a_tree_cover_every_cell_once(name):
    """So the paint needs no order: the map is the same whichever leaf
    is written first."""
    def check(filt):
        pic = filt.pic
        map_w, map_h = (pic.width + 3) >> 2, (pic.height + 3) >> 2
        trees = [0, 1] if pic.has_secondary_cu_tree() else [0]
        for cu_tree in trees:
            attrs, n = filt.build_cu_attrs(cu_tree)
            cover = np.zeros((map_h, map_w), np.int32)
            for x, y, w, h in attrs[:n, 0:4]:
                cover[y >> 2:(y + h + 3) >> 2, x >> 2:(x + w + 3) >> 2] += 1
            assert (cover == 1).all()
            fwd = deblock.paint_cu_map_plain(attrs, n, map_h, map_w)
            rev = deblock.paint_cu_map_plain(attrs[n - 1::-1], n, map_h,
                                             map_w)
            np.testing.assert_array_equal(rev, n - 1 - fwd)
        return len(trees)

    assert sum(_capture_pictures(name, check)) > 0
