"""The port's Python CU encoder on inter pictures (xvc_tpu_torch/codec/
inter_me.py and the inter half of cu_encoder, cu_writer, syntax/writer,
inter_mv and inter_mc) against the JAX package, on the CPU device:

- a 32x32 low-delay clip (3 pictures, one reference) of
  tests/encode_clips.txrd_clip (the random-access clip is in
  tests/test_torch_python_cu_inter_ra.py, so that the two spread over
  the test processes), under XVC_ME=jax and under XVC_ENC_NATIVE=0,
  equal to the JAX package's encode of the same clip under
  XVC_ME=jax: the stream, the per-NAL statistics, the SSE and the
  reconstruction; along the way every merge list
  (``inter_mv.get_merge_candidates``) and MVP list (``get_mvp_list``) the
  search derives equal to the JAX package's, in the same order, and the
  deblocking attributes of every picture's CU tree
  (``ops/deblock.DeblockingFilter.build_cu_attrs``, inter CUs included)
  equal to those the JAX package's deblocking reads (``_build_cu_maps``);
  the port's stream decodes, conforming, to the reconstruction;
- the bit counts and context states of every inter syntax element
  (``syntax/writer.py``) against the JAX package's writer;
- chip_smoke.py's copy of the phase 9 recipe and the references of its
  clips (tests/data/bench/python_cu_inter.json); the port's encode of
  ra64x48_me is held to them in tests/test_torch_me.py.
"""
import json

import numpy as np
import pytest

from xvc_tpu import api as japi
from xvc_tpu.codec import inter_mv as jmv
from xvc_tpu.ops import deblock as jdeblock
from xvc_tpu_torch import api
from xvc_tpu_torch import constants as k
from xvc_tpu_torch.codec import inter_mv as mv
from xvc_tpu_torch.codec import picture_encoder as penc
from xvc_tpu_torch.codec.decoder import decode_stream
from xvc_tpu_torch.gpu import me
from xvc_tpu_torch.ops import deblock

from . import encode_clips as clips
from .test_torch_python_cu import _chip_smoke, assert_same, encode
from .util import data_path

CLIPS = {
    "ld32x32": (3, dict(num_ref_pics=1, sub_gop_length=1, low_delay=1)),
    "ra32x32": (5, dict(num_ref_pics=2, sub_gop_length=4)),
}


def _clip(name):
    frames, kw = CLIPS[name]
    return clips.txrd_clip(32, 32, frames), frames, dict(
        width=32, height=32, qp=32, checksum_mode=1, **kw)


def _merge_key(cands):
    return [(int(c.inter_dir), tuple(c.mv), tuple(c.ref_idx), c.use_lic)
            for c in cands]


def _spy_lists(mp, module, record):
    """Record every merge and MVP list ``module``'s search derives."""
    real_merge = module.get_merge_candidates
    real_mvp = module.get_mvp_list

    def merge(restr, cu, *args):
        out = real_merge(restr, cu, *args)
        record.append(("merge", cu.pos_x, cu.pos_y, cu.width, cu.height,
                       _merge_key(out)))
        return out

    def mvp(restr, cu, ref_list, ref_idx):
        out = real_mvp(restr, cu, ref_list, ref_idx)
        record.append(("mvp", cu.pos_x, cu.pos_y, cu.width, cu.height,
                       ref_list, ref_idx, [tuple(m) for m in out]))
        return out

    mp.setattr(module, "get_merge_candidates", merge)
    mp.setattr(module, "get_mvp_list", mvp)


def jax_reference(name):
    """The JAX package's encode of clip ``name`` under XVC_ME=jax, with
    the lists and the deblocking attributes its search and deblocking
    read."""
    yuv, frames, params = _clip(name)
    lists, attrs = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XVC_ME", "jax")
        mp.delenv("XVC_ENC_NATIVE", raising=False)
        _spy_lists(mp, jmv, lists)
        real = jdeblock.DeblockingFilter.deblock_picture

        def spy(filt):
            if not filt.pic.is_intra_pic():
                attrs.append(filt._build_cu_maps(k.CuTree.PRIMARY)[1])
            return real(filt)

        mp.setattr(jdeblock.DeblockingFilter, "deblock_picture", spy)
        return encode(japi, yuv, frames, **params), lists, attrs


def check_inter_clip(name, switch, ref, monkeypatch):
    """The port's encode of clip ``name`` under ``switch`` against the JAX
    package's (``jax_reference``)."""
    yuv, frames, params = _clip(name)
    want, want_lists, want_attrs = ref
    for var in ("XVC_ME", "XVC_ENC_NATIVE", "XVC_INTRA_PREPASS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv(*switch.split("="))
    lists, attrs = [], []
    _spy_lists(monkeypatch, mv, lists)
    real = penc.PictureEncoder._deblock_on_device

    def spy(pic_enc, segment):
        pd = pic_enc.pic_data
        if not pd.is_intra_pic():
            filt = deblock.DeblockingFilter(pd, pic_enc.rec_pic,
                                            pd.beta_offset, pd.tc_offset,
                                            segment.restrictions)
            attrs.append(filt.build_cu_attrs(k.CuTree.PRIMARY)[0])
        return real(pic_enc, segment)

    monkeypatch.setattr(penc.PictureEncoder, "_deblock_on_device", spy)
    me.reset_stats()
    got = encode(api, yuv, frames, **params)
    assert_same(got, want)
    assert lists == want_lists
    assert any(rec[0] == "merge" for rec in lists)
    assert {rec[5] for rec in lists if rec[0] == "mvp"} == {0, 1}
    assert len(attrs) == len(want_attrs) == frames - 1
    for a, b in zip(attrs, want_attrs):
        np.testing.assert_array_equal(a, b)
        assert (a[:, 4] == 0).any()  # inter CUs among the leaves
    if switch == "XVC_ME=jax":
        assert me.STATS["prefetches"] > 0
    else:
        assert me.STATS["prefetches"] == 0
    pics = decode_stream(got[0], device="cpu")
    assert [p.bytes for p in pics] == got[3]
    assert all(p.conforming for p in pics)


@pytest.fixture(scope="module")
def jax_refs():
    return jax_reference("ld32x32")


@pytest.mark.parametrize("switch", ["XVC_ME=jax", "XVC_ENC_NATIVE=0"])
@pytest.mark.parametrize("name", ["ld32x32"])
def test_inter_clip_equals_the_jax_package(name, switch, jax_refs,
                                           monkeypatch):
    check_inter_clip(name, switch, jax_refs, monkeypatch)


class _Cu:
    """The fields the inter syntax elements read of a CU and of its
    left and above neighbours."""

    def __init__(self, depth, w, h, flags=(False, False, False),
                 left=None, above=None):
        self.depth, self.width, self.height = depth, w, h
        self.skip_flag, self.use_affine, self.fullpel_mv = flags
        self._left, self._above = left, above

    def get_cu_left(self):
        return self._left

    def get_cu_above(self):
        return self._above


class _Qp:
    @staticmethod
    def get_qp_raw(comp):
        return 27


def _writers(restr_flags, pic_type):
    from xvc_tpu.bitio import BitWriter as JBitWriter
    from xvc_tpu.restrictions import Restrictions as JRestrictions
    from xvc_tpu.syntax.writer import SyntaxWriter as JSyntaxWriter
    from xvc_tpu_torch.bitio import BitWriter
    from xvc_tpu_torch.restrictions import Restrictions
    from xvc_tpu_torch.syntax.writer import SyntaxWriter
    out = []
    for W, R, B in ((JSyntaxWriter, JRestrictions, JBitWriter),
                    (SyntaxWriter, Restrictions, BitWriter)):
        r = R()
        for name in restr_flags:
            setattr(r, name, True)
        out.append(W.rdo_clone(W(_Qp(), pic_type, B(), r), 0))
    return out


def _inter_elements(rng):
    """(method, args) calls of every inter element, with CUs whose
    neighbours flip the contexts."""
    cus = []
    for i in range(12):
        flags = tuple(bool(b) for b in rng.randint(0, 2, 3))
        left = _Cu(1, 16, 16, tuple(bool(b) for b in rng.randint(0, 2, 3)))
        above = None if i % 3 == 0 else _Cu(
            2, 8, 8, tuple(bool(b) for b in rng.randint(0, 2, 3)))
        cus.append(_Cu(i % 5, 4 << (i % 5), 4 << ((i + 2) % 5), flags,
                       left if i % 4 else None, above))
    calls = []
    for i, cu in enumerate(cus):
        calls += [
            ("write_skip_flag", (cu, bool(i % 2))),
            ("write_pred_mode", (k.PredictionMode(i % 2),)),
            ("write_merge_flag", (bool(i % 3),)),
            ("write_merge_idx", (i % k.NUM_INTER_MERGE_CANDIDATES,)),
            ("write_inter_dir", (cu, k.InterDir(i % 3))),
            ("write_inter_ref_idx", (i % 4, 1 + i % 4)),
            ("write_inter_mvd", ((int(rng.randint(-300, 301)),
                                  int(rng.randint(-3, 4))),)),
            ("write_inter_mvd", ((0, int(rng.randint(-70000, 70001))),)),
            ("write_inter_mvp_idx", (cu, i % k.NUM_INTER_MV_PREDICTORS)),
            ("write_inter_fullpel_mv_flag", (cu, bool(i % 2))),
            ("write_affine_flag", (cu, bool(i % 2), bool(i % 3))),
            ("write_lic_flag", (bool(i % 2),)),
            ("write_root_cbf", (bool(i % 3),)),
            ("write_exp_golomb", (int(rng.randint(0, 5000)), i % 3)),
            ("write_unary_max_symbol", (i % 5, 4, 7, 8)),
        ]
    return calls


@pytest.mark.parametrize("restr", [
    (), ("disable_inter_mvd_greater_than_flags",),
    ("disable_cabac_skip_flag_ctx", "disable_cabac_inter_dir_ctx",
     "disable_inter_mvp", "disable_ext2_inter_affine",
     "disable_ext2_inter_local_illumination_comp",
     "disable_transform_root_cbf"),
    ("disable_ext_cabac_alt_inter_dir_ctx", "disable_inter_skip_mode",
     "disable_inter_merge_candidates",
     "disable_ext2_inter_adaptive_fullpel_mv",
     "disable_ext2_inter_affine_mvp")])
@pytest.mark.parametrize("pic_type", ["UNI", "BI"])
def test_inter_syntax_elements_count_the_jax_bits(restr, pic_type):
    pt = k.PicturePredictionType[pic_type]
    jw, w = _writers(restr, pt)
    for method, args in _inter_elements(np.random.RandomState(len(restr))):
        getattr(jw, method)(*args)
        getattr(w, method)(*args)
        assert w.get_num_written_bits() == jw.get_num_written_bits(), method
        assert w.get_fractional_bits() == jw.get_fractional_bits(), method
        assert np.array_equal(w.ctx.state, jw.ctx.state), method
    assert w.get_num_written_bits() > 0


def _inter_refs():
    with open(data_path("bench/python_cu_inter.json")) as f:
        return json.load(f)


def test_chip_smoke_carries_the_python_cu_inter_recipe():
    """chip_smoke.py phase 9's copies of the clip table and the encoder
    parameters equal tests/encode_clips.py's."""
    from dataclasses import asdict
    smoke = _chip_smoke()
    assert smoke.PYTHON_CU_INTER == clips.PYTHON_CU_INTER
    for name in clips.PYTHON_CU_INTER:
        assert asdict(smoke.python_cu_inter_params(api, name)) == \
            asdict(clips.python_cu_inter_params(api, name))


def test_python_cu_inter_references_describe_the_clips():
    """tests/data/bench/python_cu_inter.json (made by tests/encode_clips.py
    ``make_python_cu_inter_refs``) carries the clips it was made from, a
    NAL per picture after the segment header, plausible PSNRs, and device
    sweeps for every clip."""
    refs = _inter_refs()
    assert refs["clips"] == clips.PYTHON_CU_INTER
    for name, clip in clips.PYTHON_CU_INTER.items():
        assert len(refs[name]["nal_sha256"]) == clip["pictures"] + 1
        assert len(refs[name]["psnr"]) == clip["pictures"]
        assert min(min(p) for p in refs[name]["psnr"]) > 15
        assert 0 < refs[name]["me"]["device_calls"] < \
            refs[name]["me"]["prefetches"]
