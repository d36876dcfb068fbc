"""The port's decoder output conversion (xvc_tpu_torch/codec/output.py) on
the CPU device against the ten goldens of tests/test_output_conversion.py,
byte for byte: resizing (the windowed-sinc resampler of gpu/resample.py,
down and up), 4:4:4 (bilinear chroma), monochrome, 10 bit, ARGB with both
colour matrices, the error-feedback dither, and the temporal dropping of
max_framerate (fps15)."""
import pytest

from xvc_tpu_torch import api

from .test_output_conversion import CASES
from .util import read_data


def decode_all(bs, **kw):
    dec = api.DecoderSession(api.DecoderParameters(**kw), device="cpu")
    off = 0
    while off < len(bs):
        ln = int.from_bytes(bs[off:off + 4], "little")
        off += 4
        dec.decode_nal(bs[off:off + ln])
        off += ln
    dec.flush()
    pics = []
    while (p := dec.get_picture()) is not None:
        pics.append(p)
    return pics


GOLDENS = [("ai64x48", "ai64x48_out_%s.yuv" % tag, kw) for tag, kw in CASES]
GOLDENS += [("ai64x48", "ai64x48_out_argb.yuv",
             dict(output_chroma_format=4, output_color_matrix=0)),
            ("ai64x48", "ai64x48_out_argb601.yuv",
             dict(output_chroma_format=4, output_color_matrix=1)),
            ("ai64x48b10", "ai64x48b10_out_dither8.yuv",
             dict(output_bitdepth=8, dither=1)),
            ("ra64x48", "ra64x48_fps15.yuv", dict(max_framerate=15))]


@pytest.mark.parametrize("stream,golden,kw", GOLDENS,
                         ids=[g[1][:-4] for g in GOLDENS])
def test_output_conversion_equals_the_golden(stream, golden, kw):
    pics = decode_all(read_data(stream + ".xvc"), **kw)
    assert pics and all(p.conforming for p in pics)
    assert b"".join(p.bytes for p in pics) == read_data(golden)
    if "max_framerate" in kw:
        assert [p.poc for p in pics] == [0, 4, 8]
        assert pics[0].framerate == 15.0
