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


SPLICE = "splice96x64to64x48"


def test_splice_alternative_is_stored_without_an_upload(monkeypatch):
    """The splice's alternative reconstruction is written to its
    frame-store slot by the one resample call that makes it: right after
    it the picture has its slot, and no reference slot is ever uploaded
    from the host (``ensure_slot`` moves no byte); the pictures equal the
    JAX package's host decode."""
    from xvc_tpu_torch.codec import picture_decoder
    from xvc_tpu_torch import profiling
    from xvc_tpu_torch.gpu import flat_recon

    from .test_torch_recon import jax_host_decode
    made = []
    generate = picture_decoder.PictureDecoder.generate_alternative_rec_pic

    def spy(self, *args, **kw):
        alt = generate(self, *args, **kw)
        made.append(str(self.device) in flat_recon._slot_map(alt))
        return alt

    uploaded = []
    ensure = flat_recon._ensure_slot

    def ensure_spy(rec_pic, device):
        before = profiling.counted("xfer.htod")
        slot = ensure(rec_pic, device)
        uploaded.append(profiling.counted("xfer.htod") - before)
        return slot

    monkeypatch.setattr(picture_decoder.PictureDecoder,
                        "generate_alternative_rec_pic", spy)
    monkeypatch.setattr(flat_recon, "_ensure_slot", ensure_spy)
    bs = read_data(SPLICE + ".xvc")
    pics = decode_all(bs)
    want = jax_host_decode(bs)
    assert [(p.poc, p.conforming, p.bytes) for p in pics] == \
        [(p.poc, p.conforming, p.bytes) for p in want]
    assert made == [True]
    assert uploaded and not any(uploaded)


@pytest.mark.parametrize("size", [(48, 32), (80, 60)])
def test_resized_threaded_decode_equals_sequential(monkeypatch, size):
    """Output resizing of a random-access stream (its highest-layer
    pictures keep their buffer's old border, read through the ring) with
    two picture threads equals the sequential decode and the JAX
    package's."""
    from .encode_clips import jax_session_decode
    monkeypatch.setenv("XVC_THREADS_NO_CLAMP", "1")
    bs = read_data("ra64x48.xvc")
    kw = dict(output_width=size[0], output_height=size[1])
    seq = decode_all(bs, **kw)
    thr = decode_all(bs, threads=2, **kw)
    want = jax_session_decode(bs, **kw)
    for pics in (thr, want):
        assert [(p.poc, p.conforming, p.bytes) for p in pics] == \
            [(p.poc, p.conforming, p.bytes) for p in seq]
    assert len(seq) == 10
