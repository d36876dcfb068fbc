"""CTU tile rows through the port's encoder (the Python CU encoder's tile
loop, codec/picture_encoder.py ``_encode_tiles``) on the CPU device,
against the JAX package's EncoderSession on tests/encode_clips.py
``synthetic_yuv420``: equal NALs, per-NAL statistics, SSE and
reconstructions, and the port's decode of its stream equal to the
reconstruction, for

- an intra 64x192 picture in 3 tiles (at 64 wide a CU on a tile top
  takes the per-CU pre-pass with the tile cut, which the JAX package's
  host route reads; narrower pictures never showed the difference);
- ``tile_rows 1``, which is the plain stream;

and tests/data/bench/python_cu_tiles.json (the JAX package's stream and
counts of qcif_tiles, the clip chip_smoke.py phase 11 encodes on the
card) describes tests/encode_clips.py's recipe, as does the script's
copy.

Inter clips and encoder threads: tests/test_torch_tiles_encode_inter.py.
"""
import json

import pytest

from xvc_tpu import api as japi
from xvc_tpu_torch import api
from xvc_tpu_torch.codec.decoder import decode_stream

from . import encode_clips as clips
from .test_torch_python_cu import _chip_smoke, assert_same, encode
from .util import data_path


@pytest.fixture(autouse=True)
def _clean_routes(monkeypatch):
    for name in ("XVC_ENC_NATIVE", "XVC_INTRA_PREPASS", "XVC_ME"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("XVC_THREADS_NO_CLAMP", "1")


def params_of(w, h, tile_rows, **kw):
    return dict(width=w, height=h, qp=32, speed_mode=2, checksum_mode=1,
                explicit_encoder_settings="tile_rows %d" % tile_rows, **kw)


def both(yuv, frames, params):
    """The JAX package's and the port's encodes, held equal; the port's
    stream decodes, conforming, to its reconstruction."""
    want = encode(japi, yuv, frames, **params)
    got = encode(api, yuv, frames, **params)
    assert_same(got, want)
    pics = decode_stream(got[0], device="cpu")
    assert all(p.conforming for p in pics)
    assert [p.bytes for p in pics] == got[3]
    return got


def test_intra_tiles():
    w, h = 64, 192
    both(clips.synthetic_yuv420(w, h, 1, 5), 1,
         params_of(w, h, 3, num_ref_pics=0, sub_gop_length=1))


def test_tile_rows_1_is_the_plain_stream():
    w, h = 64, 128
    yuv = clips.synthetic_yuv420(w, h, 1, 2)
    plain = params_of(w, h, 0, num_ref_pics=0, sub_gop_length=1)
    one = params_of(w, h, 1, num_ref_pics=0, sub_gop_length=1)
    got = encode(api, yuv, 1, **one)
    assert_same(got, encode(api, yuv, 1, **plain))
    assert_same(got, encode(japi, yuv, 1, **one))


def test_chip_smoke_carries_the_tile_recipes():
    """chip_smoke.py phase 11's copies of the qcif_tiles table and the
    names and pictures of the tile streams equal tests/encode_clips.py's,
    and python_cu_tiles.json records that table."""
    from dataclasses import asdict
    with open(data_path("bench/python_cu_tiles.json")) as f:
        refs = json.load(f)
    assert refs["clips"] == clips.PYTHON_CU_TILES
    assert set(refs["qcif_tiles"]) >= {"sha256", "rec_sha256", "me"}
    smoke = _chip_smoke()
    assert smoke.PYTHON_CU_TILES == clips.PYTHON_CU_TILES
    assert asdict(smoke.python_cu_tiles_params(api)) == \
        asdict(clips.python_cu_inter_params(api, "qcif_tiles"))
    assert smoke.TILE_STREAMS == {
        name: c["frames"] for name, c in clips.TILE_STREAMS.items()}
