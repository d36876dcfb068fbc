"""The PyTorch port's decode slice as a whole (xvc_tpu_torch), on the CPU
device: native parse -> flat reconstruction (ITX, MC, combine, intra
scans) -> device deblock -> frame store, through the user entry points.
(The replay path of the pictures the flat path refuses, every golden
through it: tests/test_torch_recon.py.)

- ai64x48, ai64x48b10 and sp_fast (the goldens whose every picture takes
  the flat path) equal their reference decodes byte for byte, every
  picture conforming, with the picture count asserted;
- a 64x48 picture of a segment with two or four CTU tile rows (one CTU
  row, so one tile with its size word; streams encoded here by the JAX
  package's encoder) equals the JAX package's decode (the tile streams
  at large: tests/test_torch_tiles.py);
- a CUDA device without a card raises;
- a decode in a fresh process never imports jax.
"""
import os
import subprocess
import sys

import pytest
import torch

from xvc_tpu_torch.api import DecoderParameters, DecoderSession
from xvc_tpu_torch.codec.decoder import Decoder, decode_stream

from .util import read_data

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_COUNTS = {"ai64x48": 3, "ai64x48b10": 2, "sp_fast": 6}


def _assert_golden(name, device):
    pics = decode_stream(read_data(name + ".xvc"), device=device)
    assert len(pics) == GOLDEN_COUNTS[name]
    assert all(p.conforming for p in pics), "checksum mismatch"
    assert b"".join(p.bytes for p in pics) == read_data(name + "_dec.yuv")


@pytest.mark.parametrize("name", sorted(GOLDEN_COUNTS))
def test_decode_matches_golden(name):
    _assert_golden(name, "cpu")


def test_session_api_matches_golden():
    """DecoderSession(device=...) with the xvc_tpu.api method set."""
    from xvc_tpu_torch.nal import split_nal_units
    sess = DecoderSession(DecoderParameters(), device="cpu")
    assert sess.device == torch.device("cpu")
    out = []
    for nal in split_nal_units(read_data("sp_fast.xvc")):
        sess.decode_nal(nal)
        while (pic := sess.get_picture()) is not None:
            out.append(pic)
    sess.flush()
    while (pic := sess.get_picture()) is not None:
        out.append(pic)
    assert len(out) == GOLDEN_COUNTS["sp_fast"]
    assert b"".join(p.bytes for p in out) == read_data("sp_fast_dec.yuv")
    assert sess.check_conformance() == (True, 0)


def _tile_stream(tile_rows):
    """One intra 64x48 picture with ``tile_rows`` CTU tile rows (the
    explicit encoder setting ``tile_rows``), by the JAX package."""
    import numpy as np
    from xvc_tpu.codec.encoder import encode_stream
    from xvc_tpu.codec.encoder_settings import EncoderSettings
    from xvc_tpu.nal import write_nal_units
    rng = np.random.RandomState(tile_rows)
    yuv = rng.randint(0, 256, 64 * 48 * 3 // 2).astype(np.uint8).tobytes()
    settings = EncoderSettings()
    settings.initialize_speed(2)
    settings.tile_rows = tile_rows
    return write_nal_units(encode_stream(yuv, 64, 48, 1, qp=32,
                                         settings=settings,
                                         sub_gop_length=1, num_ref_pics=0,
                                         checksum_mode=1))


@pytest.mark.parametrize("tile_rows", [2, 4])
def test_ineligible_pictures_raise(tile_rows):
    """Tile pictures were refused before CTU tile rows were ported; now
    the port's decode equals the JAX package's, conforming."""
    from .encode_clips import jax_session_decode
    data = _tile_stream(tile_rows)
    want = jax_session_decode(data)
    got = decode_stream(data, device="cpu")
    assert len(got) == len(want) == 1
    assert [p.bytes for p in got] == [p.bytes for p in want]
    assert all(p.conforming for p in got + want)


def test_unsupported_options_raise():
    # picture threads are supported since the pipeline was ported
    # (tests/test_torch_threads.py); a device other than cpu/cuda is not
    with pytest.raises(ValueError):
        Decoder("meta")
    with pytest.raises(ValueError):
        Decoder("meta", num_threads=2)


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        decode_stream(read_data("ai64x48.xvc"), device="cuda")
    with pytest.raises(RuntimeError):
        DecoderSession(device="cuda")


def test_decode_never_imports_jax():
    code = (
        "import sys\n"
        "from xvc_tpu_torch.codec.decoder import decode_stream\n"
        "pics = decode_stream(open('tests/data/sp_fast.xvc', 'rb').read(),"
        " device='cpu')\n"
        "assert len(pics) == 6 and all(p.conforming for p in pics)\n"
        "print('jax' in sys.modules, 'jaxlib' in sys.modules)\n")
    env = dict(os.environ)
    env.pop("XVC_DSP", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["False", "False"]


def test_port_sources_never_import_jax():
    pkg = os.path.join(ROOT, "xvc_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for fname in files:
            if fname.endswith(".py"):
                with open(os.path.join(dirpath, fname)) as f:
                    src = f.read()
                assert "import jax" not in src and "from jax" not in src, \
                    fname
