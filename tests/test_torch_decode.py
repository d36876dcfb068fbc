"""The PyTorch port's decode slice as a whole (xvc_tpu_torch), on the CPU
device: native parse -> flat reconstruction (ITX, MC, combine, intra
scans) -> device deblock -> frame store, through the user entry points.

- ai64x48, ai64x48b10 and sp_fast (the goldens whose every picture takes
  the flat path) equal their reference decodes byte for byte, every
  picture conforming, with the picture count asserted;
- pictures the flat path cannot decode (LIC in ld64x48, 4:2:2 in
  cf_c422) raise NotImplementedError instead of falling back;
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


@pytest.mark.parametrize("name,reason", [("ld64x48", "LIC"),
                                         ("cf_c422", "chroma format")])
def test_ineligible_pictures_raise(name, reason):
    with pytest.raises(NotImplementedError, match=reason):
        decode_stream(read_data(name + ".xvc"), device="cpu")


def test_unsupported_options_raise():
    with pytest.raises(NotImplementedError):
        Decoder("cpu", num_threads=2)
    with pytest.raises(ValueError):
        Decoder("meta")


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
