"""The port stands on its own: xvc_tpu_torch imports torch and numpy,
never jax and nothing of xvc_tpu.

- In a fresh process whose import system refuses ``jax``, ``jaxlib`` and
  ``xvc_tpu``, every module of the package imports, ai64x48 (the flat
  path) and ld64x48 (LIC: the replay path with its host tail) decode on
  the CPU device to their goldens, ai64x48 resized to 32x24 on output
  (the resampler) with two picture threads to its golden, the 96x64 /
  64x48 splice (its alternative picture rescaled into a frame-store slot)
  with its three tail pictures flagged as in the reference, and a speed-3
  encode (the split DP,
  the transform-RD prepass and the native encoder) and an all-intra
  encode with tpu_intra_lookahead (the Python CU encoder) decode back to
  the encoder's reconstruction, and so does a speed-3 encode through the
  apps (``xvc_tpu_torch.cli``) on two picture threads; a source scan
  finds no import of either in the package or in chip_smoke.py.
- tests/data/bench/<stream>_dec.sha256 of the six bench streams, the
  references chip_smoke.py compares the card's pictures with, equal the
  JAX package's host decode of each stream (drained with the blocking
  pull); so do the hash lists of its resampling decodes (the 720p/1080p
  splice, and three bench streams resized on output), conformance flags
  included, and the script carries the table of those decodes.
- An entry point called with no device asks for the card and raises
  where there is none, instead of decoding on the CPU.
"""
import hashlib
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from .util import data_path, read_data

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "xvc_tpu")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("import of %s is refused here" % name)
        return None


sys.meta_path.insert(0, Refuse())
sys.path.insert(0, sys.argv[1])
import xvc_tpu_torch

names = ["xvc_tpu_torch"]
for mod in pkgutil.walk_packages(xvc_tpu_torch.__path__, "xvc_tpu_torch."):
    importlib.import_module(mod.name)
    names.append(mod.name)
assert len(names) > 30, names
assert "xvc_tpu_torch.profiling" in names, names

from xvc_tpu_torch.codec.decoder import decode_stream
from xvc_tpu_torch.nal import split_nal_units
for stream, golden, count in zip(*[iter(sys.argv[2:])] * 3):
    with open(stream, "rb") as f:
        data = f.read()
    with open(golden, "rb") as f:
        want = f.read()
    pics = decode_stream(data, device="cpu")
    assert len(pics) == int(count) and all(p.conforming for p in pics)
    assert b"".join(p.bytes for p in pics) == want, stream
# output resizing (gpu/resample.py) on two picture threads
# (parallel/pipeline.py)
import os
from xvc_tpu_torch import api
data_dir = os.path.join(sys.argv[1], "tests", "data")
ses = api.DecoderSession(api.DecoderParameters(
    output_width=32, output_height=24, threads=2), device="cpu")
with open(os.path.join(data_dir, "ai64x48.xvc"), "rb") as f:
    for nal in split_nal_units(f.read()):
        ses.decode_nal(nal)
ses.flush()
pics = []
while (pic := ses.get_picture()) is not None:
    pics.append(pic)
with open(os.path.join(data_dir, "ai64x48_out_down32x24.yuv"), "rb") as f:
    assert b"".join(p.bytes for p in pics) == f.read()
# the alternative reconstruction of an open-GOP splice, written to its
# frame-store slot in one call (gpu/resample.resample_to_store): the three
# tail pictures that read it fail their checksum, as in the reference
with open(os.path.join(data_dir, "splice96x64to64x48.xvc"), "rb") as f:
    pics = decode_stream(f.read(), device="cpu")
assert len(pics) == 17 and [p.poc for p in pics if not p.conforming] == \
    [5, 6, 7]
# an encode at speed 3 (the split DP and the transform-RD prepass on the
# device, the native CTU search), decoded back
import numpy as np
rng = np.random.RandomState(2)
w, h, f = 64, 64, 2
luma = rng.randint(0, 256, (h, w)).astype(np.uint8)
luma[:, :32] = 100
yuv = b"".join(np.roll(luma, t, axis=1).tobytes() +
               np.full((h // 2, w), 128, np.uint8).tobytes()
               for t in range(f))
ses = api.EncoderSession(api.EncoderParameters(
    width=w, height=h, speed_mode=3, num_ref_pics=1, sub_gop_length=1,
    low_delay=1, checksum_mode=1), device="cpu")
fs = w * h * 3 // 2
nals = []
for t in range(f):
    nals += ses.encode(yuv[t * fs:(t + 1) * fs])
nals += ses.flush()
from xvc_tpu_torch.nal import write_nal_units
pics = decode_stream(write_nal_units(nals), device="cpu")
assert len(pics) == f and all(p.conforming for p in pics)
assert [p.bytes for p in pics] == ses.rec_pictures
# the Python CU encoder (all-intra, with the lookahead's mode ranking and
# the picture's deblocking on the device), decoded back
for mod in ("codec.cu_encoder", "codec.intra_search", "syntax.writer",
            "cabac.entropy_encoder", "native.engines"):
    assert "xvc_tpu_torch." + mod in names, mod
ses = api.EncoderSession(api.EncoderParameters(
    width=w, height=h, speed_mode=2, num_ref_pics=0, sub_gop_length=1,
    checksum_mode=1, explicit_encoder_settings="tpu_intra_lookahead 1"),
    device="cpu")
nals = ses.encode(yuv[:fs]) + ses.flush()
pics = decode_stream(write_nal_units(nals), device="cpu")
assert len(pics) == 1 and pics[0].conforming
assert pics[0].bytes == ses.rec_pictures[0]
# the apps (python -m xvc_tpu_torch.cli.xvcenc / xvcdec): a threaded
# encode at speed 3 and its threaded decode equal to its reconstruction
import tempfile
from xvc_tpu_torch.cli import xvcdec, xvcenc
with tempfile.TemporaryDirectory() as tmp:
    src, bs, rec, dec = (os.path.join(tmp, n) for n in
                         ("in.yuv", "out.xvc", "rec.yuv", "dec.yuv"))
    with open(src, "wb") as f:
        f.write(yuv)
    assert xvcenc.main(["-input-file", src, "-output-file", bs, "-rec-file",
                        rec, "-input-width", str(w), "-input-height",
                        str(h), "-speed-mode", "3", "-sub-gop-length", "2",
                        "-checksum-mode", "1", "-threads", "2", "-device",
                        "cpu"]) == 0
    assert xvcdec.main(["-bitstream-file", bs, "-output-file", dec,
                        "-threads", "2", "-device", "cpu"]) == 0
    with open(rec, "rb") as f1, open(dec, "rb") as f2:
        assert f1.read() == f2.read()
loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not loaded, loaded
print("STANDALONE-OK", len(names))
"""


def test_port_imports_and_decodes_without_jax_and_xvc_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["XVC_THREADS_NO_CLAMP"] = "1"
    res = subprocess.run(
        [sys.executable, "-c", _CHILD, ROOT, data_path("ai64x48.xvc"),
         data_path("ai64x48_dec.yuv"), "3", data_path("ld64x48.xvc"),
         data_path("ld64x48_dec.yuv"), "8"],
        capture_output=True, text=True, timeout=900, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "STANDALONE-OK" in res.stdout


def test_no_source_imports_jax_or_xvc_tpu():
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|xvc_tpu)(\.|\s|$)",
                     re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "xvc_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    assert len(files) > 30
    bad = [os.path.relpath(f, ROOT) for f in files
           if pat.search(open(f).read())]
    assert not bad, bad


BENCH_PICTURES = {"cif_ai": 16, "hd720_ld": 8, "hd720_lic": 8,
                  "fhd1080_ra": 8, "qhd1440_ra10": 5, "uhd2160_ra10": 3}


@pytest.mark.parametrize("name", sorted(BENCH_PICTURES))
def test_bench_sha256_file_matches_the_jax_package_host_decode(name):
    """The hash lists chip_smoke.py holds the card's decodes to."""
    from xvc_tpu.codec.decoder import Decoder
    from xvc_tpu.nal import split_nal_units
    dec = Decoder()
    pics = []
    for nal in split_nal_units(read_data("bench/%s.xvc" % name)):
        dec.decode_nal(nal)
        while (pic := dec.get_decoded_picture()) is not None:
            pics.append(pic)
    dec.flush()
    while (pic := dec.get_decoded_picture()) is not None:
        pics.append(pic)
    with open(data_path("bench/%s_dec.sha256" % name)) as f:
        want = [line.split()[0] for line in f if line.strip()]
    assert len(pics) == len(want) == BENCH_PICTURES[name]
    assert all(p.conforming for p in pics)
    assert [hashlib.sha256(p.bytes).hexdigest() for p in pics] == want


# the pictures of each hash list of chip_smoke.py phase 7
RESIZED_PICTURES = {"hd720_fhd1080_splice": 17, "hd720_ld_out1920x1080": 8,
                    "fhd1080_ra_out1280x720": 8,
                    "qhd1440_ra10_out1920x1080b8": 5}


@pytest.mark.parametrize("name", sorted(RESIZED_PICTURES))
def test_resampling_sha256_file_matches_the_jax_package_host_decode(name):
    """The hash lists of chip_smoke.py's resampling decodes (the splice;
    the bench streams resized on output), conformance flags included: the
    splice's three tail pictures that predict from the downscaled 1080p key
    picture fail their checksum in the JAX package's decode."""
    from .encode_clips import RESIZED, hash_lines, jax_session_decode
    stream, params = RESIZED[name]
    pics = jax_session_decode(read_data("bench/%s.xvc" % stream), **params)
    with open(data_path("bench/%s_dec.sha256" % name)) as f:
        want = [line.rstrip("\n") for line in f if line.strip()]
    assert len(pics) == RESIZED_PICTURES[name]
    assert hash_lines(pics) == want
    if name == "hd720_fhd1080_splice":
        assert [p.poc for p in pics if not p.conforming] == [5, 6, 7]
    else:
        assert all(p.conforming for p in pics)


def test_chip_smoke_carries_the_resized_streams():
    import importlib.util
    from .encode_clips import RESIZED
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_module", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert {smoke.SPLICE: (smoke.SPLICE, {}), **smoke.RESIZED_STREAMS} == \
        RESIZED


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    from xvc_tpu_torch.api import (DecoderSession, EncoderParameters,
                                   EncoderSession)
    from xvc_tpu_torch.cli import xvcdec, xvcenc
    from xvc_tpu_torch.codec.decoder import Decoder, decode_stream
    from xvc_tpu_torch.codec.encoder import Encoder
    from xvc_tpu_torch.gpu import resample
    data = read_data("ai64x48.xvc")
    plane = np.zeros((40, 40), np.int32)
    for call in (lambda: decode_stream(data), Decoder, DecoderSession,
                 lambda: Decoder(num_threads=2),
                 lambda: decode_stream(data, num_threads=2),
                 Encoder, lambda: EncoderSession(EncoderParameters(
                     width=64, height=48)),
                 lambda: Encoder(num_threads=2),
                 lambda: xvcenc.main([
                     "-input-file", data_path("sp48x32_in.yuv"),
                     "-output-file", os.devnull, "-input-width", "48",
                     "-input-height", "32", "-threads", "2"]),
                 lambda: xvcdec.main([
                     "-bitstream-file", data_path("ai64x48.xvc")]),
                 lambda: resample.resample(plane, 8, 8, 16, 16, 8, 24, 24,
                                           8)):
        with pytest.raises(RuntimeError, match="is_available"):
            call()
