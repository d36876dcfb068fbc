"""The port's apps, ``python -m xvc_tpu_torch.cli.xvcenc`` and
``xvcdec``, against the JAX apps ``cli/xvcenc.py`` and ``cli/xvcdec.py``
on the same arguments, on the CPU device (``-device cpu``) with two
picture threads: ``sp48x32_in.yuv`` (48x32, 6 pictures, sub-GOP 4,
checksum mode 1), raw and as y4m, gives the same stream and
reconstruction, and its decode the same pictures (y4m too), equal to the
reconstruction.  ``-simd-mask 0`` routes the encoder app to the Python CU
encoder (the same stream), and the decoder app to the Python parse on
the pure-Python arithmetic decoder: its output equals the JAX app's
under ``-simd-mask 0`` on that stream, on ai64x48.xvc and on the 15-bit
ra64x48b15.xvc (there on the two pictures the JAX package decodes
conforming; the others, which the JAX package fails for ROADMAP queue 3
F5, equal the stream's hash list).
``-explicit-encoder-settings "tile_rows 2"`` on a 32x128 picture (two
CTU rows) gives the JAX app's stream and reconstruction,
and the port's decoder app decodes it, conforming, to the
reconstruction.
"""
import hashlib
import io
import os
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest

from xvc_tpu_torch.cli import xvcdec, xvcenc
from xvc_tpu_torch.codec import picture_decoder
from xvc_tpu_torch.native import enc as native_enc
from xvc_tpu_torch.syntax import reader

from .encode_clips import jax_session_decode
from .util import data_path, read_data

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, FRAMES = 48, 32, 6


def y4m_input(path):
    """sp48x32_in.yuv as a y4m stream (30 fps, 4:2:0)."""
    raw = read_data("sp48x32_in.yuv")
    fs = W * H * 3 // 2
    with open(path, "wb") as f:
        f.write(b"YUV4MPEG2 W48 H32 F30:1 Ip C420 \n")
        for i in range(FRAMES):
            f.write(b"FRAME\n" + raw[i * fs:(i + 1) * fs])


def run_jax_app(app, args, code=0):
    env = dict(os.environ, JAX_PLATFORMS="cpu", XVC_THREADS_NO_CLAMP="1")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "cli", app)]
                         + args, capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert res.returncode == code, res.stderr[-2000:]


def run_port_app(module, args):
    """``module.main(args)`` in this process; returns (code, stderr)."""
    err = io.StringIO()
    # a text stream with a binary buffer, as sys.stdout has
    with redirect_stdout(io.TextIOWrapper(io.BytesIO())), \
            redirect_stderr(err):
        code = module.main(args)
    return code, err.getvalue()


def encode_args(src, out, rec, extra=()):
    args = ["-input-file", src, "-output-file", out, "-rec-file", rec,
            "-qp", "32", "-sub-gop-length", "4", "-checksum-mode", "1",
            "-threads", "2"] + list(extra)
    if src.endswith(".yuv"):
        args += ["-input-width", str(W), "-input-height", str(H)]
    return args


@pytest.mark.parametrize("form", ["raw", "y4m"])
def test_apps_equal_the_jax_apps(form, tmp_path, monkeypatch):
    monkeypatch.setenv("XVC_THREADS_NO_CLAMP", "1")
    if form == "raw":
        src = data_path("sp48x32_in.yuv")
    else:
        src = str(tmp_path / "in.y4m")
        y4m_input(src)
    dec_ext = ".yuv" if form == "raw" else ".y4m"
    out = {}
    for who in ("jax", "port"):
        bs, rec = str(tmp_path / (who + ".xvc")), str(tmp_path / who)
        dec = str(tmp_path / (who + "_dec" + dec_ext))
        dec_args = ["-bitstream-file", bs, "-output-file", dec,
                    "-threads", "2"]
        if who == "jax":
            run_jax_app("xvcenc.py", encode_args(src, bs, rec))
            run_jax_app("xvcdec.py", dec_args)
        else:
            code, _ = run_port_app(xvcenc, encode_args(
                src, bs, rec, ["-device", "cpu"]))
            assert code == 0
            code, err = run_port_app(xvcdec, dec_args + ["-device", "cpu"])
            assert code == 0 and "is a conforming bitstream" in err
        out[who] = [open(p, "rb").read() for p in (bs, rec, dec)]
    assert out["port"] == out["jax"]
    stream, rec, dec = out["port"]
    assert len(rec) == FRAMES * W * H * 3 // 2
    if form == "raw":
        assert dec == rec
    else:
        assert dec.count(b"FRAME\n") == FRAMES


def test_simd_mask_0(tmp_path, monkeypatch):
    """The encoder app codes with the Python CU encoder under -simd-mask
    0 (two all-intra pictures: the same stream as the native encoder's);
    the decoder app decodes it under -simd-mask 0 as the JAX app does."""
    monkeypatch.delenv("XVC_ENC_NATIVE", raising=False)
    routes = []
    real = native_enc.usable_for

    def spy(settings):
        routes.append(real(settings))
        return routes[-1]

    monkeypatch.setattr(native_enc, "usable_for", spy)
    src = data_path("sp48x32_in.yuv")
    streams = []
    for mask in ([], ["-simd-mask", "0"]):
        bs = str(tmp_path / ("mask%d.xvc" % len(mask)))
        code, _ = run_port_app(xvcenc, encode_args(
            src, bs, str(tmp_path / "rec"),
            ["-device", "cpu", "-max-pictures", "2", "-num-ref-pics", "0",
             "-sub-gop-length", "1"] + mask))
        assert code == 0
        streams.append(open(bs, "rb").read())
    assert streams[0] == streams[1]
    assert routes == [True, True, False, False]
    assert "XVC_ENC_NATIVE" not in os.environ
    port, jax = simd_mask_0_decodes(bs, tmp_path)
    assert port == jax and len(port) == 2 * W * H * 3 // 2


def simd_mask_0_decodes(bs, tmp_path, jax_code=0):
    """The outputs of the port's and the JAX decoder app (which exits
    with ``jax_code``) under -simd-mask 0; the port's reads the stream
    with the Python parse and exits with 0."""
    routes = []
    real = picture_decoder.PictureDecoder._python_parse

    def spy(self, segment, bit_reader, qp):
        routes.append(reader.use_native_engine())
        return real(self, segment, bit_reader, qp)

    outs = []
    for who in ("port", "jax"):
        dec = str(tmp_path / (who + "_dec.yuv"))
        args = ["-bitstream-file", bs, "-output-file", dec, "-simd-mask",
                "0"]
        if who == "jax":
            run_jax_app("xvcdec.py", args, jax_code)
        else:
            picture_decoder.PictureDecoder._python_parse = spy
            try:
                code, _ = run_port_app(xvcdec, args + ["-device", "cpu"])
            finally:
                picture_decoder.PictureDecoder._python_parse = real
            assert code == 0
            assert routes and not any(routes)  # the pure-Python engine
            assert "XVC_PIC_NATIVE" not in os.environ
            assert "XVC_NATIVE" not in os.environ
        outs.append(open(dec, "rb").read())
    return outs


@pytest.mark.parametrize("name", ["ai64x48", "ra64x48b15"])
def test_simd_mask_0_decode_equals_the_jax_app(name, tmp_path):
    port, jax = simd_mask_0_decodes(data_path(name + ".xvc"), tmp_path,
                                    0 if name == "ai64x48" else 1)
    if name == "ai64x48":
        assert port == jax == read_data("ai64x48_dec.yuv")
        return
    size = 64 * 48 * 3 // 2 * 2
    frames = [port[i:i + size] for i in range(0, len(port), size)]
    assert [hashlib.sha256(f).hexdigest() for f in frames] == [
        line.split()[0] for line in
        read_data("ra64x48b15_dec.sha256").decode().splitlines()]
    conforming = [p.conforming for p in jax_session_decode(
        read_data(name + ".xvc"))]
    assert conforming == [True, False, False, False, True]
    # the JAX app writes the conforming pictures first and last, with
    # what it left of some F5 pictures between them
    assert jax[:size] == frames[0] and jax[-size:] == frames[4]


def test_tile_rows_app_equals_the_jax_app(tmp_path, monkeypatch):
    from .encode_clips import synthetic_yuv420
    monkeypatch.setenv("XVC_THREADS_NO_CLAMP", "1")
    w, h, frames = 32, 128, 1
    src = str(tmp_path / "in.yuv")
    with open(src, "wb") as f:
        f.write(synthetic_yuv420(w, h, frames, 3))
    out = {}
    for who in ("jax", "port"):
        bs, rec = str(tmp_path / (who + ".xvc")), str(tmp_path / who)
        args = ["-input-file", src, "-output-file", bs, "-rec-file", rec,
                "-input-width", str(w), "-input-height", str(h), "-qp",
                "32", "-num-ref-pics", "0", "-sub-gop-length", "1",
                "-checksum-mode", "1",
                "-explicit-encoder-settings", "tile_rows 2"]
        if who == "jax":
            run_jax_app("xvcenc.py", args)
        else:
            code, _ = run_port_app(xvcenc, args + ["-device", "cpu"])
            assert code == 0
        out[who] = [open(p, "rb").read() for p in (bs, rec)]
    assert out["port"] == out["jax"]
    dec = str(tmp_path / "dec.yuv")
    code, err = run_port_app(xvcdec, ["-bitstream-file", str(
        tmp_path / "port.xvc"), "-output-file", dec, "-device", "cpu"])
    assert code == 0 and "is a conforming bitstream" in err
    assert open(dec, "rb").read() == out["port"][1]
    assert len(out["port"][1]) == frames * w * h * 3 // 2
