"""The port's apps, ``python -m xvc_tpu_torch.cli.xvcenc`` and
``xvcdec``, against the JAX apps ``cli/xvcenc.py`` and ``cli/xvcdec.py``
on the same arguments, on the CPU device (``-device cpu``) with two
picture threads: ``sp48x32_in.yuv`` (48x32, 6 pictures, sub-GOP 4,
checksum mode 1), raw and as y4m, gives the same stream and
reconstruction, and its decode the same pictures (y4m too), equal to the
reconstruction.  ``-simd-mask 0`` routes the encoder app to the Python CU
encoder (the same stream), and the decoder app, which has no decode
without the native library, exits with a message that says so.
``-explicit-encoder-settings "tile_rows 2"`` on a 32x128 picture (two
CTU rows) gives the JAX app's stream and reconstruction,
and the port's decoder app decodes it, conforming, to the
reconstruction.
"""
import io
import os
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest

from xvc_tpu_torch.cli import xvcdec, xvcenc
from xvc_tpu_torch.native import enc as native_enc

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


def run_jax_app(app, args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", XVC_THREADS_NO_CLAMP="1")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "cli", app)]
                         + args, capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]


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
    the decoder app refuses with a message and code 2."""
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
    code, err = run_port_app(xvcdec, ["-bitstream-file", bs, "-simd-mask",
                                      "0", "-device", "cpu"])
    assert code == 2 and "no pure-Python parse" in err


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
