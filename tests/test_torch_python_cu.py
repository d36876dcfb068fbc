"""The port's Python CU encoder (xvc_tpu_torch/codec/cu_encoder.py, intra
half) against the JAX package, on the CPU device: whole streams byte for
byte, with the per-NAL statistics, the SSE and the reconstruction equal.

- the golden tests/data/ai16x16.xvc under XVC_ENC_NATIVE=0 and under
  XVC_INTRA_PREPASS=jax (the contract of tests/test_encode_golden.py),
  and its reconstruction equal to the port's native path's;
- tpu_intra_lookahead: the 96x80 picture of tests/test_tpu_lookahead.py,
  a 10-bit picture, and a speed-3 picture at 64x48 (the split DP's
  pruning and the transform-RD prepass's candidates on the Python path);
- a 4:4:4 picture through EncoderSession on the Python path;
- the per-CU device pre-pass (``intra_search.device_prepass_satd``) equal
  to the JAX package's device function and to the native host pre-pass
  on random blocks, n = 4 to 32 at 8 and 10 bit.

The JAX package's references take its own routes: its native encoder
where the port's Python path must give the same bytes, its Python CU
encoder where a setting (tpu_intra_lookahead) changes the stream.  Each
reference is made once per module.
"""
import numpy as np
import pytest

from xvc_tpu import api as japi
from xvc_tpu_torch import api
from xvc_tpu_torch import constants as k
from xvc_tpu_torch.codec.decoder import decode_stream
from xvc_tpu_torch.nal import write_nal_units

from .util import read_data, read_meta


def lookahead_content(w, h, bitdepth=8):
    """The 4:2:0 picture of tests/test_tpu_lookahead.py ``_content``: a
    textured luma wave over flat chroma; at 10 bit its samples times 4
    plus a seeded noise, as 16-bit words."""
    rng = np.random.RandomState(5)
    yy, xx = np.mgrid[0:h, 0:w]
    tex = rng.randint(-20, 21, (h, w))
    y = np.clip(110 + 70 * np.sin(xx / 9.0) * np.cos(yy / 7.0) + tex,
                0, 255).astype(np.int32)
    u = np.full((h // 2, w // 2), 110, np.int32)
    v = np.full((h // 2, w // 2), 140, np.int32)
    if bitdepth == 8:
        return b"".join(p.astype(np.uint8).tobytes() for p in (y, u, v))
    shift = bitdepth - 8
    y = (y << shift) + rng.randint(0, 1 << shift, y.shape)
    return b"".join(p.astype("<u2").tobytes()
                    for p in (y, u << shift, v << shift))


def split_content(w, h):
    """A flat 4:2:0 picture with a 4x4 checkerboard in its top-right
    32x32 quadrant: flat blocks the split DP decides to keep whole."""
    yy, xx = np.mgrid[0:32, 0:32]
    y = np.full((h, w), 120, np.uint8)
    y[:32, w - 32:] = np.where((xx // 4 + yy // 4) % 2, 30, 220)
    return (y.tobytes() + np.full((h // 2, w // 2), 110, np.uint8).tobytes()
            + np.full((h // 2, w // 2), 140, np.uint8).tobytes())


def yuv444_content(w, h):
    rng = np.random.RandomState(11)
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.clip(128 + 60 * np.sin(xx / 5.0 + yy / 11.0) +
                rng.randint(-12, 13, (h, w)), 0, 255)
    u = np.clip(100 + 3 * xx + rng.randint(-6, 7, (h, w)), 0, 255)
    v = np.clip(150 - 2 * yy, 0, 255)
    return b"".join(p.astype(np.uint8).tobytes() for p in (y, u, v))


def encode(module, yuv, frames, device="cpu", **params):
    """(stream, [per-NAL stats], total SSE, reconstructions) of an
    EncoderSession of ``module`` (xvc_tpu.api or xvc_tpu_torch.api)."""
    p = module.EncoderParameters(**params)
    ses = module.EncoderSession(p) if module is japi else \
        module.EncoderSession(p, device=device)
    fs = len(yuv) // frames
    nals = []
    for i in range(frames):
        nals += ses.encode(yuv[i * fs:(i + 1) * fs])
    nals += ses.flush()
    stats = [(s.nal_unit_type, s.poc, s.doc, s.soc, s.tid, s.qp, s.sse,
              s.l0, s.l1, s.bytes, list(map(float, s.psnr)))
             for s in ses.nal_stats]
    return write_nal_units(nals), stats, ses.total_sse, ses.rec_pictures


def assert_same(got, want):
    assert got[0] == want[0], (len(got[0]), len(want[0]))
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] == want[3]


@pytest.fixture(autouse=True)
def _clean_routes(monkeypatch):
    for name in ("XVC_ENC_NATIVE", "XVC_INTRA_PREPASS", "XVC_ME"):
        monkeypatch.delenv(name, raising=False)


def _golden_params():
    meta = read_meta("ai16x16")
    return meta, dict(width=meta["width"], height=meta["height"],
                      qp=meta["qp"], input_bitdepth=meta["bitdepth"],
                      internal_bitdepth=meta["bitdepth"], checksum_mode=1,
                      num_ref_pics=0, sub_gop_length=1)


@pytest.fixture(scope="module")
def golden_ref():
    meta, params = _golden_params()
    raw = read_data("ai16x16_in.yuv")
    return raw, meta, params, encode(japi, raw, meta["frames"], **params)


@pytest.mark.parametrize("switch", ["XVC_ENC_NATIVE=0",
                                    "XVC_INTRA_PREPASS=jax"])
def test_golden_ai16x16_on_the_python_path(switch, golden_ref, monkeypatch):
    raw, meta, params, want = golden_ref
    monkeypatch.setenv(*switch.split("="))
    got = encode(api, raw, meta["frames"], **params)
    assert got[0] == read_data("ai16x16.xvc")
    assert_same(got, want)


def test_python_path_reconstruction_equals_the_native_path(monkeypatch):
    """ai16x16: the port's two encoders give the same pictures."""
    meta, params = _golden_params()
    raw = read_data("ai16x16_in.yuv")
    native = encode(api, raw, meta["frames"], **params)
    monkeypatch.setenv("XVC_ENC_NATIVE", "0")
    python = encode(api, raw, meta["frames"], **params)
    assert_same(python, native)
    assert len(python[3]) == meta["frames"]


# name -> (picture, width, height, bitdepth, chroma format, speed mode,
# explicit encoder settings, route switch of the port's encode)
CASES = {
    "lookahead_96x80": ("lookahead", 96, 80, 8, k.ChromaFormat.YUV420, 2,
                        "tpu_intra_lookahead 1", None),
    "lookahead_10bit_32x32": ("lookahead", 32, 32, 10,
                              k.ChromaFormat.YUV420, 2,
                              "tpu_intra_lookahead 1", None),
    "speed3_lookahead_64x48": ("split", 64, 48, 8, k.ChromaFormat.YUV420,
                               3, "tpu_intra_lookahead 1", None),
    "yuv444_32x32": ("yuv444", 32, 32, 8, k.ChromaFormat.YUV444, 2, "",
                     "XVC_ENC_NATIVE=0"),
}


def _case(name):
    picture, w, h, bd, cf, speed, explicit, switch = CASES[name]
    yuv = {"lookahead": lambda: lookahead_content(w, h, bd),
           "split": lambda: split_content(w, h),
           "yuv444": lambda: yuv444_content(w, h)}[picture]()
    params = dict(width=w, height=h, qp=32, speed_mode=speed,
                  num_ref_pics=0, sub_gop_length=1, checksum_mode=1,
                  input_bitdepth=bd, internal_bitdepth=bd, chroma_format=cf,
                  explicit_encoder_settings=explicit)
    return yuv, params, switch


@pytest.fixture(scope="module")
def case_refs():
    refs = {}
    for name in CASES:
        yuv, params, _ = _case(name)
        refs[name] = encode(japi, yuv, 1, **params)
    return refs


@pytest.mark.parametrize("name", sorted(CASES))
def test_python_path_equals_the_jax_package(name, case_refs, monkeypatch):
    from xvc_tpu_torch.gpu import wavefront_rdo as wf
    yuv, params, switch = _case(name)
    if switch:
        monkeypatch.setenv(*switch.split("="))
    decisions = []
    real = wf.decision_for

    def spy(*args):
        decisions.append(real(*args))
        return decisions[-1]

    monkeypatch.setattr(wf, "decision_for", spy)
    got = encode(api, yuv, 1, **params)
    assert_same(got, case_refs[name])
    pics = decode_stream(got[0], device="cpu")
    assert len(pics) == 1 and pics[0].conforming
    assert pics[0].bytes == got[3][0]
    if params["speed_mode"] == 3:
        # the split DP pruned the Python path's recursion
        assert wf.FORCE_LEAF in decisions
    else:
        assert not decisions


def test_speed3_python_path_takes_the_prepass_candidates(monkeypatch):
    """At speed 3 the transform-RD prepass's candidates stand in for the
    SATD pre-pass of the CUs they cover, so the per-CU device pre-pass
    runs fewer times than without them, and the Python path's stream is
    the port's native encoder's."""
    from xvc_tpu_torch.codec import intra_search
    yuv, params, _ = _case("speed3_lookahead_64x48")
    params["explicit_encoder_settings"] = ""
    native = encode(api, yuv, 1, **params)
    sizes = []
    real = intra_search.device_prepass_satd

    def spy(orig, *args):
        sizes.append(orig.shape[0])
        return real(orig, *args)

    monkeypatch.setattr(intra_search, "device_prepass_satd", spy)
    monkeypatch.setenv("XVC_ENC_NATIVE", "0")
    assert_same(encode(api, yuv, 1, **params), native)
    with_cands = len(sizes)
    sizes.clear()
    params["explicit_encoder_settings"] = "tpu_txrd_prepass 0"
    encode(api, yuv, 1, **params)
    assert len(sizes) > with_cands
    assert set(sizes) == {4, 8, 16, 32}


@pytest.mark.parametrize("bitdepth", [8, 10])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_device_prepass_equals_the_jax_and_native_prepass(n, bitdepth):
    """One CU's 67 SATDs: the port's device pre-pass (on the CPU, its
    plain versions), the JAX package's device function at B = 1 (what its
    ``_jax_prepass_satd`` calls) and the native host pre-pass (the route
    of every other CU) agree on random blocks and reference lines."""
    import jax.numpy as jnp
    from xvc_tpu.tpu import analysis as jan
    from xvc_tpu_torch import native
    from xvc_tpu_torch.codec.intra_search import device_prepass_satd
    rng = np.random.RandomState(n * 100 + bitdepth)
    jfn = jan.make_intra_satd_fn(n, bitdepth)
    top_bit = 1 << bitdepth
    for trial in range(3):
        orig = rng.randint(0, top_bit, (n, n)).astype(np.int32)
        top = rng.randint(0, top_bit, 2 * n + 1).astype(np.int32)
        left = rng.randint(0, top_bit, 2 * n).astype(np.int32)
        if trial == 1:  # smooth references: the filters matter
            top = np.sort(top)
            left = np.sort(left)
        got = device_prepass_satd(orig, top, left, bitdepth, "cpu")
        want = np.asarray(jfn(jnp.asarray(orig[None]),
                              jnp.asarray(top[None]),
                              jnp.asarray(left[None])))[0]
        host = np.empty(k.NBR_INTRA_MODES_EXT, dtype=np.int64)
        native.lib().xvcn_intra_prepass_satd(
            top.ctypes.data, left.ctypes.data, n, n, 1, 0, 0, 0, 0,
            1 if n <= 16 else 0, orig.ctypes.data, n, bitdepth,
            k.NBR_INTRA_MODES_EXT, host.ctypes.data)
        assert got.shape == (k.NBR_INTRA_MODES_EXT,)
        assert np.array_equal(got, want)
        assert np.array_equal(got, host)


def _chip_smoke():
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_module", os.path.join(root, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_carries_the_python_cu_recipe():
    """chip_smoke.py phase 8's copies of the clip table, the crop and the
    encoder parameters equal tests/encode_clips.py's."""
    from dataclasses import asdict
    from . import encode_clips as clips
    smoke = _chip_smoke()
    assert smoke.PYTHON_CU == clips.PYTHON_CU
    assert smoke.PYTHON_CU_SOURCE == clips.PYTHON_CU_SOURCE
    rng = np.random.RandomState(3)
    pics = [rng.randint(0, 256, 96 * 64 * 3 // 2).astype(np.uint8)
            .tobytes() for _ in range(2)]
    assert smoke.crop_pictures(pics, 96, 64, 32, 16) == \
        clips.crop_pictures(pics, 96, 64, 32, 16)
    for name in clips.PYTHON_CU:
        assert asdict(smoke.python_cu_params(api, name)) == \
            asdict(clips.python_cu_params(api, name))


def test_python_cu_references_describe_the_clips():
    """tests/data/bench/python_cu_enc.json (made by tests/encode_clips.py
    ``make_python_cu_refs``) carries the clips it was made from, a NAL per
    picture after the segment header, and plausible PSNRs."""
    import json
    from .encode_clips import PYTHON_CU, PYTHON_CU_SOURCE
    from .util import data_path
    with open(data_path("bench/python_cu_enc.json")) as f:
        refs = json.load(f)
    assert refs["source"] == list(PYTHON_CU_SOURCE)
    assert refs["clips"] == PYTHON_CU
    for name, clip in PYTHON_CU.items():
        assert len(refs[name]["nal_sha256"]) == clip["pictures"] + 1
        assert len(refs[name]["psnr"]) == clip["pictures"]
        assert min(min(p) for p in refs[name]["psnr"]) > 25
