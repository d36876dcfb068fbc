"""The port's encoder (xvc_tpu_torch.codec.encoder, api.EncoderSession)
against the JAX package's, on the CPU device: whole streams byte for
byte.

- encode_stream at speed 2 (no device stage), and at speed 3 (the split
  DP and the transform-RD prepass) with and without the prepass, on the
  192x192 clip of tests/test_wavefront_rdo.py and on the clip of
  tests/test_txrd_prepass.py; with restricted mode A, where the prepass
  returns None;
- EncoderSession: the same NALs, per-NAL statistics and reconstruction;
- the settings the port rejects raise NotImplementedError, and those it
  takes to its Python CU encoder (tpu_intra_lookahead,
  XVC_INTRA_PREPASS=jax) or codes on picture threads give the JAX
  package's bytes;
- hd720_s3, chip_smoke.py's encode clip: its recipe
  (tests/encode_clips.py ``make_hd720_s3``, and chip_smoke.py's own copy
  of it), its committed references
  (tests/data/bench/hd720_s3_enc.json, hd720_s3_cands.npz; made by
  ``make_hd720_s3_refs``), and picture 0 through the port on the CPU
  equal to the JAX package's (the packed prepass candidates and the NAL).
"""
import hashlib
import importlib.util
import json
import os

import numpy as np
import pytest

from xvc_tpu import api as japi
from xvc_tpu.codec.encoder import encode_stream as jax_encode_stream
from xvc_tpu.codec.encoder_settings import EncoderSettings as JaxSettings
from xvc_tpu.nal import write_nal_units
from xvc_tpu_torch import api
from xvc_tpu_torch import constants as k
from xvc_tpu_torch.codec.decoder import decode_stream
from xvc_tpu_torch.codec.encoder import encode_stream
from xvc_tpu_torch.codec.encoder_settings import EncoderSettings

from .encode_clips import (HD720_S3, make_hd720_s3, txrd_clip,
                           wavefront_clip)
from .util import data_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEGMENT_HEADER = int(k.NalUnitType.SEGMENT_HEADER)


def hd720_s3_params(module, prepass):
    """EncoderParameters of hd720_s3 for ``module`` (xvc_tpu.api or
    xvc_tpu_torch.api): low delay, one reference picture, sub-GOP 1, qp
    32, speed mode 3, checksum mode 1; ``prepass`` False keeps the split
    DP alone (tpu_txrd_prepass 0)."""
    return module.EncoderParameters(
        width=HD720_S3["width"], height=HD720_S3["height"],
        qp=HD720_S3["qp"], speed_mode=3, low_delay=1, num_ref_pics=1,
        sub_gop_length=1, checksum_mode=1,
        explicit_encoder_settings="" if prepass else "tpu_txrd_prepass 0")


def session_encode(session, yuv, width, height, frames):
    """All NALs of ``frames`` pictures through an EncoderSession, with
    the per-NAL statistics."""
    fs = width * height * 3 // 2
    nals = []
    for i in range(frames):
        nals += session.encode(yuv[i * fs:(i + 1) * fs])
    nals += session.flush()
    return nals, session.nal_stats


def make_hd720_s3_refs(out_dir):
    """Write hd720_s3_enc.json and hd720_s3_cands.npz to ``out_dir``:
    the JAX package's EncoderSession on hd720_s3, at speed 3 and with the
    split DP alone.  Per stream: the sha256 and byte count of the
    length-prefixed stream, every NAL's sha256, and each picture's PSNR
    (Y, U, V); the packed prepass candidates of each picture
    (pack_intra_cands, keep 1), in coding order.  About two minutes on
    one CPU core."""
    from xvc_tpu.tpu import txrd_prepass as jtx
    yuv = make_hd720_s3()
    W, H, N = HD720_S3["width"], HD720_S3["height"], HD720_S3["frames"]
    cands = []
    pack = jtx.pack_intra_cands

    def spy(*args, **kw):
        buf = pack(*args, **kw)
        cands.append(buf.copy())
        return buf

    refs = {"clip": dict(HD720_S3)}
    jtx.pack_intra_cands = spy
    try:
        for key, prepass in (("speed3", True), ("split_dp", False)):
            nals, stats = session_encode(
                japi.EncoderSession(hd720_s3_params(japi, prepass)), yuv,
                W, H, N)
            data = write_nal_units(nals)
            refs[key] = dict(
                sha256=hashlib.sha256(data).hexdigest(), bytes=len(data),
                nal_sha256=[hashlib.sha256(n).hexdigest() for n in nals],
                psnr=[list(map(float, s.psnr)) for s in stats
                      if s.nal_unit_type != SEGMENT_HEADER])
            if key == "speed3":
                assert len(cands) == N
    finally:
        jtx.pack_intra_cands = pack
    with open(os.path.join(out_dir, "hd720_s3_enc.json"), "w") as f:
        json.dump(refs, f, indent=1)
        f.write("\n")
    np.savez_compressed(os.path.join(out_dir, "hd720_s3_cands.npz"),
                        cands=np.stack(cands))


def _settings(module_settings, speed, prepass=None, restricted=0):
    s = module_settings()
    s.initialize_speed(speed)
    if restricted:
        s.initialize_restricted(restricted)
    if prepass is not None:
        s.tpu_txrd_prepass = prepass
    return s


# (clip, width, height, frames, speed, tpu_txrd_prepass (None: the
# preset's), restricted mode, sub_gop_length, num_ref_pics[, bit depth,
# chroma format, low delay])
ENCODES = {
    "wavefront_s2": ("wavefront", 192, 192, 2, 2, None, 0, 2, 1),
    "wavefront_s3": ("wavefront", 192, 192, 2, 3, None, 0, 2, 1),
    "wavefront_s3_split_dp": ("wavefront", 192, 192, 2, 3, 0, 0, 2, 1),
    "txrd_s3_intra": ("txrd", 128, 96, 2, 3, None, 0, 1, 0),
    "txrd_s2_prepass2": ("txrd", 128, 96, 2, 2, 2, 0, 1, 0),
    "txrd_s3_unaligned": ("txrd", 44, 36, 2, 3, None, 0, 1, 1),
    "restricted_a_s3": ("txrd", 64, 48, 2, 3, None, 1, 1, 1),
    "b10_low_delay_s3": ("txrd", 64, 48, 3, 3, None, 0, 1, 1, 10,
                         k.ChromaFormat.YUV420, True),
    "b12_intra_s3": ("txrd", 64, 48, 2, 3, None, 0, 1, 0, 12,
                     k.ChromaFormat.YUV420, False),
    "yuv444_low_delay_s3": ("txrd", 64, 48, 3, 3, None, 0, 1, 1, 8,
                            k.ChromaFormat.YUV444, True),
    "random_access_gop4_s3": ("txrd", 64, 48, 5, 3, None, 0, 4, 2, 8,
                              k.ChromaFormat.YUV420, False),
}


def _clip(name, w, h, f, bitdepth=8, chroma_format=k.ChromaFormat.YUV420):
    """The 8-bit 4:2:0 clip ``name``, its chroma resampled to
    ``chroma_format`` by repetition or decimation and its samples shifted
    up to ``bitdepth`` (16-bit words above 8)."""
    raw = wavefront_clip(w, h, f) if name == "wavefront" else \
        txrd_clip(w, h, f)
    if bitdepth == 8 and chroma_format == k.ChromaFormat.YUV420:
        return raw
    planes = np.frombuffer(raw, np.uint8).reshape(f, -1)
    out = []
    for pic in planes:
        y = pic[:w * h].reshape(h, w)
        u, v = (pic[w * h + i * (w * h // 4):][:w * h // 4]
                .reshape(h // 2, w // 2) for i in (0, 1))
        if chroma_format == k.ChromaFormat.YUV444:
            u, v = (c.repeat(2, 0).repeat(2, 1) for c in (u, v))
        elif chroma_format == k.ChromaFormat.YUV422:
            u, v = (c.repeat(2, 0) for c in (u, v))
        comps = [y] if chroma_format == k.ChromaFormat.MONOCHROME else \
            [y, u, v]
        for c in comps:
            c = c.astype(np.uint16) << (bitdepth - 8)
            out.append(c.astype("<u2" if bitdepth > 8 else np.uint8)
                       .tobytes())
    return b"".join(out)


@pytest.mark.parametrize("case", sorted(ENCODES))
def test_encode_stream_equals_the_jax_package_s(case):
    """encode_stream on the CPU device: the same bytes as the JAX
    package's encode_stream, and a stream the port's decoder finds
    conforming, equal to the encoder's reconstruction of its last
    picture."""
    clip, w, h, f, speed, prepass, restricted, sub_gop, refs = \
        ENCODES[case][:9]
    bitdepth, chroma_format, low_delay = \
        (ENCODES[case][9:] or (8, k.ChromaFormat.YUV420, False))
    yuv = _clip(clip, w, h, f, bitdepth, chroma_format)
    kw = dict(qp=32, sub_gop_length=sub_gop, num_ref_pics=refs,
              checksum_mode=1, bitdepth=bitdepth,
              chroma_format=chroma_format, low_delay=low_delay)
    want = write_nal_units(jax_encode_stream(
        yuv, w, h, f, settings=_settings(JaxSettings, speed, prepass,
                                         restricted), **kw))
    got = write_nal_units(encode_stream(
        yuv, w, h, f, settings=_settings(EncoderSettings, speed, prepass,
                                         restricted), device="cpu", **kw))
    assert got == want, (len(got), len(want))
    pics = decode_stream(got, device="cpu")
    assert len(pics) == f and all(p.conforming for p in pics)


def test_session_equals_the_jax_package_s():
    """EncoderSession on the CPU device: the same NALs, per-NAL
    statistics and reconstructed pictures as xvc_tpu.api.EncoderSession
    (speed 3, low delay, on the 192x192 clip)."""
    w, h, f = 192, 192, 3
    yuv = wavefront_clip(w, h, f)
    params = dict(width=w, height=h, qp=30, speed_mode=3, low_delay=1,
                  num_ref_pics=1, sub_gop_length=1, checksum_mode=1)
    jses = japi.EncoderSession(japi.EncoderParameters(**params))
    ses = api.EncoderSession(api.EncoderParameters(**params), device="cpu")
    assert str(ses.device) == "cpu"
    want, jstats = session_encode(jses, yuv, w, h, f)
    got, stats = session_encode(ses, yuv, w, h, f)
    assert got == want
    assert ses.rec_pictures == jses.rec_pictures and \
        len(ses.rec_pictures) == f
    assert ses.total_sse == jses.total_sse
    _assert_same_stats(stats, jstats)
    pics = decode_stream(write_nal_units(got), device="cpu")
    assert [p.bytes for p in pics] == ses.rec_pictures


def _assert_same_stats(stats, jstats):
    assert len(stats) == len(jstats)
    for a, b in zip(stats, jstats):
        assert (a.nal_unit_type, a.poc, a.doc, a.soc, a.tid, a.qp, a.sse,
                a.l0, a.l1, a.bytes) == \
            (b.nal_unit_type, b.poc, b.doc, b.soc, b.tid, b.qp, b.sse,
             b.l0, b.l1, b.bytes)
        assert np.array_equal(a.psnr, b.psnr)


# EncoderSession, which takes one picture at a time, for the chroma
# formats encode_stream misreads (ROADMAP F4): (chroma format, frames,
# sub_gop_length, num_ref_pics, low delay), 64x48 at speed 3
SESSIONS = {
    "yuv422_random_access": (k.ChromaFormat.YUV422, 5, 4, 2, 0),
    "monochrome_low_delay": (k.ChromaFormat.MONOCHROME, 3, 1, 1, 1),
}


@pytest.mark.parametrize("case", sorted(SESSIONS))
def test_session_chroma_formats_equal_the_jax_package_s(case):
    chroma_format, f, sub_gop, refs, low_delay = SESSIONS[case]
    w, h = 64, 48
    yuv = _clip("txrd", w, h, f, 8, chroma_format)
    params = dict(width=w, height=h, qp=32, speed_mode=3,
                  chroma_format=chroma_format, low_delay=low_delay,
                  num_ref_pics=refs, sub_gop_length=sub_gop,
                  checksum_mode=1)
    fs = len(yuv) // f
    out = []
    for ses in (japi.EncoderSession(japi.EncoderParameters(**params)),
                api.EncoderSession(api.EncoderParameters(**params),
                                   device="cpu")):
        nals = []
        for i in range(f):
            nals += ses.encode(yuv[i * fs:(i + 1) * fs])
        nals += ses.flush()
        out.append((nals, ses.nal_stats, ses.total_sse, ses.rec_pictures))
    (jnals, jstats, jsse, jrec), (nals, stats, sse, rec) = out
    assert nals == jnals
    assert sse == jsse and rec == jrec and len(rec) == f
    _assert_same_stats(stats, jstats)
    pics = decode_stream(write_nal_units(nals), device="cpu")
    assert [p.bytes for p in pics] == rec


# Settings the JAX package codes with its Python CU encoder or on picture
# threads, which the port encodes byte for byte as the JAX package does;
# and settings both packages refuse when the session is set up, with the
# same error: multihost_gop without the GOP pipeline's restriction
# profile (with it, test_multihost_gop_in_one_process_equals_the_jax_
# package; across processes, tests/test_torch_multihost.py).
REJECTED = {
    "multihost_gop": (dict(explicit_encoder_settings="multihost_gop 1"),
                      "GOP pipeline restriction profile"),
}
ENCODED = {
    "tpu_intra_lookahead": dict(
        num_ref_pics=0, sub_gop_length=1, speed_mode=2, checksum_mode=1,
        explicit_encoder_settings="tpu_intra_lookahead 1"),
    "python_path_num_ref_pics_1": dict(
        num_ref_pics=1, low_delay=1, sub_gop_length=1, speed_mode=2,
        checksum_mode=1, explicit_encoder_settings="tpu_intra_lookahead 1"),
    # 64x48 is one CTU row: one tile, still coded as a tile picture (its
    # size word, the rfe flag) by the Python CU encoder
    "tile_rows": dict(
        num_ref_pics=0, sub_gop_length=1, speed_mode=2, checksum_mode=1,
        explicit_encoder_settings="tile_rows 2"),
    # three pictures: the second sub-GOP's two are coded by two workers
    "threads": dict(threads=2, sub_gop_length=2, speed_mode=2,
                    checksum_mode=1, frames=3),
}


@pytest.mark.parametrize("name", sorted(REJECTED) + sorted(ENCODED))
def test_settings_that_need_the_python_cu_encoder_raise(name, monkeypatch):
    """A refused setting raises the JAX package's ValueError, word for
    word; an encoded one gives the JAX package's NALs (64x48, one
    picture, or ``frames``)."""
    monkeypatch.setenv("XVC_THREADS_NO_CLAMP", "1")
    w, h = 64, 48
    if name in REJECTED:
        kw, match = REJECTED[name]
        errors = []
        for module, extra in ((japi, {}), (api, {"device": "cpu"})):
            with pytest.raises(ValueError, match=match) as err:
                module.EncoderSession(module.EncoderParameters(
                    width=w, height=h, **kw), **extra)
            errors.append(str(err.value))
        assert errors[0] == errors[1]
        return
    kw = dict(ENCODED[name])
    frames = kw.pop("frames", 1)
    yuv = txrd_clip(w, h, frames)
    want, _ = session_encode(japi.EncoderSession(japi.EncoderParameters(
        width=w, height=h, **kw)), yuv, w, h, frames)
    ses = api.EncoderSession(api.EncoderParameters(width=w, height=h, **kw),
                             device="cpu")
    assert (ses._enc.pipeline is not None) == ("threads" in kw)
    got, _ = session_encode(ses, yuv, w, h, frames)
    assert got == want


def test_multihost_gop_in_one_process_equals_the_jax_package():
    """multihost_gop with ``GOP_PIPELINE_PROFILE`` in a single process
    (no group: every picture is this process's, and the broadcasts hand
    each picture back to itself): the JAX package's NALs, which are also
    the port's without multihost_gop."""
    from xvc_tpu.parallel.multihost import GOP_PIPELINE_PROFILE as JAX_GOP
    from xvc_tpu_torch.parallel.multihost import GOP_PIPELINE_PROFILE
    assert GOP_PIPELINE_PROFILE == JAX_GOP
    w, h, f = 32, 24, 5
    yuv = txrd_clip(w, h, f)

    def settings(cls, mh):
        s = cls()
        s.initialize_speed(2)
        s.explicit_restrictions = GOP_PIPELINE_PROFILE
        s.multihost_gop = mh
        return s

    kw = dict(qp=30, sub_gop_length=4, num_ref_pics=1)
    want = write_nal_units(jax_encode_stream(
        yuv, w, h, f, settings=settings(JaxSettings, 1), **kw))
    got = write_nal_units(encode_stream(
        yuv, w, h, f, settings=settings(EncoderSettings, 1), device="cpu",
        **kw))
    plain = write_nal_units(encode_stream(
        yuv, w, h, f, settings=settings(EncoderSettings, 0), device="cpu",
        **kw))
    assert got == want == plain


@pytest.mark.parametrize("switch", ["XVC_ME", "XVC_INTRA_PREPASS"])
def test_jax_device_switches_raise(switch, monkeypatch):
    """Under XVC_ME=jax (device motion estimation) both packages code a
    low-delay clip with their Python CU encoders, the TZ search's SAD
    sweeps on the device; under XVC_INTRA_PREPASS=jax an all-intra clip
    with the per-CU device SATD pre-pass.  Both to the same bytes through
    ``encode_stream``."""
    monkeypatch.setenv(switch, "jax")
    w, h, f = 32, 32, 2
    yuv = txrd_clip(w, h, f)
    kw = dict(qp=32, sub_gop_length=1, num_ref_pics=0, checksum_mode=1,
              speed_mode=2)
    if switch == "XVC_ME":
        kw.update(num_ref_pics=1, low_delay=1)
    want = write_nal_units(jax_encode_stream(yuv, w, h, f, **kw))
    got = write_nal_units(encode_stream(yuv, w, h, f, device="cpu", **kw))
    assert got == want


def test_encoder_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError):
        api.EncoderSession(api.EncoderParameters(width=64, height=48))
    with pytest.raises(RuntimeError):
        encode_stream(txrd_clip(64, 48, 1), 64, 48, 1)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_module", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_carries_the_hd720_s3_recipe():
    smoke = _chip_smoke()
    assert smoke.HD720_S3 == HD720_S3
    assert hashlib.sha256(smoke.make_hd720_s3()).digest() == \
        hashlib.sha256(make_hd720_s3()).digest()


def _refs():
    with open(data_path("bench/hd720_s3_enc.json")) as f:
        refs = json.load(f)
    with np.load(data_path("bench/hd720_s3_cands.npz")) as z:
        cands = z["cands"]
    return refs, cands


def test_hd720_s3_references_describe_the_clip():
    refs, cands = _refs()
    assert refs["clip"] == HD720_S3
    w, h, n = HD720_S3["width"], HD720_S3["height"], HD720_S3["frames"]
    size = sum(-(-h // s) * -(-w // s) for s in (4, 8, 16, 32))
    assert cands.shape == (n, size) and cands.dtype == np.int8
    # every fully covered block has a candidate, the 32-grid's partial
    # bottom row none
    assert (cands >= 0).sum(axis=1).tolist() == [size - w // 32] * n
    for key in ("speed3", "split_dp"):
        assert len(refs[key]["nal_sha256"]) == n + 1
        assert len(refs[key]["psnr"]) == n
        assert min(min(p) for p in refs[key]["psnr"]) > 25


@pytest.mark.parametrize("prepass", [True, False])
def test_hd720_s3_picture_0_equals_the_references(prepass, monkeypatch):
    """Picture 0 of hd720_s3 through the port's EncoderSession on the
    CPU: the segment header and the picture's NAL equal the JAX
    package's (hd720_s3_enc.json), and with the prepass its packed
    candidates equal hd720_s3_cands.npz's picture 0."""
    from xvc_tpu_torch.gpu import txrd_prepass
    refs, cands = _refs()
    packed = []
    pack = txrd_prepass.pack_intra_cands

    def spy(*args, **kw):
        packed.append(pack(*args, **kw))
        return packed[-1]

    monkeypatch.setattr(txrd_prepass, "pack_intra_cands", spy)
    w, h = HD720_S3["width"], HD720_S3["height"]
    ses = api.EncoderSession(hd720_s3_params(api, prepass), device="cpu")
    nals, _ = session_encode(ses, make_hd720_s3(), w, h, 1)
    key = "speed3" if prepass else "split_dp"
    assert [hashlib.sha256(n).hexdigest() for n in nals] == \
        refs[key]["nal_sha256"][:2]
    if prepass:
        assert len(packed) == 1 and np.array_equal(packed[0], cands[0])
    else:
        assert not packed


def _settings_fields(s):
    from dataclasses import asdict
    return asdict(s)


@pytest.mark.parametrize("speed", [0, 1, 2, 3])
@pytest.mark.parametrize("restricted", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("tune", [0, 1])
def test_encoder_settings_equal_the_jax_package_s(speed, restricted, tune):
    """The port's EncoderSettings copy: every field after the speed,
    restricted-mode and tune presets and an explicit override."""
    got, want = EncoderSettings(), JaxSettings()
    for s in (got, want):
        s.initialize_speed(speed)
        if restricted:
            s.initialize_restricted(restricted)
        s.tune(tune)
        s.parse_explicit_settings("tpu_txrd_prepass 2 lambda_scale_a 1.5")
    assert _settings_fields(got) == _settings_fields(want)


def test_picture_state_of_an_encode_equals_the_jax_package_s():
    """The state both native encoders receive for each picture of a
    low-delay speed-3 encode: picture qp and lambda, the CABAC context
    init, the reference lists and TMVP fields, the LIC decision, and the
    original planes."""
    from xvc_tpu.native import enc as jenc
    from xvc_tpu_torch.native import enc as tenc
    seen = {"jax": [], "port": []}

    def spy(key, real):
        def encode_picture(pic_encoder, segment, settings, base_qp, **kw):
            pd = pic_encoder.pic_data
            rpl = pd.ref_pic_lists
            seen[key].append(dict(
                qp=base_qp.qp_raw, lam=base_qp.get_lambda(),
                poc=pd.poc, nal=int(pd.nal_type), lic=pd.lic_active,
                tmvp=(pd.tmvp_valid, pd.tmvp_ref_list, pd.tmvp_ref_idx),
                refs=[[e.poc for e in lst] for lst in rpl.entries],
                orig=[pic_encoder.orig_pic.plane_view(c).copy()
                      for c in range(3)]))
            return real(pic_encoder, segment, settings, base_qp, **kw)
        return encode_picture

    w, h, f = 192, 192, 3
    yuv = wavefront_clip(w, h, f)
    params = dict(width=w, height=h, qp=30, speed_mode=3, low_delay=1,
                  num_ref_pics=2, sub_gop_length=1, checksum_mode=1)
    real_j, real_t = jenc.encode_picture, tenc.encode_picture
    jenc.encode_picture = spy("jax", real_j)
    tenc.encode_picture = spy("port", real_t)
    try:
        session_encode(japi.EncoderSession(japi.EncoderParameters(**params)),
                       yuv, w, h, f)
        session_encode(api.EncoderSession(api.EncoderParameters(**params),
                                          device="cpu"), yuv, w, h, f)
    finally:
        jenc.encode_picture, tenc.encode_picture = real_j, real_t
    assert len(seen["port"]) == len(seen["jax"]) == f
    for a, b in zip(seen["port"], seen["jax"]):
        for key in ("qp", "lam", "poc", "nal", "lic", "tmvp", "refs"):
            assert a[key] == b[key], key
        for pa, pb in zip(a["orig"], b["orig"]):
            assert np.array_equal(pa, pb)
    from xvc_tpu.cabac.contexts import CabacContexts as JaxContexts
    from xvc_tpu_torch.cabac.contexts import CabacContexts
    from xvc_tpu_torch.restrictions import Restrictions
    for qp in (22, 32, 45):
        for pic_type in (k.PicturePredictionType.INTRA,
                         k.PicturePredictionType.UNI,
                         k.PicturePredictionType.BI):
            ours, theirs = CabacContexts(Restrictions()), \
                JaxContexts(Restrictions())
            ours.reset_states(qp, pic_type)
            theirs.reset_states(qp, pic_type)
            assert np.array_equal(ours.state, theirs.state)


def test_native_encoders_consume_the_same_maps_alike(monkeypatch):
    """The same seeded force maps and intra candidates (not what the
    device stages would give: every node and block with a decision)
    handed to both packages' native encoders through their picture
    encoders give the same bytes."""
    from xvc_tpu.tpu import txrd_prepass as jtx
    from xvc_tpu.tpu import wavefront_rdo as jwf
    from xvc_tpu_torch.gpu import txrd_prepass as ttx
    from xvc_tpu_torch.gpu import wavefront_rdo as twf
    w, h, f = 192, 192, 2
    rng = np.random.RandomState(17)
    cands = {n: rng.randint(0, 67, (h // n, w // n, 2)).astype(np.int32)
             for n in (4, 8, 16, 32)}
    force = {n: rng.randint(-1, 2, (h // n, w // n)).astype(np.int8)
             for n in (16, 32, 64)}
    for mod in (jtx, ttx):
        monkeypatch.setattr(mod, "frame_txrd_prepass",
                            lambda *a, **kw: cands)
    for mod in (jwf, twf):
        monkeypatch.setattr(mod, "split_dp_from_lookahead",
                            lambda *a, **kw: force)
    yuv = wavefront_clip(w, h, f)
    kw = dict(qp=32, sub_gop_length=1, num_ref_pics=1, checksum_mode=1,
              low_delay=True)
    want = write_nal_units(jax_encode_stream(
        yuv, w, h, f, settings=_settings(JaxSettings, 3, 2), **kw))
    got = write_nal_units(encode_stream(
        yuv, w, h, f, settings=_settings(EncoderSettings, 3, 2),
        device="cpu", **kw))
    assert got == want
