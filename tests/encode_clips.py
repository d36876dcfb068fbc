"""Raw YUV clips the port's encoder tests encode (numpy only, so that the
card tests, which run without JAX, share them with the CPU tests).

``make_hd720_s3`` is the recipe of hd720_s3, the encode clip of
chip_smoke.py phase 6 (the script carries its own copy;
tests/test_torch_encode.py holds the two equal).  ``PYTHON_CU`` and
``crop_pictures`` are the recipe of phase 8's clips, and
``make_python_cu_refs`` records the JAX package's streams of them
(tests/data/bench/python_cu_enc.json; the script's copy is held equal by
tests/test_torch_python_cu.py).  ``PYTHON_CU_INTER`` and
``make_python_cu_inter_refs`` do the same for phase 9's inter clips
(tests/data/bench/python_cu_inter.json; held equal by
tests/test_torch_python_cu_inter.py) and, with ``PYTHON_CU_TILES``, for
phase 11's tile clip (tests/data/bench/python_cu_tiles.json).
``TILE_STREAMS`` and ``make_tile_stream`` are the recipes of the
committed CTU-tile-row streams (tests/data/bench/hd720_tiles4.xvc and
the small ones) and their hash lists.
"""
import os

import numpy as np


def wavefront_clip(w=192, h=192, f=2):
    """The structured clip of tests/test_wavefront_rdo.py
    test_speed3_native_python_identical_and_conforming: a flat band,
    moving stripes, a noise band."""
    yy, xx = np.mgrid[0:h, 0:w]
    rng = np.random.RandomState(5)
    frames = []
    for t in range(f):
        y = np.zeros((h, w), np.int32)
        y[:64] = 210
        y[64:128] = 128 + 80 * (((xx[:64] + 4 * t) >> 3) & 1)
        y[128:] = 128 + rng.randint(-20, 21, (64, w))
        frames += [np.clip(y, 0, 255).astype(np.uint8).tobytes(),
                   np.full((h // 2, w // 2), 120, np.uint8).tobytes(),
                   np.full((h // 2, w // 2), 130, np.uint8).tobytes()]
    return b"".join(frames)


def txrd_clip(w, h, f, seed=3):
    """The clip of tests/test_txrd_prepass.py synthetic_yuv420."""
    rng = np.random.RandomState(seed)
    base = (128 + 60 * np.sin(np.arange(w)[None, :] / 9.0) *
            np.cos(np.arange(h)[:, None] / 7.0)).astype(np.uint8)
    out = []
    for i in range(f):
        y = np.roll(base, i * 2, axis=1).copy()
        y[h // 2:, :] = rng.randint(0, 256, (h - h // 2, w))
        u = np.full((h // 2, w // 2), 110 + i, np.uint8)
        v = np.full((h // 2, w // 2), 130 - i, np.uint8)
        out += [y.tobytes(), u.tobytes(), v.tobytes()]
    return b"".join(out)


# hd720_s3, the encode clip of chip_smoke.py phase 6
HD720_S3 = dict(width=1280, height=720, frames=4, qp=32, seed=20261017)


def make_hd720_s3(seed=HD720_S3["seed"]):
    """The raw 8-bit 4:2:0 bytes of hd720_s3: 1280x720, 4 pictures, from
    a numpy seed.  Luma quadrants: flat (top left, +2 a picture),
    diagonal stripes moving 4 samples a picture (top right), a noise
    texture moving by (2, 1) (bottom left), a ramp brightening by 3 a
    picture (bottom right), so that the split DP forces decisions both
    ways and the prepass has real choices; smooth chroma."""
    W, H, N = HD720_S3["width"], HD720_S3["height"], HD720_S3["frames"]
    rng = np.random.RandomState(seed)
    tex = rng.randint(-40, 41, (H // 2 + 8, W // 2 + 8))
    yy, xx = np.mgrid[0:H, 0:W]
    cy, cx = np.mgrid[0:H // 2, 0:W // 2]
    out = []
    for t in range(N):
        y = np.empty((H, W), np.int64)
        y[:H // 2, :W // 2] = 90 + 2 * t
        tr = (xx[:H // 2, W // 2:] + yy[:H // 2, W // 2:] // 2 + 4 * t) // 12
        y[:H // 2, W // 2:] = 60 + 130 * (tr & 1)
        y[H // 2:, :W // 2] = 128 + tex[t:t + H // 2, 2 * t:2 * t + W // 2]
        y[H // 2:, W // 2:] = ((xx[H // 2:, W // 2:] - W // 2) * 200 //
                               (W // 2) + (yy[H // 2:, W // 2:] - H // 2)
                               // 8 + 3 * t)
        u = 128 + (30 * np.sin(cx / 40.0 + t / 4.0)).astype(np.int64)
        v = 120 + (cy * 40) // (H // 2)
        out += [np.clip(p, 0, 255).astype(np.uint8).tobytes()
                for p in (y, u, v)]
    return b"".join(out)


# ra720_s3, the threaded encode clip of chip_smoke.py phase 10: random
# access with sub-GOP 8 (so that up to four pictures of a sub-GOP are coded
# at once), speed mode 3, the speed mode's one reference picture
RA720_S3 = dict(width=1280, height=720, frames=9, qp=32, sub_gop_length=8,
                seed=20261018)


def make_ra720_s3(seed=RA720_S3["seed"]):
    """The raw 8-bit 4:2:0 bytes of ra720_s3: 1280x720, 9 pictures, from a
    numpy seed, with hd720_s3's content (``make_hd720_s3``) and more
    motion: the flat quadrant brightens by 2 a picture, the stripes move 6
    samples a picture, the noise texture by (1, 3), the ramp brightens by
    3; smooth chroma drifting with the picture."""
    W, H, N = RA720_S3["width"], RA720_S3["height"], RA720_S3["frames"]
    rng = np.random.RandomState(seed)
    tex = rng.randint(-40, 41, (H // 2 + N, W // 2 + 3 * N))
    yy, xx = np.mgrid[0:H, 0:W]
    cy, cx = np.mgrid[0:H // 2, 0:W // 2]
    out = []
    for t in range(N):
        y = np.empty((H, W), np.int64)
        y[:H // 2, :W // 2] = 90 + 2 * t
        tr = (xx[:H // 2, W // 2:] + yy[:H // 2, W // 2:] // 2 + 6 * t) // 12
        y[:H // 2, W // 2:] = 60 + 130 * (tr & 1)
        y[H // 2:, :W // 2] = 128 + tex[t:t + H // 2, 3 * t:3 * t + W // 2]
        y[H // 2:, W // 2:] = ((xx[H // 2:, W // 2:] - W // 2) * 200 //
                               (W // 2) + (yy[H // 2:, W // 2:] - H // 2)
                               // 8 + 3 * t)
        u = 128 + (30 * np.sin(cx / 40.0 + t / 4.0)).astype(np.int64)
        v = 120 + (cy * 40) // (H // 2) + t
        out += [np.clip(p, 0, 255).astype(np.uint8).tobytes()
                for p in (y, u, v)]
    return b"".join(out)


def ra720_s3_params(module, threads=0):
    """EncoderParameters of ra720_s3 for ``module`` (xvc_tpu.api or
    xvc_tpu_torch.api) with ``threads`` picture threads."""
    return module.EncoderParameters(
        width=RA720_S3["width"], height=RA720_S3["height"],
        qp=RA720_S3["qp"], speed_mode=3,
        sub_gop_length=RA720_S3["sub_gop_length"], checksum_mode=1,
        threads=threads)


def make_ra720_s3_refs(bench_dir):
    """Write ``<bench_dir>/ra720_s3_enc.json`` and ``ra720_s3_cands.npz``:
    the JAX package's EncoderSession on ra720_s3 with no picture threads.
    The sha256 and byte count of the length-prefixed stream, every NAL's
    sha256, each picture's PSNR (Y, U, V) and the sha256 of the
    reconstructions in output order; the packed prepass candidates of
    each picture (pack_intra_cands, keep 1), in coding order.  Some
    minutes on one CPU core."""
    import hashlib
    import json
    from xvc_tpu import api as japi
    from xvc_tpu.nal import write_nal_units
    from xvc_tpu.tpu import txrd_prepass as jtx
    yuv = make_ra720_s3()
    W, H, N = RA720_S3["width"], RA720_S3["height"], RA720_S3["frames"]
    cands = []
    pack = jtx.pack_intra_cands

    def spy(*args, **kw):
        buf = pack(*args, **kw)
        cands.append(buf.copy())
        return buf

    jtx.pack_intra_cands = spy
    try:
        ses = japi.EncoderSession(ra720_s3_params(japi))
        fs = W * H * 3 // 2
        nals = []
        for i in range(N):
            nals += ses.encode(yuv[i * fs:(i + 1) * fs])
        nals += ses.flush()
    finally:
        jtx.pack_intra_cands = pack
    assert len(cands) == N
    data = write_nal_units(nals)
    refs = dict(
        clip=dict(RA720_S3), sha256=hashlib.sha256(data).hexdigest(),
        bytes=len(data),
        nal_sha256=[hashlib.sha256(n).hexdigest() for n in nals],
        psnr=[list(map(float, s.psnr)) for s in ses.nal_stats
              if s.nal_unit_type != SEGMENT_HEADER],
        rec_sha256=hashlib.sha256(b"".join(ses.rec_pictures)).hexdigest())
    with open(os.path.join(bench_dir, "ra720_s3_enc.json"), "w") as f:
        json.dump(refs, f, indent=1)
        f.write("\n")
    np.savez_compressed(os.path.join(bench_dir, "ra720_s3_cands.npz"),
                        cands=np.stack(cands))


# The splices: two streams of one recipe at two sizes, joined at their
# second segment headers (the open-GOP splice of tools/make_golden.py
# make_scalability_vector, encoded by the JAX package's EncoderSession
# instead of the reference binary).  hd720_fhd1080_splice is the full-width
# one of chip_smoke.py (1280x720 then 1920x1080: the output stays latched
# at 720p, so every 1080p picture is downscaled on output and the 720p
# tail pictures predict from the downscaled 1080p key picture); the small
# one goes the other way (96x64 then 64x48: both upsample).
SPLICES = {"bench/hd720_fhd1080_splice": ((1280, 720), (1920, 1080), 17),
           "splice96x64to64x48": ((96, 64), (64, 48), 17)}
SEGMENT_HEADER = 16  # NalUnitType.SEGMENT_HEADER


def _splice_stream(size, frames):
    """The NALs of one side of a splice: synth_yuv420's clip of
    tools/make_golden.py through the JAX package's EncoderSession, 8-bit
    4:2:0, qp 32, checksum mode 1, sub-GOP 4, a key picture every 8, two
    reference pictures, speed mode 2."""
    from tools.make_golden import synth_yuv420
    from xvc_tpu import api as japi
    w, h = size
    yuv = synth_yuv420(w, h, frames, 8)
    ses = japi.EncoderSession(japi.EncoderParameters(
        width=w, height=h, qp=32, checksum_mode=1, sub_gop_length=4,
        max_keypic_distance=8, num_ref_pics=2, speed_mode=2))
    fs = w * h * 3 // 2
    nals = []
    for t in range(frames):
        nals += ses.encode(yuv[t * fs:(t + 1) * fs])
    return nals + ses.flush()


def make_splice(name, data_dir):
    """Write ``<data_dir>/<name>.xvc`` (a key of SPLICES): the first
    stream up to its second segment header, then the second stream from
    its second segment header on.  The 1080p side of the full-width
    splice takes some minutes on one CPU core."""
    from xvc_tpu.nal import write_nal_units
    first, second, frames = SPLICES[name]
    parts = []
    for size in (first, second):
        nals = _splice_stream(size, frames)
        parts.append((nals, next(i for i in range(1, len(nals))
                                 if (nals[i][0] >> 1) & 31 ==
                                 SEGMENT_HEADER)))
    (n1, i1), (n2, i2) = parts
    with open(os.path.join(data_dir, name + ".xvc"), "wb") as f:
        f.write(write_nal_units(n1[:i1] + n2[i2:]))


# The hash lists of the card's resampling decodes (chip_smoke.py phase 7):
# name -> (stream under tests/data/bench, DecoderParameters fields).  The
# splice at its own output size (its first segment's, 1280x720), the
# others resized on output: hd720_ld up to 1920x1080, fhd1080_ra down to
# 1280x720 (the 12-tap class 2), qhd1440_ra10 down to 1920x1080 at 8 bit
# without dither.
RESIZED = {"hd720_fhd1080_splice": ("hd720_fhd1080_splice", {}),
           "hd720_ld_out1920x1080": ("hd720_ld", dict(output_width=1920,
                                                      output_height=1080)),
           "fhd1080_ra_out1280x720": ("fhd1080_ra", dict(output_width=1280,
                                                         output_height=720)),
           "qhd1440_ra10_out1920x1080b8": ("qhd1440_ra10", dict(
               output_width=1920, output_height=1080, output_bitdepth=8))}


def jax_session_decode(data, **params):
    """The JAX package's host decode through its DecoderSession, drained
    with the blocking pull."""
    from xvc_tpu import api as japi
    from xvc_tpu.nal import split_nal_units
    ses = japi.DecoderSession(japi.DecoderParameters(**params))
    pics = []
    for nal in split_nal_units(data):
        ses.decode_nal(nal)
        while (pic := ses.get_picture()) is not None:
            pics.append(pic)
    ses.flush()
    while (pic := ses.get_picture()) is not None:
        pics.append(pic)
    return pics


def hash_lines(pics):
    """The lines of a hash list: sha256, the POC, and "checksum-mismatch"
    where the picture does not conform."""
    import hashlib
    return ["%s  poc %d%s" % (hashlib.sha256(p.bytes).hexdigest(), p.poc,
                              "" if p.conforming else "  checksum-mismatch")
            for p in pics]


def make_resized_hashes(name, bench_dir):
    """Write ``<bench_dir>/<name>_dec.sha256`` (a key of RESIZED) from the
    JAX package's host decode."""
    stream, params = RESIZED[name]
    with open(os.path.join(bench_dir, stream + ".xvc"), "rb") as f:
        pics = jax_session_decode(f.read(), **params)
    with open(os.path.join(bench_dir, name + "_dec.sha256"), "w") as f:
        f.write("\n".join(hash_lines(pics)) + "\n")


# The Python CU encoder's clips (chip_smoke.py phase 8, which carries its
# own copy of this table and of ``crop_pictures``): crops at (0, 0) of the
# first pictures of tests/data/bench/hd720_ld.xvc as decoded, 8-bit 4:2:0,
# all-intra (num_ref_pics 0, sub-GOP 1), qp 32, speed mode 2, checksum
# mode 1.  cif_la: 352x288, one picture, with tpu_intra_lookahead; qcif_pp:
# 176x144, two pictures, under XVC_INTRA_PREPASS=jax (the per-CU device
# SATD pre-pass).  CIF and not 1280x720: the Python CU encoder spends
# seconds of host Python a CTU.
PYTHON_CU = {
    "cif_la": dict(width=352, height=288, pictures=1,
                   settings="tpu_intra_lookahead 1", env={}),
    "qcif_pp": dict(width=176, height=144, pictures=2, settings="",
                    env={"XVC_INTRA_PREPASS": "jax"}),
}
PYTHON_CU_SOURCE = ("hd720_ld", 1280, 720)


def crop_pictures(pictures, src_w, src_h, w, h):
    """The 4:2:0 8-bit bytes of the top-left w x h crop of each picture
    (``pictures``: the packed 4:2:0 bytes of src_w x src_h pictures)."""
    out = []
    for pic in pictures:
        buf = np.frombuffer(pic, np.uint8)
        y = buf[:src_w * src_h].reshape(src_h, src_w)
        cw, ch = src_w // 2, src_h // 2
        u = buf[src_w * src_h:][:cw * ch].reshape(ch, cw)
        v = buf[src_w * src_h + cw * ch:][:cw * ch].reshape(ch, cw)
        out += [np.ascontiguousarray(y[:h, :w]).tobytes(),
                np.ascontiguousarray(u[:h // 2, :w // 2]).tobytes(),
                np.ascontiguousarray(v[:h // 2, :w // 2]).tobytes()]
    return b"".join(out)


def python_cu_params(module, name):
    """EncoderParameters of a PYTHON_CU clip for ``module`` (xvc_tpu.api
    or xvc_tpu_torch.api)."""
    clip = PYTHON_CU[name]
    return module.EncoderParameters(
        width=clip["width"], height=clip["height"], qp=32, speed_mode=2,
        num_ref_pics=0, sub_gop_length=1, checksum_mode=1,
        explicit_encoder_settings=clip["settings"])


def make_python_cu_refs(bench_dir):
    """Write ``<bench_dir>/python_cu_enc.json``: for each PYTHON_CU clip,
    the sha256 and byte count of the JAX package's length-prefixed stream
    (its EncoderSession, under the clip's environment), every NAL's sha256
    and each picture's PSNR.  About five minutes on one CPU core."""
    import hashlib
    import json
    from xvc_tpu import api as japi
    from xvc_tpu.nal import write_nal_units
    stream, src_w, src_h = PYTHON_CU_SOURCE
    with open(os.path.join(bench_dir, stream + ".xvc"), "rb") as f:
        decoded = [p.bytes for p in jax_session_decode(f.read())]
    refs = {"source": list(PYTHON_CU_SOURCE),
            "clips": {n: {k: v for k, v in c.items()}
                      for n, c in PYTHON_CU.items()}}
    for name, clip in PYTHON_CU.items():
        w, h, n = clip["width"], clip["height"], clip["pictures"]
        yuv = crop_pictures(decoded[:n], src_w, src_h, w, h)
        saved = {k: os.environ.get(k) for k in clip["env"]}
        os.environ.update(clip["env"])
        try:
            ses = japi.EncoderSession(python_cu_params(japi, name))
            fs = w * h * 3 // 2
            nals = []
            for i in range(n):
                nals += ses.encode(yuv[i * fs:(i + 1) * fs])
            nals += ses.flush()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        data = write_nal_units(nals)
        refs[name] = dict(
            sha256=hashlib.sha256(data).hexdigest(), bytes=len(data),
            nal_sha256=[hashlib.sha256(x).hexdigest() for x in nals],
            psnr=[list(map(float, s.psnr)) for s in ses.nal_stats
                  if s.nal_unit_type != SEGMENT_HEADER])
    with open(os.path.join(bench_dir, "python_cu_enc.json"), "w") as f:
        json.dump(refs, f, indent=1)
        f.write("\n")


# The Python CU encoder's inter clips (chip_smoke.py phase 9, which carries
# its own copy of this table), both under XVC_ME=jax, qp 32, checksum mode
# 1.  qcif_me: the top-left 176x144 crops of the first two pictures of
# tests/data/bench/hd720_ld.xvc as decoded, low delay with one reference,
# speed mode 2, the uni-prediction search range set to 64 so that the TZ
# search's sweeps fit the device window (at the default 96-256 they never
# do).  ra64x48_me: the first five pictures of tests/data/ra64x48_in.yuv,
# random access with sub-GOP 4 and two references (bi-prediction), the
# default settings.
PYTHON_CU_INTER = {
    "qcif_me": dict(
        source="bench/hd720_ld.xvc", width=176, height=144, pictures=2,
        params=dict(num_ref_pics=1, sub_gop_length=1, low_delay=1,
                    speed_mode=2),
        settings="inter_search_range_uni_max 64 inter_search_range_uni_min 64",
        env={"XVC_ME": "jax"}),
    "ra64x48_me": dict(
        source="ra64x48_in.yuv", width=64, height=48, pictures=5,
        params=dict(num_ref_pics=2, sub_gop_length=4), settings="",
        env={"XVC_ME": "jax"}),
}


# More inter clips of the Python CU encoder under XVC_ME=jax, qp 32,
# checksum mode 1, random access with sub-GOP 4 and two references, the
# default settings (the JAX package's streams in
# tests/data/bench/python_cu_inter_more.json).  ra64x48_me4: the first four
# pictures of tests/data/ra64x48_in.yuv (pictures 1 and 3 predict from the
# same two references, so that picture threads code them at once);
# ra64x48b10_me: the first two of tests/data/ra64x48b10_in.yuv, 10-bit
# input and coding; c422_ra64x48_me: two 8-bit 4:2:2 pictures of the
# texture of tests/data/c422_ra64x48.xvc (``chroma_ra_clip``).
PYTHON_CU_INTER_MORE = {
    "ra64x48_me4": dict(
        source="ra64x48_in.yuv", width=64, height=48, pictures=4,
        params=dict(num_ref_pics=2, sub_gop_length=4), settings="",
        env={"XVC_ME": "jax"}),
    "ra64x48b10_me": dict(
        source="ra64x48b10_in.yuv", width=64, height=48, pictures=2,
        params=dict(num_ref_pics=2, sub_gop_length=4, input_bitdepth=10,
                    internal_bitdepth=10), settings="",
        env={"XVC_ME": "jax"}),
    "c422_ra64x48_me": dict(
        source="chroma_ra_clip", width=64, height=48, pictures=2,
        params=dict(num_ref_pics=2, sub_gop_length=4, chroma_format=2),
        settings="", env={"XVC_ME": "jax"}),
}


# The Python CU encoder's tile clip (chip_smoke.py phase 11, which carries
# its own copy of this table): qcif_tiles, qcif_me's input and settings
# (XVC_ME=jax, low delay, one reference, speed mode 2, range 64) with its
# 3 CTU rows cut into 3 tiles, under XVC_INTRA_PREPASS=jax too (the JAX
# package's streams in tests/data/bench/python_cu_tiles.json).
PYTHON_CU_TILES = {
    "qcif_tiles": dict(
        source="bench/hd720_ld.xvc", width=176, height=144, pictures=2,
        params=dict(num_ref_pics=1, sub_gop_length=1, low_delay=1,
                    speed_mode=2),
        settings="inter_search_range_uni_max 64 inter_search_range_uni_min "
                 "64 tile_rows 3",
        env={"XVC_ME": "jax", "XVC_INTRA_PREPASS": "jax"}),
}
INTER_TABLES = {"python_cu_inter": PYTHON_CU_INTER,
                "python_cu_inter_more": PYTHON_CU_INTER_MORE,
                "python_cu_tiles": PYTHON_CU_TILES}


def inter_clip(name):
    """The clip ``name`` of PYTHON_CU_INTER, PYTHON_CU_INTER_MORE or
    PYTHON_CU_TILES."""
    return next(t[name] for t in INTER_TABLES.values() if name in t)


def frame_bytes(clip):
    """The bytes of one raw input picture of an inter clip."""
    w, h = clip["width"], clip["height"]
    chroma = clip["params"].get("chroma_format", 1)
    samples = {0: w * h, 1: w * h * 3 // 2, 2: w * h * 2, 3: w * h * 3}
    wide = clip["params"].get("input_bitdepth", 8) > 8
    return samples[chroma] * (2 if wide else 1)


def chroma_ra_clip(w, h, n, chroma_format):
    """The 8-bit pictures of the recipe of tests/data/c422_ra64x48.xvc
    (``make_chroma_ra`` of tests/test_torch_recon.py): a textured gradient
    moving by (3, 2) samples a picture, +8*t on the left half of the luma
    of picture t."""
    rng = np.random.RandomState(7)
    tex = rng.randint(0, 256, (h + 32, w + 32))
    yy, xx = np.mgrid[0:h + 32, 0:w + 32]
    base = (0.5 * tex + 0.5 * ((xx * 4 + yy * 3) % 256)).astype(np.int32)
    cw = w if chroma_format == 3 else w // 2
    ch = h // 2 if chroma_format == 1 else h
    out = []
    for t in range(n):
        y = base[2 * t:2 * t + h, 3 * t:3 * t + w].copy()
        y[:, :w // 2] += 8 * t
        c = base[2 * t:2 * t + ch, 3 * t:3 * t + cw] - 128
        out += [np.clip(p, 0, 255).astype(np.uint8).tobytes()
                for p in (y, 128 + c // 4, 128 - c // 4)]
    return b"".join(out)


def python_cu_inter_input(name, data_dir, decode=None):
    """The raw bytes of an inter clip (PYTHON_CU_INTER,
    PYTHON_CU_INTER_MORE or PYTHON_CU_TILES).  ``decode(data)`` returns the packed pictures
    of a stream (the JAX package's host decode when None)."""
    clip = inter_clip(name)
    w, h, n = clip["width"], clip["height"], clip["pictures"]
    if clip["source"] == "chroma_ra_clip":
        return chroma_ra_clip(w, h, n, clip["params"]["chroma_format"])
    with open(os.path.join(data_dir, clip["source"]), "rb") as f:
        data = f.read()
    if not clip["source"].endswith(".xvc"):
        return data[:n * frame_bytes(clip)]
    if decode is None:
        pics = [p.bytes for p in jax_session_decode(data)]
    else:
        pics = decode(data)
    return crop_pictures(pics[:n], 1280, 720, w, h)


def python_cu_inter_params(module, name, threads=0):
    """EncoderParameters of an inter clip for ``module``, with
    ``threads`` picture threads."""
    clip = inter_clip(name)
    return module.EncoderParameters(
        width=clip["width"], height=clip["height"], qp=32, checksum_mode=1,
        explicit_encoder_settings=clip["settings"], threads=threads,
        **clip["params"])


def make_python_cu_inter_refs(data_dir, refs_name="python_cu_inter"):
    """Write ``<data_dir>/bench/<table>.json``: for each clip of
    PYTHON_CU_INTER (``refs_name`` "python_cu_inter"), PYTHON_CU_INTER_MORE
    ("python_cu_inter_more") or PYTHON_CU_TILES ("python_cu_tiles"), the
    sha256 and byte count of the JAX
    package's length-prefixed stream (its EncoderSession under the clip's
    environment), every NAL's sha256, each picture's PSNR, the sha256 of
    its reconstructions in output order, and how its
    ``DeviceSadTable.prefetch`` calls went: all calls, those its device
    function evaluated and their new candidates.  About six and four
    minutes on one CPU core."""
    import hashlib
    import json
    from xvc_tpu import api as japi
    from xvc_tpu.nal import write_nal_units
    from xvc_tpu.tpu import me as jme
    clips = INTER_TABLES[refs_name]
    refs = {"clips": {n: dict(c) for n, c in clips.items()}}
    real = jme.DeviceSadTable.prefetch
    for name, clip in clips.items():
        counts = dict(prefetches=0, device_calls=0, device_candidates=0)

        def counted(table, qp, mvs):
            counts["prefetches"] += 1
            before = len(table.cache)
            real(table, qp, mvs)
            if len(table.cache) > before:
                counts["device_calls"] += 1
                counts["device_candidates"] += len(table.cache) - before

        yuv = python_cu_inter_input(name, data_dir)
        w, h, n = clip["width"], clip["height"], clip["pictures"]
        saved = {k: os.environ.get(k) for k in clip["env"]}
        os.environ.update(clip["env"])
        jme.DeviceSadTable.prefetch = counted
        try:
            ses = japi.EncoderSession(python_cu_inter_params(japi, name))
            fs = frame_bytes(clip)
            nals = []
            for i in range(n):
                nals += ses.encode(yuv[i * fs:(i + 1) * fs])
            nals += ses.flush()
        finally:
            jme.DeviceSadTable.prefetch = real
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        data = write_nal_units(nals)
        refs[name] = dict(
            sha256=hashlib.sha256(data).hexdigest(), bytes=len(data),
            nal_sha256=[hashlib.sha256(x).hexdigest() for x in nals],
            psnr=[list(map(float, s.psnr)) for s in ses.nal_stats
                  if s.nal_unit_type != SEGMENT_HEADER],
            rec_sha256=hashlib.sha256(
                b"".join(ses.rec_pictures)).hexdigest(),
            me=counts)
    with open(os.path.join(data_dir, "bench", refs_name + ".json"), "w") as f:
        json.dump(refs, f, indent=1)
        f.write("\n")


def synthetic_yuv420(w, h, f, seed=5):
    """The clip of tests/test_tiles.py synthetic_yuv420: a moving sine
    pattern with noise in the luma, flat U rising by 1 a picture, noise
    in V."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t in range(f):
        y = (128 + 80 * np.sin(2 * np.pi * (xx + 5 * t) / w) *
             np.cos(2 * np.pi * yy / h) +
             rng.randint(-10, 11, (h, w))).clip(0, 255).astype(np.uint8)
        u = np.full((h // 2, w // 2), 100 + t, np.uint8)
        v = rng.randint(100, 156, (h // 2, w // 2)).astype(np.uint8)
        out += [y.tobytes(), u.tobytes(), v.tobytes()]
    return b"".join(out)


# The tile-row streams (chip_smoke.py phase 11 and the card's -k tiles
# tests): synthetic_yuv420 through the JAX package's encode_stream, 8-bit
# 4:2:0, qp 32, speed mode 2, checksum mode 1, low delay with one
# reference (sub-GOP 1), the CTU rows cut into ``tile_rows`` tiles.
# hd720_tiles4: 1280x720, 12 CTU rows in 4 tiles of 3, one intra and two
# inter pictures (about 90 minutes of encoding on one CPU core).
# tiles64x256: 64x256, 4 tiles, the flat path's small stream.
# tiles64x128_lic: 64x128, 2 tiles, 16*t added to the luma of picture t
# and the explicit setting fast_inter_local_illumination_comp 0 (speed
# mode 2 sets it), so that the encoder turns local illumination
# compensation on, which the flat path refuses: the replay path's small
# stream.
TILE_STREAMS = {
    "hd720_tiles4": dict(width=1280, height=720, frames=3, tile_rows=4,
                         seed=20261018, luma_step=0, settings=""),
    "tiles64x256": dict(width=64, height=256, frames=3, tile_rows=4,
                        seed=12, luma_step=0, settings=""),
    "tiles64x128_lic": dict(
        width=64, height=128, frames=3, tile_rows=2, seed=9, luma_step=16,
        settings="fast_inter_local_illumination_comp 0"),
}


def tile_stream_yuv(name):
    """The raw 4:2:0 bytes of the TILE_STREAMS entry ``name``."""
    c = TILE_STREAMS[name]
    w, h, f = c["width"], c["height"], c["frames"]
    raw = bytearray(synthetic_yuv420(w, h, f, c["seed"]))
    fs = w * h * 3 // 2
    for t in range(f):
        y = np.frombuffer(bytes(raw[t * fs:t * fs + w * h]), np.uint8)
        raw[t * fs:t * fs + w * h] = np.clip(
            y.astype(np.int32) + c["luma_step"] * t, 0, 255).astype(
                np.uint8).tobytes()
    return bytes(raw)


def tile_stream_nals(name):
    """The JAX package's NALs of the TILE_STREAMS entry ``name``."""
    from xvc_tpu.codec.encoder import encode_stream
    from xvc_tpu.codec.encoder_settings import EncoderSettings
    c = TILE_STREAMS[name]
    w, h, f = c["width"], c["height"], c["frames"]
    s = EncoderSettings()
    s.initialize_speed(2)
    s.parse_explicit_settings(c["settings"])
    s.tile_rows = c["tile_rows"]
    return encode_stream(tile_stream_yuv(name), w, h, f,
                         qp=32, settings=s, sub_gop_length=1,
                         num_ref_pics=1, low_delay=True, checksum_mode=1)


def make_tile_stream(name, bench_dir):
    """Write ``<bench_dir>/<name>.xvc`` and its ``_dec.sha256`` (the JAX
    package's host decode) for the TILE_STREAMS entry ``name``."""
    from xvc_tpu.nal import write_nal_units
    data = write_nal_units(tile_stream_nals(name))
    with open(os.path.join(bench_dir, name + ".xvc"), "wb") as f:
        f.write(data)
    pics = jax_session_decode(data)
    with open(os.path.join(bench_dir, name + "_dec.sha256"), "w") as f:
        f.write("\n".join(hash_lines(pics)) + "\n")


# The 15-bit streams (tests/test_torch_highbit.py, tests/test_torch_cuda.py
# -k b15 and chip_smoke.py phase 12): 4:2:0 clips lifted to 15 bit,
# through the JAX package's encode_stream (its native encoder), qp 20
# (ra64x48b15, tiles64x128b15) or 32, checksum mode 1.
# ra64x48b15: the first five pictures of tests/data/ra64x48_in.yuv as
# sample << 7 plus seeded noise in the low 7 bits, with two flat 16x16
# squares holding a brighter 8x8 core (their residuals are DC-only
# blocks) and a one-sample checkerboard at (40, 0) (transform skip);
# random access, sub-GOP 4, two references.  The generator asserts that
# its parsed tree holds bi-prediction, full-pel and sub-pel motion
# vectors, DC-only blocks of the DCT-2 family, transform skip and LM.
# tiles64x128b15: synthetic_yuv420 lifted the same way, low delay with
# one reference, 2 CTU tile rows, speed mode 2.  bench/hd720_b15: the
# same at 1280x720, low delay, 4 pictures, speed mode 2 (about 140 s of
# the native encoder on one CPU core).
B15_STREAMS = {
    "ra64x48b15": dict(
        source="ra64x48_in.yuv", width=64, height=48, frames=5, seed=6,
        qp=20, params=dict(num_ref_pics=2, sub_gop_length=4),
        squares=[(0, 16), (32, 48)], checker=(40, 0), tile_rows=1,
        speed_mode=1),
    "tiles64x128b15": dict(
        source="synthetic", width=64, height=128, frames=3, seed=11,
        qp=20, params=dict(num_ref_pics=1, sub_gop_length=1,
                           low_delay=True),
        squares=[], checker=None, tile_rows=2, speed_mode=2),
    "bench/hd720_b15": dict(
        source="synthetic", width=1280, height=720, frames=4, seed=15,
        qp=32, params=dict(num_ref_pics=1, sub_gop_length=1,
                           low_delay=True),
        squares=[], checker=None, tile_rows=1, speed_mode=2),
}
B15_FEATURES = ("bi", "fullpel", "subpel", "dc_dct2", "tskip", "lm")


def b15_yuv(name, data_dir):
    """The raw 15-bit 4:2:0 input of the B15_STREAMS entry ``name``
    (little-endian 16-bit samples)."""
    c = B15_STREAMS[name]
    w, h, f = c["width"], c["height"], c["frames"]
    fs = w * h * 3 // 2
    if c["source"] == "synthetic":
        raw = synthetic_yuv420(w, h, f, c["seed"])
    else:
        with open(os.path.join(data_dir, c["source"]), "rb") as fh:
            raw = fh.read()[:fs * f]
    a = np.frombuffer(raw, np.uint8).astype(np.int64)
    rng = np.random.RandomState(c["seed"])
    a = (a << 7) | rng.randint(0, 128, a.shape)
    checker = 30000 * ((np.arange(8)[:, None] + np.arange(8)[None, :]) % 2)
    for t in range(f):
        y = a[t * fs:t * fs + w * h].reshape(h, w)
        for by, bx in c["squares"]:
            y[by:by + 16, bx:bx + 16] = 12000
            y[by + 4:by + 12, bx + 4:bx + 12] = 20000
        if c["checker"] is not None:
            cy, cx = c["checker"]
            y[cy:cy + 8, cx:cx + 8] = checker
    return np.clip(a, 0, 32767).astype("<u2").tobytes()


def b15_encode(name, data_dir):
    """(NALs, reconstructions in output order) of the JAX package's
    encoder for the B15_STREAMS entry ``name`` (``encode_stream``'s
    settings, with the encoder's reconstructed pictures kept)."""
    from xvc_tpu.codec.encoder import Encoder
    from xvc_tpu.codec.encoder_settings import EncoderSettings
    c = B15_STREAMS[name]
    w, h, f = c["width"], c["height"], c["frames"]
    p = c["params"]
    s = EncoderSettings()
    s.initialize_speed(c["speed_mode"])
    s.tile_rows = c["tile_rows"]
    s.default_num_ref_pics = p["num_ref_pics"]
    enc = Encoder(15)
    enc.set_resolution(w, h)
    enc.set_chroma_format(1)
    enc.set_deblock(1)
    enc.set_checksum_mode(1)
    enc.set_qp(c["qp"])
    enc.set_low_delay(p.get("low_delay", False))
    enc.input_bitdepth = 15
    enc.set_encoder_settings(s)
    enc.set_num_ref_pics(p["num_ref_pics"])
    enc.set_sub_gop_length(p["sub_gop_length"])
    sub = p["sub_gop_length"]
    enc.set_segment_length((640 // sub) * sub)
    enc.set_closed_gop_interval(((1 << 62) // sub) * sub)
    yuv = b15_yuv(name, data_dir)
    fs = w * h * 3
    nals, recs = [], []

    def collect(out):
        nals.extend(n.bytes for n in out)
        poc, rec = enc.out_rec
        if poc is not None:
            recs.append(rec)
        enc.out_rec = (None, None)

    for t in range(f):
        collect(enc.encode(yuv[t * fs:(t + 1) * fs]))
    while True:
        out, more = enc.flush()
        collect(out)
        if not more:
            break
    return nals, recs


def b15_features(data):
    """The features of B15_FEATURES that the JAX package's parse of the
    stream ``data`` holds, each with its count of blocks; its host decode,
    with the residual of a DC-only block of the DCT-2 family set to the
    encoder's (0) instead of raising, must conform."""
    from xvc_tpu import constants as jk
    from xvc_tpu.codec import cu_decoder as jcd
    from xvc_tpu.ops import transform as jtx
    found = dict.fromkeys(B15_FEATURES, 0)
    real = jcd.CuDecoder._decompress_component

    def integer(mv):
        return ((mv[0] | mv[1]) & 15) == 0

    def seen(self, cu, comp, qp):
        try:
            return real(self, cu, comp, qp)
        finally:
            if cu.is_intra():
                if comp and cu.intra_mode_chroma == jk.INTRA_MODE_LM_CHROMA:
                    found["lm"] += 1
            elif comp == 0:
                lists = [0, 1] if cu.inter_dir == jk.InterDir.BI else \
                    [0 if cu.inter_dir == jk.InterDir.L0 else 1]
                found["bi"] += cu.inter_dir == jk.InterDir.BI
                found["fullpel"] += all(integer(cu.mv[i][0]) for i in lists)
                found["subpel"] += not all(integer(cu.mv[i][0])
                                           for i in lists)
            t0 = cu.get_transform_type(comp, 0)
            t1 = cu.get_transform_type(comp, 1)
            if cu.cbf[comp] and cu.transform_skip[comp]:
                found["tskip"] += 1
            elif (cu.cbf[comp] and cu.dc_only[comp] and t0 <= 1 and
                  t1 <= 1 and not (comp == 0 and cu.is_intra() and
                                   cu.size(0) == (4, 4))):
                found["dc_dct2"] += 1

    def dc_zero(coeff, tx_ver, tx_hor, bitdepth, high_precision,
                dc_only=False):
        # the residual the encoder gave such a block (F5), so that the
        # picture's parse goes on past it
        if dc_only and bitdepth > 14 and tx_ver <= 1 and tx_hor <= 1:
            return np.zeros(coeff.shape, np.int32)
        return real_itx(coeff, tx_ver, tx_hor, bitdepth, high_precision,
                        dc_only)

    real_itx = jtx.inverse_transform_np
    jcd.CuDecoder._decompress_component = seen
    jtx.inverse_transform_np = dc_zero
    try:
        pics = jax_session_decode(data)
    finally:
        jcd.CuDecoder._decompress_component = real
        jtx.inverse_transform_np = real_itx
    assert all(p.conforming for p in pics)
    return found


def make_b15_stream(name, data_dir):
    """Write ``<data_dir>/<name>.xvc`` and ``<name>_dec.sha256`` for the
    B15_STREAMS entry ``name``.  The hash list is of the JAX package's
    encoder's reconstructions, which the stream's checksums record: the
    JAX package's decode reports a picture with a DC-only block of the
    DCT-2 family as non-conforming (ROADMAP queue 3 F5), so its samples
    are no reference there.  ra64x48b15 must hold every feature of
    B15_FEATURES."""
    import hashlib
    from xvc_tpu.nal import write_nal_units
    nals, recs = b15_encode(name, data_dir)
    data = write_nal_units(nals)
    if name == "ra64x48b15":
        found = b15_features(data)
        missing = [f for f in B15_FEATURES if not found[f]]
        assert not missing, "ra64x48b15 lacks %r" % (missing,)
    with open(os.path.join(data_dir, name + ".xvc"), "wb") as f:
        f.write(data)
    lines = ["%s  poc %d" % (hashlib.sha256(r).hexdigest(), poc)
             for poc, r in enumerate(recs)]
    with open(os.path.join(data_dir, name + "_dec.sha256"), "w") as f:
        f.write("\n".join(lines) + "\n")
