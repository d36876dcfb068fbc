"""CTU tile rows (the JAX package's tile extension, tests/test_tiles.py)
through the port's decoder on the CPU device, against the JAX package:

- tile streams made here by the JAX package's ``encode_stream`` (intra
  64x192 in 3 tiles, random access 64x128 in 2 tiles with sub-GOP 4 and
  two references, 64x48 in "2" tiles, which is one CTU row and so one
  tile) and the committed small streams of tests/encode_clips.py
  TILE_STREAMS (64x256 in 4 tiles, intra and inter, on the flat path;
  64x128 in 2 tiles with LIC on, on the replay path) decode to the JAX
  package's bytes, every picture conforming, and take the path asserted;
- the committed streams' hash lists are the JAX package's decodes;
- zeroing the last tile's payload leaves the first tile's rows as they
  were (and as the JAX package decodes them), the picture non-conforming;
- the flat path's intra scan metadata of a tile picture (``has_a`` cut at
  the tile top) equals the rows the JAX package's device reconstruction
  (``XVC_DSP=jax``, ``JaxReconstructor``) hands its scans;
- a decode with 2 picture threads equals the sequential one;
- hd720_tiles4 (1280x720 in 4 tiles, chip_smoke.py phase 11's stream)
  decodes on the flat path to its hash list (the JAX package's decode).

The port's encoder on tile pictures: tests/test_torch_tiles_encode.py.
"""
import functools
import hashlib

import numpy as np
import pytest

from xvc_tpu.nal import write_nal_units
from xvc_tpu_torch.codec import picture_decoder as pdec
from xvc_tpu_torch.codec.decoder import decode_stream
from xvc_tpu_torch.gpu import flat_recon

from . import encode_clips as clips
from .util import read_data


def _jax_encode(w, h, f, tile_rows, seed, num_ref_pics=0, sub_gop=1):
    """tests/test_tiles.py's ``_encode`` of its ``synthetic_yuv420``."""
    from xvc_tpu.codec.encoder import encode_stream
    from xvc_tpu.codec.encoder_settings import EncoderSettings
    s = EncoderSettings()
    s.initialize_speed(2)
    s.tile_rows = tile_rows
    return encode_stream(clips.synthetic_yuv420(w, h, f, seed), w, h, f,
                         qp=32, settings=s, sub_gop_length=sub_gop,
                         num_ref_pics=num_ref_pics, checksum_mode=1)


# name -> (stream maker, pictures, path every picture takes)
STREAMS = {
    "intra64x192_t3": (lambda: _jax_encode(64, 192, 2, 3, 5), 2, "flat"),
    "ra64x128_t2": (lambda: _jax_encode(64, 128, 4, 2, 9, num_ref_pics=2,
                                        sub_gop=4), 4, "flat"),
    "ai64x48_t2": (lambda: _jax_encode(64, 48, 1, 2, 2), 1, "flat"),
    "tiles64x256": (None, 3, "flat"),
    "tiles64x128_lic": (None, 3, "replay"),
}


@functools.lru_cache(maxsize=None)
def _stream(name):
    make = STREAMS[name][0]
    if make is None:
        return read_data("bench/%s.xvc" % name)
    return write_nal_units(make())


def _record_paths(monkeypatch):
    """The path each decoded picture takes, in decode order."""
    paths = []
    real = flat_recon.eligible

    def eligible(pd, restr):
        ok = real(pd, restr)
        paths.append("flat" if ok else "replay")
        return ok

    monkeypatch.setattr(pdec.flat_recon, "eligible", eligible)
    return paths


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_tile_stream_decodes_as_the_jax_package(name, monkeypatch):
    _, count, path = STREAMS[name]
    data = _stream(name)
    want = clips.jax_session_decode(data)
    paths = _record_paths(monkeypatch)
    got = decode_stream(data, device="cpu")
    assert len(got) == len(want) == count
    assert all(p.conforming for p in got + want)
    assert [p.bytes for p in got] == [p.bytes for p in want]
    if path == "flat":
        assert paths == ["flat"] * count
    else:  # the intra key picture is flat; the LIC pictures replay
        assert paths[0] == "flat" and "replay" in paths[1:]


@pytest.mark.parametrize("name", ["tiles64x256", "tiles64x128_lic"])
def test_committed_tile_hashes_are_the_jax_package_s(name):
    """The hash lists the card tests hold the port to (encode_clips
    ``make_tile_stream``) are the JAX package's decodes of the streams."""
    want = read_data("bench/%s_dec.sha256" % name).decode().splitlines()
    pics = clips.jax_session_decode(_stream(name))
    assert clips.hash_lines(pics) == want


def _tile_sizes(nal, tiles, tail):
    """(offset of the size table, sizes) of a tile picture's NAL: the
    sizes, then the payloads, then ``tail`` checksum bytes end it."""
    for off in range(2, len(nal) - 4 * tiles):
        sizes = [int.from_bytes(nal[off + 4 * t:off + 4 * t + 4], "big")
                 for t in range(tiles)]
        if all(sizes) and off + 4 * tiles + sum(sizes) + tail == len(nal):
            return off, sizes
    raise AssertionError("size table not located")


def test_damaged_last_tile_leaves_the_first_tile():
    """tests/test_tiles.py test_tile_substreams_parse_independently on the
    port: the last tile's payload zeroed, the first tile's rows (less the
    4 the deblocking at the tile edge mixes) equal the undamaged decode's
    and the JAX package's decode of the damaged stream; the checksum
    fails."""
    w, h = 64, 128
    nals = _jax_encode(w, h, 1, 2, 7)
    nal = bytearray(nals[-1])
    off, (s0, s1) = _tile_sizes(nal, 2, 48)
    start = off + 8 + s0
    nal[start:start + s1] = bytes(s1)
    bad_data = write_nal_units(nals[:-1] + [bytes(nal)])
    good = decode_stream(write_nal_units(nals), device="cpu")
    bad = decode_stream(bad_data, device="cpu")
    jbad = clips.jax_session_decode(bad_data)
    assert len(good) == len(bad) == len(jbad) == 1
    assert good[0].conforming and not bad[0].conforming
    assert not jbad[0].conforming

    def top(pic):
        return np.frombuffer(pic.bytes, np.uint8)[:w * 60]

    assert (top(bad[0]) == top(good[0])).all()
    assert (top(bad[0]) == top(jbad[0])).all()


def test_scan_metadata_cut_at_the_tile_top(monkeypatch):
    """The flat path's luma and chroma scan rows of an intra tile picture
    equal those the JAX package's device reconstruction builds under
    XVC_DSP=jax (its ``_for_each_leaf`` cut per CTU), and some leaf below
    the picture top has its above row cut."""
    from xvc_tpu.tpu import intra_scan as jscan
    data = _stream("intra64x192_t3")
    jrows = {}

    def spy(make, key):
        def wrapped(*args):
            fn = make(*args)

            def call(*xs):
                jrows.setdefault(key, []).append(np.asarray(xs[-1]))
                return fn(*xs)
            return call
        return wrapped

    monkeypatch.setenv("XVC_DSP", "jax")
    monkeypatch.setattr(jscan, "make_intra_scan",
                        spy(jscan.make_intra_scan, "luma"))
    monkeypatch.setattr(jscan, "make_intra_chroma_scan",
                        spy(jscan.make_intra_chroma_scan, "chroma"))
    jpics = clips.jax_session_decode(data)
    monkeypatch.delenv("XVC_DSP")
    rows = {"luma": [], "chroma": []}
    real = flat_recon.FlatReconstructor._build_intra_meta

    def build(self, leaves, chroma=True):
        lmeta, cmeta = real(self, leaves, chroma)
        rows["luma"].append(lmeta)
        rows["chroma"].append(cmeta)
        return lmeta, cmeta

    monkeypatch.setattr(flat_recon.FlatReconstructor, "_build_intra_meta",
                        build)
    pics = decode_stream(data, device="cpu")
    assert [p.bytes for p in pics] == [p.bytes for p in jpics]
    assert len(jrows["luma"]) == len(rows["luma"]) == 2
    for key in ("luma", "chroma"):
        for got, want in zip(rows[key], jrows[key]):
            assert np.array_equal(got, want), key
    # a leaf on a tile top (y = 64 or 128) has no above row
    lm = rows["luma"][0]
    top = lm[(lm[:, 1] % 64 == 0) & (lm[:, 1] > 0) & (lm[:, 10] == 1)]
    assert len(top) and not top[:, 6].any()


def test_threaded_tile_decode_equals_sequential(monkeypatch):
    monkeypatch.setenv("XVC_THREADS_NO_CLAMP", "1")
    data = _stream("tiles64x256")
    seq = decode_stream(data, device="cpu")
    thr = decode_stream(data, device="cpu", num_threads=2)
    assert [p.bytes for p in thr] == [p.bytes for p in seq]
    assert all(p.conforming for p in thr)
    want = read_data("bench/tiles64x256_dec.sha256").decode().split()[::3]
    assert [hashlib.sha256(p.bytes).hexdigest() for p in thr] == want


def test_hd720_tiles4_decodes_to_its_hash_list(monkeypatch):
    paths = _record_paths(monkeypatch)
    pics = decode_stream(read_data("bench/hd720_tiles4.xvc"), device="cpu")
    want = read_data("bench/hd720_tiles4_dec.sha256").decode().splitlines()
    assert clips.hash_lines(pics) == want
    assert paths == ["flat"] * 3
