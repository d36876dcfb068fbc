"""Damaged streams in the PyTorch port's decoder session, against the JAX
package's on the same bytes (the port's twin of
``tests/test_fuzz_robustness.py``).

Truncated, corrupted and garbage NALs never make the session raise; the
damage shows as non-conforming pictures and a corrupt-picture count.
Both must equal those of ``xvc_tpu``'s session on the same bytes: the
number of pictures, each picture's conformance flag and the session's
corrupt count.  The reference runs its per-CU host path
(``XVC_PIC_NATIVE=0``), whose checksum is taken in line: its native
picture decode finishes the checksum on a worker thread and counts a
picture whose parse failed twice, once at the parse and once at the
checksum, a quirk of its own (its ``XVC_DSP=jax`` device path counts as
the per-CU path does, at some seconds of XLA compiles a stream).  That
covers a segment header that cannot describe a picture (chroma format
UNDEFINED, a zero dimension), after which the port counts its pictures
as corrupt where it used to raise.  The streams are goldens of both
device paths: ai64x48, ai64x48b10 and sp_fast take the flat path,
ld64x48 (LIC) and cf_c422 (4:2:2) the replay path (``gpu/recon.py``).
"""
import random
import types

import pytest

from xvc_tpu import api as jax_api
from xvc_tpu_torch import api
from xvc_tpu_torch import constants as k
from xvc_tpu_torch.codec.decoder import DamagedHeaderError, Decoder

from .util import read_data

STREAMS = ("ai64x48", "ai64x48b10", "sp_fast", "ld64x48", "cf_c422")
MODES = ("truncate", "corrupt", "garbage")


def nals_of(stream):
    out, off = [], 0
    while off + 4 <= len(stream):
        ln = int.from_bytes(stream[off:off + 4], "little")
        off += 4
        out.append(stream[off:off + ln])
        off += ln
    return out


def damaged(nals, idx, mode, seed):
    """The stream's NALs with NAL ``idx`` damaged as the reference's test
    damages it."""
    rng = random.Random(seed)
    out = list(nals)
    b = bytearray(nals[idx])
    if mode == "truncate":
        b = b[:max(1, len(b) // 2)]
    elif mode == "corrupt":
        for _ in range(8):
            b[rng.randrange(len(b))] ^= rng.randrange(1, 256)
    else:
        b = bytearray(rng.randbytes(len(b)))
    out[idx] = bytes(b)
    return out


def session_result(session, nals):
    """(pictures' conformance flags, corrupt count) of a session fed the
    NALs, drained with the blocking pull."""
    flags = []
    for nal in nals:
        session.decode_nal(nal)
        while (pic := session.get_picture()) is not None:
            flags.append(pic.conforming)
    session.flush()
    while (pic := session.get_picture()) is not None:
        flags.append(pic.conforming)
    return flags, session.check_conformance()[1]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("stream", STREAMS)
def test_damaged_nals_count_as_the_reference_counts(monkeypatch, stream,
                                                    mode):
    monkeypatch.setenv("XVC_PIC_NATIVE", "0")
    nals = nals_of(read_data(stream + ".xvc"))
    for idx in sorted({0, 1, 2, len(nals) // 2, len(nals) - 1}):
        for seed in (0, 1):
            bad = damaged(nals, idx, mode, seed)
            got = session_result(api.DecoderSession(device="cpu"), bad)
            want = session_result(jax_api.DecoderSession(), bad)
            assert got == want, (idx, seed)


@pytest.mark.parametrize("mode", ["truncate", "garbage"])
@pytest.mark.parametrize("stream", STREAMS)
def test_damaged_segment_header_is_corrupt_not_an_error(monkeypatch, stream,
                                                        mode):
    """NAL 0, the segment header, made unable to describe a picture: the
    session decodes on, every picture after it non-conforming; then the
    clean stream on the same session, as the reference's session takes
    it."""
    monkeypatch.setenv("XVC_PIC_NATIVE", "0")
    nals = nals_of(read_data(stream + ".xvc"))
    results = []
    for session in (api.DecoderSession(device="cpu"),
                    jax_api.DecoderSession()):
        first = session_result(session, damaged(nals, 0, mode, 0))
        results.append((first, session_result(session, nals)))
    (flags, corrupt), _ = results[0]
    assert not any(flags) and corrupt >= 1
    assert results[0] == results[1]


@pytest.mark.parametrize("fmt,width,height,error", [
    (k.ChromaFormat.YUV420, 64, 48, RuntimeError),
    (k.ChromaFormat.UNDEFINED, 64, 48, DamagedHeaderError),
    (k.ChromaFormat.YUV420, 64, 0, DamagedHeaderError)])
def test_no_free_picture_decoder(fmt, width, height, error):
    """Running out of picture decoders is a parse error (counted, the
    session goes on) after a header that cannot describe a picture, and
    stays a RuntimeError, which propagates, after any other."""
    dec = Decoder("cpu")
    busy = types.SimpleNamespace(ref_count=1, output_status_done=False)
    dec.pic_decoders = [busy]
    sh = types.SimpleNamespace(chroma_format=fmt, internal_width=width,
                               internal_height=height)
    with pytest.raises(error) as got:
        dec._get_free_picture_decoder(sh)
    assert isinstance(got.value, Decoder._PARSE_ERRORS) == \
        (error is DamagedHeaderError)
