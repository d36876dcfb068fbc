"""The port's span table (xvc_tpu_torch.profiling) against the JAX
package's (xvc_tpu.profiling) on the same calls, the spans a decode
through the flat path reports, and the transform-RD prepass's sub-spans
in a speed-3 encode.
"""
import time

import pytest

from xvc_tpu import profiling as jprof
from xvc_tpu_torch import profiling as tprof
from xvc_tpu_torch.codec.decoder import decode_stream

from .util import read_data


@pytest.fixture
def both():
    """Both modules enabled and empty; left disabled and empty."""
    was = jprof.enabled()
    for mod in (jprof, tprof):
        mod.enable()
        mod.reset()
    yield jprof, tprof
    jprof.enable(was)
    tprof.enable(False)
    for mod in (jprof, tprof):
        mod.reset()


def _drive(mod):
    with mod.span("a.first"):
        time.sleep(0.02)
    for _ in range(3):
        with mod.span("b.second"):
            pass
    mod.add_span_time("c.native", 1.25, calls=4)
    mod.add_span_time("c.native", 0.5)
    with pytest.raises(KeyError):
        with mod.span("d.raises"):
            raise KeyError("x")


def test_span_table_behaves_as_the_reference(both):
    reports = []
    for mod in both:
        _drive(mod)
        reports.append(mod.report())
    ref, got = reports
    # sorted by time: the two long spans lead, in the same order
    assert list(got)[:2] == list(ref)[:2] == ["c.native", "a.first"]
    assert {n: r["calls"] for n, r in got.items()} == \
        {n: r["calls"] for n, r in ref.items()} == \
        {"a.first": 1, "b.second": 3, "c.native": 5, "d.raises": 1}
    assert got["c.native"]["seconds"] == ref["c.native"]["seconds"] == 1.75
    for rep in (ref, got):
        assert 0.02 <= rep["a.first"]["seconds"] < 1.0
    lines = [mod.format_report().splitlines() for mod in both]
    assert lines[0][0] == lines[1][0]
    assert [l.split()[0] for l in lines[1][1:]] == list(got)
    assert [l.split()[2] for l in lines[1][1:]] == \
        [str(r["calls"]) for r in got.values()]


def test_reset_and_enable_behave_as_the_reference(both):
    for mod in both:
        _drive(mod)
        mod.reset()
        assert mod.report() == {}
        assert mod.enabled()
        mod.enable(False)
        assert not mod.enabled()


def test_disabled_spans_record_nothing():
    tprof.enable(False)
    tprof.reset()
    with tprof.span("x"):
        pass
    tprof.add_span_time("y", 1.0)
    assert tprof.report() == {} and not tprof.enabled()
    # a disabled span is a flag test: no clock is read
    clock = tprof.time.perf_counter
    tprof.time.perf_counter = None
    try:
        with tprof.span("x"):
            pass
    finally:
        tprof.time.perf_counter = clock


def test_sync_is_off_unless_asked_and_harmless_without_a_card():
    tprof.reset()
    tprof.enable()
    assert tprof.enabled() and not tprof._sync
    tprof.enable(sync=True)
    try:
        with tprof.span("s"):
            pass
        assert tprof.report()["s"]["calls"] == 1
    finally:
        tprof.enable(False)
        tprof.reset()
    assert not tprof._sync


# the spans of the reference's flat path (xvc_tpu/tpu/flat_recon.py run,
# xvc_tpu/codec/picture_decoder.py, xvc_tpu/tpu/deblock_jax.py)
_FLAT_SPANS = {"decode.parse", "decode.flat", "decode.deblock",
               "flat.build", "flat.upload", "flat.dispatch",
               "flat.intra_scan", "flat.chroma_scan", "deblock.meta",
               "deblock.upload", "deblock.download"}
# spans the port adds: its host post step, its deblock passes with the
# edge decisions inside them, and the frame-store write after deblock
_PORT_SPANS = {"decode.post", "deblock.passes", "deblock.edges",
               "deblock.store"}


def test_cpu_decode_reports_the_flat_path_spans():
    data = read_data("ai64x48.xvc")
    rep, seconds, pics = tprof.profile_decode(data, device="cpu", warmup=0)
    assert len(pics) == 3 and all(p.conforming for p in pics)
    assert b"".join(p.bytes for p in pics) == read_data("ai64x48_dec.yuv")
    assert _FLAT_SPANS | _PORT_SPANS <= set(rep)
    for name in ("decode.parse", "decode.flat", "decode.deblock",
                 "decode.post", "flat.intra_scan", "flat.chroma_scan"):
        assert rep[name]["calls"] == 3
    # nested spans: a stage is no longer than the one that holds it
    inner = sum(rep[n]["seconds"] for n in rep if n.startswith("flat."))
    assert inner <= rep["decode.flat"]["seconds"] + 1e-3
    assert rep["decode.flat"]["seconds"] <= seconds
    # profile_decode leaves profiling as it found it
    assert not tprof.enabled()


def test_command_line_prints_the_table(capsys, tmp_path):
    path = tmp_path / "s.xvc"
    path.write_bytes(read_data("ai64x48.xvc"))
    assert tprof.main([str(path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[0].split() == ["stage", "seconds", "calls"]
    assert "decode.flat" in out and "3 pictures" in out


# the transform-RD prepass's sub-spans, one call each per block size of a
# picture, inside the picture encoder's encode.txrd_prepass
_PREPASS_SPANS = ("encode.txrd_prepass.extract", "encode.txrd_prepass.upload",
                  "encode.txrd_prepass.device",
                  "encode.txrd_prepass.download")


def test_speed3_encode_reports_the_prepass_sub_spans():
    from xvc_tpu_torch.codec.encoder import encode_stream
    from xvc_tpu_torch.codec.encoder_settings import EncoderSettings
    from .encode_clips import txrd_clip
    s = EncoderSettings()
    s.initialize_speed(3)
    tprof.reset()
    tprof.enable()
    try:
        encode_stream(txrd_clip(64, 48, 2), 64, 48, 2, qp=32, settings=s,
                      sub_gop_length=1, num_ref_pics=1, checksum_mode=1,
                      device="cpu")
        rep = tprof.report()
    finally:
        tprof.enable(False)
        tprof.reset()
    assert rep["encode.txrd_prepass"]["calls"] == 2
    for name in _PREPASS_SPANS:     # sizes 4, 8, 16 and 32, two pictures
        assert rep[name]["calls"] == 8, name
    inner = sum(rep[n]["seconds"] for n in _PREPASS_SPANS)
    assert inner <= rep["encode.txrd_prepass"]["seconds"] + 1e-3
