"""What the port's span table sees of a decode through
``api.DecoderSession`` (xvc_tpu_torch/profiling.py): the session's own
work (``decode.session``) beside the picture's stages, never around
them; the output queue (``session.output_wait``); and the copy counters
(``xfer.*``), which count with spans off as well.  On the CPU device,
over the 64x48 low-delay golden ``ld64x48``: 8 pictures, each handed out
by the ``decode_nal`` that feeds the next one.
"""
import json

import pytest
import torch

from xvc_tpu_torch import api, profiling
from xvc_tpu_torch.nal import split_nal_units

from .util import read_data

STREAM = "ld64x48"
PICTURES = 8
# the visible 4:2:0 planes of a 64x48 picture, in samples
SAMPLES = 64 * 48 + 2 * 32 * 24


def feed(on_fed=None):
    """Decode the stream through a session, the way a live client does:
    a NAL, then every picture the session hands out.  ``on_fed(k, out)``
    after picture k was fed.  Returns the pictures handed out."""
    nals = list(split_nal_units(read_data(STREAM + ".xvc")))
    ses = api.DecoderSession(device="cpu")
    out = []
    for i, nal in enumerate(nals):  # the segment header, then pictures
        ses.decode_nal(nal)
        while (pic := ses.get_picture()) is not None:
            out.append(pic)
        if i and on_fed is not None:
            on_fed(i - 1, len(out))
    ses.flush()
    while (pic := ses.get_picture()) is not None:
        out.append(pic)
    return out


@pytest.fixture
def table():
    """The span table empty; left disabled and empty."""
    profiling.enable(False)
    profiling.reset()
    yield profiling
    profiling.enable(False)
    profiling.reset()


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One decode with the table enabled and a trace running: (pictures,
    report, after each picture fed (parse calls, pictures handed out),
    the trace's host ranges [(name, start, end)])."""
    profiling.reset()
    profiling.enable(True)
    steps = []
    profiling.start_trace(str(tmp_path_factory.mktemp("trace")))
    try:
        pics = feed(lambda k, n: steps.append(
            (profiling.counted("decode.parse"), n)))
    finally:
        path = profiling.stop_trace()
        profiling.enable(False)
        rep = profiling.report()
        profiling.reset()
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events["traceEvents"]
    ranges = [(ev["name"], float(ev["ts"]), float(ev["ts"]) +
               float(ev.get("dur", 0))) for ev in events
              if ev.get("ph") == "X" and ev.get("cat") == "user_annotation"]
    return pics, rep, steps, ranges


def test_output_wait_is_one_call_a_picture_handed_out(traced):
    pics, rep, _, _ = traced
    assert len(pics) == PICTURES and all(p.conforming for p in pics)
    assert b"".join(p.bytes for p in pics) == read_data(STREAM + "_dec.yuv")
    assert rep["session.output_wait"]["calls"] == PICTURES
    assert rep["session.output_wait"]["seconds"] > 0
    assert all(p.decoded_at is not None for p in pics)


def test_a_picture_is_handed_out_when_the_next_is_fed(traced):
    """The session's one-picture output delay: after feeding picture
    k >= 1, k + 1 pictures were parsed and k handed out."""
    _, _, steps, _ = traced
    assert len(steps) == PICTURES
    for k, (parsed, handed) in enumerate(steps):
        assert parsed == k + 1
        assert handed == k


def test_session_span_is_beside_the_picture_stages(traced):
    """``decode.session`` is recorded at least once a picture, and none
    of its ranges holds a picture stage's range."""
    _, rep, _, ranges = traced
    assert rep["decode.session"]["calls"] >= PICTURES
    session = [(s, e) for n, s, e in ranges if n == "decode.session"]
    stages = [(s, e) for n, s, e in ranges
              if n in ("decode.parse", "decode.flat", "decode.recon",
                       "decode.deblock", "decode.post")]
    assert len(session) == rep["decode.session"]["calls"]
    assert len(stages) >= 4 * PICTURES
    for s0, e0 in session:
        assert not any(s0 <= s and e <= e0 for s, e in stages)


def test_downloaded_bytes_follow_the_geometry(traced):
    """Every picture downloads its visible int16 planes once after
    deblocking; a picture with a host tail downloads its planes and
    residuals as int32 once before it.  No wait on a card is recorded
    on the CPU."""
    _, rep, _, _ = traced
    tails = rep.get("recon.download", {"calls": 0})["calls"]
    assert rep["deblock.download"]["calls"] == PICTURES
    assert rep["xfer.dtoh"]["calls"] == PICTURES + tails
    assert rep["xfer.dtoh.bytes"]["calls"] == \
        PICTURES * SAMPLES * 2 + tails * 2 * SAMPLES * 4
    assert rep["xfer.htod"]["calls"] >= 2 * PICTURES
    assert "device.wait" not in rep
    for name in ("xfer.htod", "xfer.dtoh", "xfer.dtoh.bytes"):
        assert rep[name]["seconds"] == 0.0


def test_counters_count_with_spans_off(table):
    """Spans off: no span row, the copies counted all the same."""
    pics = feed()
    rep = table.report()
    assert len(pics) == PICTURES
    assert set(rep) >= {"xfer.htod", "xfer.htod.bytes", "xfer.dtoh",
                        "xfer.dtoh.bytes"}
    assert all(name.startswith("xfer.") for name in rep)
    assert rep["xfer.dtoh"]["calls"] >= PICTURES
    assert rep["xfer.dtoh.bytes"]["calls"] >= PICTURES * SAMPLES * 2
    assert all(p.decoded_at is None for p in pics)


def test_count_rows_and_reset(table):
    assert table.counted("xfer.move") == 0
    table.count("xfer.move", 1, 96)
    table.count("xfer.move", 2, 4)
    table.count("glue.count")
    assert table.report()["xfer.move"] == {"seconds": 0.0, "calls": 3}
    assert table.counted("xfer.move.bytes") == 100
    assert table.counted("glue.count") == 1
    assert "glue.count.bytes" not in table.report()
    table.reset()
    assert table.report() == {} and table.counted("xfer.move") == 0


def test_device_wait_is_a_flag_test_with_spans_off(table):
    """Spans off, ``wait_device`` reads no clock and records nothing; on,
    a tensor off the card has nothing to wait for."""
    clock = profiling.time.perf_counter
    profiling.time.perf_counter = None
    try:
        profiling.wait_device(torch.zeros(2))
        with profiling.span("x"):
            pass
    finally:
        profiling.time.perf_counter = clock
    table.enable(True)
    profiling.wait_device(torch.zeros(2))
    assert table.report() == {}
