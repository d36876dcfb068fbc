"""Picture-parallel decode in the port (xvc_tpu_torch/parallel/pipeline.py):
threaded output equals unthreaded, on the CPU device.

The determinism contract of tests/test_threads.py (ref:
src/xvc_dec_lib/thread_decoder.cc, test/xvc_test/restrictions_test.cc
SupportParallelDecodeWhenRestrictionChanges) for the port's session:
with 2 and 4 workers (``XVC_THREADS_NO_CLAMP=1``) every stream of that
test decodes to the sequential decode's pictures, conformance flags and
count, and to its golden (``scal16to24`` and the port's own splice, whose
tail pictures predict from a rescaled key picture, to the JAX package's
host decode).  Every wait is bounded: the pipeline's ``WAIT_SECONDS`` is
cut to 120 s here, and a worker that outlasts it makes the session
raise instead of hanging; an error of a worker that is not a parse error
reaches the caller.
"""
import os
import sys
import threading
import time
from concurrent import futures

import pytest

from xvc_tpu_torch import api, kernels, profiling
from xvc_tpu_torch.codec import picture_decoder
from xvc_tpu_torch.codec.decoder import decode_stream
from xvc_tpu_torch.ops import resample
from xvc_tpu_torch.parallel import pipeline

from .test_torch_recon import jax_host_decode
from .util import read_data

STREAMS = ["ra64x48", "ld64x48", "ra128x96", "scal16to24", "rm3_64x48"]
# the open-GOP splice made by the JAX package's encoder
# (tests/encode_clips.py make_splice): 96x64, then 64x48 from picture 8 on;
# the output and the alternative reconstruction both upsample
SPLICE = "splice96x64to64x48"


@pytest.fixture(autouse=True)
def _bounded(monkeypatch):
    # the tests exercise the pipeline itself, also on hosts whose clamp
    # would route it to the sequential path; no wait is unbounded, and
    # every picture job a test started has ended before the next test
    monkeypatch.setenv("XVC_THREADS_NO_CLAMP", "1")
    monkeypatch.setattr(pipeline, "WAIT_SECONDS", 120.0)
    jobs = []
    submit = pipeline.DecodePipeline.submit

    def record(self, *args):
        jobs.append(submit(self, *args))
        return jobs[-1]

    monkeypatch.setattr(pipeline.DecodePipeline, "submit", record)
    yield
    _, running = futures.wait([job.future for job in jobs], timeout=60)
    assert not running


def decode_all(bs, threads, **kw):
    dec = api.DecoderSession(api.DecoderParameters(threads=threads, **kw),
                             device="cpu")
    assert (dec._dec.pipeline is not None) == (threads > 0)
    off = 0
    while off < len(bs):
        ln = int.from_bytes(bs[off:off + 4], "little")
        off += 4
        dec.decode_nal(bs[off:off + ln])
        off += ln
    dec.flush()
    pics = []
    while (p := dec.get_picture()) is not None:
        pics.append(p)
    return pics


def _same(a, b):
    assert [p.poc for p in a] == [p.poc for p in b]
    assert [p.conforming for p in a] == [p.conforming for p in b]
    assert [p.bytes for p in a] == [p.bytes for p in b]


@pytest.mark.parametrize("threads", [2, 4])
@pytest.mark.parametrize("name", STREAMS)
def test_threaded_equals_unthreaded_and_the_golden(name, threads):
    bs = read_data(name + ".xvc")
    seq = decode_all(bs, 0)
    thr = decode_all(bs, threads)
    _same(seq, thr)
    if name == "scal16to24":
        _same(jax_host_decode(bs), thr)
    else:
        assert all(p.conforming for p in thr)
        assert b"".join(p.bytes for p in thr) == \
            read_data(name + "_dec.yuv")


@pytest.mark.parametrize("threads", [2, 4])
def test_threaded_restriction_switch(threads):
    bs = read_data("rm1_64x48.xvc") + read_data("rm3_64x48.xvc")
    seq = decode_all(bs, 0)
    thr = decode_all(bs, threads)
    _same(seq, thr)
    assert len(thr) == 6 and all(p.conforming for p in thr)


def _spy_alternatives(monkeypatch):
    """Count the planes the alternative reconstruction rescales (one call
    a picture, every plane in it)."""
    calls = []
    orig = resample.resample_pic

    def spy(dst, src, device=None, border_padded=False):
        calls.extend((src.width[c], src.height[c], dst.width[c],
                      dst.height[c]) for c in range(3))
        return orig(dst, src, device, border_padded)

    monkeypatch.setattr(resample, "resample_pic", spy)
    return calls


@pytest.mark.parametrize("threads", [0, 2, 4])
def test_splice_equals_the_jax_host_decode(monkeypatch, threads):
    """Output latched at 96x64: the 64x48 pictures upsample on output, and
    the tail pictures 5-7 of the first segment predict from the 64x48 key
    picture upsampled to 96x64.  Those three fail their checksum in the
    JAX package's decode too: the encoder of the first stream predicted
    them from its own key picture (a splice of two encodes)."""
    bs = read_data(SPLICE + ".xvc")
    want = jax_host_decode(bs)
    calls = _spy_alternatives(monkeypatch)
    got = decode_all(bs, threads)
    _same(want, got)
    assert len(got) == 17 and all(p.width == 96 for p in got)
    assert [p.poc for p in got if not p.conforming] == [5, 6, 7]
    assert calls == [(64, 48, 96, 64), (32, 24, 48, 32), (32, 24, 48, 32)]


def test_decode_stream_takes_threads():
    bs = read_data("ra64x48.xvc")
    a = decode_stream(bs, device="cpu")
    b = decode_stream(bs, device="cpu", num_threads=3)
    _same(a, b)
    assert len(b) == 10


def test_a_worker_error_reaches_the_caller(monkeypatch):
    """A fault that is not a parse error (a CUDA fault, say) is raised by
    the session's pull, as in the sequential decode."""
    orig = picture_decoder.PictureDecoder.decode

    def decode(self, *a, **kw):
        if self.pic_data.poc == 4:
            raise RuntimeError("injected device fault")
        return orig(self, *a, **kw)

    monkeypatch.setattr(picture_decoder.PictureDecoder, "decode", decode)
    with pytest.raises(RuntimeError, match="injected"):
        decode_all(read_data("ra64x48.xvc"), 2)


def test_a_stalled_worker_times_out(monkeypatch):
    """A picture that outlasts WAIT_SECONDS makes the pull raise instead of
    waiting for ever; the stalled worker ends on its own."""
    monkeypatch.setattr(pipeline, "WAIT_SECONDS", 0.5)
    release = threading.Event()
    orig = picture_decoder.PictureDecoder.decode

    def decode(self, *a, **kw):
        if self.pic_data.poc == 0:
            release.wait(30)
        return orig(self, *a, **kw)

    monkeypatch.setattr(picture_decoder.PictureDecoder, "decode", decode)
    t0 = time.perf_counter()
    try:
        with pytest.raises(TimeoutError):
            decode_all(read_data("ld64x48.xvc"), 2)
    finally:
        release.set()
    assert time.perf_counter() - t0 < 20



def test_shared_counters_under_contention():
    """More workers than cores, a short switch interval: the counters the
    workers share (the span table with its transfer counters, the launch
    counts) lose no update."""
    bs = read_data("ra64x48.xvc")
    workers = 2 * (os.cpu_count() or 2)

    def run(threads):
        before = dict(kernels.LAUNCHES)
        profiling.reset()
        profiling.enable(True)
        try:
            pics = decode_all(bs, threads)
        finally:
            profiling.enable(False)
        calls = {k: v["calls"] for k, v in profiling.report().items()}
        return pics, {k: kernels.LAUNCHES[k] - before[k] for k in before}, \
            calls

    # the tables a decode uploads once are uploaded before both runs
    decode_all(bs, 0)
    seq, seq_launches, seq_calls = run(0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        thr, thr_launches, thr_calls = run(workers)
        kernels.reset_launches()
        counters = [threading.Thread(target=lambda: [
            kernels.count_launch("resample") for _ in range(2000)])
            for _ in range(workers)]
        for t in counters:
            t.start()
        for t in counters:
            t.join(60)
        assert not any(t.is_alive() for t in counters)
    finally:
        sys.setswitchinterval(interval)
    _same(seq, thr)
    assert thr_launches == seq_launches and seq_calls["xfer.htod"] > 0
    assert thr_calls == seq_calls
    assert kernels.LAUNCHES["resample"] == 2000 * workers


def test_a_dying_picture_takes_no_lock():
    """A picture's finalizer can run at any allocation of any thread,
    inside a locked section: it hands its frame-store slot back without
    taking the store's lock, and the next put reuses the slot."""
    import gc

    import numpy as np
    import torch

    from xvc_tpu_torch.codec.yuv import YuvPicture
    from xvc_tpu_torch.gpu import flat_recon

    def picture():
        pic = YuvPicture(1, 64, 48, 8)
        planes = {c: torch.from_numpy(np.zeros(
            flat_recon._padded_shape(pic, c), np.int16)) for c in range(3)}
        return pic, planes

    pic, planes = picture()
    flat_recon.frame_store_put(pic, planes, torch.device("cpu"))
    store, slot, _ = pic._torch_slots["cpu"]
    held, done = threading.Event(), threading.Event()

    def hold():
        with flat_recon._STORE_LOCK:
            held.set()
            done.wait(30)

    holder = threading.Thread(target=hold)
    holder.start()
    assert held.wait(30)
    box = [pic]
    del pic
    # the last reference goes in another thread, whose finalizer would
    # wait for the holder if it took the lock
    dropper = threading.Thread(target=box.clear)
    try:
        dropper.start()
        dropper.join(5)
        assert not dropper.is_alive()
    finally:
        done.set()
        holder.join(30)
        dropper.join(30)
    assert not holder.is_alive() and not dropper.is_alive()
    gc.collect()
    other, planes = picture()
    assert flat_recon.frame_store_put(other, planes,
                                      torch.device("cpu")) == slot
    assert not store.released
