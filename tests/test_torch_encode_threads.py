"""Picture-threaded encoding in the port (``codec/encoder.py`` with
``parallel/pipeline.EncodePipeline``): the threaded stream equals the
sequential one, on the CPU device.

The determinism contract of tests/test_threads.py
``test_threaded_encode_equals_sequential`` (ref: thread_encoder.cc) for
the port's session, with 2 and 4 workers (``XVC_THREADS_NO_CLAMP=1``):
- the native branch: ``sp48x32_in.yuv`` (48x32, 6 pictures, sub-GOP 4,
  checksum mode 1) at speed 2 and at speed 3 (the split DP and the
  transform-RD prepass on their CPU twins), stream and reconstructions
  equal to the port's sequential encode and to the JAX package's, the
  stage spans called as often;
- the Python CU encoder's intra half under ``XVC_INTRA_PREPASS=jax``:
  five all-intra pictures (32x16 cuts of sp48x32) of sub-GOP 4, so that
  four independent pictures are in flight at once;
- eight all-intra pictures at once on 8 workers, whose native writes
  each keep their own per-CTU coefficient flag;
- a worker that raises reaches the caller as that exception within
  ``WAIT_SECONDS``, and its dependents do not hang; a stalled reference
  times out;
- the caches that workers share build once under contention:
  ``native/engines._offsets_ptr`` (whose raw address goes to C) and
  ``gpu/txrd_prepass._DEV_TABLES``.
"""
import sys
import threading
import time
from concurrent import futures

import numpy as np
import pytest

from xvc_tpu import api as japi
from xvc_tpu_torch import api, profiling
from xvc_tpu_torch.codec import picture_encoder
from xvc_tpu_torch.gpu import txrd_prepass
from xvc_tpu_torch.native import engines
from xvc_tpu_torch.parallel import pipeline

from .util import read_data

W, H, FRAMES = 48, 32, 6
FS = W * H * 3 // 2


@pytest.fixture(autouse=True)
def _bounded(monkeypatch):
    # the pipeline itself, also on hosts whose clamp would route it to the
    # sequential path; no wait is unbounded, and every picture job a test
    # started has ended before the next test
    monkeypatch.setenv("XVC_THREADS_NO_CLAMP", "1")
    monkeypatch.setattr(pipeline, "WAIT_SECONDS", 120.0)
    jobs = []
    submit = pipeline.EncodePipeline.submit

    def record(self, *args):
        jobs.append(submit(self, *args))
        return jobs[-1]

    monkeypatch.setattr(pipeline.EncodePipeline, "submit", record)
    yield jobs
    _, running = futures.wait([job.future for job in jobs], timeout=60)
    assert not running


def sp48x32(w=W, h=H):
    """The pictures of sp48x32_in.yuv, cut to their top-left w x h."""
    raw = np.frombuffer(read_data("sp48x32_in.yuv"), np.uint8)
    out = []
    for pic in raw.reshape(FRAMES, FS):
        y = pic[:W * H].reshape(H, W)
        u, v = pic[W * H:].reshape(2, H // 2, W // 2)
        out += [p[:ph, :pw].tobytes() for p, ph, pw in
                ((y, h, w), (u, h // 2, w // 2), (v, h // 2, w // 2))]
    return b"".join(out)


def encode(module, threads, frames=FRAMES, w=W, h=H, **kw):
    """The length-prefixed stream and the reconstructions of ``frames``
    pictures of sp48x32 (cut to w x h) through ``module``'s
    EncoderSession."""
    raw = sp48x32(w, h)
    fs = w * h * 3 // 2
    params = module.EncoderParameters(width=w, height=h, qp=32,
                                      checksum_mode=1, threads=threads, **kw)
    ses = module.EncoderSession(params) if module is japi else \
        api.EncoderSession(params, device="cpu")
    nals = []
    for i in range(frames):
        nals += ses.encode(raw[i * fs:(i + 1) * fs])
    nals += ses.flush()
    return (b"".join(len(n).to_bytes(4, "little") + n for n in nals),
            list(ses.rec_pictures))


def in_flight(monkeypatch):
    """Count the picture encodes running at once; returns [most seen]."""
    most, now, lock = [0], [0], threading.Lock()
    orig = picture_encoder.PictureEncoder.encode

    def counted(self, *args):
        with lock:
            now[0] += 1
            most[0] = max(most[0], now[0])
        try:
            time.sleep(0.05)  # let the other workers of the burst start
            return orig(self, *args)
        finally:
            with lock:
                now[0] -= 1

    monkeypatch.setattr(picture_encoder.PictureEncoder, "encode", counted)
    return most


_REFS = {}


def references(key, **kw):
    """The JAX package's and the port's sequential encodes (cached)."""
    if key not in _REFS:
        _REFS[key] = (encode(japi, 0, **kw), encode(api, 0, **kw))
    return _REFS[key]


@pytest.mark.parametrize("workers", [2, 4])
@pytest.mark.parametrize("speed", [2, 3])
def test_native_branch_threaded_equals_sequential(speed, workers,
                                                  monkeypatch):
    """Stream and reconstructions equal the port's sequential encode and
    the JAX package's; more than one picture was in flight, and each
    stage span was called as often as in the sequential encode."""
    (jax_bs, jax_rec), (seq_bs, seq_rec) = references(
        "speed%d" % speed, sub_gop_length=4, speed_mode=speed)
    assert seq_bs == jax_bs and seq_rec == jax_rec
    profiling.reset()
    profiling.enable(True)
    try:
        encode(api, 0, sub_gop_length=4, speed_mode=speed)
        seq_calls = {k: v["calls"] for k, v in profiling.report().items()}
        profiling.reset()
        most = in_flight(monkeypatch)
        bs, rec = encode(api, workers, sub_gop_length=4, speed_mode=speed)
        calls = {k: v["calls"] for k, v in profiling.report().items()}
    finally:
        profiling.enable(False)
        profiling.reset()
    assert bs == seq_bs and rec == seq_rec
    assert most[0] > 1
    assert calls == seq_calls
    if speed == 3:
        assert calls["encode.txrd_prepass"] == FRAMES
        assert calls["encode.split_dp"] == FRAMES


@pytest.mark.parametrize("workers", [2, 4])
def test_python_intra_threaded_equals_sequential(workers, monkeypatch):
    """The Python CU encoder's intra half with the per-CU device SATD
    pre-pass: picture 0, then four independent intra pictures coded at
    once, equal to the port's sequential encode and the JAX package's
    (32x16 cuts of sp48x32: the host search is slow)."""
    monkeypatch.setenv("XVC_INTRA_PREPASS", "jax")
    kw = dict(num_ref_pics=0, sub_gop_length=4, speed_mode=2, w=32, h=16)
    (jax_bs, jax_rec), (seq_bs, seq_rec) = references("intra", frames=5,
                                                      **kw)
    assert seq_bs == jax_bs and seq_rec == jax_rec
    most = in_flight(monkeypatch)
    bs, rec = encode(api, workers, frames=5, **kw)
    assert bs == seq_bs and rec == seq_rec
    assert most[0] == workers


def test_concurrent_native_writes_keep_their_own_ctu_flags():
    """Eight all-intra 128x128 pictures coded at once by 8 workers, flat
    ones (no coefficient in a CTU) between noise: whether a CTU writes its
    delta QP (adaptive QP) follows its own coefficients, a flag of the
    native writer kept per thread, so the stream equals the sequential
    encode's and the JAX package's (a flag shared by the threads gave
    another stream in every run)."""
    w = h = 128
    rng = np.random.RandomState(1)
    pics = []
    for t in range(9):
        y = np.full((h, w), 100 + t, np.uint8) if t % 2 else \
            rng.randint(0, 256, (h, w)).astype(np.uint8)
        pics.append(y.tobytes() + np.full(w * h // 2, 128, np.uint8).tobytes())

    def run(module, threads):
        params = module.EncoderParameters(
            width=w, height=h, qp=32, speed_mode=2, num_ref_pics=0,
            sub_gop_length=8, threads=threads)
        ses = module.EncoderSession(params) if module is japi else \
            api.EncoderSession(params, device="cpu")
        nals = []
        for pic in pics:
            nals += ses.encode(pic)
        return nals + ses.flush()

    seq = run(api, 0)
    assert seq == run(japi, 0)
    for _ in range(2):
        assert run(api, 8) == seq


def test_a_clamped_pool_is_sequential(monkeypatch):
    """A pool clamped to one worker takes the sequential path."""
    monkeypatch.delenv("XVC_THREADS_NO_CLAMP")
    monkeypatch.setattr(pipeline.os, "cpu_count", lambda: 1)
    ses = api.EncoderSession(api.EncoderParameters(
        width=W, height=H, threads=4), device="cpu")
    assert ses._enc.pipeline is None
    monkeypatch.setattr(pipeline.os, "cpu_count", lambda: 2)
    ses = api.EncoderSession(api.EncoderParameters(
        width=W, height=H, threads=4), device="cpu")
    assert ses._enc.pipeline is not None


def test_a_worker_that_raises_reaches_the_caller(monkeypatch, _bounded):
    """Picture 2 raises in its worker: the session's encode raises that
    exception, the pictures that predict from it end at once, and no
    picture job is left running."""
    orig = picture_encoder.PictureEncoder.encode

    def encode_or_fail(self, *args):
        if self.pic_data.poc == 2:
            raise ValueError("picture 2 fails")
        return orig(self, *args)

    monkeypatch.setattr(picture_encoder.PictureEncoder, "encode",
                        encode_or_fail)
    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="picture 2 fails"):
        encode(api, 2, sub_gop_length=4, speed_mode=2)
    assert time.perf_counter() - t0 < 60
    assert all(job.future.done() for job in _bounded)
    failed = [job.pic_dec.pic_data.poc for job in _bounded
              if job.future.exception() is not None]
    # picture 2 and the pictures of its sub-GOP that predict from it
    assert 2 in failed and set(failed) <= {1, 2, 3}


def test_a_stalled_reference_times_out(monkeypatch):
    """A reference that outlasts WAIT_SECONDS makes the session raise
    instead of waiting for ever; the stalled worker ends on its own."""
    monkeypatch.setattr(pipeline, "WAIT_SECONDS", 0.5)
    release = threading.Event()
    orig = picture_encoder.PictureEncoder.encode

    def stall(self, *args):
        if self.pic_data.poc == 4:
            release.wait(30)
        return orig(self, *args)

    monkeypatch.setattr(picture_encoder.PictureEncoder, "encode", stall)
    t0 = time.perf_counter()
    try:
        with pytest.raises(TimeoutError):
            encode(api, 2, sub_gop_length=4, speed_mode=2)
    finally:
        release.set()
    assert time.perf_counter() - t0 < 20


def contend(fn, workers=16):
    """``fn()`` from ``workers`` threads released together, with a short
    switch interval; returns their results."""
    barrier = threading.Barrier(workers)
    out = [None] * workers

    def run(i):
        barrier.wait(30)
        out[i] = fn()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    return out


def test_offsets_ptr_under_contention(monkeypatch):
    """Every thread gets the address of one array, built once and kept
    by the module: no thread's C call can read an array that another
    thread's store freed."""
    builds = []
    real = engines.family_offsets

    def slow():
        builds.append(1)
        time.sleep(0.01)
        return real()

    monkeypatch.setattr(engines, "_OFFSETS_ARR", None)
    monkeypatch.setattr(engines, "family_offsets", slow)
    ptrs = contend(engines._offsets_ptr)
    assert len(builds) == 1
    assert set(ptrs) == {engines._OFFSETS_ARR.ctypes.data}
    np.testing.assert_array_equal(engines._OFFSETS_ARR, real())


def test_device_tables_under_contention(monkeypatch):
    """The transform-RD prepass's tables on a device are built once, and
    every thread gets the same tensors."""
    builds = []
    real = txrd_prepass._fwd_basis

    def slow(*args):
        builds.append(args)
        time.sleep(0.01)
        return real(*args)

    monkeypatch.setattr(txrd_prepass, "_DEV_TABLES", {})
    monkeypatch.setattr(txrd_prepass, "_fwd_basis", slow)
    got = contend(lambda: txrd_prepass._device_tables(8, 10, "cpu"))
    assert len(builds) == 1
    assert all(g[0] is got[0][0] and g[1] is got[0][1] for g in got)
    weights = contend(lambda: txrd_prepass._device_weights(8, 1, "cpu"))
    assert all(w is weights[0] for w in weights)
    assert len(txrd_prepass._DEV_TABLES) == 2


def test_chip_smoke_carries_the_ra720_s3_recipe():
    """chip_smoke.py phase 10's copies of the ra720_s3 recipe and its
    parameters equal tests/encode_clips.py's."""
    from dataclasses import asdict

    from . import encode_clips as clips
    from .test_torch_encode import _chip_smoke
    smoke = _chip_smoke()
    assert smoke.RA720_S3 == clips.RA720_S3
    assert smoke.make_ra720_s3() == clips.make_ra720_s3()
    assert asdict(smoke.ra720_s3_params(api, smoke.THREADS)) == \
        asdict(clips.ra720_s3_params(api, smoke.THREADS))
    assert smoke.THREADED_INTER_CLIP in clips.PYTHON_CU_INTER
    assert asdict(smoke.python_cu_inter_params(api, "ra64x48_me", 4)) == \
        asdict(clips.python_cu_inter_params(api, "ra64x48_me", 4))


def test_ra720_s3_references_describe_the_clip():
    """tests/data/bench/ra720_s3_enc.json and ra720_s3_cands.npz (made by
    tests/encode_clips.py ``make_ra720_s3_refs``) carry the clip, a NAL
    for each picture and the segment header, a PSNR for each picture and
    the prepass candidates of each picture."""
    import json

    from . import encode_clips as clips
    from .util import data_path
    with open(data_path("bench/ra720_s3_enc.json")) as f:
        refs = json.load(f)
    with np.load(data_path("bench/ra720_s3_cands.npz")) as z:
        cands = z["cands"]
    n = clips.RA720_S3["frames"]
    assert refs["clip"] == clips.RA720_S3
    assert len(refs["nal_sha256"]) == n + 1 and len(refs["psnr"]) == n
    assert cands.shape[0] == n and cands.dtype == np.int8
    assert all(len(p) == 3 and min(p) > 30 for p in refs["psnr"])
