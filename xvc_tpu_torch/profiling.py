"""Lightweight per-stage profiling of the port's host and device paths.

Own copy of the span table of ``xvc_tpu/profiling.py`` (``enable``,
``enabled``, ``reset``, ``span``, ``add_span_time``, ``report``,
``format_report``), without its ``XVC_PROFILE`` switch, and its trace
hooks on ``torch.profiler``: ``start_trace(trace_dir)`` /
``stop_trace()`` record the host operators and, on a card, the device's
kernels and copies, with every span as a range of its name (the first,
``profiling.start_trace``, opened by ``start_trace`` itself), and write
one Chrome trace (viewable in Perfetto) under ``trace_dir``;
``XVC_TRACE_DIR=<dir>`` starts one at import.

    from xvc_tpu_torch import profiling
    profiling.enable(sync=True)
    ... decode ...
    print(profiling.format_report())

PyTorch returns from a launch before the card has done the work, so a
host clock around a stage times its enqueue and the work lands on the
next stage that waits.  ``enable(sync=True)`` makes every span end with
``torch.cuda.synchronize()`` when CUDA has been initialised, so the time
is attributed to the stage that spent it (the reference's blocking
``XVC_FLAT_SYNC`` profile).  The synchronisation serialises host and
device and so lengthens the whole run: it is for a breakdown, not for an
end-to-end time.  Spans are on while the table is enabled or a trace
runs; off, a span is one test of a flag: no clock is read and nothing is
allocated.

The table holds two kinds of rows, ``{"seconds": s, "calls": n}`` each:

- spans, recorded only while the table is enabled (``enable``), and
  ranges of their names in a running trace;
- counters (``count``), counted whether or not the table is enabled,
  with ``"seconds": 0.0``; ``reset`` clears them too.

The spans the port records: the decode's (``decode.*``, ``flat.*``,
``recon.*``, ``deblock.*``; inside ``decode.post`` the resampler's
``resample.window`` (the host side of a window: the ring of a picture
whose border was not padded, or a host cut), ``resample.upload``,
``resample.kernel`` (its launch) and ``resample.download``, and
``output.pack`` (the host planes of an output cast into its bytes)).
Beside them, never around them, ``decode.session``: the decoder
session's own work (``api.DecoderSession``, ``codec/decoder.py``): NAL
and picture headers, segment headers, reference lists, finding or
making a ``PictureDecoder`` and its ``init_pic``, the output picture's
assembly, a new session; several ranges a picture, none around
``PictureDecoder.decode``.  ``device.wait``: the host blocked on the
card before a download (``gpu/dsp.py`` ``download``): while spans are
on, the copy's stream is synchronised inside it first, so that the copy
itself no longer waits; off, nothing is synchronised.
``session.output_wait`` is a row of the table, no range: while the table
is enabled, for each picture ``DecoderSession.get_picture`` hands out,
the time from the return of its decode (on whichever thread ran it) to
its hand-out, one call a picture.

The counters: ``xfer.htod`` / ``xfer.htod.bytes`` (host-to-device
copies and their bytes), ``xfer.dtoh`` / ``xfer.dtoh.bytes``
(device-to-host) and ``xfer.move`` / ``xfer.move.bytes`` (a reference
plane copied between mesh slots), counted at every such copy site of the
decode path (``gpu/dsp.py`` ``upload`` / ``download`` / ``move``,
``gpu/resample.py`` ``download``) and of the encoder's deblocking; on
the CPU device they count the copies the card would make.

The encoder's spans, per picture:
``encode.txrd_prepass`` (the transform-RD prepass), with, per block
size, ``encode.txrd_prepass.extract`` (the host's block and reference
extraction), ``.upload``, ``.device`` (prediction, SATD and the ``txrd``
kernel) and ``.download``;
``encode.split_dp`` (the split DP's lookahead maps, zero-MV SADs and DP
on the device), ``encode.native`` (the native CTU search and write) and,
from the native encoder's own timers, ``encode.native.me``,
``encode.native.intra_search``, ``encode.native.txrd`` (nested in the two
searches), ``encode.native.write`` and ``encode.native.deblock``; or,
where the Python CU encoder codes the picture, ``encode.intra_lookahead``
(``tpu_intra_lookahead``'s maps, with ``.extract``, the host's block and
reference extraction, and ``.device``, upload, step and download, once a
block size), ``encode.python`` (its CTU search and write, in which
``encode.intra_prepass`` is one per-CU device pre-pass call: upload,
prediction, SATD, download) and ``encode.deblock`` (the picture's
deblocking on the device, with its ``deblock.*`` spans).

Run as a script it decodes a stream on the card and prints the table:

    python -m xvc_tpu_torch.profiling tests/data/bench/hd720_ld.xvc
"""
import collections
import contextlib
import os
import tempfile
import threading
import time

_stats = collections.defaultdict(float)
_counts = collections.defaultdict(int)
# the workers of a threaded decode record side by side (their spans
# overlap, so a span's seconds can add up to more than the decode's)
_lock = threading.Lock()
_enabled = False
_sync = False
# the running trace: (torch.profiler.profile, its directory), or None
_trace = None


def enable(on=True, sync=False):
    global _enabled, _sync
    _enabled = on
    _sync = bool(on and sync)


def enabled():
    return _enabled


def reset():
    with _lock:
        _stats.clear()
        _counts.clear()


def _device_sync():
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# what a span is while spans are off: reusable, so nothing is allocated
_OFF = contextlib.nullcontext()


def span(name):
    """Accumulate wall-clock for a named stage (no-op when disabled); while
    a trace runs, also a range of that name in the trace."""
    if not _enabled and _trace is None:
        return _OFF
    return _span(name)


@contextlib.contextmanager
def _span(name):
    if _trace is not None:
        from torch.profiler import record_function
        ranged = record_function(name)
    else:
        ranged = contextlib.nullcontext()
    t0 = time.perf_counter()
    try:
        with ranged:
            yield
    finally:
        if _enabled:
            if _sync:
                _device_sync()
            _add(name, time.perf_counter() - t0, 1)


def wait_device(tensor):
    """While spans are on and ``tensor`` lies on a card: block, inside
    span ``device.wait``, until the work enqueued so far on its device's
    current stream is done.  A copy of ``tensor`` to the host on that
    stream would wait for the same work, so nothing is reordered; spans
    off, this is one test of a flag."""
    if (not _enabled and _trace is None) or not tensor.is_cuda:
        return
    import torch
    with _span("device.wait"):
        torch.cuda.current_stream(tensor.device).synchronize()


def _add(name, seconds, calls):
    with _lock:
        _stats[name] += seconds
        _counts[name] += calls


def count(name, n=1, nbytes=None):
    """Add ``n`` to the counter row ``name`` and, where ``nbytes`` is
    given, ``nbytes`` to the row ``name + ".bytes"``, under one lock;
    counted whether or not the table is enabled."""
    with _lock:
        _stats[name] += 0.0
        _counts[name] += n
        if nbytes is not None:
            _stats[name + ".bytes"] += 0.0
            _counts[name + ".bytes"] += nbytes


def counted(name):
    """The ``calls`` of the row ``name`` (0 where it has none)."""
    with _lock:
        return _counts.get(name, 0)


def add_span_time(name, seconds, calls=1):
    """Fold an externally measured duration (e.g. native-side timers)
    into the span table (no-op when disabled)."""
    if not _enabled:
        return
    _add(name, seconds, calls)


def report():
    """{stage: {"seconds": s, "calls": n}} sorted by time desc."""
    with _lock:
        return {name: {"seconds": round(_stats[name], 4),
                       "calls": _counts[name]}
                for name in sorted(_stats, key=_stats.get, reverse=True)}


def format_report():
    lines = ["%-28s %10s %8s" % ("stage", "seconds", "calls")]
    for name, row in report().items():
        lines.append("%-28s %10.3f %8d" % (name, row["seconds"],
                                           row["calls"]))
    return "\n".join(lines)


def start_trace(trace_dir=None):
    """Start a ``torch.profiler`` trace of this process: the host's
    operators and the spans, and the device's kernels and copies where
    CUDA is available.  ``trace_dir`` defaults to ``XVC_TRACE_DIR``, else
    ``xvc_trace`` in the temporary directory.  Raises if a trace is
    already running or the profiler cannot start."""
    global _trace
    from torch.profiler import ProfilerActivity, profile, record_function
    import torch
    if _trace is not None:
        raise RuntimeError("a trace is already running")
    out = trace_dir or os.environ.get("XVC_TRACE_DIR") or \
        os.path.join(tempfile.gettempdir(), "xvc_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    # the first range of a trace opens a millisecond or more after its
    # start stamp (the profiler's set-up); taken here, it leaves every
    # later range, a caller's clock mark too, on time
    with record_function("profiling.start_trace"):
        pass
    _trace = (prof, out)


def stop_trace():
    """Stop the running trace and write it as a Chrome trace,
    ``<trace_dir>/xvc_trace_<pid>_<ms>.json``; returns its path (None if
    no trace was running)."""
    global _trace
    if _trace is None:
        return None
    (prof, out), _trace = _trace, None
    prof.stop()
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "xvc_trace_%d_%d.json" % (
        os.getpid(), int(time.time() * 1000)))
    prof.export_chrome_trace(path)
    return path


def profile_decode(data, device=None, warmup=1):
    """Decode ``data`` ``warmup`` times unprofiled (first-use costs), then
    once with synchronising spans.  Returns (report, seconds of the
    profiled decode, pictures)."""
    from .codec.decoder import decode_stream
    for _ in range(warmup):
        decode_stream(data, device=device)
    was_on, was_sync = _enabled, _sync
    reset()
    enable(sync=True)
    try:
        t0 = time.perf_counter()
        pics = decode_stream(data, device=device)
        _device_sync()
        seconds = time.perf_counter() - t0
        return report(), seconds, pics
    finally:
        enable(was_on, was_sync)


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        description="Stage profile of one decode (synchronising spans).")
    parser.add_argument("stream", help="an .xvc bitstream")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    with open(args.stream, "rb") as f:
        data = f.read()
    _, seconds, pics = profile_decode(data, device=args.device)
    print(format_report())
    print("%d pictures in %.3f s (spans synchronise the device)"
          % (len(pics), seconds))
    return 0


if os.environ.get("XVC_TRACE_DIR"):
    start_trace()

if __name__ == "__main__":
    raise SystemExit(main())
