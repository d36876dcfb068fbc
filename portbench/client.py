"""One client of a cell: a child process that decodes the cell's stream
through ``xvc_tpu_torch.api.DecoderSession``, spoken to over pipes by
``load.ClientProcess``.

    python3 portbench/client.py

Each way one JSON object a line.  The parent sends the job; the client
imports the port, decodes the stream once, answers ``warm`` and waits
for ``go``, which carries the window's times; it then decodes as its
traffic says, answers with its record, and exits.
The port's own output goes to standard error, so that standard output
carries only the protocol.

- ``closed`` (files back to back): from ``start`` on, the stream start
  to end through a new session, drained, and the next file at once,
  until a stream ends at or after ``t1``.
- ``open`` (a live feed): one session, fed the stream's pictures at the
  due times of ``schedule`` (the stream looped, a new segment each
  loop), whether or not earlier pictures are out yet, then flushed.

The record holds every picture handed out (when, the sha256 of its
bytes, its conformance flag, its size), the streams' starts and sizes or
the feed's due and fed times, the span of every call into the session,
and with ``trace``: the port's span totals from the window's start to
its close, the device's operations and the host's spans of this
process's trace, on the clock of ``time.perf_counter``, which all
processes of the machine share.
"""
import hashlib
import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import load  # noqa: E402

# the range that ties this process's trace to ``time.perf_counter``
MARK = "portbench.mark"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("user_annotation",)


def handed(pic):
    return [hashlib.sha256(pic.bytes).hexdigest(), bool(pic.conforming),
            pic.width, pic.height]


class Loop:
    """The client's decoding, with what it records."""

    def __init__(self, job, make_session, profiling=None):
        self.job = job
        self.head, self.pics = load.stream_units(
            open(job["stream"], "rb").read())
        self.make_session = make_session
        self.profiling = profiling
        self.delivered = []     # [seconds, sha256, conforming, w, h]
        self.streams = []       # closed loop: [start, pictures]
        self.fed = []           # open loop: [due, fed at]
        self.calls = []         # [call, start, end]
        self.spans = None       # the port's spans over the window
        self.t0 = self.t1 = None
        self._reset = False

    def _call(self, name, fn, *args):
        s = time.perf_counter()
        out = fn(*args)
        e = time.perf_counter()
        if self.t0 is not None:
            self.calls.append([name, s, e])
            self._spans_at(e)
        return out

    def _spans_at(self, now):
        """The port's spans count from the first call that ends in the
        window to the first that ends after it."""
        if self.profiling is None:
            return
        if not self._reset and now >= self.t0:
            self.profiling.reset()
            self._reset = True
        if self.spans is None and now >= self.t1:
            self.spans = self.profiling.report()

    def _drain(self, ses, out):
        while True:
            pic = self._call("get_picture", ses.get_picture)
            if pic is None:
                return
            out.append([time.perf_counter()] + handed(pic))

    def one_stream(self):
        ses = self._call("new_session", self.make_session)
        out = []
        for nal in self.head:
            self._call("decode_nal", ses.decode_nal, nal)
        for nal in self.pics:
            self._call("decode_nal", ses.decode_nal, nal)
            self._drain(ses, out)
        self._call("flush", ses.flush)
        self._drain(ses, out)
        return out

    def _feed(self, ses, j):
        """Picture ``j`` of the live feed: the stream's picture
        ``(offset + j) mod n``, a new segment before each picture 0."""
        i = (self.job["offset"] + j) % len(self.pics)
        if i == 0:
            for nal in self.head:
                self._call("decode_nal", ses.decode_nal, nal)
        self._call("decode_nal", ses.decode_nal, self.pics[i])

    def warm(self):
        """The set-up's decode: the stream once; for the live feed, on
        into the next loop up to the picture where the feed starts."""
        if self.job["loop"] == "closed":
            self.one_stream()
            return
        self.ses = self.make_session()
        self.warm_out = []
        n = len(self.pics)
        for j in range(-n - self.job["offset"], 0):
            self._feed(self.ses, j)
            self._drain(self.ses, self.warm_out)

    def run(self, go):
        self.t0, self.t1 = go["t0"], go["t1"]
        if self.job["loop"] == "closed":
            load.sleep_until(go["start"])
            while time.perf_counter() < self.t1:
                start = time.perf_counter()
                out = self.one_stream()
                self.streams.append([start, len(out)])
                self.delivered.extend(out)
        else:
            n = len(self.pics)
            # the warm-up's last pictures are still inside the session
            skip = n + self.job["offset"] - len(self.warm_out)
            for j, due in enumerate(go["schedule"]):
                wait = due - time.perf_counter()
                if wait > 0:
                    self._call("sleep", time.sleep, wait)
                fed = time.perf_counter()
                self._feed(self.ses, j)
                self.fed.append([due, fed])
                self._drain(self.ses, self.delivered)
            self._call("flush", self.ses.flush)
            self._drain(self.ses, self.delivered)
            self.delivered = self.delivered[skip:]
        self._spans_at(max(time.perf_counter(), self.t1))


def mark():
    """A range in the trace and the ``perf_counter`` reading inside it."""
    from torch.profiler import record_function
    with record_function(MARK):
        return time.perf_counter()


def read_trace(path, at_mark):
    """The device's operations and the host's spans of this process's
    Chrome trace, as ``[name, start, end]`` on the ``perf_counter``
    clock; the trace file is removed."""
    try:
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    events = [ev for ev in events if ev.get("ph") == "X"]
    marks = [float(ev["ts"]) for ev in events if ev.get("name") == MARK]
    if not marks:
        raise ValueError("the trace %s has no %s range" % (path, MARK))
    shift = at_mark - marks[0] * 1e-6
    device, host = [], []
    for ev in events:
        cat = ev.get("cat")
        if cat in DEVICE_CATEGORIES:
            rows = device
        elif cat in HOST_CATEGORIES and ev.get("name") != MARK:
            rows = host
        else:
            continue
        s = float(ev["ts"]) * 1e-6 + shift
        rows.append([ev.get("name", ""), s,
                     s + float(ev.get("dur", 0)) * 1e-6])
    return device, host


def forbidden_modules():
    names = ("jax", "jaxlib", "flax", "xvc_tpu")
    return sorted(m for m in sys.modules if m.split(".")[0] in names)


def main():
    proto = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)  # the port's prints go to standard error

    def say(**msg):
        proto.write(json.dumps(msg) + "\n")
        proto.flush()

    def hear(key):
        line = sys.stdin.readline()
        if not line:
            raise SystemExit("portbench client: the parent went away")
        msg = json.loads(line)
        if key not in msg:
            raise SystemExit("portbench client: expected %r, got %r"
                             % (key, msg))
        return msg[key]

    try:
        run_job(json.loads(sys.stdin.readline()), say, hear)
    except BaseException:  # the parent reports it and fails the run
        say(error=traceback.format_exc())
        raise
    finally:
        proto.close()


def run_job(job, say, hear):
    import torch
    from xvc_tpu_torch import api, profiling
    params = api.DecoderParameters(threads=job["threads"])
    device = job.get("device")

    def make_session():
        return api.DecoderSession(params, device=device)

    if job.get("fault"):
        from portbench.faults import FaultySession
        plain = make_session

        def make_session():
            return FaultySession(plain(), job["fault"])

    cuda = device != "cpu" and torch.cuda.is_available()
    if cuda:
        torch.cuda.set_device(torch.device(device) if device else 0)
        torch.cuda.reset_peak_memory_stats()
    loop = Loop(job, make_session, profiling if job["trace"] else None)
    loop.warm()
    trace_path = at_mark = None
    if job["trace"]:
        profiling.enable(True)
        profiling.start_trace(job["trace_dir"])
        at_mark = mark()
    say(warm=True)
    loop.run(hear("go"))
    record = dict(delivered=loop.delivered, streams=loop.streams,
                  fed=loop.fed, calls=loop.calls, spans=loop.spans or {},
                  device_ops=[], host_spans=[])
    if job["trace"]:
        trace_path = profiling.stop_trace()
        profiling.enable(False)
        record["device_ops"], record["host_spans"] = read_trace(
            trace_path, at_mark)
    if cuda:
        torch.cuda.synchronize()
        record["device_name"] = torch.cuda.get_device_name()
        record["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    record["forbidden"] = forbidden_modules()
    say(record=record)


if __name__ == "__main__":
    main()
