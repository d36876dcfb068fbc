"""The load generator: client processes that drive decoder sessions.

Every client of a cell is a child process (``client.py``) that decodes
the cell's stream through a session of its own, as a decode farm's
workers do: a process a stream, each with its own interpreter and its
own CUDA context on the card.  ``ClientProcess`` is the parent's end of
its pipes.  The parent makes the schedule and the window's times here,
hands them out, and reads each client's record once the window has
closed.  Nothing is checked inside the window.

- ``closed`` (files back to back): a client decodes the stream start to
  end through a new session, drains it, and starts the next file at
  once.  The clients start a stream's n-th part apart.
- ``open`` (live streams): one session a client, fed the stream as a
  continuous live feed, picture after picture at the times of a fixed
  schedule, whether or not earlier pictures are out yet.
"""
import json
import os
import queue
import random
import subprocess
import sys
import threading
import time

from .reference.xvcref.nal import split_nal_units

CLIENT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "client.py")


def stream_units(data):
    """The stream as (segment-header NALs, one NAL per picture)."""
    nals = list(split_nal_units(data))
    head = []
    while nals and (nals[0][0] >> 1) & 31 == 16:  # segment header
        head.append(nals.pop(0))
    return head, nals


def sleep_until(t):
    wait = t - time.perf_counter()
    if wait > 0:
        time.sleep(wait)


class Handed:
    """A picture handed out: the sha256 of its bytes (hex), its
    conformance flag and its size."""
    __slots__ = ("digest", "conforming", "width", "height")

    def __init__(self, digest, conforming, width, height):
        self.digest = digest
        self.conforming = conforming
        self.width = width
        self.height = height


class ClientProcess:
    """A client process and the lines it sends, read by a thread of the
    parent so that a wait can time out."""

    def __init__(self, index, job, cwd):
        self.index = index
        self.job = job
        self.proc = subprocess.Popen(
            [sys.executable, CLIENT], cwd=cwd, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True, bufsize=1)
        self.lines = queue.Queue()
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        self.send(job)

    def _read(self):
        for line in self.proc.stdout:
            self.lines.put(json.loads(line))
        self.lines.put(None)

    def send(self, msg):
        self.proc.stdin.write(json.dumps(msg) + "\n")
        self.proc.stdin.flush()

    def expect(self, key, timeout):
        """The client's next message, which has to carry ``key``."""
        try:
            msg = self.lines.get(timeout=max(timeout, 0.0))
        except queue.Empty:
            raise RuntimeError("client %d sent no %r in %.0f s"
                               % (self.index, key, timeout)) from None
        if msg is None:
            raise RuntimeError("client %d ended (code %s) before %r"
                               % (self.index, self.proc.wait(), key))
        if "error" in msg:
            raise RuntimeError("client %d failed:\n%s"
                               % (self.index, msg["error"]))
        if key not in msg:
            raise RuntimeError("client %d sent %r, not %r"
                               % (self.index, sorted(msg), key))
        return msg[key]

    def stop(self, timeout=30.0):
        """Waits for the process to end, and ends it if it does not."""
        try:
            self.proc.stdin.close()
        except OSError:
            pass
        try:
            self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.reader.join(timeout)


class Client:
    """What a client recorded, as the check and the readers take it."""

    def __init__(self, index, job, record, schedule=(), in_window=0):
        self.index = index
        self.offset = job.get("offset", 0)
        self.schedule = list(schedule)
        self.in_window = in_window
        self.delivered = [(row[0], Handed(*row[1:]))
                          for row in record["delivered"]]
        self.streams = [tuple(s) for s in record["streams"]]
        self.fed = [tuple(f) for f in record["fed"]]
        self.calls = [tuple(c) for c in record["calls"]]
        self.spans = record["spans"]
        self.device_ops = [tuple(d) for d in record["device_ops"]]
        self.host_spans = [tuple(h) for h in record["host_spans"]]
        self.device_name = record.get("device_name")
        self.memory_peak_bytes = record.get("memory_peak_bytes", 0)
        self.forbidden = record.get("forbidden", [])


def open_schedule(rng, t0, t1, rate, jitter, phase, whole, offset):
    """Due times of one live stream: a picture every ``1 / rate`` seconds
    from ``t0 + phase``, each late by up to ``jitter`` of a period, up to
    ``t1`` and on to the end of the stream's current loop of ``whole``
    pictures (the feed, which starts at picture ``offset``, goes on past
    the window).  Returns (due times, how many fall before ``t1``)."""
    period = 1.0 / rate
    out = []
    inside = None
    j = 0
    while True:
        due = t0 + phase + j * period + rng.uniform(0, jitter * period)
        if due >= t1 and inside is None:
            inside = j
        if inside is not None and (offset + j) % whole == 0:
            return out, inside
        out.append(due)
        j += 1


def phases(rng, n):
    """The clients' places in a cycle of ``n`` equal steps: the same set
    for every seed, dealt out in the seed's order, so that the seed moves
    which client is where and not how the load falls."""
    order = list(range(n))
    rng.shuffle(order)
    return order


def seeded(seed, *salt):
    """A generator of its own for each use of the seed."""
    return random.Random(repr((int(seed),) + salt))
