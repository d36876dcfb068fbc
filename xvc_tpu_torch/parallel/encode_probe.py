"""Where the time of a picture-threaded encode goes, on the card.

Run from the root of a checkout on a machine with an NVIDIA GPU, on a raw
8-bit 4:2:0 clip (chip_smoke.py's ``make_ra720_s3`` writes the one of
its phase 10):

    python -m xvc_tpu_torch.parallel.encode_probe CLIP.yuv WIDTH HEIGHT \\
        FRAMES [--sub-gop 8] [--speed 3] [--workers 4]

It encodes the clip through ``api.EncoderSession`` on the card three
times, with the stage spans on (no synchronisation, no torch.profiler):
with no picture threads, on the pipeline with one worker (each picture
in a worker thread, one at a time), and with ``--workers`` workers; the
streams must be equal.  For each it prints the seconds, each picture's
encode seconds by POC and the spans' seconds (the native CTU search and
its parts, the split DP, the transform-RD prepass).  Before them it
times one to ``--workers`` threads hashing 256 MB each (``hashlib``
releases the interpreter lock), which shows how many cores the host
lets the workers use at once, and it prints the CPUs this process may
run on.
"""
import argparse
import hashlib
import json
import os
import threading
import time

import torch

from .. import api, profiling
from ..codec import picture_encoder
from ..parallel.pipeline import EncodePipeline


def host_scaling(workers, mbytes=256):
    """Seconds for 1..workers threads each hashing ``mbytes`` MB at once."""
    data = os.urandom(1 << 20) * mbytes
    out = {}
    for n in range(1, workers + 1):
        threads = [threading.Thread(target=hashlib.sha256, args=(data,))
                   for _ in range(n)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        out[n] = time.perf_counter() - t0
    return out


def encode(yuv, width, height, frames, sub_gop, speed, workers):
    """One encode on the card with ``workers`` picture threads (0: none;
    1: the pipeline with one worker).  Returns (NALs, seconds, seconds a
    picture by POC, spans)."""
    params = api.EncoderParameters(
        width=width, height=height, qp=32, speed_mode=speed,
        sub_gop_length=sub_gop, checksum_mode=1, threads=workers)
    ses = api.EncoderSession(params)
    if workers == 1:
        ses._enc.pipeline = EncodePipeline(1)
    cls = picture_encoder.PictureEncoder
    orig, per_picture = cls.encode, {}

    def timed(self, *args):
        t0 = time.perf_counter()
        try:
            return orig(self, *args)
        finally:
            per_picture[self.pic_data.poc] = round(
                time.perf_counter() - t0, 4)

    fs = width * height * 3 // 2
    profiling.reset()
    profiling.enable()
    cls.encode = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nals = []
        for i in range(frames):
            nals += ses.encode(yuv[i * fs:(i + 1) * fs])
        nals += ses.flush()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        spans = {k: v["seconds"] for k, v in profiling.report().items()}
    finally:
        cls.encode = orig
        profiling.enable(False)
        profiling.reset()
    return nals, seconds, per_picture, spans


def main(argv=None):
    ap = argparse.ArgumentParser(prog="encode_probe")
    ap.add_argument("clip")
    ap.add_argument("width", type=int)
    ap.add_argument("height", type=int)
    ap.add_argument("frames", type=int)
    ap.add_argument("--sub-gop", type=int, default=8)
    ap.add_argument("--speed", type=int, default=3)
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("encode_probe: no CUDA device")
    with open(args.clip, "rb") as f:
        yuv = f.read()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "cpus": os.cpu_count(),
                      "cpus_allowed": len(os.sched_getaffinity(0)),
                      "hash_threads_seconds": host_scaling(args.workers)}),
          flush=True)
    first = None
    for workers in (0, 1, args.workers):
        nals, seconds, per_picture, spans = encode(
            yuv, args.width, args.height, args.frames, args.sub_gop,
            args.speed, workers)
        if first is None:
            first = nals
        elif nals != first:
            raise AssertionError("the encode with %d workers differs from "
                                 "the sequential one" % workers)
        print(json.dumps({"workers": workers, "seconds": seconds,
                          "picture_seconds": per_picture, "spans": spans}),
              flush=True)


if __name__ == "__main__":
    main()
