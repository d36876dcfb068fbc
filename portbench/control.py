"""The readings that set and prove the limits of ``correct``.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]
        [--seconds <s>] [--fault-seconds <s>]

For each seed, on the card, with the cell's clients as ``run.py`` starts
them:

- the program: a run of the cell, and its numbers (the lower readings);
- the control: the same run's pictures, each replaced by the picture a
  decode that leaves the in-loop deblocking filter out gives at the same
  place in the stream (the reference with ``skip_deblocking``): the
  exactness the configuration states, broken as a later change might be
  tempted to break it;
- each fault planted under the timed path (``faults.FAULTS``): a run
  whose sessions hand out the previous picture again, drop every second
  picture, or alter one byte of a picture (``--fault-seconds 0``: none).

It prints one JSON line a seed.  The benchmark's own runs never run this.
"""
import argparse
import copy
import json
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import correct, harness, spec  # noqa: E402
from portbench.faults import FAULTS  # noqa: E402
from portbench.reference import work  # noqa: E402


class _Delivered:
    """A client's record with other pictures in its place."""

    def __init__(self, client, delivered):
        self.streams = client.streams
        self.schedule = client.schedule
        self.offset = client.offset
        self.delivered = delivered


def substitute(win, pictures):
    """The window's clients, each picture replaced by ``pictures``' at the
    same place in the stream (its sha256 and conformance flag)."""
    n = len(pictures)
    out = []
    for c in win.clients:
        rows = []
        if win.kind == "closed":
            for _, got in c.streams:
                for i in range(got):
                    t, pic = c.delivered[len(rows)]
                    rows.append((t, _as(pic, pictures[i % n])))
        else:
            rows = [(t, _as(pic, pictures[(c.offset + k) % n]))
                    for k, (t, pic) in enumerate(c.delivered)]
        out.append(_Delivered(c, rows))
    return out


def _as(pic, other):
    out = copy.copy(pic)
    out.digest = other["digest"]
    out.conforming = other["conforming"]
    return out


def control_pictures(cfg):
    """The control's pictures of the configuration's stream."""
    with open(cfg["stream_path"], "rb") as f:
        pics = work.decode(f.read(), skip_deblocking=True)
    return [{"digest": work.digest(p), "conforming": p["conforming"]}
            for p in pics]


def readings(cell, cfg, traffic, seed, seconds, fault_seconds, ctrl,
             device=None):
    expect = harness.expected_pictures(cfg)
    out = {"seed": seed}
    win = harness.run_cell(cell, cfg, traffic, seed, seconds, T_START,
                           device=device)
    out["program"] = correct.compare(win.clients, win.kind, expect)[2]
    out["control"] = correct.compare(substitute(win, ctrl), win.kind,
                                     expect)[2]
    for fault in FAULTS if fault_seconds > 0 else ():
        fwin = harness.run_cell(cell, cfg, traffic, seed, fault_seconds,
                                T_START, device=device, fault=fault)
        counts = correct.compare(fwin.clients, fwin.kind, expect)
        out[fault] = dict(counts[2], correct=correct.verdict(counts[0],
                                                             counts[2]))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--fault-seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    bench = spec.load_benchmark()
    cell, cfg, traffic, _, _ = spec.cell_spec(bench, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    ctrl = control_pictures(cfg)
    for seed in args.seeds:
        row = readings(cell, cfg, traffic, seed,
                       args.seconds or bench["run_seconds"],
                       args.fault_seconds, ctrl)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
