"""The sweep that found a live mix's rate: a cell's open loop at each of
several rates a stream, one run each, on the card.

    python3 portbench/sweep.py --workload <cell> --seed <n> --seconds <s>
        --rates <r> [<r> ...]

It prints one JSON line a rate: ``live_p95_ms``, the median latency of
the pictures due in the window's first and last thirds (a backlog that
grows through the window shows as the second far above the first: the
rate is past the knee), and whether the pictures were correct.  The
knee is the highest rate whose backlog stays flat; the mix's file keeps
the rate chosen from it.  The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import correct, harness, spec  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    cell, cfg, traffic, _, _ = spec.cell_spec(spec.load_benchmark(),
                                              args.workload)
    for rate in args.rates:
        win = harness.run_cell(cell, cfg, dict(traffic, rate=rate),
                               args.seed, args.seconds, time.perf_counter())
        attempted, _, counts = correct.compare(
            win.clients, win.kind, harness.expected_pictures(cfg))
        print(json.dumps({"rate": rate,
                          "live_p95_ms": win.metrics["live_p95_ms"],
                          "thirds_ms": win.run.backlog,
                          "correct": correct.verdict(attempted, counts)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
