"""Where each client's time went in one traced window of a cell.

    python3 portbench/selftime.py --workload <cell> --seed <n>
        --seconds <s>

runs the cell once with every client traced, as ``run.py --trace 1``
does, and prints one JSON line: the per-layer metrics; ``self_ms``, the
clients' time a picture of the window by the innermost range open (a
span of the port, or a call into the session where no span is open:
that call's name, the ``unspanned`` time; ``sleep``; ``client`` where
none is open), which adds up to the clients' time in the window;
``copies``, the port's copy counters against the trace's copy events;
and for an open loop ``latency_ms``, the mean latency split into how
late the picture was fed, its decode chain and its wait in the session's
output queue.  A tool for reading a cell, not part of the benchmark's
line.
"""
import argparse
import collections
import heapq
import json
import os
import shutil
import sys
import tempfile
import time

T_START = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import harness, spec  # noqa: E402
from portbench.trace import kernel_name  # noqa: E402

COPIES = (("xfer.htod", "Memcpy HtoD"), ("xfer.dtoh", "Memcpy DtoH"))


def self_seconds(rows, lo, hi):
    """Seconds of ``[lo, hi]`` by the row ([name, start, end]) that
    opened last among those open, "client" where none is."""
    out = collections.Counter()
    edges = sorted({lo, hi} | {min(max(t, lo), hi) for _, s, e in rows
                               for t in (s, e)})
    rows = sorted((s, e, n) for n, s, e in rows if e > s)
    heap, i = [], 0
    for a, b in zip(edges, edges[1:]):
        while i < len(rows) and rows[i][0] <= a:
            s, e, n = rows[i]
            heapq.heappush(heap, (-s, e, n))
            i += 1
        # a row that opened later than the top and is still open would be
        # the top: what lies under a closed top is older
        while heap and heap[0][1] <= a:
            heapq.heappop(heap)
        out[heap[0][2] if heap else "client"] += b - a
    return out


def read_window(win, cfg, per_layer):
    """The line's dict of a traced window ``win`` (``harness.run_cell``
    with ``trace``) of the configuration ``cfg``."""
    run = win.run
    run.trace = tr = win.trace()
    ok = harness.judge(cfg, win)[0]
    n = run.pictures
    total = collections.Counter()
    for rows in tr.host.values():
        total.update(self_seconds(rows, tr.lo, tr.hi))
    out = {"correct": ok, "pictures": n,
           "metrics": {k: v["value"] for k, v in
                       harness.per_layer(per_layer, run).items()},
           "self_ms": {k: v * 1e3 / n for k, v in total.most_common()},
           "copies": {c: {"counted": run.spans.get(c, {}).get("calls"),
                          "bytes": run.spans.get(c + ".bytes", {}).get(
                              "calls"),
                          "trace": sum(1 for name, s, _ in tr.device
                                       if kernel_name(name) == ev and
                                       tr.lo <= s < tr.hi)}
                      for c, ev in COPIES},
           "spans": run.spans}
    if win.kind == "open":
        lat = harness._live_latencies(win.clients, win.t1 + harness.DRAIN_S)
        wait = run.spans.get("session.output_wait")
        mean = sum(lat) / len(lat)
        lag = sum(run.lags) / len(run.lags)
        out_wait = wait["seconds"] / wait["calls"] if wait else 0.0
        out["latency_ms"] = {"mean": mean * 1e3, "gen_lag": lag * 1e3,
                             "output_wait": out_wait * 1e3,
                             "decode_chain": (mean - lag - out_wait) * 1e3}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    cell, cfg, traffic, _, per_layer = spec.cell_spec(
        spec.load_benchmark(), args.workload)
    trace_dir = tempfile.mkdtemp(prefix="portbench_trace")
    try:
        win = harness.run_cell(cell, cfg, traffic, args.seed, args.seconds,
                               T_START, trace=True, trace_dir=trace_dir)
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    print(json.dumps(read_window(win, cfg, per_layer)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
