"""Runs one cell of the port's benchmark once and prints one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout that holds the port, on a machine with the
card(s) the cell asks for.  This process starts the cell's clients, each
a process of its own (``client.py``), and never touches the card itself.
``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` runs
the same window with every client under the port's trace and reports
its per-layer metrics and where the time went.  Either way the pictures
handed out are compared with the plain reference decoder's after the
window, and the numbers compared are printed beside their limits as the
last lines of standard error and the last key of the line.  It exits
with another code than 0, printing no result, where CUDA or the port is
missing, or where ``jax``, ``jaxlib``, ``flax`` or ``xvc_tpu`` is loaded
in this process or in a client once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import correct, harness, spec  # noqa: E402

TOP = 10


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg):
    print("portbench: " + msg, file=sys.stderr, flush=True)
    return 2


def execute(cell, cfg, traffic, e2e, per_layer, seed, seconds, traced,
            device=None, fault=None):
    """One run of a cell once the card has been found: the window, the
    check and the result's line as a dict, or an error message."""
    trace_dir = tempfile.mkdtemp(prefix="portbench_trace")
    try:
        win = harness.run_cell(cell, cfg, traffic, seed, seconds, T_START,
                               device=device, fault=fault, trace=traced,
                               trace_dir=trace_dir)
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    bad = harness.forbidden_modules() + sorted(
        {m for c in win.clients for m in c.forbidden})
    if bad:
        return "loaded in the run's processes: %s" % ", ".join(bad)
    out_device = win.device()
    if traced:
        win.run.trace = win.trace()
        out_device["busy_s"] = win.run.trace.busy_s()
        out_device["window_s"] = win.run.trace.window_s
    if win.kind == "open":
        print("portbench: median latency of the window's first and last "
              "thirds %s ms" % (win.run.backlog,), file=sys.stderr)
    ok, attempted, failed, counts = harness.judge(cfg, win)
    if traced:
        metrics = harness.per_layer(per_layer, win.run)
    else:
        metrics = {m["name"]: {"value": win.metrics[m["name"]],
                               "unit": m["unit"]} for m in e2e}
    out = {"correct": ok, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": out_device}
    if traced:
        tr = win.run.trace
        out["breakdown"] = {
            "device_ops": [[n, s] for n, s in
                           tr.device_seconds_by_name().most_common(TOP)],
            "idle_gaps": [[n, s] for n, s in
                          tr.idle_by_host().most_common(TOP)]}
    out["checks"] = correct.check_lines(counts)
    return out


def main(argv=None):
    args = parse_args(argv)
    cell, cfg, traffic, e2e, per_layer = spec.cell_spec(
        spec.load_benchmark(), args.workload)
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device (torch.cuda.is_available() is False)")
    if torch.cuda.device_count() < cell["chips"]:
        return fail("the cell asks for %d cards, %d visible" % (
            cell["chips"], torch.cuda.device_count()))
    if importlib.util.find_spec("xvc_tpu_torch") is None:
        return fail("the port is not in this checkout")
    out = execute(cell, cfg, traffic, e2e, per_layer, args.seed,
                  args.seconds, bool(args.trace))
    if isinstance(out, str):
        return fail(out)
    for name, row in out["checks"].items():
        print("check %s %s limit %s" % (name, row["value"], row["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
