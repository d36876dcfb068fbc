"""One run of one cell: set-up, the measured window, the check, the line.

``run_cell`` starts the cell's client processes (``load.py``,
``client.py``), lets each decode the stream once (the first run in a
checkout builds the port's kernels there; the port's build is safe when
several processes start it at once), measures for ``seconds``, lets the
clients finish what they hold, and collects their records.  ``judge``
compares every picture handed out with the plain reference decoder's, as
its hash list records them.  Neither looks for a card: ``run.py`` does.
"""
import json
import sys
import time

from . import correct, load, spec, stats
from .trace import Trace

# a client that has not finished what it holds a minute past the close
# has lost it
DRAIN_S = 60.0
# how long the clients may take to import, build and warm up
WARM_S = 1200.0
# a traced client's writing and reading of its trace, after the drain
TRACE_READ_S = 240.0
# from the go to the first client's start
GO_LEAD_S = 0.05
FORBIDDEN = ("jax", "jaxlib", "flax", "xvc_tpu")


def forbidden_modules(modules=None):
    """Of the module names (``sys.modules`` by default) those whose
    top-level name is one of ``FORBIDDEN``, the name compared whole
    (``xvc_tpu_torch`` is not ``xvc_tpu``)."""
    return sorted(m for m in (sys.modules if modules is None else modules)
                  if m.split(".")[0] in FORBIDDEN)


class Run:
    """What the per-layer readers read: the window's pictures, spans
    and trace, the open loop's lags and the reference's work."""

    def __init__(self, **kw):
        self.pictures = 0
        self.spans = {}
        self.trace = None
        self.lags = []
        self.work = {}
        self.__dict__.update(kw)

    def span_ms(self, *names):
        """Milliseconds a window picture of the spans ``names``, summed
        over the clients; None where none was recorded."""
        rows = [self.spans[n] for n in names if n in self.spans]
        if not rows or not self.pictures:
            return None
        return sum(r["seconds"] for r in rows) * 1e3 / self.pictures


def read_hashes(path):
    """A hash list: each picture's sha256 (hex) and conformance flag, in
    output order."""
    with open(path) as f:
        rows = [line.split() for line in f if line.strip()]
    return [r[0] for r in rows], ["checksum-mismatch" not in r for r in rows]


def expected_pictures(cfg):
    """The reference decoder's pictures of the configuration's stream, as
    its hash list holds them (``tests/test_portbench_reference.py`` holds
    the reference to the list)."""
    hashes, flags = read_hashes(cfg["hashes_path"])
    if len(hashes) != cfg["pictures"]:
        raise RuntimeError("%s lists %d pictures, the configuration %d"
                           % (cfg["hashes_path"], len(hashes),
                              cfg["pictures"]))
    return [{"digest": h, "conforming": c} for h, c in zip(hashes, flags)]


def read_work(cfg):
    """The bytes the picture kernels need for an average picture of the
    stream, by kind (``reference/work.py``, recorded in the file the
    configuration names)."""
    with open(cfg["work_path"]) as f:
        rows = json.load(f)["pictures"]
    return {kind: sum(r[kind] for r in rows) / len(rows)
            for kind in rows[0] if kind != "poc"}


def _window_pictures(clients, t0, t1):
    return [p for c in clients for t, p in c.delivered if t0 <= t < t1]


def _live_latencies(clients, gave_up):
    """Seconds from each scheduled picture's due time to its delivery; for
    one never delivered, to ``gave_up``, when the check stopped waiting."""
    out = []
    for c in clients:
        for k, due in enumerate(c.schedule[:c.in_window]):
            out.append((c.delivered[k][0] if k < len(c.delivered)
                        else gave_up) - due)
    return out


def _backlog(clients, gave_up):
    """The median latency, ms, of the pictures due in the window's first
    and last thirds: a backlog that grows through the window shows as the
    second far above the first (the rate is past the knee)."""
    first, last = [], []
    for c in clients:
        n = c.in_window
        for k, due in enumerate(c.schedule[:n]):
            got = c.delivered[k][0] if k < len(c.delivered) else gave_up
            if k < n // 3:
                first.append(got - due)
            elif k >= n - n // 3:
                last.append(got - due)
    return (stats.tail(first, 0.5) * 1e3 if first else None,
            stats.tail(last, 0.5) * 1e3 if last else None)


class Window:
    """A cell's clients after the window, with what was measured."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def trace(self):
        """The window's device operations over every client, and what
        each client was doing meanwhile."""
        tr = Trace([op for c in self.clients for op in c.device_ops],
                   (self.t0, self.t1))
        for c in self.clients:
            tr.add_host(c.index, c.calls + c.host_spans)
        return tr

    def device(self):
        """The line's ``device``: the card of the clients, and the sum of
        their peaks (the clients share the card)."""
        names = {c.device_name for c in self.clients}
        return {"platform": "gpu", "kind": sorted(map(str, names))[0],
                "count": self.chips,
                "memory_peak_bytes": sum(c.memory_peak_bytes
                                         for c in self.clients)}


def _jobs(cfg, traffic, chips, place, device, fault, trace, trace_dir):
    n = traffic["clients"]
    with open(cfg["stream_path"], "rb") as f:
        pictures = len(load.stream_units(f.read())[1])
    jobs = []
    for i in range(n):
        jobs.append(dict(
            stream=cfg["stream_path"], loop=traffic["loop"],
            threads=traffic["threads"], fault=fault, trace=trace,
            trace_dir=trace_dir,
            device=device or ("cuda:%d" % (i % chips) if chips > 1
                              else None),
            offset=place[i] * pictures // n
            if traffic["loop"] == "open" else 0))
    return jobs, pictures


def run_cell(cell, cfg, traffic, seed, seconds, t_start, device=None,
             fault=None, trace=False, trace_dir=None):
    """Set-up, the window and the drain.  ``device`` ("cpu" in the tests)
    overrides the card; ``fault`` plants one of ``faults.FAULTS`` under
    every client's session."""
    kind = traffic["loop"]
    if kind == "open" and cfg["coding"]["sub_gop_length"] != 1:
        # the k-th picture fed is the k-th handed out only in low delay
        raise ValueError("an open-loop mix needs a low-delay stream")
    n = traffic["clients"]
    # the clients start a stream's n-th part apart: in the closed loop
    # by time, in the open loop by picture and by phase in the period
    place = load.phases(load.seeded(seed, cell["name"], "places"), n)
    jobs, pictures = _jobs(cfg, traffic, cell.get("chips", 1), place,
                           device, fault, trace, trace_dir)
    procs = []
    try:
        for i, job in enumerate(jobs):
            procs.append(load.ClientProcess(i, job, spec.ROOT))
        deadline = time.perf_counter() + WARM_S
        for p in procs:
            p.expect("warm", deadline - time.perf_counter())
        print("portbench: set-up: every client warm %.1f s after the start"
              % (time.perf_counter() - t_start), file=sys.stderr)
        go = time.perf_counter() + GO_LEAD_S
        schedules = [((), 0)] * n
        if kind == "closed":
            t0 = go + traffic["stagger_s"]
            t1 = t0 + seconds
            for i, p in enumerate(procs):
                p.send({"go": {"t0": t0, "t1": t1, "start": go + place[i] *
                               traffic["stagger_s"] / n}})
        else:
            t0 = go
            t1 = t0 + seconds
            for i, p in enumerate(procs):
                schedules[i] = load.open_schedule(
                    load.seeded(seed, cell["name"], "client", i),
                    t0 + traffic["lead_s"], t1, traffic["rate"],
                    traffic["jitter"], place[i] / n / traffic["rate"],
                    pictures, jobs[i]["offset"])
                p.send({"go": {"t0": t0, "t1": t1,
                               "schedule": schedules[i][0]}})
        until = t1 + DRAIN_S + (TRACE_READ_S if trace else 0.0)
        records = [p.expect("record", until - time.perf_counter())
                   for p in procs]
    finally:
        for p in procs:
            p.stop()
    clients = [load.Client(i, jobs[i], rec, *schedules[i])
               for i, rec in enumerate(records)]
    pics = _window_pictures(clients, t0, t1)
    if kind == "closed":
        print("portbench: streams a client %s, pictures handed out in the "
              "window %d" % ([len(c.streams) for c in clients], len(pics)),
              file=sys.stderr)
    spans = {}
    for c in clients:
        for name, row in c.spans.items():
            tot = spans.setdefault(name, {"seconds": 0.0, "calls": 0})
            tot["seconds"] += row["seconds"]
            tot["calls"] += row["calls"]
    run = Run(pictures=len(pics), spans=spans)
    metrics = dict(setup_s=t0 - t_start,
                   decode_mpix_s=stats.rate(
                       sum(p.width * p.height for p in pics), seconds) / 1e6)
    if kind == "open":
        run.lags = [fed - due for c in clients
                    for due, fed in c.fed[:c.in_window]]
        lat = _live_latencies(clients, t1 + DRAIN_S)
        metrics["live_p95_ms"] = stats.tail(lat) * 1e3
        run.backlog = _backlog(clients, t1 + DRAIN_S)
    return Window(clients=clients, kind=kind, run=run, metrics=metrics,
                  t0=t0, t1=t1, chips=cell.get("chips", 1))


def judge(cfg, win):
    """After the window: the work a picture needs (into ``win.run``), and
    (correct, attempted, failed, counts) against the reference."""
    win.run.work = read_work(cfg)
    attempted, failed, counts = correct.compare(
        win.clients, win.kind, expected_pictures(cfg))
    return correct.verdict(attempted, counts), attempted, failed, counts


def per_layer(entries, run):
    """The per-layer metrics whose readers find something to read."""
    out = {}
    for m in entries:
        value = spec.reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
