"""Finds everything a cell needs by the names in ``BENCHMARK.json``.

A configuration is ``configs/<config>.json``, a traffic mix
``traffic/<traffic>.json`` and a per-layer metric the reader
``metrics/<family>.py``, where the family is the metric's name up to its
first dot (``parse_ms.live`` -> ``metrics/parse_ms.py``).  A later change
adds a cell, a configuration, a mix or a metric by adding such files and
entries, never by editing one.
"""
import importlib
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def config_file(name):
    return os.path.join(HERE, "configs", name + ".json")


def traffic_file(name):
    return os.path.join(HERE, "traffic", name + ".json")


def reader_module(metric):
    return "portbench.metrics." + metric.split(".")[0]


def load_config(name):
    with open(config_file(name)) as f:
        cfg = json.load(f)
    cfg["stream_path"] = os.path.join(ROOT, cfg["stream"])
    cfg["hashes_path"] = os.path.join(ROOT, cfg["hashes"])
    cfg["work_path"] = os.path.join(ROOT, cfg["work"])
    return cfg


def load_traffic(name):
    with open(traffic_file(name)) as f:
        return json.load(f)


def applies(metric, cell):
    """Whether a metric entry is reported in a cell."""
    return cell in metric.get("workloads", [cell])


def cell_spec(bench, workload):
    """(cell, config, traffic, end-to-end entries, per-layer entries)."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError("no workload %r in BENCHMARK.json" % workload)
    cell = cells[workload]
    return (cell, load_config(cell["config"]), load_traffic(cell["traffic"]),
            [m for m in bench["end_to_end"] if applies(m, workload)],
            [m for m in bench["per_layer"] if applies(m, workload)])


def reader(metric):
    """The ``read(run)`` function of a per-layer metric."""
    return importlib.import_module(reader_module(metric)).read
