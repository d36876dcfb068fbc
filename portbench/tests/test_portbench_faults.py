"""A whole run, past the look for a card, with the timed path sound and
with it broken underneath: ``correct`` has to come out true, then false
for each fault a cell can have.  On the CPU, over the 64x48 low-delay
golden stream, with the clients as processes as on the card; the card's
own run is ``test_card_run``."""
import pytest

from portbench import control, correct, harness, run, spec
from portbench.faults import FAULTS

from .conftest import tiny_config, tiny_traffic

SECONDS = 1.5
SEED = 2 ** 31 + 12345


def execute(loop, fault=None, traced=False):
    cell = {"name": "tiny." + loop, "chips": 1}
    bench = spec.load_benchmark()
    e2e = [m for m in bench["end_to_end"]
           if m["name"] in ("setup_s", "decode_mpix_s" if loop == "closed"
                            else "live_p95_ms")]
    per_layer = [m for m in bench["per_layer"]
                 if m["name"].startswith(("parse_ms", "post_ms",
                                          "device_idle_pct"))]
    return run.execute(cell, tiny_config(), tiny_traffic(loop), e2e,
                       per_layer, SEED, SECONDS, traced, device="cpu",
                       fault=fault)


@pytest.mark.parametrize("loop", ["closed", "open"])
def test_sound_run_is_correct(loop):
    out = execute(loop)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert all(v["value"] <= v["limit"] for v in out["checks"].values())
    assert out["metrics"]["setup_s"]["value"] > 0
    assert len(out["metrics"]) == 2


def test_traced_run_reads_spans_and_the_trace():
    """Every client traces itself; the spans add up over the clients and
    the idle gaps are named by what the clients had open."""
    out = execute("closed", traced=True)
    assert out["correct"]
    assert out["metrics"]["parse_ms.farm"]["value"] > 0
    assert out["metrics"]["post_ms.farm"]["value"] > 0
    # on the CPU the trace has no device operations: all idle
    assert out["metrics"]["device_idle_pct.farm"]["value"] == 100.0
    assert out["device"]["window_s"] == pytest.approx(SECONDS)
    gaps = out["breakdown"]["idle_gaps"]
    assert gaps and any("x" in name for name, _ in gaps)


@pytest.mark.parametrize("loop", ["closed", "open"])
@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(loop, fault):
    out = execute(loop, fault=fault)
    assert not out["correct"]
    assert out["failed"] > 0


@pytest.mark.parametrize("loop", ["closed", "open"])
def test_control_is_not_correct(loop):
    """The control's pictures in the program's place fail the check."""
    cfg = tiny_config()
    win = harness.run_cell({"name": "tiny"}, cfg, tiny_traffic(loop), SEED,
                           SECONDS, 0.0, device="cpu")
    expect = harness.expected_pictures(cfg)
    attempted, _, counts = correct.compare(win.clients, win.kind, expect)
    assert correct.verdict(attempted, counts)
    attempted, failed, counts = correct.compare(
        control.substitute(win, control.control_pictures(cfg)), win.kind,
        expect)
    assert not correct.verdict(attempted, counts)
    assert counts["mismatched"] > 0


def test_client_that_fails_fails_the_run():
    """A client that dies reports why, and the run raises."""
    with pytest.raises(RuntimeError, match="client 0 failed"):
        harness.run_cell({"name": "tiny"}, tiny_config(),
                         tiny_traffic("closed"), SEED, SECONDS, 0.0,
                         device="no_such_device")


def test_card_run(card):
    """One short run of each cell on the card, from the command line."""
    import json
    import subprocess
    import sys
    for cell in spec.load_benchmark()["workloads"]:
        res = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", cell["name"],
             "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
            cwd=spec.ROOT, capture_output=True, text=True, timeout=1200)
        assert res.returncode == 0, res.stderr[-2000:]
        assert json.loads(res.stdout.splitlines()[-1])["correct"]
