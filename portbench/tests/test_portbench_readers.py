"""The readers of the per-layer metrics on the port's session, output
queue, device waits, copies and unspanned time, on hand-built runs and
traces, and in a traced run of the port on the CPU."""
import pytest

from portbench import harness, run, selftime, spec
from portbench.metrics import (device_wait_ms, dtoh_mb, output_wait_ms,
                               session_ms, unspanned_ms)
from portbench.trace import Trace

from .conftest import tiny_config, tiny_traffic

NEW = ("session_ms", "output_wait_ms", "device_wait_ms", "dtoh_mb",
       "unspanned_ms")


def client_rows():
    """A client's calls and spans: nested and overlapping spans inside
    ``decode_nal`` (1 + 5 = 6 of its 10 s covered), ``get_picture`` with
    none, a span inside ``sleep`` (not a call)."""
    return [["decode_nal", 0.0, 10.0], ["decode.session", 0.0, 1.0],
            ["decode.parse", 2.0, 5.0], ["flat.build", 3.0, 4.0],
            ["decode.flat", 4.5, 7.0], ["device.wait", 6.0, 6.5],
            ["get_picture", 12.0, 13.0], ["sleep", 13.0, 20.0],
            ["decode.session", 14.0, 15.0]]


def test_unspanned_is_the_uncovered_time_of_the_calls():
    rows = client_rows()
    assert unspanned_ms.uncovered_s(rows, 0.0, 100.0) == \
        pytest.approx(4.0 + 1.0)
    # clipped to the window: decode_nal's first second (covered) and
    # half of get_picture fall out
    assert unspanned_ms.uncovered_s(rows, 1.0, 12.5) == \
        pytest.approx(4.0 + 0.5)
    # a span that overlaps a call's edge covers only its part inside
    assert unspanned_ms.uncovered_s(
        [["flush", 0.0, 2.0], ["decode.post", -1.0, 0.5],
         ["decode.post", 1.5, 3.0]], 0.0, 10.0) == pytest.approx(1.0)
    tr = Trace([], (0.0, 12.5))
    tr.add_host(0, rows)
    tr.add_host(1, [["decode_nal", 2.0, 3.0]])
    r = harness.Run(pictures=3, trace=tr)
    assert unspanned_ms.read(r) == pytest.approx((4.0 + 0.5 + 1.0) * 1e3 / 3)


def test_unspanned_ignores_sleep_and_needs_calls():
    tr = Trace([], (0.0, 10.0))
    tr.add_host(0, [["sleep", 0.0, 9.0], ["decode.session", 1.0, 2.0]])
    assert unspanned_ms.read(harness.Run(pictures=2, trace=tr)) is None
    tr.add_host(0, [["decode_nal", 9.0, 9.5]])
    assert unspanned_ms.read(harness.Run(pictures=2, trace=tr)) == \
        pytest.approx(250.0)
    assert unspanned_ms.read(harness.Run(pictures=2)) is None
    assert unspanned_ms.read(harness.Run(pictures=0, trace=tr)) is None


def test_span_and_counter_readers():
    spans = {"decode.session": {"seconds": 0.3, "calls": 40},
             "session.output_wait": {"seconds": 0.9, "calls": 10},
             "device.wait": {"seconds": 0.02, "calls": 10},
             "xfer.dtoh.bytes": {"seconds": 0.0, "calls": 62208000}}
    r = harness.Run(pictures=10, spans=spans)
    assert session_ms.read(r) == pytest.approx(30.0)
    assert output_wait_ms.read(r) == pytest.approx(90.0)
    assert device_wait_ms.read(r) == pytest.approx(2.0)
    assert dtoh_mb.read(r) == pytest.approx(6.2208)
    # a program without the rows (the parent of these spans) reads None
    bare = harness.Run(pictures=10,
                       spans={"decode.parse": {"seconds": 1.0, "calls": 10}})
    for reader in (session_ms, output_wait_ms, device_wait_ms, dtoh_mb):
        assert reader.read(bare) is None
        assert reader.read(harness.Run(pictures=0, spans=spans)) is None


def test_new_metrics_are_listed_for_their_cells():
    bench = spec.load_benchmark()
    names = {m["name"]: m for m in bench["per_layer"]
             if m["name"].split(".")[0] in NEW}
    assert len(names) == 9
    for name, m in names.items():
        cell = {"farm": "fhd1080_ra.farm4",
                "live": "hd720_ld.live4"}[name.split(".")[1]]
        assert m["workloads"] == [cell]
        assert m["source"] == "program_span"
        assert callable(spec.reader(name))


@pytest.mark.parametrize("loop", ["closed", "open"])
def test_traced_cpu_run_reports_the_new_metrics(loop):
    """A traced run of the port on the CPU (no card: no device waits)
    reports the session, the copies and the unspanned time, and the
    output queue in the open loop."""
    bench = spec.load_benchmark()
    suffix = ".farm" if loop == "closed" else ".live"
    per_layer = [m for m in bench["per_layer"]
                 if m["name"].split(".")[0] in NEW and
                 m["name"].endswith(suffix)]
    e2e = [m for m in bench["end_to_end"] if m["name"] == "setup_s"]
    out = run.execute({"name": "tiny." + loop, "chips": 1}, tiny_config(),
                      tiny_traffic(loop), e2e, per_layer, 2 ** 31 + 77, 1.5,
                      True, device="cpu")
    assert out["correct"]
    got = out["metrics"]
    assert got["session_ms" + suffix]["value"] > 0
    assert got["unspanned_ms" + suffix]["value"] >= 0
    # the counters run from the first call that ends in the window to the
    # first that ends after it, so a window of a few pictures reads loose
    assert got["dtoh_mb" + suffix]["value"] > 0
    assert "device_wait_ms" + suffix not in got
    if loop == "open":
        assert got["output_wait_ms.live"]["value"] > 0


def test_self_time_goes_to_the_innermost_open_row():
    rows = client_rows()
    got = selftime.self_seconds(rows, 0.0, 21.0)
    # decode.flat opened inside decode.parse: their overlap is flat's
    assert got == pytest.approx({
        "decode.session": 1.0 + 1.0, "decode_nal": 1.0 + 3.0,
        "decode.parse": 1.0 + 0.5, "flat.build": 1.0, "decode.flat": 2.0,
        "device.wait": 0.5, "get_picture": 1.0, "sleep": 6.0,
        "client": 2.0 + 1.0})
    assert sum(got.values()) == pytest.approx(21.0)


@pytest.mark.parametrize("loop", ["closed", "open"])
def test_selftime_of_a_traced_cpu_window(loop, tmp_path):
    """The self times add up to the clients' time in the window, and
    the counters meet the trace (no copy events on the CPU)."""
    bench = spec.load_benchmark()
    win = harness.run_cell({"name": "tiny." + loop, "chips": 1},
                           tiny_config(), tiny_traffic(loop), 2 ** 31 + 5,
                           1.5, 0.0, device="cpu", trace=True,
                           trace_dir=str(tmp_path))
    suffix = ".farm" if loop == "closed" else ".live"
    out = selftime.read_window(win, tiny_config(), [
        m for m in bench["per_layer"] if m["name"].endswith(suffix)])
    assert out["correct"] and out["pictures"] > 0
    clients = tiny_traffic(loop)["clients"]
    assert sum(out["self_ms"].values()) * out["pictures"] == \
        pytest.approx(1.5e3 * clients)
    assert out["self_ms"]["decode.parse"] > 0
    assert out["copies"]["xfer.dtoh"]["counted"] > 0
    assert out["copies"]["xfer.dtoh"]["trace"] == 0
    if loop == "open":
        lat = out["latency_ms"]
        assert lat["output_wait"] > 0
        assert lat["gen_lag"] + lat["decode_chain"] + lat["output_wait"] == \
            pytest.approx(lat["mean"])
