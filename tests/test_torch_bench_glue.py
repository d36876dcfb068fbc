"""The port's bench and trace glue on the CPU device.

- ``gpu/device_bench.py``: ``mc_device_bench`` and ``itx_device_bench``
  (``xvc_tpu/tpu/device_bench.py:41/:92``) at a small batch time the
  plain versions with the host clock and return their fields; the
  shares of the card's rates are None there, since a host time says
  nothing of the card.  The timed calls write what the group kernels'
  plain versions write.
- ``profiling.start_trace`` / ``stop_trace`` (``xvc_tpu/profiling.py:
  80-100``, on ``torch.profiler``) write a Chrome trace that holds the
  spans run meanwhile; a second start raises; ``XVC_TRACE_DIR`` starts
  a trace when the module is imported.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from xvc_tpu_torch import profiling
from xvc_tpu_torch.gpu import device_bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = {"device", "timing", "iters", "batch", "device_us_per_call",
          "mpix_s", "gmac_s", "bytes", "share_of_hbm_3.35TB_s",
          "share_of_int32_67TOP_s"}


@pytest.mark.parametrize("bench", ["mc_device_bench", "itx_device_bench"])
def test_device_bench_on_the_cpu_returns_its_fields(bench):
    res = getattr(device_bench, bench)(batch=64, iters=2, device="cpu")
    assert set(res) == FIELDS
    assert res["device"] == "cpu" and "host clock" in res["timing"]
    assert res["iters"] == 2 and res["batch"] == 64
    assert res["device_us_per_call"] > 0
    assert res["mpix_s"] > 0 and res["gmac_s"] > 0 and res["bytes"] > 0
    assert res["share_of_hbm_3.35TB_s"] is None
    assert res["share_of_int32_67TOP_s"] is None


def test_the_benched_calls_are_the_group_kernels(monkeypatch):
    """Each timed call is one ``mc_scatter`` / ``itx_scatter`` of the
    whole batch: 16x16 blocks on a 64-wide grid, MC from six 512x768
    planes with both fractions set, ITX as DCT-2."""
    from xvc_tpu_torch.gpu import itx, mc
    calls = []
    monkeypatch.setattr(mc, "mc_scatter",
                        lambda *a: calls.append(("mc", a)))
    monkeypatch.setattr(itx, "itx_scatter",
                        lambda *a: calls.append(("itx", a)))
    device_bench.mc_device_bench(batch=128, iters=3, device="cpu")
    device_bench.itx_device_bench(batch=128, iters=3, device="cpu")
    assert [c[0] for c in calls] == ["mc"] * 4 + ["itx"] * 4
    pred, mask, planes, params = calls[0][1][:4]
    assert tuple(planes.shape) == (6, 512, 768)
    assert tuple(pred.shape) == (2, 32, 1024) and params.shape[1] == 128
    assert bool((params[3] > 0).all()) and bool((params[4] > 0).all())
    assert calls[0][1][4:] == (16, 16, True, 8, True, False)
    resi, coeff = calls[4][1][:2]
    assert tuple(coeff.shape) == (128, 16, 16)
    assert tuple(resi.shape) == (1, 32, 1024)


def test_trace_holds_the_spans(tmp_path):
    profiling.start_trace(str(tmp_path))
    try:
        with pytest.raises(RuntimeError, match="already running"):
            profiling.start_trace(str(tmp_path))
        with profiling.span("glue.span"):
            torch.ones(64, dtype=torch.int32).cumsum(0)
    finally:
        path = profiling.stop_trace()
    assert profiling.stop_trace() is None
    assert os.path.dirname(path) == str(tmp_path)
    with open(path) as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert "glue.span" in names
    assert any(str(n).startswith("aten::cumsum") for n in names)


def test_trace_dir_starts_a_trace_at_import(tmp_path):
    code = ("from xvc_tpu_torch import profiling\n"
            "with profiling.span('glue.import'):\n"
            "    pass\n"
            "print(profiling.stop_trace())\n")
    env = dict(os.environ, XVC_TRACE_DIR=str(tmp_path),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    path = out.stdout.strip().splitlines()[-1]
    assert os.path.dirname(path) == str(tmp_path)
    with open(path) as f:
        assert "glue.import" in {ev.get("name")
                                 for ev in json.load(f)["traceEvents"]}
