"""The contract of tests/test_device_me.py on the port: its low-delay
golden, tests/data/ld64x48.xvc (64x48, 8 pictures, one reference),
encoded by the port's Python CU encoder with device motion estimation
(XVC_ME=jax) on the CPU device, byte for byte, with device SAD sweeps
(the raster grid) among its prefetches.
"""
from xvc_tpu_torch import api
from xvc_tpu_torch.gpu import me

from .util import read_data, read_meta


def test_low_delay_device_me_equals_the_golden(monkeypatch):
    for var in ("XVC_ENC_NATIVE", "XVC_INTRA_PREPASS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("XVC_ME", "jax")
    meta = read_meta("ld64x48")
    raw = read_data("ld64x48_in.yuv")
    ses = api.EncoderSession(api.EncoderParameters(
        width=meta["width"], height=meta["height"], qp=meta["qp"],
        input_bitdepth=meta["bitdepth"], internal_bitdepth=meta["bitdepth"],
        checksum_mode=1, num_ref_pics=1, sub_gop_length=1, low_delay=1),
        device="cpu")
    fs = meta["width"] * meta["height"] * 3 // 2
    me.reset_stats()
    nals = []
    for i in range(meta["frames"]):
        nals += ses.encode(raw[i * fs:(i + 1) * fs])
    nals += ses.flush()
    out = b"".join(len(n).to_bytes(4, "little") + n for n in nals)
    assert out == read_data("ld64x48.xvc")
    assert me.STATS["device_calls"] > 0
    assert me.STATS["device_candidates"] > me.STATS["device_calls"]
