"""CTU tile rows through the port's encoder on inter pictures, on the CPU
device, against the JAX package's EncoderSession on tests/encode_clips.py
``synthetic_yuv420``: equal NALs, per-NAL statistics, SSE and
reconstructions, for

- a low-delay 64x72 clip in 2 tiles (the second one 8 rows) under XVC_ME=jax and
  XVC_INTRA_PREPASS=jax, with the same motion-search prefetches, device
  sweeps and candidates;
- 2 encoder threads coding a random-access 32x128 clip in 2 tiles.

(The intra tile pictures and qcif_tiles: tests/test_torch_tiles_encode.py.)
"""
from xvc_tpu import api as japi
from xvc_tpu.tpu import me as jme
from xvc_tpu_torch import api
from xvc_tpu_torch.gpu import me
from xvc_tpu_torch.nal import write_nal_units

from . import encode_clips as clips
from .test_torch_python_cu import assert_same, encode
from .test_torch_tiles_encode import _clean_routes, params_of  # noqa: F401


def test_low_delay_tiles_under_the_device_switches(monkeypatch):
    """Both packages' motion searches prefetch the same vectors and send
    the same sweeps and candidates to the device."""
    monkeypatch.setenv("XVC_ME", "jax")
    monkeypatch.setenv("XVC_INTRA_PREPASS", "jax")
    counts = dict(prefetches=0, device_calls=0, device_candidates=0)
    real = jme.DeviceSadTable.prefetch

    def counted(table, qp, mvs):
        counts["prefetches"] += 1
        before = len(table.cache)
        real(table, qp, mvs)
        if len(table.cache) > before:
            counts["device_calls"] += 1
            counts["device_candidates"] += len(table.cache) - before

    monkeypatch.setattr(jme.DeviceSadTable, "prefetch", counted)
    w, h, f = 64, 72, 2
    yuv = clips.synthetic_yuv420(w, h, f, 9)
    params = params_of(w, h, 2, num_ref_pics=1, sub_gop_length=1,
                       low_delay=1)
    # a range whose sweeps fit the device window (qcif_me's)
    params["explicit_encoder_settings"] += \
        " inter_search_range_uni_max 64 inter_search_range_uni_min 64"
    want = encode(japi, yuv, f, **params)
    me.reset_stats()
    got = encode(api, yuv, f, **params)
    assert_same(got, want)
    assert counts["device_calls"] > 0
    assert {key: me.STATS[key] for key in counts} == counts


def test_threaded_tile_encode():
    """Sub-GOP 2: the second sub-GOP's two pictures coded by two
    workers, each in 2 tiles."""
    w, h, f = 32, 128, 3
    yuv = clips.synthetic_yuv420(w, h, f, 4)
    params = params_of(w, h, 2, sub_gop_length=2, num_ref_pics=1)
    want = encode(japi, yuv, f, **params)
    ses = api.EncoderSession(api.EncoderParameters(threads=2, **params),
                             device="cpu")
    assert ses._enc.pipeline is not None
    fs = w * h * 3 // 2
    nals = []
    for i in range(f):
        nals += ses.encode(yuv[i * fs:(i + 1) * fs])
    nals += ses.flush()
    assert write_nal_units(nals) == want[0]
    assert ses.rec_pictures == want[3]
