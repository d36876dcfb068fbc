"""ra64x48_me, the random-access clip of chip_smoke.py phase 9 (pictures
0-4 of tests/data/ra64x48_in.yuv, sub-GOP 4, two references,
XVC_ME=jax), encoded by the port's Python CU encoder on the CPU device:
the JAX package's sha256 in tests/data/bench/python_cu_inter.json, with
its prefetches, device sweeps and their candidates equal to the JAX
package's counts there.  A file of its own: the encode is the longest
test of the device motion search.
"""
import hashlib
import json

from xvc_tpu_torch import api
from xvc_tpu_torch.gpu import me
from xvc_tpu_torch.nal import write_nal_units

from . import encode_clips as clips
from .util import data_path


def test_ra64x48_me_equals_its_reference(monkeypatch):
    """The port's encode of ra64x48_me under XVC_ME=jax gives the JAX
    package's stream, with the same prefetches, device sweeps and
    candidates (routing copied from the reference)."""
    name = "ra64x48_me"
    clip = clips.PYTHON_CU_INTER[name]
    with open(data_path("bench/python_cu_inter.json")) as f:
        ref = json.load(f)[name]
    for var in ("XVC_ENC_NATIVE", "XVC_INTRA_PREPASS"):
        monkeypatch.delenv(var, raising=False)
    for var, val in clip["env"].items():
        monkeypatch.setenv(var, val)
    yuv = clips.python_cu_inter_input(name, data_path(""))
    ses = api.EncoderSession(clips.python_cu_inter_params(api, name),
                             device="cpu")
    fs = clip["width"] * clip["height"] * 3 // 2
    me.reset_stats()
    nals = []
    for i in range(clip["pictures"]):
        nals += ses.encode(yuv[i * fs:(i + 1) * fs])
    nals += ses.flush()
    data = write_nal_units(nals)
    assert hashlib.sha256(data).hexdigest() == ref["sha256"]
    assert me.STATS["device_calls"] > 0
    for key, val in ref["me"].items():
        assert me.STATS[key] == val, key
