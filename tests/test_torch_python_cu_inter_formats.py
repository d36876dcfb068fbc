"""The Python CU encoder's inter half above 8 bit and outside 4:2:0, on
the CPU device under ``XVC_ME=jax``: the port's encode of a clip of
tests/encode_clips.py ``PYTHON_CU_INTER_MORE`` equals the JAX package's
stream and reconstructions, recorded in
tests/data/bench/python_cu_inter_more.json by ``make_python_cu_inter_refs``
(so that only the port's encode runs here), with the motion search's
prefetches, device sweeps and candidates equal to the JAX package's
counts.  ``ra64x48b10_me``: 10-bit 4:2:0 random access, 2 pictures.  The
8-bit 4:2:2 clip has a file of its own
(tests/test_torch_python_cu_inter_c422.py), so that the two encodes
spread over Tier-1's processes.
"""
import hashlib
import json

from xvc_tpu_torch import api
from xvc_tpu_torch.gpu import me
from xvc_tpu_torch.nal import write_nal_units

from . import encode_clips as clips
from .util import data_path


def encode_inter_clip(name, threads, monkeypatch):
    """Encode the PYTHON_CU_INTER_MORE clip ``name`` through the port's
    EncoderSession with ``threads`` picture threads and hold it to its
    reference; returns the session."""
    clip = clips.PYTHON_CU_INTER_MORE[name]
    with open(data_path("bench/python_cu_inter_more.json")) as f:
        refs = json.load(f)
    assert refs["clips"][name] == clip
    ref = refs[name]
    for var in ("XVC_ENC_NATIVE", "XVC_INTRA_PREPASS"):
        monkeypatch.delenv(var, raising=False)
    for var, val in clip["env"].items():
        monkeypatch.setenv(var, val)
    yuv = clips.python_cu_inter_input(name, data_path(""))
    fs = clips.frame_bytes(clip)
    assert len(yuv) == clip["pictures"] * fs
    ses = api.EncoderSession(
        clips.python_cu_inter_params(api, name, threads), device="cpu")
    me.reset_stats()
    nals = []
    for i in range(clip["pictures"]):
        nals += ses.encode(yuv[i * fs:(i + 1) * fs])
    nals += ses.flush()
    data = write_nal_units(nals)
    assert hashlib.sha256(data).hexdigest() == ref["sha256"]
    assert [hashlib.sha256(n).hexdigest() for n in nals] == \
        ref["nal_sha256"]
    assert hashlib.sha256(b"".join(ses.rec_pictures)).hexdigest() == \
        ref["rec_sha256"]
    assert me.STATS["device_calls"] > 0
    for key, val in ref["me"].items():
        assert me.STATS[key] == val, key
    return ses


def test_ra64x48b10_me_equals_the_jax_package(monkeypatch):
    encode_inter_clip("ra64x48b10_me", 0, monkeypatch)
