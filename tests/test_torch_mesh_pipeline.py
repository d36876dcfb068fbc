"""The mesh-pipelined encode (GOP across slots) equals the sequential
encode, on the CPU device.

tests/test_sharding.py ``test_gop_pipeline_mesh_encode_byte_identical``
for the port: ``sp48x32_in.yuv`` (48x32, its first 5 pictures, sub-GOP
4, ``tpu_intra_lookahead 1`` under ``XVC_ME=jax``: the Python CU
encoder's lookahead and device motion search) on 4 picture threads with
a mesh of eight ``"cpu"`` slots, each in-flight picture pinned to slot
``doc % 8``, gives the sequential encode's bytes.  Its equality with the
JAX package's meshed encode is tests/test_torch_mesh_pipeline_jax.py.
"""
import pytest

from xvc_tpu_torch import api, engine
from xvc_tpu_torch.codec import picture_encoder
from xvc_tpu_torch.parallel import mesh as mesh_mod
from xvc_tpu_torch.parallel import pipeline

from .util import read_data

W, H, FRAMES = 48, 32, 5
FS = W * H * 3 // 2


def encode_sp48x32(module, threads):
    """The length-prefixed stream of sp48x32's first FRAMES pictures
    through ``module``'s EncoderSession (the port's on the CPU)."""
    raw = read_data("sp48x32_in.yuv")
    p = module.EncoderParameters(
        width=W, height=H, qp=32, sub_gop_length=4, checksum_mode=1,
        threads=threads, explicit_encoder_settings="tpu_intra_lookahead 1")
    enc = api.EncoderSession(p, device="cpu") if module is api else \
        module.EncoderSession(p)
    nals = []
    for i in range(FRAMES):
        nals += enc.encode(raw[i * FS:(i + 1) * FS])
    nals += enc.flush()
    return b"".join(len(n).to_bytes(4, "little") + n for n in nals)


@pytest.fixture
def pipelined(monkeypatch):
    monkeypatch.setenv("XVC_ME", "jax")
    monkeypatch.setenv("XVC_THREADS_NO_CLAMP", "1")
    monkeypatch.setattr(pipeline, "WAIT_SECONDS", 120.0)
    pins = []
    orig = picture_encoder.PictureEncoder.encode

    def pinned(self, *args):
        pins.append(engine.get_pin_device())
        return orig(self, *args)

    monkeypatch.setattr(picture_encoder.PictureEncoder, "encode", pinned)
    yield pins
    engine.set_mesh(None)


def mesh_pipelined(pins):
    """The port's encode on 4 threads with 8 slots; every picture coded
    on a worker ran pinned, and the pictures took several slots."""
    engine.set_mesh(mesh_mod.make_mesh(["cpu"] * 8))
    try:
        out = encode_sp48x32(api, 4)
    finally:
        engine.set_mesh(None)
    assert pins and None not in pins
    assert len({slot.index for slot in pins}) >= 3
    return out


def test_mesh_pipelined_encode_equals_the_sequential_encode(pipelined):
    seq = encode_sp48x32(api, 0)
    assert pipelined == [None] * FRAMES
    pipelined.clear()
    assert mesh_pipelined(pipelined) == seq
