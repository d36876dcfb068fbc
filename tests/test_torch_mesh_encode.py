"""A lookahead encode with a mesh of slots installed, on the CPU device.

tests/test_sharding.py ``test_sharded_lookahead_encode_byte_identical``
for the port: a 64x64, 2-picture all-intra encode with
``tpu_intra_lookahead 1`` (the Python CU encoder), whose lookahead is
sharded over a mesh of eight ``"cpu"`` slots, gives the bytes of the
unmeshed encode and of the JAX package's encode on its eight virtual
CPU devices (tests/conftest.py).
"""
import jax
import numpy as np

from xvc_tpu import api as japi
from xvc_tpu import engine as jengine
from xvc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from xvc_tpu_torch import api, engine
from xvc_tpu_torch.parallel import mesh as mesh_mod


def _lookahead_encode(module):
    rng = np.random.RandomState(4)
    w, h, frames = 64, 64, 2
    yy, xx = np.mgrid[0:h, 0:w]
    raws = []
    for t in range(frames):
        y = np.clip(100 + 50 * np.sin((xx + 3 * t) / 7.0) +
                    rng.randint(-8, 9, (h, w)), 0, 255).astype(np.uint8)
        u = np.full((h // 2, w // 2), 120, np.uint8)
        v = np.full((h // 2, w // 2), 136, np.uint8)
        raws.append(y.tobytes() + u.tobytes() + v.tobytes())
    raw = b"".join(raws)
    p = module.EncoderParameters(
        width=w, height=h, qp=32, checksum_mode=1, num_ref_pics=0,
        sub_gop_length=1, explicit_encoder_settings="tpu_intra_lookahead 1")
    enc = japi.EncoderSession(p) if module is japi else \
        api.EncoderSession(p, device="cpu")
    fs = w * h * 3 // 2
    nals = []
    for i in range(frames):
        nals += enc.encode(raw[i * fs:(i + 1) * fs])
    nals += enc.flush()
    return b"".join(len(n).to_bytes(4, "little") + n for n in nals)


def test_sharded_lookahead_encode_equals_unmeshed_and_the_jax_package():
    unmeshed = _lookahead_encode(api)
    engine.set_mesh(mesh_mod.make_mesh(["cpu"] * 8))
    try:
        meshed = _lookahead_encode(api)
    finally:
        engine.set_mesh(None)
    jengine.set_mesh(jax_make_mesh(jax.devices()[:8]))
    try:
        jax_meshed = _lookahead_encode(japi)
    finally:
        jengine.set_mesh(None)
    assert meshed == unmeshed == jax_meshed
