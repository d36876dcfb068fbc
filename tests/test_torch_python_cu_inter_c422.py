"""The Python CU encoder's inter half in 8-bit 4:2:2, on the CPU device
under ``XVC_ME=jax``: ``c422_ra64x48_me`` (two 64x48 pictures of the
texture of tests/data/c422_ra64x48.xvc, random access) equals the JAX
package's stream, reconstructions and prefetch counts, recorded in
tests/data/bench/python_cu_inter_more.json (see
tests/test_torch_python_cu_inter_formats.py)."""
from .test_torch_python_cu_inter_formats import encode_inter_clip


def test_c422_ra64x48_me_equals_the_jax_package(monkeypatch):
    encode_inter_clip("c422_ra64x48_me", 0, monkeypatch)
