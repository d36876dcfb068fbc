"""The mesh-pipelined encode equals the JAX package's, on the CPU.

The encode of tests/test_torch_mesh_pipeline.py (sp48x32's first 5
pictures, 4 picture threads, ``XVC_ME=jax``, a mesh of eight ``"cpu"``
slots) against the JAX package's encode of the same pictures on its
eight virtual CPU devices (tests/conftest.py), pinned the same way
(``xvc_tpu/codec/encoder.py:427-440``): the same bytes.
"""
import jax

from xvc_tpu import api as japi
from xvc_tpu import engine as jengine
from xvc_tpu.parallel.mesh import make_mesh as jax_make_mesh

from .test_torch_mesh_pipeline import (encode_sp48x32, mesh_pipelined,
                                       pipelined)  # noqa: F401


def test_mesh_pipelined_encode_equals_the_jax_package_s(pipelined):
    ported = mesh_pipelined(pipelined)
    jengine.set_mesh(jax_make_mesh(jax.devices()[:8]))
    try:
        assert encode_sp48x32(japi, 4) == ported
    finally:
        jengine.set_mesh(None)
