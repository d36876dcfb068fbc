"""The random-access clip of tests/test_torch_python_cu_inter.py (32x32,
5 pictures, sub-GOP 4, two references: bi-prediction), encoded by the
port's Python CU encoder on the CPU device under XVC_ME=jax and under
XVC_ENC_NATIVE=0, against the JAX package's encode of the same clip: the
stream, the statistics, the reconstruction, every merge and MVP list and
the deblocking attributes (``check_inter_clip``).  A file of its own, so
that the two clips spread over the test processes.
"""
import pytest

from .test_torch_python_cu_inter import check_inter_clip, jax_reference


@pytest.fixture(scope="module")
def jax_refs():
    return jax_reference("ra32x32")


@pytest.mark.parametrize("switch", ["XVC_ME=jax", "XVC_ENC_NATIVE=0"])
@pytest.mark.parametrize("name", ["ra32x32"])
def test_inter_clip_equals_the_jax_package(name, switch, jax_refs,
                                           monkeypatch):
    check_inter_clip(name, switch, jax_refs, monkeypatch)
