"""The port's SATD (xvc_tpu_torch.gpu.satd) against the JAX package, on
the CPU: ``satd_square`` against ``xvc_tpu.tpu.satd.satd_square``, and
``satd8`` against the Pallas kernel ``satd8_pallas`` in interpret mode.

Inputs come from a numpy seed; diffs span the full range +-(2^bd - 1);
batches are not multiples of the Pallas tile of 1024.  Tolerance 0: every
result is an integer and must match bit for bit.  (The CUDA kernel is
held against ``satd_plain`` on the card, tests/test_torch_cuda.py.)
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xvc_tpu.tpu import satd as jsatd
from xvc_tpu.tpu.pallas_satd import satd8_pallas
from xvc_tpu_torch.gpu import satd as tsatd


def _diff(seed, shape, bd):
    rng = np.random.RandomState(seed)
    d = rng.randint(-(2 ** bd - 1), 2 ** bd, size=shape).astype(np.int32)
    d.reshape(-1)[:4] = (2 ** bd - 1, -(2 ** bd - 1), 0, 1)  # the extremes
    return d


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("bd", [8, 10])
def test_satd_square_matches_jax(n, bd):
    diff = _diff(100 * n + bd, (13, 5, n, n), bd)
    want = np.asarray(jsatd.satd_square(jnp.asarray(diff), bd))
    got = tsatd.satd_square(torch.from_numpy(diff), bd)
    assert got.dtype == torch.int32 and tuple(got.shape) == (13, 5)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_satd_square_worst_case_magnitude(n):
    """All-extreme diffs (the largest transformed sums, bitdepth 14)."""
    rng = np.random.RandomState(n)
    diff = (rng.randint(0, 2, (9, n, n)) * 2 - 1).astype(np.int32) * 16383
    diff[0] = 16383
    want = np.asarray(jsatd.satd_square(jnp.asarray(diff), 14))
    got = tsatd.satd_square(torch.from_numpy(diff), 14).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bd,batch", [(8, 37), (10, 1030)])
def test_satd8_matches_pallas_interpret(bd, batch):
    diff = _diff(bd + batch, (batch, 8, 8), bd)
    want = np.asarray(satd8_pallas(diff, bd, interpret=True))
    got = tsatd.satd8(torch.from_numpy(diff), bd)
    assert tuple(got.shape) == (batch,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_satd_pred_is_satd_of_the_difference(n):
    rng = np.random.RandomState(n + 1)
    orig = rng.randint(0, 1024, (7, n, n)).astype(np.int32)
    preds = rng.randint(0, 1024, (7, 6, n, n)).astype(np.int32)
    want = np.asarray(jsatd.satd_square(
        jnp.asarray(orig[:, None] - preds), 10))
    got = tsatd.satd_pred(torch.from_numpy(orig), torch.from_numpy(preds),
                          10).numpy()
    np.testing.assert_array_equal(got, want)


def test_satd_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        tsatd.satd_square(torch.zeros((2, 8, 8), dtype=torch.int64), 8)
    with pytest.raises(ValueError):
        tsatd.satd_square(torch.zeros((2, 12, 12), dtype=torch.int32), 8)
    with pytest.raises(ValueError):
        tsatd.satd8(torch.zeros((2, 16, 16), dtype=torch.int32), 8)
    with pytest.raises(ValueError):
        tsatd.satd_pred(torch.zeros((2, 8, 8), dtype=torch.int32),
                        torch.zeros((3, 4, 8, 8), dtype=torch.int32), 8)
