"""The port's batched intra prediction and SATD step
(xvc_tpu_torch.gpu.intra_batch, gpu.analysis) against the JAX package on
the CPU, the twins of tests/test_tpu_intra.py.

Blocks and reference lines come from a numpy-seeded frame through the
JAX package's ``extract_blocks``; both sides compute from the same state
(the JAX weight tensor handed over by ``state.from_reference``).
Tolerance 0: integer results, bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xvc_tpu.restrictions import Restrictions as JaxRestrictions
from xvc_tpu.tpu import analysis as jan
from xvc_tpu.tpu import intra_batch as jib
from xvc_tpu_torch.gpu import analysis as tan
from xvc_tpu_torch.gpu import intra_batch as tib
from xvc_tpu_torch.restrictions import Restrictions
from xvc_tpu_torch.state import from_reference

SIZES = [4, 8, 16, 32]


def _blocks(n, bd, seed):
    rng = np.random.RandomState(seed)
    frame = rng.randint(0, 1 << bd, size=(4 * n, 5 * n)).astype(np.int32)
    return frame, jan.extract_blocks(frame, n, bd, JaxRestrictions())


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("n", SIZES)
def test_angular_weight_tensor_matches_jax(n):
    np.testing.assert_array_equal(tib.angular_weight_tensor(n),
                                  jib.angular_weight_tensor(n))


@pytest.mark.parametrize("n", SIZES)
def test_extract_blocks_matches_jax(n):
    frame, want = _blocks(n, 10, n)
    got = tan.extract_blocks(frame, n, 10, Restrictions())
    for a, b in zip(got, want):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", SIZES)
def test_filter_refs_matches_jax(n):
    _, (_, top, left) = _blocks(n, 10, 3 * n)
    want = jib.filter_refs(jnp.asarray(top), jnp.asarray(left))
    got = tib.filter_refs(*_t(top, left))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("post_filter", [True, False])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("n", SIZES)
def test_predict_all_modes_matches_jax(n, bd, post_filter):
    _, (_, top, left) = _blocks(n, bd, 7 * n + bd)
    ref_w = jib.angular_weight_tensor(n)
    want = np.asarray(jib.predict_all_modes(
        n, jnp.asarray(top), jnp.asarray(left), jnp.asarray(ref_w), bd,
        post_filter))
    w = from_reference({"angular/%d" % n: ref_w}, "cpu")["angular/%d" % n]
    got = tib.predict_all_modes(n, *_t(top, left), w, bd, post_filter)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_predict_all_modes_refuses_tf32():
    _, (_, top, left) = _blocks(4, 8, 1)
    w = torch.from_numpy(tib.angular_weight_tensor(4))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError):
            tib.predict_all_modes(4, *_t(top, left), w, 8, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("mode_step", [1, 4])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("n", SIZES)
def test_make_intra_satd_fn_matches_jax(n, bd, mode_step):
    _, (orig, top, left) = _blocks(n, bd, 11 * n + bd)
    want = np.asarray(jan.make_intra_satd_fn(n, bd, mode_step)(
        jnp.asarray(orig), jnp.asarray(top), jnp.asarray(left)))
    got = tan.make_intra_satd_fn(n, bd, mode_step)(*_t(orig, top, left))
    modes = 67 if mode_step == 1 else 2 + -(-65 // mode_step)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == (orig.shape[0], modes) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_analyze_frame_matches_jax():
    frame, _ = _blocks(8, 8, 5)
    want = jan.analyze_frame(frame, 8, 8)
    got = tan.analyze_frame(frame, 8, 8, device="cpu")
    np.testing.assert_array_equal(got["costs"], want["costs"])
    np.testing.assert_array_equal(got["best_mode"], want["best_mode"])
