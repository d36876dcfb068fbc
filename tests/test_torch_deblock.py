"""Deblocking of the PyTorch port (xvc_tpu_torch) against the JAX package
on the CPU backend: bit-exact (tolerance 0), same numpy-seeded inputs.

- the luma pass (``gpu/deblock.luma_pass``, plain on the CPU) vs
  ``tpu/deblock_jax.make_luma_pass``, in both directions (the horizontal
  pass runs on the transposed plane), under each restriction flag, with
  an edge whose strip start is clamped;
- the chroma pass vs ``make_chroma_pass``, both directions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xvc_tpu.ops import deblock as dbk
from xvc_tpu.tpu import deblock_jax as jdb
from xvc_tpu_torch.gpu import deblock


def _blocky(rng, H, W, bd):
    """8x8 steps plus small noise: strong, weak and untouched edges."""
    blocks = rng.randint(0, 1 << bd, (H // 8 + 1, W // 8 + 1))
    plane = np.repeat(np.repeat(blocks, 8, 0), 8, 1)[:H, :W]
    mean = int(blocks.mean())
    # noise amplitude per 8-row band: 0, 1 or 6 (8-bit units)
    amp = np.repeat(rng.choice([0, 1, 6], H // 8 + 1), 8)[:H, None]
    amp = amp << (bd - 8)
    noise = np.round((rng.rand(H, W) * 2 - 1) * amp).astype(np.int64)
    plane = mean + (plane - mean) // 12 + noise
    return np.clip(plane, 0, (1 << bd) - 1).astype(np.int16)


def _luma_edges(rng, H, W, bd):
    G = H // 4
    xs = np.arange(4, W, 4).astype(np.int32)
    xs[-1] = W - 2  # strip start past W - 8: clamped like dynamic_slice
    qp = rng.randint(16, 52, (len(xs), G))
    beta = (np.asarray(dbk.BETA_TABLE)[np.clip(qp, 0, 51)]
            << (bd - 8)).astype(np.int32)
    tc = (np.asarray(dbk.TC_TABLE)[np.clip(qp + 2, 0, 53)]
          << (bd - 8)).astype(np.int32)
    mask = (rng.rand(len(xs), G) < 0.8).astype(np.int32)
    return xs, mask, tc, beta


FLAGS = [(False,) * 5,
         (True, False, False, False, False),
         (False, True, False, False, False),
         (False, False, True, False, False),
         (False, False, False, True, True)]


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("bd", [8, 10])
def test_luma_pass_matches_jax(flags, bd):
    rng = np.random.RandomState(bd + 7 * FLAGS.index(flags))
    for H, W in ((48, 96), (96, 48)):  # vertical, and horizontal (T)
        plane = _blocky(rng, H, W, bd)
        xs, mask, tc, beta = _luma_edges(rng, H, W, bd)
        E = len(xs)
        flat = np.concatenate([xs, mask.reshape(-1), tc.reshape(-1),
                               beta.reshape(-1)])
        eg = mask.size
        want = np.asarray(jdb.make_luma_pass(H, W, 4, bd, flags, E)(
            jnp.asarray(plane), jnp.asarray(flat), 0, E, E + eg,
            E + 2 * eg))
        got = torch.from_numpy(plane.copy())
        deblock.luma_pass(got, *[torch.from_numpy(a) for a in
                                 (xs, mask, tc, beta)], bd, flags)
        assert (want != plane).any()  # the case filters something
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bd", [8, 10])
def test_chroma_pass_matches_jax(bd):
    rng = np.random.RandomState(30 + bd)
    for H, W in ((24, 48), (48, 24)):
        plane = _blocky(rng, H, W, bd)
        edges = np.arange(8, W, 8).astype(np.int32)
        E = len(edges)
        apply = (rng.rand(E, H) < 0.7).astype(np.int32)
        tc = (rng.randint(0, 12, (E, H)) << (bd - 8)).astype(np.int32)
        flat = np.concatenate([edges, apply.reshape(-1), tc.reshape(-1)])
        want = np.asarray(jdb.make_chroma_pass(H, E, bd)(
            jnp.asarray(plane), jnp.asarray(flat), 0, E, E + apply.size))
        got = torch.from_numpy(plane.copy())
        deblock.chroma_pass(got, torch.from_numpy(edges),
                            torch.from_numpy(apply), torch.from_numpy(tc),
                            bd)
        assert (want != plane).any()
        np.testing.assert_array_equal(got.numpy(), want)
