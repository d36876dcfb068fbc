"""Dequant + inverse transform of the PyTorch port (xvc_tpu_torch) against
the JAX package on the CPU backend: bit-exact (tolerance 0, the stages
are integer), same numpy-seeded inputs.

- ``gpu/dsp._itx_core`` vs ``tpu/dsp.make_dequant_itx_direct`` for the
  gen / dst4 / dc / skip variants;
- the ITX scatter (``gpu/itx.py``, plain version on the CPU) vs
  ``tpu/flat_recon.make_itx_scatter_gen`` / ``make_itx_scatter``,
  including _BIG padding lanes and blocks partly outside the plane.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xvc_tpu import constants as k
from xvc_tpu.tpu import dsp as jdsp
from xvc_tpu.tpu import flat_recon as jfr
from xvc_tpu_torch import profiling
from xvc_tpu_torch.gpu import dsp, itx

_BIG = 1 << 20
DCT2, DCT5, DCT8, DST1, DST7 = (int(k.TransformType.DCT2),
                                int(k.TransformType.DCT5),
                                int(k.TransformType.DCT8),
                                int(k.TransformType.DST1),
                                int(k.TransformType.DST7))


def _coeffs(rng, B, w, h):
    coeff = rng.randint(-32768, 32768, (B, h, w)).astype(np.int16)
    coeff[rng.rand(B, h, w) < 0.6] = 0
    # scales up to 2^22: large enough that the dequant product wraps
    scale = rng.randint(1, 1 << 22, B).astype(np.int32)
    return coeff, scale


@pytest.mark.parametrize("w,h,bd,variant,txv,txh", [
    (4, 4, 8, "gen", DCT2, DCT2),
    (8, 16, 8, "gen", DST7, DCT8),
    (32, 32, 10, "gen", DCT5, DST1),
    (64, 64, 8, "gen", DCT2, DCT2),
    (64, 16, 10, "gen", DST7, DCT2),
    (2, 2, 8, "gen", DCT2, DCT2),
    (4, 4, 8, "dst4", 0, 0),
    (4, 4, 10, "dst4", 0, 0),
    (8, 8, 8, "dc", 0, 0),
    (32, 16, 10, "dc", 0, 0),
    (4, 4, 8, "skip", 0, 0),
    (16, 8, 10, "skip", 0, 0),
    (32, 32, 8, "skip", 0, 0),
])
def test_itx_core_matches_jax(w, h, bd, variant, txv, txh):
    rng = np.random.RandomState(w * 100 + h + bd)
    coeff, scale = _coeffs(rng, 12, w, h)
    for hp in (True, False):
        want = np.asarray(jdsp.make_dequant_itx_direct(
            w, h, bd, txv, txh, variant, hp)(jnp.asarray(coeff),
                                             jnp.asarray(scale)))
        got = dsp._itx_core(torch.from_numpy(coeff),
                            torch.from_numpy(scale), w, h, bd, txv, txh,
                            variant, hp).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_fam_stacks_match_jax():
    for size in (2, 4, 8, 16, 32, 64):
        for hp in (True, False):
            M, S = itx._fam_stacks(size, hp)
            JM, JS = jfr._fam_stacks(size, 8, hp, 8)
            np.testing.assert_array_equal(M, JM)
            np.testing.assert_array_equal(S, JS)


def _scatter_inputs(rng, w, h, B, nplanes, H, W, gen):
    """Disjoint block positions (some partly outside the plane) and
    _BIG padding lanes in the last quarter of the batch."""
    coeff, scale = _coeffs(rng, B, w, h)
    nx = max(1, (W + w - 1) // w)
    ty, tx = np.divmod(rng.permutation(B), nx)
    rows = [rng.randint(0, nplanes, B), ty * h, tx * w]
    if gen:
        rows += [rng.randint(0, 5, B), rng.randint(0, 5, B)]
    params = np.stack(rows).astype(np.int32)
    params[:3, B - B // 4:] = _BIG
    if gen:
        params[3:, B - B // 4:] = 0
    return coeff, scale, params


def _jax_scatter(fn, resi, coeff, scale, params):
    flat16 = jnp.asarray(coeff.reshape(-1))
    flat32 = jnp.asarray(np.concatenate([scale, params.reshape(-1)]))
    return np.asarray(fn(jnp.asarray(resi), flat16, 0, flat32, 0,
                         len(scale)))


@pytest.mark.parametrize("w,h,bd", [(4, 4, 8), (8, 8, 10), (16, 4, 8),
                                    (32, 32, 8), (64, 64, 10), (8, 32, 8)])
def test_itx_scatter_gen_matches_jax(w, h, bd):
    rng = np.random.RandomState(7 + w + h)
    B, nplanes, H, W = 16, 2, 72, 88
    coeff, scale, params = _scatter_inputs(rng, w, h, B, nplanes, H, W,
                                           True)
    resi = rng.randint(-50, 50, (nplanes, H, W)).astype(np.int32)
    want = _jax_scatter(jfr.make_itx_scatter_gen(w, h, bd, True, B,
                                                 nplanes, H, W),
                        resi, coeff, scale, params)
    got = torch.from_numpy(resi.copy())
    itx.itx_scatter_gen(got, torch.from_numpy(coeff),
                        torch.from_numpy(scale), torch.from_numpy(params),
                        w, h, bd, True)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("w,h,bd,variant,txv,txh", [
    (4, 4, 8, "dst4", 0, 0), (4, 4, 10, "skip", 0, 0),
    (16, 16, 8, "skip", 0, 0), (8, 8, 8, "dc", 0, 0),
    (16, 8, 10, "gen", DST7, DCT5)])
def test_itx_scatter_variants_match_jax(w, h, bd, variant, txv, txh):
    rng = np.random.RandomState(11 + w * h)
    B, nplanes, H, W = 8, 1, 40, 56
    coeff, scale, params = _scatter_inputs(rng, w, h, B, nplanes, H, W,
                                           False)
    resi = np.zeros((nplanes, H, W), np.int32)
    want = _jax_scatter(jfr.make_itx_scatter(w, h, bd, txv, txh, variant,
                                             True, B, nplanes, H, W),
                        resi, coeff, scale, params)
    got = torch.from_numpy(resi.copy())
    itx.itx_scatter(got, torch.from_numpy(coeff), torch.from_numpy(scale),
                    torch.from_numpy(params), w, h, bd, txv, txh, variant,
                    True)
    np.testing.assert_array_equal(got.numpy(), want)


def test_devbatch_slices_are_exact():
    """DevBatch hands out exactly the arrays added (a torch slice would
    truncate where lax.dynamic_slice clamps, so an overrun raises)."""
    rng = np.random.RandomState(3)
    arrs = [rng.randint(-9, 9, s).astype(dt) for s, dt in (
        ((3, 4), np.int16), ((5,), np.int32), ((2, 2, 2), np.int16),
        ((7, 3), np.int32), ((1,), np.int64))]
    batch = dsp.DevBatch()
    handles = [batch.add(a) for a in arrs]
    before = profiling.counted("xfer.htod")
    batch.upload(torch.device("cpu"))
    assert profiling.counted("xfer.htod") - before == 2  # one copy per dtype
    for a, hd in zip(arrs, handles):
        got = batch.get(hd)
        assert tuple(got.shape) == a.shape
        np.testing.assert_array_equal(got.numpy(), a)
    key, off, shape, size = handles[0]
    with pytest.raises(IndexError):
        batch.get((key, off + 1000, shape, size))
    flat, offs = dsp.gather_flat([torch.from_numpy(a) for a in arrs[:1]])
    np.testing.assert_array_equal(flat[:12].reshape(3, 4), arrs[0])
