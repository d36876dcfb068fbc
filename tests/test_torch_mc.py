"""Motion compensation of the PyTorch port (xvc_tpu_torch) against the JAX
package on the CPU backend: bit-exact (tolerance 0), same numpy-seeded
inputs.

- the plain MC core (``gpu/dsp._mc_core_builder``) vs
  ``tpu/dsp._mc_core_builder``, luma and chroma, every bucket, clipped
  and short outputs, windows clamped at every edge;
- the same core vs the Pallas kernel ``tpu/pallas_mc.make_mc_pallas`` in
  interpret mode (the cases of tests/test_pallas.py plus chroma buckets);
- the MC scatter (``gpu/mc.py``, plain on the CPU) vs
  ``tpu/flat_recon.make_mc_scatter``, with _BIG lanes and blocks partly
  outside the plane.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xvc_tpu.tpu import dsp as jdsp
from xvc_tpu.tpu import flat_recon as jfr
from xvc_tpu_torch.gpu import dsp, mc

_BIG = 1 << 20


def _core_inputs(rng, luma, wb, hb, bd, B, S, Hp, Wp, margin):
    taps = 8 if luma else 4
    nph = 16 if luma else 32
    wh, ww = hb + taps - 1, wb + taps - 1
    planes = rng.randint(0, 1 << bd, (S, Hp, Wp)).astype(np.int16)
    ref = rng.randint(-1 if margin else 0, S + (1 if margin else 0), B)
    y0 = rng.randint(-margin, Hp - wh + 1 + margin, B)
    x0 = rng.randint(-margin, Wp - ww + 1 + margin, B)
    fx = rng.randint(0, nph, B) * (rng.rand(B) > 0.3)
    fy = rng.randint(0, nph, B) * (rng.rand(B) > 0.3)
    return planes, np.stack([ref, y0, x0, fx, fy]).astype(np.int32)


def _run_core(planes, p, wb, hb, luma, bd, hp, short):
    jfn = jax.jit(jdsp._mc_core_builder(wb, hb, luma, bd, hp, short))
    want = np.asarray(jfn(jnp.asarray(planes), *[jnp.asarray(r) for r in p]))
    tfn = dsp._mc_core_builder(wb, hb, luma, bd, hp, short)
    got = tfn(torch.from_numpy(planes),
              *[torch.from_numpy(np.ascontiguousarray(r)) for r in p])
    return got.numpy(), want


@pytest.mark.parametrize("luma,wb,hb", [
    (True, 8, 8), (True, 16, 32), (True, 64, 64), (True, 32, 8),
    (False, 8, 8), (False, 16, 16), (False, 32, 64), (False, 64, 8)])
@pytest.mark.parametrize("short", [False, True])
def test_mc_core_matches_jax(luma, wb, hb, short):
    rng = np.random.RandomState(wb * 7 + hb + short)
    for bd, hp in ((8, True), (10, True), (8, False)):
        planes, p = _core_inputs(rng, luma, wb, hb, bd, 12, 3, 96, 160,
                                 margin=10)
        got, want = _run_core(planes, p, wb, hb, luma, bd, hp, short)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("luma,block,bd,short", [
    (True, 8, 8, False), (True, 8, 8, True), (True, 16, 10, False),
    (False, 8, 8, False), (False, 4, 10, True), (False, 16, 8, True),
    (False, 32, 10, False)])
def test_mc_core_matches_pallas_interpret(luma, block, bd, short):
    from xvc_tpu.tpu.pallas_mc import make_mc_pallas
    rng = np.random.RandomState(11 + block + bd)
    S, Hp, Wp, batch = 3, 64, 384, 16
    taps = 8 if luma else 4
    planes = rng.randint(0, 1 << bd, (S, Hp, Wp)).astype(np.int16)
    p = np.stack([rng.randint(0, S, batch),
                  rng.randint(0, Hp - block - taps, batch),
                  rng.randint(0, Wp - block - taps, batch),
                  rng.randint(0, 16, batch),
                  rng.randint(0, 16, batch)]).astype(np.int32)
    # windows at the bottom-right corner of the plane
    p[1, :2] = Hp - block - taps + 1
    p[2, :2] = Wp - block - taps + 1
    kfn = make_mc_pallas(block, block, luma, bd, True, short, batch,
                         group=8, interpret=True)
    want = np.asarray(kfn(jnp.asarray(planes), jnp.asarray(p)))
    got = dsp._mc_core_builder(block, block, luma, bd, True, short)(
        torch.from_numpy(planes),
        *[torch.from_numpy(np.ascontiguousarray(r)) for r in p]).numpy()
    np.testing.assert_array_equal(got, want)


def _scatter_inputs(rng, luma, wb, hb, bd, B, S, Hp, Wp, H, W):
    nplanes = 1 if luma else 2
    planes, p5 = _core_inputs(rng, luma, wb, hb, bd, B, S, Hp, Wp,
                              margin=6)
    nx = (W + wb - 1) // wb
    ty, tx = np.divmod(rng.permutation(B), nx)
    w = rng.randint(max(2, wb // 2), wb + 1, B)
    h = rng.randint(max(2, hb // 2), hb + 1, B)
    chan = rng.randint(0, 2 * nplanes, B)
    params = np.concatenate([p5, np.stack([chan, ty * hb, tx * wb, w,
                                           h])]).astype(np.int32)
    params[:, B - B // 4:] = _BIG
    return planes, params


@pytest.mark.parametrize("luma,wb,hb,short", [
    (True, 8, 8, False), (True, 16, 8, True), (True, 32, 32, True),
    (False, 8, 8, True), (False, 16, 32, False), (False, 8, 16, True)])
def test_mc_scatter_matches_jax(luma, wb, hb, short):
    rng = np.random.RandomState(3 + wb + hb + luma)
    nplanes = 1 if luma else 2
    B, S, Hp, Wp, H, W = 16, 3, 96, 160, 40, 56
    bd = 8 if luma else 10
    planes, params = _scatter_inputs(rng, luma, wb, hb, bd, B, S, Hp, Wp,
                                     H, W)
    pred = rng.randint(0, 255, (2 * nplanes, H, W)).astype(np.int16)
    mask = np.zeros((nplanes, H, W), np.int16)
    fn = jfr.make_mc_scatter(wb, hb, luma, bd, True, short, B, H, W,
                             nplanes)
    jpred, jmask = fn(jnp.asarray(pred), jnp.asarray(mask),
                      jnp.asarray(planes),
                      jnp.asarray(params.reshape(-1)), 0)
    tpred = torch.from_numpy(pred.copy())
    tmask = torch.from_numpy(mask.copy())
    mc.mc_scatter(tpred, tmask, torch.from_numpy(planes),
                  torch.from_numpy(params), wb, hb, luma, bd, True, short)
    np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))
    # the port stores 1 where JAX adds 1; combine reads only mask > 0
    np.testing.assert_array_equal(tmask.numpy() > 0, np.asarray(jmask) > 0)
    if short:
        assert (tmask.numpy() > 0).any()


@pytest.mark.parametrize("nplanes,bd", [(1, 8), (2, 10)])
def test_combine_matches_jax(nplanes, bd):
    """Uni/bi select + AddAvg + residual + clip into the scan canvas."""
    from xvc_tpu_torch.gpu import flat_recon
    rng = np.random.RandomState(nplanes + bd)
    H, W, ph, pw = 24, 40, 256, 256
    pred = rng.randint(-9000, 9000, (2 * nplanes, H, W)).astype(np.int16)
    pred[:nplanes, :, : W // 2] = rng.randint(0, 1 << bd,
                                              (nplanes, H, W // 2))
    mask = (rng.rand(nplanes, H, W) < 0.5).astype(np.int16)
    resi = rng.randint(-300, 300, (nplanes, H, W)).astype(np.int32)
    want = jfr.make_combine(nplanes, H, W, ph, pw, bd)(
        jnp.asarray(pred), jnp.asarray(mask), jnp.asarray(resi))
    got = flat_recon.combine(torch.from_numpy(pred),
                             torch.from_numpy(mask),
                             torch.from_numpy(resi), H, W, ph, pw, bd)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_device_pad_planes_matches_jax():
    """Edge-replicated frame-store planes: same values, same geometry."""
    from xvc_tpu import constants as k
    from xvc_tpu.codec.yuv import YuvPicture
    from xvc_tpu_torch.gpu import flat_recon
    rng = np.random.RandomState(2)
    rec = YuvPicture(k.ChromaFormat.YUV420, 72, 40, 8, True)
    planes = {c: rng.randint(0, 255, (rec.height[c], rec.width[c]))
              .astype(np.int16) for c in range(3)}
    want = jfr.device_pad_planes(
        rec, {c: jnp.asarray(p) for c, p in planes.items()})
    got = flat_recon.device_pad_planes(
        rec, {c: torch.from_numpy(p) for c, p in planes.items()})
    for c in range(3):
        np.testing.assert_array_equal(got[c].numpy(), np.asarray(want[c]))
