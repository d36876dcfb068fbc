"""Deblocking of the PyTorch port (xvc_tpu_torch) against the JAX package
on the CPU backend: bit-exact (tolerance 0), same numpy-seeded inputs.

- the luma pass (``gpu/deblock.luma_pass``, plain on the CPU) vs
  ``tpu/deblock_jax.make_luma_pass``, in both directions (the horizontal
  pass runs on the transposed plane), under each restriction flag, with
  an edge whose strip start is clamped;
- the chroma pass vs ``make_chroma_pass``, both directions;
- both passes with ``direction=1`` on the plane as it lies vs the JAX
  pass on the transposed plane, for every edge position, a pruned edge
  list, a width with ``W % 8 == 4`` whose last strip start is clamped
  and a height that is no multiple of 4
  (``xvc_tpu_torch/gpu/deblock_cases.py``, which the card tests put
  through the CUDA kernels);
- the stage as a whole: ``deblock_picture`` on the CPU against the planes
  the JAX package's host decoder holds before and after its deblocking
  of the same picture, for every picture of sp_fast, ai64x48 and
  ai64x48b10.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xvc_tpu.codec import decoder as jdecoder
from xvc_tpu.nal import split_nal_units
from xvc_tpu.ops import deblock as dbk
from xvc_tpu.tpu import deblock_jax as jdb
from xvc_tpu_torch.codec import picture_decoder
from xvc_tpu_torch.codec.decoder import decode_stream
from xvc_tpu_torch.gpu import deblock
from xvc_tpu_torch.gpu import deblock_cases as cases

from .util import read_data


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


def _jax_luma(plane, xs, mask, tc, beta, bd, flags):
    H, W = plane.shape
    E = len(xs)
    flat = np.concatenate([xs, mask.reshape(-1), tc.reshape(-1),
                           beta.reshape(-1)])
    eg = mask.size
    return np.asarray(jdb.make_luma_pass(H, W, 4, bd, flags, E)(
        jnp.asarray(plane), jnp.asarray(flat), 0, E, E + eg, E + 2 * eg))


@pytest.mark.parametrize("direction", [0, 1])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("kind", cases.LUMA_KINDS)
def test_luma_pass_edge_lists_match_jax(kind, bd, direction):
    """``luma_pass_plain`` on the plane as it lies against the JAX pass
    (on the transposed plane for direction 1).  The JAX pass takes whole
    groups of four lines only, so for a ragged plane it is given the
    4 * (lines // 4) lines that are filtered, and the rest must stay."""
    changed = 0
    for n, flags in enumerate(FLAGS):
        plane, xs, mask, tc, beta = cases.luma_case(kind, bd, direction, n)
        lines = plane.shape[direction]
        assert (kind != "ragged") or lines % 4
        assert (kind != "clamped") or plane.shape[1 - direction] % 8 == 4
        assert (kind != "pruned") or (np.diff(xs) > 4).any()
        assert (kind != "odd") or (plane.shape[0] % 2 and plane.shape[1] % 2)
        src = plane.T if direction else plane
        whole = lines // 4 * 4
        want = src.copy()
        want[:whole] = _jax_luma(np.ascontiguousarray(src[:whole]), xs, mask,
                                 tc, beta, bd, flags)
        want = want.T if direction else want
        got = torch.from_numpy(plane.copy())
        deblock.luma_pass(got, *[torch.from_numpy(a) for a in
                                 (xs, mask, tc, beta)], bd, flags, direction)
        np.testing.assert_array_equal(got.numpy(), want)
        changed += int((want != plane).sum())
    assert changed


@pytest.mark.parametrize("direction", [0, 1])
@pytest.mark.parametrize("bd", [8, 10])
def test_chroma_pass_direction_matches_jax(bd, direction):
    plane, edges, apply, tc = cases.chroma_case(bd, direction)
    src = np.ascontiguousarray(plane.T if direction else plane)
    E = len(edges)
    flat = np.concatenate([edges, apply.reshape(-1), tc.reshape(-1)])
    want = np.asarray(jdb.make_chroma_pass(src.shape[0], E, bd)(
        jnp.asarray(src), jnp.asarray(flat), 0, E, E + apply.size))
    want = want.T if direction else want
    got = torch.from_numpy(plane.copy())
    deblock.chroma_pass(got, *[torch.from_numpy(a) for a in
                               (edges, apply, tc)], bd, direction)
    assert (want != plane).any()
    np.testing.assert_array_equal(got.numpy(), want)


def test_luma_pass_refuses_tensors_that_disagree():
    plane, xs, mask, tc, beta = [torch.from_numpy(a) for a in
                                 cases.luma_case("regular", 8, 0)]
    with pytest.raises(ValueError):
        deblock.luma_pass(plane, xs, mask, tc, beta, 8, (False,) * 5, 1)
    with pytest.raises(ValueError):
        deblock.luma_pass(plane, xs[:-1], mask, tc, beta, 8, (False,) * 5)
    with pytest.raises(ValueError):
        deblock.luma_pass(plane, xs, mask, tc, beta, 8, (False,) * 4)
    with pytest.raises(ValueError):
        deblock.chroma_pass(plane, xs, mask, tc, 8)


def _jax_host_deblock_planes(name):
    """Decode ``name`` with the JAX package's host decoder; per picture
    the visible planes before and after its deblocking."""
    seen = []
    orig = dbk.DeblockingFilter.deblock_picture

    def hook(self):
        comps = range(self.pic.max_num_components)
        before = [self.rec.plane_view(c).copy() for c in comps]
        orig(self)
        seen.append((before, [self.rec.plane_view(c).copy() for c in comps]))

    mp = pytest.MonkeyPatch()
    mp.setattr(dbk.DeblockingFilter, "deblock_picture", hook)
    # the per-CU host path: the whole-picture native decode deblocks
    # inside its one C++ call
    mp.setenv("XVC_PIC_NATIVE", "0")
    mp.delenv("XVC_DSP", raising=False)
    try:
        dec = jdecoder.Decoder()
        count = 0
        for nal in split_nal_units(read_data(name + ".xvc")):
            dec.decode_nal(nal)
            while dec.get_decoded_picture() is not None:
                count += 1
        dec.flush()
        while dec.get_decoded_picture() is not None:
            count += 1
    finally:
        mp.undo()
    assert count == len(seen)
    return seen


@pytest.mark.parametrize("name,count", [("sp_fast", 6), ("ai64x48", 3),
                                        ("ai64x48b10", 2)])
def test_deblock_picture_matches_jax_package_host_planes(name, count):
    """The stage alone: same planes in, same planes out, picture by
    picture."""
    want = _jax_host_deblock_planes(name)
    assert len(want) == count
    got = []
    orig = picture_decoder.deblock_picture

    def hook(filt, planes, device):
        before = [planes[c].numpy().copy() for c in sorted(planes)]
        out = orig(filt, planes, device)
        got.append((before, [planes[c].numpy().copy()
                             for c in sorted(planes)]))
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(picture_decoder, "deblock_picture", hook)
    try:
        pics = decode_stream(read_data(name + ".xvc"), device="cpu")
    finally:
        mp.undo()
    assert len(pics) == len(got) == count
    changed = 0
    for (gb, ga), (wb, wa) in zip(got, want):
        for c in range(len(wb)):
            np.testing.assert_array_equal(gb[c], wb[c])
            np.testing.assert_array_equal(ga[c], wa[c])
            changed += int((wa[c] != wb[c]).sum())
    assert changed
