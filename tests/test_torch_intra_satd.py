"""The port's all-mode intra SATD (xvc_tpu_torch.gpu.intra_satd) against
the JAX package on the CPU, and a numpy model of its kernel's arithmetic.

- ``intra_satd_plain`` (the CPU route of ``intra_satd``) equals
  ``xvc_tpu.tpu.analysis.make_intra_satd_fn`` at n = 4-16, and at n = 32
  and 64 the same two JAX functions that step composes
  (``predict_all_modes`` then ``satd_square``) with the weight tensor
  given as an argument: the JAX step bakes it into its program as a
  constant, whose folding takes 2.5-3 s a compile at n = 32 and 4-13 s
  and 1-3 GB at n = 64 (tests/test_torch_intra_batch.py holds the step
  itself at n = 32).  Every n in 4-64, mode_step 1, 4 and 8, 8 to 12 bit,
  random and sorted (smooth) reference lines.
- A numpy model of what ``kernels/csrc/intra_satd.cu`` computes per
  sample (each angular mode's projected reference line built once with
  the lines' zero entry past their end and Angular's clamps, then two
  taps at the projected line index, the post filters by (y, x); planar,
  DC and DC's edge filter by their formulas) equals
  ``intra_batch.predict_all_modes`` over every mode at every n, and the
  model of its launch (the modes of each CTA) covers every mode once.
- The per-CU call's packing: pack, then the tensor views, give the JAX
  package's [67] at n = 4-32, through ``intra_satd`` and through
  ``intra_search.device_prepass_satd`` on the CPU device.

Tolerance 0: integer results, bit for bit.  The kernel itself runs only
on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xvc_tpu.tpu import analysis as jan
from xvc_tpu.tpu import intra_batch as jib
from xvc_tpu.tpu import satd as jsatd
from xvc_tpu_torch.codec import intra_search
from xvc_tpu_torch.gpu import intra_batch as ib
from xvc_tpu_torch.gpu import intra_satd as isa
from xvc_tpu_torch.ops import intra_pred as ip

SIZES = (4, 8, 16, 32, 64)
STEPS = (1, 4, 8)
# blocks a case: half random, half sorted
BLOCKS = {4: 12, 8: 12, 16: 8, 32: 6, 64: 2}


def _inputs(n, bd, seed, blocks=None):
    return isa.synthetic_inputs(np.random.RandomState(seed),
                                blocks or BLOCKS[n], n, bd)


@functools.partial(jax.jit, static_argnums=(4, 5, 6))
def _jax_step_given_weights(orig, top, left, weights, n, bitdepth, post):
    preds = jib.predict_all_modes(n, top, left, weights, bitdepth, post)
    return jsatd.satd_square(orig[:, None].astype(jnp.int32) - preds,
                             bitdepth)


def _jax_costs(orig, top, left, n, bd, mode_step):
    if n <= 16:
        return np.asarray(jan.make_intra_satd_fn(n, bd, mode_step)(
            jnp.asarray(orig), jnp.asarray(top), jnp.asarray(left)))
    weights = np.ascontiguousarray(jib.angular_weight_tensor(n)[::mode_step])
    return np.asarray(_jax_step_given_weights(
        orig, top, left, weights, n, bd, n <= 16 and mode_step == 1))


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("mode_step", STEPS)
@pytest.mark.parametrize("n", SIZES)
def test_intra_satd_plain_matches_jax(n, mode_step, bd):
    orig, top, left = _inputs(n, bd, 100 * n + 10 * mode_step + bd)
    want = _jax_costs(orig, top, left, n, bd, mode_step)
    t = [torch.from_numpy(a) for a in (orig, top, left)]
    got = isa.intra_satd_plain(*t, n, bd, mode_step)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == (orig.shape[0], isa.num_modes(mode_step))
    assert want.shape == tuple(got.shape)
    np.testing.assert_array_equal(got.numpy(), want)
    # on the CPU the wrapper is the plain version
    np.testing.assert_array_equal(
        isa.intra_satd(*t, n, bd, mode_step).numpy(), want)


# ---- a numpy model of the kernel's arithmetic ----------------------------

_THR_EXT = (0, 20, 20, 14, 2, 0, 20, 0)


def _use_filtered(n, mode):
    d = min(abs(mode - 18), abs(mode - 50))
    return d > _THR_EXT[n.bit_length() - 1]


def _filter(top, left, n):
    """filter_ref_line of intra_pred.cuh over lines of 2n + 1 and 2n,
    with the zero entry past each end the kernel's shared memory holds."""
    n2 = 2 * n
    ftop, fleft = top.copy(), left.copy()
    for j in range(n2):
        ftop[:, j] = ((top[:, 0] << 1) + top[:, 1] + left[:, 0] + 2 >> 2
                      if j == 0 else
                      (top[:, j] << 1) + top[:, j - 1] + top[:, j + 1] + 2
                      >> 2)
    for j in range(n2 - 1):
        fleft[:, j] = ((left[:, 0] << 1) + top[:, 0] + left[:, 1] + 2 >> 2
                       if j == 0 else
                       (left[:, j] << 1) + left[:, j - 1] + left[:, j + 1]
                       + 2 >> 2)
    return ftop, fleft


class _Angular:
    """struct Angular of intra_pred.cuh over numpy lines [B, 2n+2] (top)
    and [B, 2n+1] (left)."""

    def __init__(self, top, left, n, mode):
        self.top, self.left = top, left
        self.is_hor = mode < 34
        ao = 18 - mode if self.is_hor else mode - 50
        self.angle = ip.ANGLE_TABLE_EXT[min(max(16 + ao, 0), 32)]
        self.inv = ip.INV_ANGLE_TABLE_EXT[min(max(-ao - 1, 0), 15)]
        self.base = -((n * self.angle) >> 5) if self.angle < 0 else 1

    def t(self, j):
        if not self.is_hor:
            return self.top[:, j]
        return self.top[:, 0] if j == 0 else \
            self.left[:, min(max(j - 1, 0), 127)]

    def l(self, j):
        return self.top[:, np.minimum(1 + j, 128)] if self.is_hor else \
            self.left[:, j]

    def rv(self, jr):
        d = jr - self.base
        if d >= -1:
            return self.t(min(max(d + 1, 0), 128))
        proj = ((128 + (-d - 1) * self.inv) >> 8) - 1
        return self.l(min(max(proj, 0), 127))


def _model_predict(n, top, left, bd, mode_step):
    """[B, M, n, n] as the kernel predicts: per angular mode its projected
    line [B, 2n+2] once, then per sample (y, x) the line index
    base + ((yy+1)*angle >> 5) + xx and two taps, and the post filters at
    xx == 0 where n <= 16 and mode_step == 1."""
    b = top.shape[0]
    top = np.concatenate([top, np.zeros((b, 1), top.dtype)], 1)
    left = np.concatenate([left, np.zeros((b, 1), left.dtype)], 1)
    ftop, fleft = _filter(top, left, n)
    post = n <= 16 and mode_step == 1
    maxv = (1 << bd) - 1
    l2 = n.bit_length() - 1
    y, x = np.mgrid[0:n, 0:n]
    out = []
    # planar by its own filter rule (pred_planar)
    pt, pl = (ftop, fleft) if _use_filtered(n, 0) else (top, left)
    hor = (n - 1 - y) * pt[:, 1 + x] + (y + 1) * pl[:, n][:, None, None]
    ver = (n - 1 - x) * pl[:, y] + (x + 1) * pt[:, 1 + n][:, None, None]
    out.append(((hor << l2) + (ver << l2) + (1 << 2 * l2)) >> (2 * l2 + 1))
    # DC and its edge filter (dc_value, dc_post), never filtered
    dc = ((top[:, 1:1 + n].sum(1) + left[:, :n].sum(1) + n)
          // (2 * n))[:, None, None]
    p = np.broadcast_to(dc, (b, n, n)).copy()
    if post:
        p = np.where(x == 0, (left[:, y] + 3 * dc + 2) >> 2, p)
        p = np.where(y == 0, (top[:, 1 + x] + 3 * dc + 2) >> 2, p)
        p[:, 0, 0] = (top[:, 1] + left[:, 0] + 2 * dc[:, 0, 0] + 2) >> 2
    out.append(p)
    for mode in range(2, 67, mode_step):
        filt = _use_filtered(n, mode)
        a = _Angular(ftop if filt else top, fleft if filt else left, n, mode)
        line = np.stack([a.rv(jr) for jr in range(2 * n + 2)], 1)
        yy, xx = (x, y) if a.is_hor else (y, x)
        asum = (yy + 1) * a.angle
        iw = asum & 31
        idx = a.base + (asum >> 5) + xx
        assert idx.min() >= 0 and idx.max() + 1 < 2 * n + 2
        p = ((32 - iw) * line[:, idx] + iw * line[:, idx + 1] + 16) >> 5
        if post and -1 <= a.angle <= 1:
            # the modes within 1 of horizontal and vertical take the
            # unfiltered lines where the post filters apply
            assert not filt
            diff = a.l(yy) - a.t(0)[:, None, None]
            edge = a.t(1)[:, None, None] + (diff >> 1) if a.angle == 0 \
                else p + (diff >> 2)
            p = np.where(xx == 0, np.clip(edge, 0, maxv), p)
        out.append(p)
    return np.stack(out, 1)


@pytest.mark.parametrize("mode_step", STEPS)
@pytest.mark.parametrize("n", SIZES)
def test_kernel_model_matches_predict_all_modes(n, mode_step):
    for bd in (8, 10):
        _, top, left = _inputs(n, bd, 7 * n + mode_step + bd)
        want = ib.predict_all_modes(
            n, torch.from_numpy(top), torch.from_numpy(left),
            isa.weights_on(n, mode_step, "cpu"), bd,
            n <= 16 and mode_step == 1).numpy()
        got = _model_predict(n, top.astype(np.int64), left.astype(np.int64),
                             bd, mode_step)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _model_launch(n, num_modes):
    """The CTAs xvc_intra_satd gives one block (the host half of
    intra_satd.cu): (threads, first mode, modes) of each."""
    t = 4 if n == 4 else 8
    lanes = (n // t) ** 2 * t
    max_modes = 1 if lanes >= 256 else 256 // lanes
    per = min(num_modes, max_modes)
    chunks = -(-num_modes // per)
    per = -(-num_modes // chunks)
    threads = min(256, -(-per * lanes // 32) * 32)
    return [(threads, c * per, min(per, num_modes - c * per))
            for c in range(chunks)], max_modes


@pytest.mark.parametrize("n", SIZES)
def test_kernel_launch_covers_every_mode_once(n):
    """For every mode_step, each mode of a block falls to one CTA, no CTA
    is empty or takes more modes than its shared memory holds, and its
    threads are whole warps; one block of 4 to 32 spreads over 2 to 34
    CTAs."""
    for step in range(1, 70):
        m = isa.num_modes(step)
        ctas, max_modes = _model_launch(n, m)
        covered = [mi for _, m0, mc in ctas for mi in range(m0, m0 + mc)]
        assert covered == list(range(m))
        for threads, _, mc in ctas:
            assert 1 <= mc <= max_modes
            assert threads % 32 == 0 and 32 <= threads <= 256
    if n <= 32:
        assert len(_model_launch(n, 67)[0]) == {4: 2, 8: 3, 16: 9,
                                                32: 34}[n]


# ---- the per-CU call ------------------------------------------------------

@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_per_cu_packing_matches_jax(n, bd):
    orig, top, left = _inputs(n, bd, 31 * n + bd, blocks=2)
    want = _jax_costs(orig, top, left, n, bd, 1)
    for b in range(2):
        packed = np.full(isa.packed_size(n), -1, np.int32)
        isa.pack_block(orig[b], top[b], left[b], packed)
        views = isa.block_views(torch.from_numpy(packed), n)
        for view, a in zip(views, (orig, top, left)):
            np.testing.assert_array_equal(view.numpy(), a[b:b + 1])
        got = isa.intra_satd(*views, n, bd, 1)
        np.testing.assert_array_equal(got.numpy(), want[b:b + 1])
        prepass = intra_search.device_prepass_satd(
            orig[b], top[b], left[b], bd, "cpu")
        assert prepass.dtype == np.int32 and prepass.shape == (67,)
        np.testing.assert_array_equal(prepass, want[b])


@pytest.mark.parametrize("bad", ["n", "shape", "dtype", "bitdepth",
                                 "mode_step"])
def test_intra_satd_refuses_what_the_kernel_does_not_take(bad):
    n, bd, step = 8, 10, 1
    orig, top, left = (torch.from_numpy(a) for a in _inputs(n, bd, 5, 2))
    if bad == "n":
        n = 12
    elif bad == "shape":
        left = left[:, 1:]
    elif bad == "dtype":
        top = top.to(torch.int64)
    elif bad == "bitdepth":
        bd = 17
    else:
        step = 0
    with pytest.raises(ValueError):
        isa.intra_satd(orig, top, left, n, bd, step)
