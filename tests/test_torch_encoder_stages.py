"""The encoder's device stages of speed mode 3 in the port against the
JAX package, on the CPU device, with inputs made from numpy seeds.

- The split DP (gpu/wavefront_rdo.py): frame_zero_mv_sad and
  split_dp_from_lookahead equal array for array on the structured clip
  of tests/test_wavefront_rdo.py (intra and inter pictures), its forcing
  and near-tie cases, and a SAD map left out (the 1 << 30 fill, whose
  int32 sums wrap as the JAX package's do); decision_for and
  pack_force_maps.
- The lookahead at the split DP's sizes and mode subsets: (16, 32) with
  mode_step 4 and (64,) with mode_step 8, exact, on frames of 128x128 and
  more.
- The transform-RD prepass (gpu/txrd_prepass.py): the candidate maps of
  frame_txrd_prepass equal the JAX package's at 8 and 10 bit, intra and
  inter, keep 1-3, on the clips of tests/test_txrd_prepass.py and a
  256x256 clip.  The tolerance is equality: the maps are equal entry for
  entry (a differing block is named by the assertion).  Below the
  frame: txrd_plain (the plain version of the txrd kernel: everything
  after the SATD) equals the JAX package's _txrd_step block for block at
  every size, 8 and 10 bit, intra and inter, screen_step 1 and 4, keep 1,
  2 and 8, on blocks with SATD and cost ties and at full scale; its
  stages alone: the screen's tie order against lax.top_k, the float64
  forward transform against an exact integer transform.
- The kernel's arithmetic (kernels/csrc/txrd.cu), modelled in numpy and
  held against txrd_plain: the int32 transform sums and their bounds
  (exact_sum_bounds, the bit depths the kernel takes), the log2 table,
  the int64 error sum and the fixed-point bit sum against the float64
  sums of the plain version.
"""
import numpy as np
import pytest
import torch

from xvc_tpu.ops.quant import Qp as JaxQp
from xvc_tpu.restrictions import Restrictions as JaxRestrictions
from xvc_tpu.tpu import lookahead as jla
from xvc_tpu.tpu import txrd_prepass as jtx
from xvc_tpu.tpu import wavefront_rdo as jwf
from xvc_tpu_torch.gpu import intra_satd, lookahead, txrd_prepass, \
    wavefront_rdo
from xvc_tpu_torch.ops.quant import Qp
from xvc_tpu_torch.restrictions import Restrictions


def wavefront_luma(t, w=192, h=192):
    """Luma of picture t of the clip of tests/test_wavefront_rdo.py
    :140-160 (flat band, stripes moving 4 samples a picture, noise)."""
    yy, xx = np.mgrid[0:h, 0:w]
    rng = np.random.RandomState(5)
    for i in range(t + 1):
        noise = rng.randint(-20, 21, (64, w))
    y = np.zeros((h, w), np.int32)
    y[:64] = 210
    y[64:128] = 128 + 80 * (((xx[:64] + 4 * t) >> 3) & 1)
    y[128:] = 128 + noise
    return np.clip(y, 0, 255)


def forcing_frame():
    """The 64x128 frame of tests/test_wavefront_rdo.py
    test_split_dp_forces_decisions: a flat 64 block, and one whose four
    32 quadrants each fit a different intra mode."""
    yy, xx = np.mgrid[0:32, 0:32]
    frame = np.zeros((64, 128), np.int32)
    frame[:, :64] = 128
    q = np.zeros((64, 64), np.int32)
    q[:32, :32] = 128 + 90 * ((yy >> 2) & 1)
    q[:32, 32:] = 128 + 90 * ((xx >> 2) & 1)
    q[32:, :32] = 128 + 90 * (((xx + yy) >> 2) & 1)
    q[32:, 32:] = 40
    frame[:, 64:] = q
    return frame


def txrd_luma(w, h, t, seed=3):
    """Luma of picture t of tests/test_txrd_prepass.py synthetic_yuv420."""
    rng = np.random.RandomState(seed)
    base = (128 + 60 * np.sin(np.arange(w)[None, :] / 9.0) *
            np.cos(np.arange(h)[:, None] / 7.0)).astype(np.uint8)
    for i in range(t + 1):
        y = np.roll(base, i * 2, axis=1).copy()
        y[h // 2:, :] = rng.randint(0, 256, (h - h // 2, w))
    return y.astype(np.int32)


def _equal_maps(got, want, what):
    assert (got is None) == (want is None), what
    if want is None:
        return
    assert sorted(got) == sorted(want), what
    for n in want:
        assert got[n].shape == want[n].shape, (what, n)
        bad = np.argwhere(np.asarray(got[n]) != np.asarray(want[n]))
        assert not len(bad), "%s n=%d: blocks differ at %s" % (
            what, n, bad[:10].tolist())


# ---- the split DP -------------------------------------------------------

@pytest.mark.parametrize("sizes", [(16, 32, 64), (8, 16, 32, 64)])
@pytest.mark.parametrize("nrefs", [1, 2])
def test_frame_zero_mv_sad_equals_jax(sizes, nrefs):
    orig = wavefront_luma(2)
    refs = [wavefront_luma(1), wavefront_luma(0)][:nrefs]
    want = jwf.frame_zero_mv_sad(orig, refs, 8, sizes=sizes)
    got = wavefront_rdo.frame_zero_mv_sad(orig, refs, 8, sizes=sizes,
                                          device="cpu")
    _equal_maps(got, want, "zero-MV SAD")
    for n in sizes:
        assert got[n].dtype == np.int32


def test_frame_zero_mv_sad_without_room_or_references():
    orig = wavefront_luma(0)[:48, :48]
    assert wavefront_rdo.frame_zero_mv_sad(orig, [orig], 8,
                                           device="cpu") is None
    assert jwf.frame_zero_mv_sad(orig, [orig], 8) is None
    assert wavefront_rdo.frame_zero_mv_sad(orig, [], 8, device="cpu") \
        is None


def _dp_maps(frame, sizes=((16, 32), 4, (64,), 8)):
    """The split DP's lookahead maps as the picture encoder asks for them
    (the port's; the lookahead test below holds them to JAX's)."""
    s1, step1, s2, step2 = sizes
    maps = lookahead.frame_intra_lookahead(frame, 8, Restrictions(),
                                           sizes=s1, mode_step=step1,
                                           device="cpu")
    maps.update(lookahead.frame_intra_lookahead(
        frame, 8, Restrictions(), sizes=s2, mode_step=step2, device="cpu"))
    return maps


DP_CASES = {
    "intra": dict(inter=False, allow_force_split=True),
    "inter": dict(inter=True, allow_force_split=False),
    "inter_no_binary": dict(inter=True, allow_force_split=False,
                            binary_depth_ok=False),
    "intra_binary16": dict(inter=False, allow_force_split=True,
                           max_binary_size=16),
    "inter_missing_sad": dict(inter=True, allow_force_split=True,
                              drop=16),
}


@pytest.mark.parametrize("case", sorted(DP_CASES))
@pytest.mark.parametrize("lambda_sqrt", [0.0, 11.3])
def test_split_dp_equals_jax(case, lambda_sqrt):
    kw = dict(DP_CASES[case])
    inter = kw.pop("inter")
    drop = kw.pop("drop", None)
    frame = wavefront_luma(1)
    maps = _dp_maps(frame)
    sad = None
    if inter:
        sad = wavefront_rdo.frame_zero_mv_sad(
            frame, [wavefront_luma(0)], 8, sizes=(16, 32, 64), device="cpu")
        if drop:
            del sad[drop]   # filled with 1 << 30: int32 sums wrap
    want = jwf.split_dp_from_lookahead(maps, lambda_sqrt, sad, **kw)
    got = wavefront_rdo.split_dp_from_lookahead(maps, lambda_sqrt, sad,
                                                device="cpu", **kw)
    _equal_maps(got, want, case)
    assert sorted(got) == [32, 64]
    for n in got:
        assert got[n].dtype == np.int8
    if case == "intra":
        assert any((f != 0).any() for f in got.values())


def test_split_dp_forcing_case_equals_jax():
    maps = lookahead.frame_intra_lookahead(forcing_frame(), 8,
                                           Restrictions(),
                                           sizes=(4, 8, 16, 32, 64),
                                           device="cpu")
    want = jwf.split_dp_from_lookahead(maps, lambda_sqrt=8.0)
    got = wavefront_rdo.split_dp_from_lookahead(maps, lambda_sqrt=8.0,
                                                device="cpu")
    _equal_maps(got, want, "forcing")
    d = wavefront_rdo.decision_for
    assert d(got, 0, 0, 64, 64) == wavefront_rdo.FORCE_LEAF
    assert d(got, 64, 0, 64, 64) == wavefront_rdo.FORCE_SPLIT
    for args in ((0, 0, 32, 16), (8, 0, 16, 16), (0, 0, 128, 128)):
        assert d(got, *args) == wavefront_rdo.UNDECIDED == \
            jwf.decision_for(want, *args)
    assert d(None, 0, 0, 32, 32) == wavefront_rdo.UNDECIDED


@pytest.mark.parametrize("child_scale", [1.0, 0.98, 0.80, 1.25])
@pytest.mark.parametrize("max_binary_size", [0, 32])
def test_split_dp_near_tie_cases_equal_jax(child_scale, max_binary_size):
    base = 10000
    maps = {8: np.full((2, 2, 1), int(base * child_scale) // 4, np.int32),
            16: np.full((1, 1, 1), base, np.int32)}
    want = jwf.split_dp_from_lookahead(maps, 0.0,
                                       max_binary_size=max_binary_size)
    got = wavefront_rdo.split_dp_from_lookahead(
        maps, 0.0, max_binary_size=max_binary_size, device="cpu")
    _equal_maps(got, want, "near tie")


@pytest.mark.parametrize("w,h", [(192, 192), (44, 36), (1280, 720)])
def test_pack_force_maps_equals_jax(w, h):
    rng = np.random.RandomState(w)
    fm = {n: rng.randint(-1, 2, (h // n, w // n)).astype(np.int8)
          for n in (16, 32, 64) if h >= n and w >= n}
    got = wavefront_rdo.pack_force_maps(fm, w, h)
    assert got.tobytes() == jwf.pack_force_maps(fm, w, h).tobytes()
    assert wavefront_rdo.pack_force_maps(None, w, h).tobytes() == \
        jwf.pack_force_maps(None, w, h).tobytes()


@pytest.mark.parametrize("w,h,keep", [(44, 36, 2), (1280, 720, 1),
                                      (128, 96, 3)])
def test_pack_intra_cands_equals_jax(w, h, keep):
    rng = np.random.RandomState(h)
    maps = {n: rng.randint(0, 67, (h // n, w // n, keep)).astype(np.int32)
            for n in (4, 8, 16, 32) if h >= n and w >= n}
    got = txrd_prepass.pack_intra_cands(maps, w, h, keep)
    assert got.dtype == np.int8
    assert got.tobytes() == jtx.pack_intra_cands(maps, w, h, keep).tobytes()
    assert txrd_prepass.pack_intra_cands(None, w, h, keep).tobytes() == \
        jtx.pack_intra_cands(None, w, h, keep).tobytes()


# ---- the lookahead at the split DP's sizes ------------------------------

@pytest.mark.parametrize("frame_name", ["wavefront", "txrd", "noise10"])
@pytest.mark.parametrize("sizes,mode_step", [((16, 32), 4), ((64,), 8)])
def test_lookahead_split_dp_sizes_equal_jax(frame_name, sizes, mode_step):
    bd = 8
    if frame_name == "wavefront":
        frame = wavefront_luma(1)
    elif frame_name == "txrd":
        frame = txrd_luma(256, 128, 1)
    else:
        bd = 10
        frame = np.random.RandomState(11).randint(0, 1024, (128, 192))
    want = jla.frame_intra_lookahead(frame, bd, JaxRestrictions(),
                                     sizes=sizes, mode_step=mode_step)
    got = lookahead.frame_intra_lookahead(frame, bd, Restrictions(),
                                          sizes=sizes, mode_step=mode_step,
                                          device="cpu")
    _equal_maps(got, want, "lookahead %s/%d" % (sizes, mode_step))
    modes = 2 + -(-65 // mode_step)
    for n in sizes:
        assert got[n].shape == (frame.shape[0] // n, frame.shape[1] // n,
                                modes)


def test_weights_of_the_64_maps_are_built_once():
    a = intra_satd.weights_on(64, 8, torch.device("cpu"))
    assert intra_satd.weights_on(64, 8, torch.device("cpu")) is a
    assert tuple(a.shape) == (9, 64 * 64, 2 * (4 * 64 + 1))


# ---- the transform-RD prepass -------------------------------------------

def _qp(module, qp, bd):
    return module(qp, 1, bd, 0.57 * 2 ** ((qp - 12) / 3))


PREPASS_CASES = {
    "txrd128x96_intra_k2": ("txrd", 128, 96, 8, 32, True, 2),
    "txrd128x96_inter_k2": ("txrd", 128, 96, 8, 32, False, 2),
    "txrd44x36_k1": ("txrd", 44, 36, 8, 32, True, 1),
    "clip256_k1": ("txrd", 256, 256, 8, 32, True, 1),
    "clip256_qp22_k3": ("txrd", 256, 256, 8, 22, False, 3),
    "clip256_10bit_k1": ("txrd", 256, 256, 10, 32, True, 1),
    "clip256_10bit_inter_k2": ("txrd", 256, 256, 10, 37, False, 2),
    "wavefront_k1": ("wavefront", 192, 192, 8, 32, True, 1),
    # scale 16384: |c| * scale + offset meets multiples of 2^24, where
    # XLA's inexact exp2(-24) decides the level
    "clip256_qp34_inter_k1": ("txrd", 256, 256, 8, 34, False, 1),
    "clip256_qp34_intra_k1": ("txrd", 256, 256, 8, 34, True, 1),
}


@pytest.mark.parametrize("case", sorted(PREPASS_CASES))
def test_frame_txrd_prepass_equals_jax(case):
    clip, w, h, bd, qp, intra, keep = PREPASS_CASES[case]
    frame = (wavefront_luma(1) if clip == "wavefront" else
             txrd_luma(w, h, 1)) << (bd - 8)
    want = jtx.frame_txrd_prepass(frame, bd, _qp(JaxQp, qp, bd), intra,
                                  keep=keep)
    got = txrd_prepass.frame_txrd_prepass(frame, bd, _qp(Qp, qp, bd), intra,
                                          keep=keep, device="cpu")
    _equal_maps(got, want, case)
    for n in got:
        assert got[n].dtype == np.int32 and got[n].shape[2] == keep
        assert got[n].min() >= 0 and got[n].max() <= 66


def test_frame_txrd_prepass_leaves_out_sizes_larger_than_the_picture():
    frame = txrd_luma(12, 20, 0)
    got = txrd_prepass.frame_txrd_prepass(frame, 8, _qp(Qp, 32, 8), True,
                                          device="cpu")
    assert sorted(got) == [4, 8]
    assert txrd_prepass.frame_txrd_prepass(frame[:3], 8, _qp(Qp, 32, 8),
                                           True, device="cpu") is None


def test_screen_breaks_ties_toward_the_lower_index():
    """The 8-candidate screen and the keep-best selection order equal
    SATD (and equal costs) by index, as lax.top_k does."""
    import jax
    import jax.numpy as jnp
    rng = np.random.RandomState(3)
    satd = rng.randint(0, 6, (64, 67)).astype(np.int32)   # many ties
    _, want = jax.lax.top_k(-jnp.asarray(satd), 8)
    got = txrd_prepass._stable_best(torch.from_numpy(satd), 8)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("bd", [8, 10])
def test_forward_transform_is_the_exact_integer_transform(n, bd):
    """The float64 products are exact: the coefficients equal the
    integer transform with the same floor shifts (int64 numpy), also for
    residuals whose float32 partial sums would pass 2^24."""
    basis, shift1, shift2 = txrd_prepass._fwd_basis(n, bd, n == 4)
    m = basis.astype(np.int64)
    rng = np.random.RandomState(n + bd)
    lim = 1 << bd
    resi = rng.randint(-lim + 1, lim, (16, 8, n, n))
    resi[0] = lim - 1           # a flat block at full range
    t1 = (resi @ m.T + (1 << (shift1 - 1))) >> shift1
    want = (m @ t1 + (1 << (shift2 - 1))) >> shift2
    got = txrd_prepass.forward_transform(
        torch.from_numpy(resi.astype(np.int32)), n, bd)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy().astype(np.int64), want)


def test_rank_params_are_the_jax_package_s_quant_parameters():
    from xvc_tpu.ops import quant as jq
    for n in (4, 8, 16, 32):
        for bd in (8, 10):
            qp = _qp(Qp, 32, bd)
            p = txrd_prepass.rank_params(n, bd, qp, True)
            tshift = jq.get_transform_shift(n, n, bd)
            assert p["scale"] == qp.get_fwd_scale(0)
            shift = jq.QUANT_SHIFT + qp.get_qp_per(0) + tshift
            assert p["p_shift"] == txrd_prepass.xla_exp2(-shift)
            assert p["p_inv"] == 2.0 ** -(jq.IQUANT_SHIFT - tshift)
            assert p["inv_gain"] == float(np.float32(
                1.0 / jtx._parseval_gain2(n, bd, n == 4)))


def test_xla_exp2_table_is_jnp_exp2_on_the_cpu_backend():
    """The quant powers of the ranking: exp2 of integer-valued float32
    as XLA's CPU backend computes it, off the exact power for |x| >= 13
    (the JAX package's expression, copied as it is)."""
    import jax
    import jax.numpy as jnp
    xs = np.arange(-64, 65, dtype=np.float32)
    want = np.asarray(jax.jit(jnp.exp2)(jnp.asarray(xs)))
    got = np.array([txrd_prepass.xla_exp2(int(x)) for x in xs], np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    exact = np.ldexp(np.float32(1), xs.astype(int)).astype(np.float32)
    assert (got[np.abs(xs) <= 12] == exact[np.abs(xs) <= 12]).all()
    assert (got[np.abs(xs) == 13] != exact[np.abs(xs) == 13]).all()


# ---- txrd_plain against the JAX step; the kernel's arithmetic -----------

def _jax_quant_params(qp, n, bd):
    """The JAX step's traced quant parameters, as its frame_txrd_prepass
    makes them."""
    import jax.numpy as jnp
    from xvc_tpu.ops import quant as jq
    tshift = jq.get_transform_shift(n, n, bd)
    return tuple(jnp.float32(x) for x in (
        qp.get_fwd_scale(0), jq.QUANT_SHIFT + qp.get_qp_per(0) + tshift,
        qp.get_inv_scale(0), jq.IQUANT_SHIFT - tshift, qp.get_lambda()))


def _step_inputs(n, bd, seed):
    """(orig, top, left) int32 blocks: blocks of a real clip, blocks with
    flat references (every mode predicts the same: SATD ties across the
    8th and 9th place, and equal costs), flat on one side only, and full
    scale residuals (orig 0 or 2^bd - 1 against references at the other
    end, uniform and checkered)."""
    rng = np.random.RandomState(seed)
    maxv = (1 << bd) - 1
    frame = txrd_luma(128, 96, 1) << (bd - 8)
    orig, top, left = txrd_prepass._extract_grid_fast(frame, n)
    extra_o, extra_t, extra_l = [], [], []

    def add(o, t, l):
        extra_o.append(np.broadcast_to(o, (n, n)))
        extra_t.append(np.broadcast_to(t, (2 * n + 1,)))
        extra_l.append(np.broadcast_to(l, (2 * n,)))

    for v in (0, 100 << (bd - 8), maxv):        # flat references
        add(rng.randint(0, maxv + 1, (n, n)), v, v)
    add(rng.randint(0, maxv + 1, (n, n)), 60 << (bd - 8),
        rng.randint(0, maxv + 1, 2 * n))         # flat top only
    check = (np.add.outer(np.arange(n), np.arange(n)) & 1) * maxv
    for o, r in ((maxv, 0), (0, maxv), (check, 0), (maxv - check, maxv)):
        add(o, r, r)
    return (np.concatenate([orig, np.stack(extra_o)]).astype(np.int32),
            np.concatenate([top, np.stack(extra_t)]).astype(np.int32),
            np.concatenate([left, np.stack(extra_l)]).astype(np.int32))


@pytest.mark.parametrize("keep", [1, 2, 8])
@pytest.mark.parametrize("screen_step", [1, 4])
@pytest.mark.parametrize("intra", [True, False])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_txrd_plain_equals_the_jax_step(n, bd, intra, screen_step, keep):
    import jax.numpy as jnp
    qpv = 32 if bd == 8 else 37
    orig, top, left = _step_inputs(n, bd, n + bd)
    want = np.asarray(jtx._txrd_step(
        jnp.asarray(orig), jnp.asarray(top), jnp.asarray(left), n, bd, keep,
        intra, screen_step, _jax_quant_params(_qp(JaxQp, qpv, bd), n, bd)))
    params = txrd_prepass.rank_params(n, bd, _qp(Qp, qpv, bd), intra)
    t = [torch.from_numpy(a) for a in (orig, top, left)]
    got = txrd_prepass._txrd_step(*t, n, bd, keep, intra, screen_step,
                                  params)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    bad = np.argwhere(got.numpy() != want)
    assert not len(bad), "blocks differ at %s" % bad[:10].tolist()
    # the same through the three stages the step runs
    from xvc_tpu_torch.gpu import intra_batch, satd
    preds = intra_batch.predict_all_modes(
        n, t[1], t[2], intra_satd.weights_on(n, screen_step, "cpu"), bd,
        n <= 16 and screen_step == 1)
    sat = satd.satd_pred(t[0], preds, bd)
    assert sat.shape[1] == (67 if screen_step == 1 else 19)
    assert torch.equal(txrd_prepass.txrd_plain(
        t[0], preds, sat, n, bd, keep, screen_step, params), got)


def test_txrd_refuses_fewer_modes_than_it_screens():
    orig = torch.zeros((2, 4, 4), dtype=torch.int32)
    preds = torch.zeros((2, 7, 4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="fewer than 8"):
        txrd_prepass.txrd(orig, preds, torch.zeros((2, 7), dtype=torch.int32),
                          4, 8, 1, 1, {})
    with pytest.raises(ValueError, match="disagree"):
        txrd_prepass.txrd(orig, preds, torch.zeros((2, 8), dtype=torch.int32),
                          4, 8, 1, 1, {})


def _sign_patterns(basis, bd, rng):
    """Full-scale residuals [k, n, n] (every entry +-(2^bd - 1)): all +,
    all -, every row the signs of basis row k (the largest row-pass sum
    |S1| there is), and random signs."""
    n = basis.shape[0]
    mag = (1 << bd) - 1
    rows = np.sign(basis).astype(np.int64)
    rows[rows == 0] = 1
    pats = [np.ones((n, n), np.int64), -np.ones((n, n), np.int64)]
    pats += [np.broadcast_to(rows[k], (n, n)) for k in range(n)]
    pats += [rng.choice([-1, 1], (n, n)) for _ in range(8)]
    return mag * np.stack(pats)


def _floor_shift(s, shift, integer):
    """A floor shift of the kernel: float32 (f32(s) + 2^(shift-1)) *
    2^-shift floored, and where ``integer`` (txrd_prepass.integer_shifts)
    the integer shift it takes instead, held equal."""
    f = np.floor((s.astype(np.float32) + np.float32(1 << (shift - 1))) *
                 np.float32(1.0 / (1 << shift))).astype(np.int64)
    if integer:
        assert np.array_equal((s + (1 << (shift - 1))) >> shift, f)
    return f


def _int_transform(resi, basis, shift1, shift2, integer=(False, False)):
    """The kernel's transform in int64: (S1, t1, S2, c), each floor shift
    as the kernel does it; at n >= 8 also the even-odd form of each pass
    (sums and differences of mirrored entries, half the products), held
    to the direct sums."""
    m = basis.astype(np.int64)
    n = m.shape[0]
    s1 = resi @ m.T
    t1 = _floor_shift(s1, shift1, integer[0])
    s2 = m @ t1
    if n > 4:
        h = n // 2
        rr = resi[..., ::-1][..., :h]                     # mirrored
        assert np.array_equal((resi[..., :h] + rr) @ m[0::2, :h].T,
                              s1[..., 0::2])
        assert np.array_equal((resi[..., :h] - rr) @ m[1::2, :h].T,
                              s1[..., 1::2])
        tr = t1[..., ::-1, :][..., :h, :]
        assert np.array_equal(m[0::2, :h] @ (t1[..., :h, :] + tr),
                              s2[..., 0::2, :])
        assert np.array_equal(m[1::2, :h] @ (t1[..., :h, :] - tr),
                              s2[..., 1::2, :])
    c = _floor_shift(s2, shift2, integer[1]).astype(np.float32)
    return s1, t1, s2, c


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_txrd_int32_sums_at_full_scale(n, bd):
    """Residuals at full scale: every sum of the kernel's int32
    transform stays below 2^31 and inside exact_sum_bounds, the row-pass
    bound is reached, and the coefficients equal the float64 transform."""
    basis, shift1, shift2 = txrd_prepass._fwd_basis(n, bd, n == 4)
    resi = _sign_patterns(basis, bd, np.random.RandomState(n))
    s1, t1, s2, c = _int_transform(resi, basis, shift1, shift2,
                                   txrd_prepass.integer_shifts(n, bd))
    b1, bt, b2 = txrd_prepass.exact_sum_bounds(n, bd)
    assert np.abs(s1).max() == b1 < 2 ** 31
    assert np.abs(t1).max() <= bt < 2 ** 22
    assert np.abs(s2).max() <= b2 < 2 ** 31
    assert txrd_prepass.kernel_takes(n, bd)
    got = txrd_prepass.forward_transform(
        torch.from_numpy(resi[:, None].astype(np.int32)), n, bd)[:, 0]
    assert np.array_equal(got.numpy(), c)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_txrd_kernel_takes_bit_depths_while_its_sums_fit(n):
    """The wrapper's limit: the kernel takes every bit depth up to the
    last whose row-pass sums stay below 2^31 (18 at n = 32, 19 at 16, 20
    at 8) and refuses the next, where a full-scale residual's row pass
    does pass 2^31; at n = 4, whose kernel shifts in integers only, up to
    the last whose row-pass sums plus the rounding offset stay below 2^24
    (16)."""
    basis = txrd_prepass._fwd_basis(n, 8, n == 4)[0]
    first = next(bd for bd in range(8, 32)
                 if not txrd_prepass.kernel_takes(n, bd))
    assert first == {4: 17, 8: 21, 16: 20, 32: 19}[n]
    for bd in (first - 1, first):
        shift1 = txrd_prepass._fwd_basis(n, bd, n == 4)[1]
        limit = 2 ** 24 - (1 << (shift1 - 1)) if n == 4 else 2 ** 31
        resi = _sign_patterns(basis, bd, np.random.RandomState(0))
        s1 = np.abs(resi @ basis.astype(np.int64).T).max()
        assert (s1 >= limit) == (bd == first)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_txrd_integer_floor_shifts_where_float32_is_exact(n):
    """The kernel's integer floor shifts, each where the pass's sums plus
    2^(shift-1) stay below 2^24 (which the full-scale test above holds to
    the float32 shift): pass 1 up to 16 bit at n = 4, 13 at n = 8, 12 at
    16 and 11 at 32; pass 2 at n = 4 only, at every bit depth (its
    column sums stay below 2^23)."""
    last = {4: 16, 8: 13, 16: 12, 32: 11}[n]
    for bd in range(8, 19):
        assert txrd_prepass.integer_shifts(n, bd) == (bd <= last, n == 4)


def test_txrd_log2_table_is_torch_log2_of_float64():
    table = txrd_prepass.log2_table()
    want = torch.log2(torch.arange(1, 32769, dtype=torch.float64)).float()
    assert table.dtype == np.float32 and table.shape == (32768,)
    assert np.array_equal(table.view(np.uint32), want.numpy().view(np.uint32))


def _kernel_sums(coeff, p):
    """The kernel's two sums over [..., n, n] float32 coefficients: the
    int64 sum of (|c| - ch)^2 and the bit sum in fixed point at 2^-22,
    with levels from a float32 arithmetic equal to txrd_rank_plain's."""
    f32 = np.float32
    a = np.abs(coeff)
    u = (a.astype(np.float64) * p["scale"] + p["offset"]).astype(f32)
    level = np.minimum(np.floor(u * f32(p["p_shift"])), f32(32767))
    ch = np.minimum(np.floor(level * f32(p["inv_scale"]) * f32(p["p_inv"]) +
                             f32(0.5)), f32(32767))
    e = (a - ch).astype(np.int64)
    lg = txrd_prepass.log2_table()[level.astype(np.int64)]
    term = f32(1.5) + f32(2) * lg
    fixed = np.where(level > 0, (term * f32(2 ** 22)).astype(np.int64), 0)
    assert (fixed == np.where(level > 0, term.astype(np.float64) * 2 ** 22,
                              0)).all()         # exactly a multiple
    return (e * e).sum(axis=(-1, -2)), fixed.sum(axis=(-1, -2)), level


def _kernel_model(orig, preds, satd, n, bd, keep, step, p):
    """txrd.cu in numpy: the (satd, mode) key screen, the int32
    transform, the two exact sums rounded once to float32, the cost and
    the strict (cost, candidate) pick."""
    f32 = np.float32
    key = (satd.astype(np.int64) + 2 ** 31) << 32 | np.arange(satd.shape[1])
    cand = (np.sort(key, axis=1)[:, :8] & 0xffffffff).astype(np.int64)
    picked = np.take_along_axis(preds, cand[:, :, None, None], axis=1)
    basis, shift1, shift2 = txrd_prepass._fwd_basis(n, bd, n == 4)
    s1, _, s2, c = _int_transform(orig[:, None].astype(np.int64) - picked,
                                  basis, shift1, shift2,
                                  txrd_prepass.integer_shifts(n, bd))
    assert np.abs(s1).max() < 2 ** 31 and np.abs(s2).max() < 2 ** 31
    err, fixed, _ = _kernel_sums(c, p)
    dist = err.astype(f32) * f32(p["inv_gain"])
    bits = fixed.astype(f32) * f32(2 ** -22)
    cost = (p["lam"] * bits.astype(np.float64) + dist).astype(f32)
    order = np.lexsort((np.broadcast_to(np.arange(8), cost.shape), cost),
                       axis=1)[:, :keep]
    best = np.take_along_axis(cand, order, axis=1)
    return np.where(best < 2, best, (best - 2) * step + 2).astype(np.int32)


@pytest.mark.parametrize("keep", [1, 3, 8])
@pytest.mark.parametrize("bd,qpv,intra", [(8, 32, True), (8, 22, False),
                                          (10, 37, True), (10, 27, False)])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_txrd_kernel_model_equals_txrd_plain(n, bd, qpv, intra, keep):
    step = 4 if keep == 3 else 1            # 19 modes, else 67
    orig, preds, satd = txrd_prepass.synthetic_inputs(
        np.random.RandomState(n * 7 + qpv + keep), 40, n, bd,
        2 + -(-65 // step))
    p = txrd_prepass.rank_params(n, bd, _qp(Qp, qpv, bd), intra)
    want = txrd_prepass.txrd(*(torch.from_numpy(a) for a in
                               (orig, preds, satd)), n, bd, keep, step, p)
    got = _kernel_model(orig, preds, satd, n, bd, keep, step, p)
    assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("kind", ["random", "extreme"])
@pytest.mark.parametrize("n", [4, 32])
def test_txrd_exact_sums_equal_the_float64_sums(n, kind):
    """The kernel's int64 error sum and fixed-point bit sum, rounded to
    float32, equal txrd_rank_plain's float64 sums rounded to float32, on
    random levels and on extreme ones (|c| up to 2^15, zero and one; and
    with a coarser quantizer shift, levels at the 32767 clamp)."""
    rng = np.random.RandomState(n)
    if kind == "random":
        c = np.round(rng.laplace(0, 300, (64, 8, n, n)))
    else:
        c = rng.choice([0, 1, -1, 2 ** 15 - 1, -(2 ** 15), 2 ** 14 + 3],
                       (64, 8, n, n))
        c[0] = 2 ** 15 - 1
    c = c.astype(np.float32)
    for qpv in (22, 37, 51, "clamp"):
        p = txrd_prepass.rank_params(n, 8, _qp(Qp, 22 if qpv == "clamp"
                                                else qpv, 8), True)
        if qpv == "clamp":          # a coarser shift: levels at the clamp
            p["p_shift"] *= 2.0 ** 10
        err, fixed, level = _kernel_sums(c, p)
        if kind == "extreme" and qpv == "clamp":
            assert (level[0] == 32767).all()
        ct = torch.from_numpy(c)
        # the plain version's float64 sums (txrd_rank_plain's expressions)
        u = (ct.abs().double() * p["scale"] + p["offset"]).float()
        lv = torch.floor(u * p["p_shift"]).clamp(max=32767.0)
        ch = torch.floor(lv * p["inv_scale"] * p["p_inv"] + 0.5).clamp(
            max=32767.0)
        e = (ct.abs() - ch).double()
        lg = torch.log2((lv + 1.0).double()).float()
        terms = torch.where(lv > 0.0, lg * 2.0 + 1.5, torch.zeros_like(lg))
        assert np.array_equal(lv.numpy(), level)
        assert np.array_equal(err.astype(np.float32),
                              (e * e).sum(dim=(2, 3)).float().numpy())
        assert np.array_equal(
            fixed.astype(np.float32) * np.float32(2 ** -22),
            terms.double().sum(dim=(2, 3)).float().numpy())
        assert (err < 2 ** 42).all() and (fixed < 2 ** 37).all()
