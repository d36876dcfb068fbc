"""Device transform-RD intra mode prepass: whole-frame batched predict +
SATD screen + forward transform + quantize + rate/distortion ranking.

Port of ``xvc_tpu/tpu/txrd_prepass.py`` (the analog of the per-candidate
loop of the reference's transform encoder, ref: src/xvc_enc_lib/
transform_encoder.cc:54-200 driven from intra_search.cc:188-303): for
every aligned square block of the picture, all 67 intra modes are
predicted and SATD-screened to 8, the survivors get a forward DCT / DST,
the picture-QP fast quantizer, an entropy-rate proxy and a
Parseval-domain distortion, and only the top-K candidates per block are
handed to the native RD search, which then runs the exact per-candidate
RDO on the shorter mode list.

``_txrd_step`` of the JAX package is one jitted program; here it is
three launches on the card:

1. predictions: ``intra_batch.predict_all_modes``;
2. SATD: ``satd.satd_pred`` (``kernels/csrc/satd.cu`` on the card);
3. everything after the SATD (``txrd``): the 8-candidate screen, the
   residual of the picked predictions, the exact forward transform,
   quantization, distortion, rate, cost and the keep-best selection,
   ``kernels/csrc/txrd.cu`` on the card and ``txrd_plain`` on the CPU.

The lookahead's all-mode SATD is one kernel that never writes its
predictions (``intra_satd.py``); this prepass needs the picked
predictions for its residuals, so it keeps steps 1 and 2 apart.

``txrd_plain`` keeps the stages apart: a stable ascending sort of the SATD
(ties toward the lower index, as ``lax.top_k``), a gather, the forward
transform as two float64 ``torch.matmul`` whose every product and partial
sum is an exact integer (below 2^53), each rounded to float32 where the
JAX expression has its float32 einsum value (the JAX package's float32
einsum is exact only while its partial sums stay below 2^24), and the
ranking (``txrd_rank_plain``).

Open-loop (references from the original picture, with the left-edge
self-clamp of ``_extract_grid_fast`` copied) and approximate (rate proxy
instead of CABAC bits): the decisions it forces are encoder-side freedom
only and every stream stays decodable.
"""
import functools
import threading

import numpy as np
import torch

from .. import constants as k
from .. import kernels
from ..engine import resolve_device
from ..ops import quant as q
from ..ops import transform as tx
from ..profiling import span
from . import intra_batch as ib
from . import intra_satd
from . import satd as satd_mod

SIZES = (4, 8, 16, 32)
# SATD screening width before the transform stage; 8 covers the
# reference's num_modes_for_slow_rdo (2-3) + neighbour refinement span.
SATD_KEEP = 8
# block-batch chunk bound: keeps the [chunk, 67, n, n] prediction tensor
# and its float32 numerators near 0.3 GB each at n = 4 (one chunk per
# size at 1280x720)
CHUNK = 65536


@functools.lru_cache(maxsize=None)
def _fwd_basis(n, bitdepth, use_dst):
    """f32 forward basis + shifts for an n x n square block (DCT-2 at
    high precision, or the 4x4 DST-7 used by default intra luma)."""
    l2 = n.bit_length() - 1
    if use_dst:
        m = np.asarray(tx._DST4, dtype=np.float32)
        shift1 = 2 + bitdepth - 9
        shift2 = 2 + 6
    else:
        mi, adj = tx._matrix_i32(int(k.TransformType.DCT2), n, True)
        m = np.asarray(mi, dtype=np.float32)
        shift1 = l2 + bitdepth - 9 + 2 + adj
        shift2 = l2 + 6 + 2 + adj
    return m, shift1, shift2


@functools.lru_cache(maxsize=None)
def _parseval_gain2(n, bitdepth, use_dst):
    """coeff-domain energy per unit pixel-domain energy for the f32
    forward basis (measured once; the int bases are near-orthogonal
    scaled DCT/DST so a scalar gain is accurate to ~1%)."""
    rng = np.random.RandomState(7)
    m, shift1, shift2 = _fwd_basis(n, bitdepth, use_dst)
    m64 = m.astype(np.float64)
    g = []
    for _ in range(4):
        r = rng.randint(-64, 65, size=(n, n)).astype(np.float64)
        t = np.floor((r @ m64.T + (1 << (shift1 - 1))) / (1 << shift1))
        c = np.floor((m64 @ t + (1 << (shift2 - 1))) / (1 << shift2))
        g.append((c * c).sum() / max((r * r).sum(), 1.0))
    return float(np.mean(g))


# exp2 of the integer-valued float32 arguments -64..64 as the JAX
# package's expression gets it from XLA's CPU backend (jnp.exp2 lowers to
# exp(x * ln 2), not exact for |x| >= 13), in float32 units in the last
# place away from the exact power of two.  The prepass's quant powers are
# such values: with an exact 2^-24, a level whose |c| * scale + offset is
# a multiple of 2^24 (scale 16384 at qp 34) rounds up where the JAX
# package's rounds down.  tests/test_torch_encoder_stages.py holds the
# table to jnp.exp2.
_XLA_EXP2_ULPS = (
    -2, -26, 7, -10, 15, 3, -18, 11, -2, -26, 7, -10, -34, 3, -18, 11, -2,
    -26, 7, -9, -1, 3, -17, -9, -1, 3, 7, -9, -1, 3, -17, -9, -1, 4, 8, -9,
    -1, 4, -17, -9, -1, 4, -1, -9, -1, 4, -1, -9, -1, 4, 0, -8, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 4, 0, -8,
    0, 4, 0, -7, 0, 4, 0, -7, 0, 4, 8, -7, 0, 4, -15, -7, 1, 5, 9, -7, 1, 5,
    -15, -7, 1, 5, 9, -7, 1, 5, -15, 13, 1, -22, 9, -6, 17, 5, -14, 13, 1,
    -22, 9, -6, -30, 5, -14, 13, 1
)


def xla_exp2(x):
    """exp2 of the integer ``x`` (|x| <= 64) as float32, as the JAX
    package's XLA CPU backend computes it."""
    exact = np.float32(2.0 ** x).view(np.uint32)
    return float(np.uint32(int(exact) + _XLA_EXP2_ULPS[x + 64])
                 .view(np.float32))


def _f32(x):
    """``x`` rounded to float32, as a Python float (exact in either
    precision, so a tensor operation with it computes in float32 as the
    JAX expression's float32 scalar does)."""
    return float(np.float32(x))


def rank_params(n, bitdepth, qp, is_intra_slice):
    """The ranking's scalars for an n x n block at ``qp``: the float32
    values of the JAX expression's quant parameters (scale, shift,
    inv_scale, inv_shift, lam) and of the terms built from them, with
    its powers of two as ``xla_exp2`` gives them."""
    tshift = q.get_transform_shift(n, n, bitdepth)
    shift = q.QUANT_SHIFT + qp.get_qp_per(0) + tshift
    inv_shift = q.IQUANT_SHIFT - tshift  # dequant shift (>= 0 here)
    return dict(
        scale=_f32(qp.get_fwd_scale(0)),
        offset=_f32(_f32(171.0 if is_intra_slice else 85.0) *
                    xla_exp2(shift - 9)),
        p_shift=xla_exp2(-shift),
        inv_scale=_f32(qp.get_inv_scale(0)),
        p_inv=xla_exp2(-inv_shift),
        inv_gain=_f32(1.0 / _parseval_gain2(n, bitdepth, n == 4)),
        lam=_f32(qp.get_lambda()))


def _stable_best(values, count):
    """Indices of the ``count`` smallest entries along dim 1, lower index
    first among equals (``lax.top_k`` of the negated values)."""
    return torch.sort(values, dim=1, stable=True).indices[:, :count]


def txrd_rank_plain(coeff, cand, keep, screen_step, params):
    """The ranking of ``txrd_plain``, the last stage of the kernel:
    coeff [B, m, n, n] float32 integers, cand [B, m] int32 subset
    mode indices, ``params`` from ``rank_params``.  Returns [B, keep]
    int32 true mode numbers, best first."""
    p = params
    absc = coeff.abs()
    # |c| * scale + offset with one rounding (XLA's CPU backend contracts
    # it into an FMA; the product is exact in float64)
    u = (absc.double() * p["scale"] + p["offset"]).float()
    level = torch.floor(u * p["p_shift"]).clamp(max=32767.0)
    ch = torch.floor(level * p["inv_scale"] * p["p_inv"] + 0.5).clamp(
        max=32767.0)
    err = (absc - ch).double()
    dist_t = (err * err).sum(dim=(2, 3)).float()
    dist = dist_t * p["inv_gain"]
    lg = torch.log2((level + 1.0).double()).float()
    terms = torch.where(level > 0.0, lg * 2.0 + 1.5,
                        torch.zeros_like(lg))
    bits = terms.double().sum(dim=(2, 3)).float()
    # dist + lam * bits with one rounding (XLA's FMA)
    cost = (bits.double() * p["lam"] + dist.double()).float()
    best = torch.gather(cand, 1, _stable_best(cost, keep))
    return torch.where(best < 2, best, (best - 2) * screen_step + 2).to(
        torch.int32)


def forward_transform(resi, n, bitdepth):
    """Forward 2-D transform of [B, m, n, n] int32 residuals as the JAX
    expression computes it (row pass, floor shift, column pass, floor
    shift), each product in float64 (exact) and rounded to float32.
    Returns float32 integer coefficients."""
    basis, shift1, shift2 = _fwd_basis(n, bitdepth, n == 4)
    bm = torch.from_numpy(basis.astype(np.float64)).to(resi.device)
    r = resi.double()
    t1 = torch.floor((torch.matmul(r, bm.t()).float() +
                      float(1 << (shift1 - 1))) * (1.0 / (1 << shift1)))
    return torch.floor((torch.matmul(bm, t1.double()).float() +
                        float(1 << (shift2 - 1))) * (1.0 / (1 << shift2)))


# int32 bound of the kernel's transform sums (sums of int32 products)
_INT32_LIMIT = 1 << 31
# the kernel turns t1 and |c| into ints by adding 1.5 * 2^23: exact below
# 2^22
_T1_LIMIT = 1 << 22
# every integer below 2^24 is a float32
_F32_EXACT = 1 << 24


@functools.lru_cache(maxsize=None)
def exact_sum_bounds(n, bitdepth):
    """Upper bounds of |sum| of the kernel's row pass, |t1| after its
    floor shift and |sum| of its column pass, for residuals of magnitude
    at most 2^bitdepth - 1: the largest residual times the largest row sum
    of |basis|, and for t1 that over 2^shift1 (with the float32 rounding of
    the sum and the floor counted)."""
    basis, shift1, _ = _fwd_basis(n, bitdepth, n == 4)
    row = int(np.abs(basis.astype(np.int64)).sum(axis=1).max())
    s1 = ((1 << bitdepth) - 1) * row
    t1 = -(-(s1 + (s1 >> 23) + 1) // (1 << shift1)) + 1
    return s1, t1, t1 * row


@functools.lru_cache(maxsize=None)
def kernel_takes(n, bitdepth):
    """True if the kernel's int32 transform holds every sum exactly (with
    t1 and |c| below 2^22) and, at n = 4, whose kernel shifts in integers
    only, both floor shifts are integer ones (``integer_shifts``)."""
    s1, t1, s2 = exact_sum_bounds(n, bitdepth)
    shift2 = _fwd_basis(n, bitdepth, n == 4)[2]
    c = -(-(s2 + (s2 >> 23) + 1) // (1 << shift2)) + 1
    return s1 < _INT32_LIMIT and s2 < _INT32_LIMIT and \
        max(t1, c) < _T1_LIMIT and (n > 4 or all(integer_shifts(n, bitdepth)))


@functools.lru_cache(maxsize=None)
def integer_shifts(n, bitdepth):
    """(pass 1, pass 2): True where every sum of that pass plus its
    rounding offset 2^(shift-1) stays below 2^24, so that float32 holds
    the sum and the offset's addition exactly and the floor shift is an
    integer shift (the kernel then takes it so)."""
    _, shift1, shift2 = _fwd_basis(n, bitdepth, n == 4)
    s1, _, s2 = exact_sum_bounds(n, bitdepth)
    return (s1 + (1 << (shift1 - 1)) < _F32_EXACT,
            s2 + (1 << (shift2 - 1)) < _F32_EXACT)


@functools.lru_cache(maxsize=None)
def log2_table():
    """float32 log2(level + 1) for every level the ranking's clamp allows
    (0..32767): the float64 log2 rounded to float32, which is what
    ``txrd_rank_plain`` computes (torch.log2 of float64 agrees on the CPU
    and the card)."""
    return np.log2(np.arange(1, 32769, dtype=np.float64)).astype(np.float32)


# the tables on each device, made once under the lock: the pictures of a
# threaded encode share the first one made
_DEV_TABLES = {}
_DEV_TABLES_LOCK = threading.Lock()


def _cached_on_device(key, make):
    got = _DEV_TABLES.get(key)
    if got is None:
        with _DEV_TABLES_LOCK:
            got = _DEV_TABLES.get(key)
            if got is None:
                got = _DEV_TABLES[key] = make()
    return got


def _device_tables(n, bitdepth, device):
    """The int32 basis [n, n] and the log2 table on ``device`` (cached)."""

    def make():
        basis = _fwd_basis(n, bitdepth, n == 4)[0].astype(np.int32)
        # the kernel's even-odd passes at n >= 8 need every DCT-2 row even
        # or odd: m[k][n-1-j] = (-1)^k m[k][j]
        sign = np.where(np.arange(n) % 2, -1, 1)[:, None]
        if n > 4 and not np.array_equal(basis[:, ::-1], sign * basis):
            raise ValueError("txrd: the n=%d basis is not even-odd" % n)
        return (torch.from_numpy(basis).to(device),
                torch.from_numpy(log2_table()).to(device))

    return _cached_on_device((n, bitdepth, str(device)), make)


def _device_weights(n, screen_step, device):
    """The predictor's tap weights on ``device`` (cached with the tables:
    the all-mode SATD's kernel needs none, this prepass predicts with
    them)."""
    return _cached_on_device(
        ("weights", n, screen_step, str(device)),
        lambda: intra_satd.weights_on(n, screen_step, device))


def txrd_plain(orig, preds, satd, n, bitdepth, keep, screen_step, params):
    """Plain PyTorch version of the prepass kernel (same result bit for
    bit): the 8-candidate screen as a stable sort of ``satd``, the gather
    of the picked predictions, ``forward_transform`` of the residual and
    ``txrd_rank_plain``."""
    cand = _stable_best(satd, SATD_KEEP).to(torch.int32)
    idx = cand.long()[:, :, None, None].expand(-1, -1, n, n)
    coeff = forward_transform(orig[:, None] - torch.gather(preds, 1, idx),
                              n, bitdepth)
    return txrd_rank_plain(coeff, cand, keep, screen_step, params)


def txrd(orig, preds, satd, n, bitdepth, keep, screen_step, params):
    """Everything after the SATD for a batch of n x n blocks: orig
    [B, n, n], preds [B, M, n, n] (``intra_batch.predict_all_modes``),
    satd [B, M] (``satd.satd_pred``), all int32, samples of ``bitdepth``
    bits; ``params`` from ``rank_params``.  Returns [B, keep] int32 true
    mode numbers, best first.  ``kernels/csrc/txrd.cu`` on the card,
    ``txrd_plain`` on the CPU."""
    b = orig.shape[0]
    if orig.dtype != torch.int32 or preds.dtype != torch.int32 or \
            satd.dtype != torch.int32 or tuple(orig.shape[1:]) != (n, n) or \
            preds.dim() != 4 or tuple(preds.shape[2:]) != (n, n) or \
            preds.shape[0] != b or tuple(satd.shape) != preds.shape[:2]:
        raise ValueError("txrd: orig %s %r, preds %s %r and satd %s %r "
                         "disagree (n=%d)" % (
                             orig.dtype, tuple(orig.shape), preds.dtype,
                             tuple(preds.shape), satd.dtype,
                             tuple(satd.shape), n))
    if satd.shape[1] < SATD_KEEP:
        # lax.top_k(-satd, SATD_KEEP) refuses fewer modes than it keeps
        raise ValueError("txrd prepass: %d screened modes, fewer than %d"
                         % (satd.shape[1], SATD_KEEP))
    if not 1 <= keep <= SATD_KEEP:
        raise ValueError("txrd: keep %d outside 1..%d" % (keep, SATD_KEEP))
    if not kernels.on_cuda(orig, preds, satd):
        return txrd_plain(orig, preds, satd, n, bitdepth, keep, screen_step,
                          params)
    from ..kernels import build
    if n not in SIZES or satd.shape[1] > ib.NUM_MODES_EXT or \
            not kernel_takes(n, bitdepth):
        raise ValueError("txrd: the kernel takes n in %r, at most %d modes "
                         "and bit depths whose transform sums stay below "
                         "2^31 (at n = 4 below 2^24); got n=%d, %d modes, "
                         "%d bit" % (
                             SIZES, ib.NUM_MODES_EXT, n, satd.shape[1],
                             bitdepth))
    orig, preds, satd = (t.contiguous() for t in (orig, preds, satd))
    if orig.data_ptr() % 16 or preds.data_ptr() % 16:
        raise ValueError("txrd: tensor storage is not 16-byte aligned")
    basis, lg2 = _device_tables(n, bitdepth, orig.device)
    _, shift1, shift2 = _fwd_basis(n, bitdepth, n == 4)
    int1, int2 = integer_shifts(n, bitdepth)
    out = torch.empty((b, keep), dtype=torch.int32, device=orig.device)
    if b:
        p = params
        rc = build.lib().xvc_txrd(
            build.ptr(orig), build.ptr(preds), build.ptr(satd),
            build.ptr(basis), build.ptr(lg2), b, satd.shape[1], n, keep,
            screen_step, shift1, shift2, int1, int2, p["scale"], p["offset"],
            p["p_shift"], p["inv_scale"], p["p_inv"], p["inv_gain"],
            p["lam"], build.ptr(out), build.stream_of(orig))
        build.check(rc, "txrd")
        kernels.count_launch("txrd")
    return out


def synthetic_inputs(rng, B, n, bitdepth, modes=ib.NUM_MODES_EXT):
    """numpy (orig [B, n, n], preds [B, modes, n, n], satd [B, modes])
    int32 for holding the kernel to its plain version: predictions a
    Laplace spread around orig; SATDs from a small range, so that many
    tie, also across the 8th and 9th place.  Every 7th block and the two
    after it are at full scale both ways (orig 2^bitdepth - 1 against
    predictions 0, and 0 against 2^bitdepth - 1) and flat (every
    candidate's cost equal); in the 4th all SATDs tie; in every 5th block
    mode 1 predicts as mode 0."""
    maxv = (1 << bitdepth) - 1
    orig = rng.randint(0, maxv + 1, (B, n, n))
    preds = np.clip(orig[:, None] + np.round(rng.laplace(
        0, 30 << (bitdepth - 8), (B, modes, n, n))), 0, maxv)
    orig[::7], preds[::7] = maxv, 0
    orig[1::7], preds[1::7] = 0, maxv
    preds[2::7] = orig[2::7, None]
    preds[::5, 1] = preds[::5, 0]
    satd = rng.randint(0, 12, (B, modes))
    satd[3::7] = 5
    return tuple(np.ascontiguousarray(a, dtype=np.int32)
                 for a in (orig, preds, satd))


def _txrd_step(orig, top, left, n, bitdepth, keep, is_intra_slice,
               screen_step, params):
    """One block-batch mode evaluation on the tensors' device.

    orig [B,n,n] int32, top [B,2n+1], left [B,2n] int32.  screen_step > 1
    predicts planar/DC + every screen_step-th angular mode only.  Returns
    [B, keep] int32 mode indices (true 0..66 numbering), best first;
    ``is_intra_slice`` is in ``params`` (the JAX step's argument order)."""
    weights = _device_weights(n, screen_step, orig.device)
    # the batched post filter edits fixed full-set mode positions, so it
    # is only applicable on the unstrided tensor
    post_filter = n <= 16 and screen_step == 1
    preds = ib.predict_all_modes(n, top, left, weights, bitdepth,
                                 post_filter)            # [B, M, n, n]
    satd = satd_mod.satd_pred(orig, preds, bitdepth)     # [B, M]
    return txrd(orig, preds, satd, n, bitdepth, keep, screen_step, params)


def _extract_grid_fast(frame, n):
    """Vectorized open-loop block + reference-line extraction for the
    full n-grid: interior references are true frame samples; rows/cols
    beyond the frame clamp to the edge (replicate padding), and the left
    column of blocks at x = 0 clamps to the frame's own first column (the
    JAX package's quirk, copied).  A preview-quality analog of
    compute_ref_samples (ref: intra_prediction.cc:707-848): border
    differences only affect candidate ranking, never conformance."""
    h, w = frame.shape
    bh, bw = h // n, w // n
    orig = np.ascontiguousarray(
        frame[:bh * n, :bw * n].reshape(bh, n, bw, n).swapaxes(1, 2)
        .reshape(bh * bw, n, n).astype(np.int32))
    px = (np.arange(bw) * n)[None, :, None]                  # [1,bw,1]
    py = (np.arange(bh) * n)[:, None, None]                  # [bh,1,1]
    tshape = (bh, bw, 2 * n + 1)
    tcols = np.broadcast_to(
        np.clip(px - 1 + np.arange(2 * n + 1)[None, None, :], 0, w - 1),
        tshape)
    trows = np.broadcast_to(np.clip(py - 1, 0, h - 1), tshape)
    top = frame[trows, tcols].reshape(bh * bw, 2 * n + 1).astype(np.int32)
    lshape = (bh, bw, 2 * n)
    lrows = np.broadcast_to(
        np.clip(py + np.arange(2 * n)[None, None, :], 0, h - 1), lshape)
    lcols = np.broadcast_to(np.clip(px - 1, 0, w - 1), lshape)
    left = frame[lrows, lcols].reshape(bh * bw, 2 * n).astype(np.int32)
    return orig, top, left


def frame_txrd_prepass(luma_plane, bitdepth, qp, is_intra_pic, keep=2,
                       sizes=SIZES, screen_step=1, device=None):
    """Whole-picture transform-RD mode maps on ``device`` (the card when
    None).

    Returns {n: int32 [bh, bw, keep]} candidate mode indices (best
    first) for every fully-covered aligned n x n block, or None when no
    size fits the picture."""
    dev = resolve_device(device)
    frame = np.ascontiguousarray(luma_plane, dtype=np.int32)
    h, w = frame.shape
    keep = max(1, min(keep, SATD_KEEP))
    maps = {}
    for n in sizes:
        if h < n or w < n:
            continue
        params = rank_params(n, bitdepth, qp, bool(is_intra_pic))
        with span("encode.txrd_prepass.extract"):
            grid = _extract_grid_fast(frame, n)
        with span("encode.txrd_prepass.upload"):
            orig, top, left = (torch.from_numpy(a).to(dev) for a in grid)
        with span("encode.txrd_prepass.device"):
            out = torch.cat([
                _txrd_step(orig[s:s + CHUNK], top[s:s + CHUNK],
                           left[s:s + CHUNK], n, bitdepth, keep,
                           bool(is_intra_pic), screen_step, params)
                for s in range(0, orig.shape[0], CHUNK)])
        with span("encode.txrd_prepass.download"):
            maps[n] = out.cpu().numpy().reshape(h // n, w // n, keep)
    return maps or None


def pack_intra_cands(maps, width, height, keep, sizes=SIZES):
    """Flatten candidate maps into the single int8 buffer consumed by
    the native encoder (native/csrc/xvcn_enc.inc enc_intra_cand_lookup):
    for each n in `sizes` in order, a ceil(height/n) x ceil(width/n) x
    keep grid, -1 where the map has no entry (partial edge blocks)."""
    bufs = []
    for n in sizes:
        gh = -(-height // n)
        gw = -(-width // n)
        g = np.full((gh, gw, keep), -1, np.int8)
        f = None if maps is None else maps.get(n)
        if f is not None:
            g[:f.shape[0], :f.shape[1]] = f[:gh, :gw].astype(np.int8)
        bufs.append(g.reshape(-1))
    return np.ascontiguousarray(np.concatenate(bufs))
