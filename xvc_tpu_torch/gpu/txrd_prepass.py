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

``_txrd_step`` of the JAX package is one jitted program; here its stages
are:

1. predictions: ``intra_batch.predict_all_modes``;
2. SATD: ``satd.satd_pred`` (``kernels/csrc/satd.cu`` on the card);
3. the 8-candidate screen: a stable ascending sort of the SATD, which
   breaks ties toward the lower index as ``lax.top_k`` does;
4. the forward transform, as two float64 ``torch.matmul`` whose every
   product and partial sum is an exact integer (below 2^53), each product
   rounded to float32 where the JAX expression has its float32 einsum
   value; the JAX package's float32 einsum is exact only while its partial
   sums stay below 2^24;
5. the ranking (``txrd_rank``): quantization, distortion, rate, cost and
   the keep-best selection, ``kernels/csrc/txrd.cu`` on the card and
   ``txrd_rank_plain`` on the CPU.

Open-loop (references from the original picture, with the left-edge
self-clamp of ``_extract_grid_fast`` copied) and approximate (rate proxy
instead of CABAC bits): the decisions it forces are encoder-side freedom
only and every stream stays decodable.
"""
import functools

import numpy as np
import torch

from .. import constants as k
from .. import kernels
from ..engine import resolve_device
from ..ops import quant as q
from ..ops import transform as tx
from . import analysis as an
from . import intra_batch as ib
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
    """Plain PyTorch version of the ranking kernel (same result bit for
    bit): coeff [B, m, n, n] float32 integers, cand [B, m] int32 subset
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


def txrd_rank(coeff, cand, keep, screen_step, params):
    """The ranking stage: ``kernels/csrc/txrd.cu`` on the card,
    ``txrd_rank_plain`` on the CPU (same arguments and result)."""
    if coeff.dtype != torch.float32 or coeff.dim() != 4 or \
            coeff.shape[-1] != coeff.shape[-2] or \
            cand.dtype != torch.int32 or cand.shape != coeff.shape[:2]:
        raise ValueError("txrd_rank: coeff %s %r and cand %s %r disagree"
                         % (coeff.dtype, tuple(coeff.shape), cand.dtype,
                            tuple(cand.shape)))
    if not kernels.on_cuda(coeff, cand):
        return txrd_rank_plain(coeff, cand, keep, screen_step, params)
    from ..kernels import build
    coeff = coeff.contiguous()
    cand = cand.contiguous()
    b, m, n = coeff.shape[0], coeff.shape[1], coeff.shape[-1]
    out = torch.empty((b, keep), dtype=torch.int32, device=coeff.device)
    if b:
        p = params
        rc = build.lib().xvc_txrd_rank(
            build.ptr(coeff), build.ptr(cand), b, m, n, keep, screen_step,
            p["scale"], p["offset"], p["p_shift"], p["inv_scale"],
            p["p_inv"], p["inv_gain"], p["lam"], build.ptr(out),
            build.stream_of(coeff))
        build.check(rc, "txrd")
        kernels.LAUNCHES["txrd"] += 1
    return out


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


def screen(orig, top, left, n, bitdepth, screen_step):
    """Stages 1-3: all-mode prediction, SATD and the 8-candidate screen.
    Returns (cand [B, 8] int32 subset indices, their predictions
    [B, 8, n, n] int32)."""
    weights = an.weights_on(n, screen_step, orig.device)
    # the batched post filter edits fixed full-set mode positions, so it
    # is only applicable on the unstrided tensor
    post_filter = n <= 16 and screen_step == 1
    preds = ib.predict_all_modes(n, top, left, weights, bitdepth,
                                 post_filter)            # [B, M, n, n]
    satd = satd_mod.satd_pred(orig, preds, bitdepth)     # [B, M]
    if satd.shape[1] < SATD_KEEP:
        # lax.top_k(-satd, SATD_KEEP) refuses fewer modes than it keeps
        raise ValueError("txrd prepass: %d screened modes, fewer than %d"
                         % (satd.shape[1], SATD_KEEP))
    cand = _stable_best(satd, SATD_KEEP).to(torch.int32)
    idx = cand.long()[:, :, None, None].expand(-1, -1, n, n)
    return cand, torch.gather(preds, 1, idx)


def _txrd_step(orig, top, left, n, bitdepth, keep, is_intra_slice,
               screen_step, params):
    """One block-batch mode evaluation on the tensors' device.

    orig [B,n,n] int32, top [B,2n+1], left [B,2n] int32.  screen_step > 1
    predicts planar/DC + every screen_step-th angular mode only.  Returns
    [B, keep] int32 mode indices (true 0..66 numbering), best first."""
    cand, pred_m = screen(orig, top, left, n, bitdepth, screen_step)
    coeff = forward_transform(orig[:, None] - pred_m, n, bitdepth)
    return txrd_rank(coeff, cand, keep, screen_step, params)


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
        orig, top, left = (torch.from_numpy(a).to(dev)
                           for a in _extract_grid_fast(frame, n))
        outs = [_txrd_step(orig[s:s + CHUNK], top[s:s + CHUNK],
                           left[s:s + CHUNK], n, bitdepth, keep,
                           bool(is_intra_pic), screen_step, params)
                for s in range(0, orig.shape[0], CHUNK)]
        maps[n] = torch.cat(outs).cpu().numpy().reshape(h // n, w // n,
                                                        keep)
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
