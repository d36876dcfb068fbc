"""Batched intra prediction for all 67 modes as one matrix product.

Port of ``xvc_tpu/tpu/intra_batch.py``: the reference intra predictor
(ref: src/xvc_common_lib/intra_prediction.cc:425-558) as used by the
encoder's SATD mode pre-pass (ref: src/xvc_enc_lib/intra_search.cc:
188-303).

For an NxN block every angular mode is a 2-tap interpolation of the
(possibly projected, possibly [1 2 1]-filtered) reference line, i.e. an
affine map of the 4N+1 reference samples.  Per block size one integer
weight tensor W[mode, N*N, 2*(4N+1)], whose columns run over [top, left,
filtered_top, filtered_left], turns the prediction of all 65 angular
modes for a batch of B blocks into one product

    num[B, mode, N*N] = ref[B, 2R] @ W^T,   pred = (num + 16) >> 5

in float32 (``torch.matmul``: the JAX version leaves this product to XLA
too).  Every numerator stays below 2^24, so float32 accumulation is exact
as long as TF32 is off, which ``predict_all_modes`` asserts; the final
floor-shift is a power-of-two scaling (exact in f32) followed by floor.
Planar and DC are computed directly.  Edge post-filters (exact-hor/ver
and |angle|<=1, luma blocks <=16) are masked row/column updates, stored
in place in the JAX version's order.

Only the default (unrestricted, 67-mode) configuration is supported.
"""
import functools

import numpy as np
import torch

from ..ops import intra_pred as ip

EXT_HOR = 18
EXT_VER = 50
EXT_DIAG = 34
NUM_MODES_EXT = 67
# use_filtered_ref_samples thresholds (ref: intra_prediction.cc:342-363)
_THR_EXT = (0, 20, 20, 14, 2, 0, 20, 0)


def _use_filtered(n, mode):
    size = (n.bit_length() - 1 + n.bit_length() - 1) >> 1
    mode_diff = min(abs(mode - EXT_HOR), abs(mode - EXT_VER))
    return mode_diff > _THR_EXT[size]


def _angular_weights(n, mode):
    """Integer tap weights of one angular mode over [top(2n+1), left(2n)].

    Mirrors ref: intra_prediction.cc:425-558 (AngularPred): horizontal
    modes run in the flipped frame (left as top) with the output
    transposed; negative angles project left samples onto the main
    reference line via the inverse-angle table.
    """
    is_hor = mode < EXT_DIAG
    angle_offset = (EXT_HOR - mode) if is_hor else (mode - EXT_VER)
    angle = ip.ANGLE_TABLE_EXT[16 + angle_offset]

    def t_src(i):  # working-frame top sample i -> (plane, index)
        if is_hor:
            return (0, 0) if i == 0 else (1, i - 1)
        return (0, i)

    def l_src(j):  # working-frame left sample j -> (plane, index)
        return (0, 1 + j) if is_hor else (1, j)

    if angle < 0:
        num_projected = -((n * angle) >> 5) - 1
        base = num_projected + 1
        ref_line = [None] * (base + 2 * n + 1)
        for i in range(n + 1):
            ref_line[base - 1 + i] = t_src(i)
        inv_angle = ip.INV_ANGLE_TABLE_EXT[-angle_offset - 1]
        inv_sum = 128
        for i in range(num_projected):
            inv_sum += inv_angle
            ref_line[base - 2 - i] = l_src((inv_sum >> 8) - 1)
        ref_off = base
    else:
        ref_line = [t_src(i) for i in range(2 * n + 1)]
        ref_off = 1

    w = np.zeros((n * n, 4 * n + 1), dtype=np.float32)
    angle_sum = 0
    for y in range(n):
        angle_sum += angle
        off = angle_sum >> 5
        frac = angle_sum & 31
        for x in range(n):
            p = (x * n + y) if is_hor else (y * n + x)
            for pos, wgt in ((ref_off + off + x, 32 - frac),
                             (ref_off + off + x + 1, frac)):
                if wgt:  # frac==0 taps are never read (weight 0)
                    plane, idx = ref_line[pos]
                    w[p, idx if plane == 0 else 2 * n + 1 + idx] += wgt
    return w


@functools.lru_cache(maxsize=None)
def angular_weight_tensor(n):
    """W[65, n*n, 2*(4n+1)] f32 numpy; columns [top, left, ftop, fleft]."""
    r = 4 * n + 1
    out = np.zeros((NUM_MODES_EXT - 2, n * n, 2 * r), dtype=np.float32)
    for mode in range(2, NUM_MODES_EXT):
        w = _angular_weights(n, mode)
        half = r if _use_filtered(n, mode) else 0
        out[mode - 2, :, half:half + r] = w
    return out


def filter_refs(top, left):
    """[1 2 1] reference filter, batched (ref: intra_prediction.cc:850-871).

    top: [B, 2n+1] int32, left: [B, 2n] int32.
    """
    n2 = left.shape[1]
    ftop = torch.cat([
        ((top[:, :1] << 1) + top[:, 1:2] + left[:, :1] + 2) >> 2,
        ((top[:, 1:n2] << 1) + top[:, :n2 - 1] + top[:, 2:n2 + 1] + 2) >> 2,
        top[:, n2:n2 + 1]], dim=1)
    fleft = torch.cat([
        ((left[:, :1] << 1) + top[:, :1] + left[:, 1:2] + 2) >> 2,
        ((left[:, 1:n2 - 1] << 1) + left[:, :n2 - 2] + left[:, 2:n2] + 2)
        >> 2,
        left[:, n2 - 1:n2]], dim=1)
    return ftop, fleft


def _pred_planar(n, top, left):
    """Batched planar (ref: intra_prediction.cc:401-423); refs already
    filtered/unfiltered per mode rule."""
    l2 = n.bit_length() - 1
    above = top[:, 1:1 + n]
    leftv = left[:, :n]
    top_right = top[:, 1 + n:2 + n]
    bottom_left = left[:, n:n + 1]
    shift = 2 * l2 + 1
    offset = 1 << (shift - 1)
    ar = torch.arange(n, dtype=torch.int32, device=top.device)
    y = ar[:, None]
    x = ar[None, :]
    hor = (n - 1 - y)[None] * above[:, None, :] + \
        (y + 1)[None] * bottom_left[:, :, None]
    ver = (n - 1 - x)[None] * leftv[:, :, None] + \
        (x + 1)[None] * top_right[:, :, None]
    return ((hor << l2) + (ver << l2) + offset) >> shift


def _pred_dc(n, top, left, post_filter):
    """Batched DC + post filter (ref: intra_prediction.cc:365-399)."""
    ssum = top[:, 1:1 + n].sum(dim=1, dtype=torch.int32) + \
        left[:, :n].sum(dim=1, dtype=torch.int32)
    # non-negative, so the floor division equals the reference's
    dc = torch.div(ssum + n, 2 * n, rounding_mode="floor")
    out = dc[:, None, None].expand(top.shape[0], n, n).clone()
    if not post_filter:
        return out
    col0 = (left[:, :n] + 3 * dc[:, None] + 2) >> 2
    row0 = (top[:, 1:1 + n] + 3 * dc[:, None] + 2) >> 2
    corner = (top[:, 1] + left[:, 0] + 2 * dc + 2) >> 2
    # stores in the reference's order: the corner overwrites row 0 and
    # column 0
    out[:, :, 0] = col0
    out[:, 0, :] = row0
    out[:, 0, 0] = corner
    return out


def predict_all_modes(n, top, left, weights, bitdepth, post_filter):
    """All-mode batched intra prediction.

    top [B, 2n+1] int32, left [B, 2n] int32, weights [Ma, n*n, 2(4n+1)]
    f32 from ``angular_weight_tensor(n)`` on the tensors' device.
    Returns preds [B, 2 + Ma, n, n] int32 (planar, DC, then the angular
    modes)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("predict_all_modes needs exact float32 products:"
                           " torch.backends.cuda.matmul.allow_tf32 is on")
    b = top.shape[0]
    ma = weights.shape[0]
    maxv = (1 << bitdepth) - 1
    ftop, fleft = filter_refs(top, left)
    ref2 = torch.cat([top, left, ftop, fleft], dim=1).to(torch.float32)
    num = torch.matmul(ref2, weights.reshape(ma * n * n, -1).t())
    preds = torch.empty((b, 2 + ma, n, n), dtype=torch.int32,
                        device=top.device)
    ang = preds[:, 2:]
    ang.copy_(torch.floor((num + 16.0) * (1.0 / 32.0)).view(b, ma, n, n))

    if post_filter:  # luma, n <= 16 (ref: intra_prediction.cc:306-320)
        dtop = (top[:, 1:1 + n] - top[:, :1])
        dleft = (left[:, :n] - top[:, :1])
        # exact vertical / horizontal edge filter (arithmetic shifts of
        # possibly negative differences)
        ang[:, EXT_VER - 2, :, 0] = (top[:, 1:2] + (dleft >> 1)).clamp(
            0, maxv)
        ang[:, EXT_HOR - 2, 0, :] = (left[:, :1] + (dtop >> 1)).clamp(
            0, maxv)
        # |angle| == 1 edge filter (modes 49/51 vertical, 17/19 horizontal)
        for m in (EXT_VER - 1, EXT_VER + 1):
            ang[:, m - 2, :, 0] = (ang[:, m - 2, :, 0] +
                                   (dleft >> 2)).clamp(0, maxv)
        for m in (EXT_HOR - 1, EXT_HOR + 1):
            ang[:, m - 2, 0, :] = (ang[:, m - 2, 0, :] +
                                   (dtop >> 2)).clamp(0, maxv)

    planar_filt = _use_filtered(n, 0)
    preds[:, 0] = _pred_planar(n, ftop if planar_filt else top,
                               fleft if planar_filt else left)
    preds[:, 1] = _pred_dc(n, top, left, post_filter)
    return preds
