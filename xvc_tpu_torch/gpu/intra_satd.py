"""All-mode intra SATD of square blocks (kernel ``intra_satd``).

Port of the device step of ``xvc_tpu/tpu/analysis.py``
(``_intra_satd_step``): every intra mode of each n x n block predicted
from its reference lines, and the Hadamard SATD of ``orig - pred`` of
each mode (ref: src/xvc_enc_lib/intra_search.cc:188-303
DetermineSlowIntraModes).  The modes come in the JAX step's order:
planar, DC, then the angular modes ``2, 2 + s, 2 + 2s, ...`` for
``mode_step`` s; with s > 1 no post filter applies (a cheap upper-bound
cost subset for the split DP).

On the card ``intra_satd`` launches ``kernels/csrc/intra_satd.cu``
(``xvc_intra_satd``) and nothing else: the kernel predicts every mode on
chip, two integer taps of the mode's projected reference line a sample,
so no weight tensor is built and the predictions never reach memory.  On
the CPU it runs ``intra_satd_plain``: the batched predictor of
``intra_batch.py`` (a float32 product with the tap-weight tensor) and
``satd.satd_plain``.

The transform-RD prepass (``txrd_prepass._txrd_step``) needs the
predictions themselves, so it keeps ``intra_batch.predict_all_modes`` and
``satd.satd_pred`` (``satd.cu``) on the card.
"""
import functools

import numpy as np
import torch

from .. import kernels
from . import intra_batch as ib
from . import satd as satd_mod

SIZES = (4, 8, 16, 32, 64)


def num_modes(mode_step):
    """M: planar, DC and every ``mode_step``-th of the 65 angular modes."""
    return 2 + -(-(ib.NUM_MODES_EXT - 2) // mode_step)


@functools.lru_cache(maxsize=None)
def _cpu_weights(n, mode_step):
    return torch.from_numpy(np.ascontiguousarray(
        ib.angular_weight_tensor(n)[::mode_step]))


def weights_on(n, mode_step, device):
    """``angular_weight_tensor(n)[::mode_step]`` on ``device``: the plain
    version's tap weights.  Built once on the CPU (cached); any other
    device gets a copy at each call.  The card's path needs none: the
    kernel computes every tap itself (the transform-RD prepass, which
    predicts with them on the card, caches its copy with its other
    tables)."""
    return _cpu_weights(n, mode_step).to(device)


def intra_satd_plain(orig, top, left, n, bitdepth, mode_step):
    """Plain PyTorch version of the kernel, on the tensors' device:
    ``intra_batch.predict_all_modes`` then ``satd.satd_plain``."""
    weights = weights_on(n, mode_step, orig.device)
    preds = ib.predict_all_modes(n, top, left, weights, bitdepth,
                                 n <= 16 and mode_step == 1)
    return satd_mod.satd_plain(orig[:, None] - preds, bitdepth)


def packed_size(n):
    """int32 entries of one packed block: orig, top and left."""
    return n * n + 4 * n + 1


def pack_block(orig, top, left, out):
    """One block's orig [n, n], top [2n+1] and left [2n] into the numpy
    int32 array ``out`` [packed_size(n)], in that order."""
    n = orig.shape[0]
    out[:n * n] = orig.reshape(-1)
    out[n * n:n * n + 2 * n + 1] = top
    out[n * n + 2 * n + 1:] = left


def block_views(packed, n):
    """(orig [1, n, n], top [1, 2n+1], left [1, 2n]): views of a packed
    block tensor, the arguments of ``intra_satd`` with B = 1."""
    return (packed[:n * n].view(1, n, n),
            packed[n * n:n * n + 2 * n + 1][None],
            packed[n * n + 2 * n + 1:][None])


def synthetic_inputs(rng, blocks, n, bitdepth):
    """numpy int32 (orig [B, n, n], top [B, 2n+1], left [B, 2n]) from the
    numpy RandomState ``rng``: the first half of the blocks with random
    lines, the second with sorted ones (smooth edges, where the filtered
    and the plain lines differ little), the extremes 0 and 2^bitdepth - 1
    in the first two.  The inputs of the tests and of chip_smoke.py."""
    top_v = 1 << bitdepth
    orig = rng.randint(0, top_v, (blocks, n, n)).astype(np.int32)
    top = rng.randint(0, top_v, (blocks, 2 * n + 1)).astype(np.int32)
    left = rng.randint(0, top_v, (blocks, 2 * n)).astype(np.int32)
    half = blocks // 2
    top[half:] = np.sort(top[half:], axis=1)
    left[half:] = np.sort(left[half:], axis=1)[:, ::-1]
    top[0, 0], left[0, 0], orig[0, 0, 0] = top_v - 1, 0, top_v - 1
    if blocks > 1:
        top[1, 1], left[1, 1], orig[1, -1, -1] = 0, top_v - 1, 0
    return orig, top, left


def _check(orig, top, left, n, bitdepth, mode_step):
    b = orig.shape[0] if orig.dim() == 3 else -1
    shapes = ((orig, (b, n, n)), (top, (b, 2 * n + 1)), (left, (b, 2 * n)))
    if n not in SIZES or b < 0 or any(
            t.dtype != torch.int32 or tuple(t.shape) != s
            for t, s in shapes):
        raise ValueError(
            "intra_satd takes int32 orig [B, n, n], top [B, 2n+1] and left "
            "[B, 2n] with n in %r; got n=%r, %s" % (
                SIZES, n, ", ".join("%s %r" % (t.dtype, tuple(t.shape))
                                    for t, _ in shapes)))
    if not 8 <= bitdepth <= 16 or mode_step < 1:
        raise ValueError("intra_satd: bitdepth %r (8 to 16) or mode_step %r "
                         "(1 or more) out of range" % (bitdepth, mode_step))


def intra_satd(orig, top, left, n, bitdepth, mode_step=1):
    """SATD of every intra mode of every block: orig [B, n, n], top
    [B, 2n+1], left [B, 2n] int32 -> [B, M] int32 on their device, M =
    ``num_modes(mode_step)`` (67 when mode_step is 1)."""
    _check(orig, top, left, n, bitdepth, mode_step)
    if not kernels.on_cuda(orig, top, left):
        return intra_satd_plain(orig, top, left, n, bitdepth, mode_step)
    from ..kernels import build
    orig, top, left = (t.contiguous() for t in (orig, top, left))
    out = torch.empty((orig.shape[0], num_modes(mode_step)),
                      dtype=torch.int32, device=orig.device)
    if out.numel():
        rc = build.lib().xvc_intra_satd(
            build.ptr(orig), build.ptr(top), build.ptr(left), orig.shape[0],
            n, bitdepth, mode_step, build.ptr(out), build.stream_of(orig))
        build.check(rc, "intra_satd")
        kernels.count_launch("intra_satd")
    return out
