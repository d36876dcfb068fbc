"""Frame intra analysis: all-mode SATD cost maps in one device step.

Port of ``xvc_tpu/tpu/analysis.py``, the encoder's intra SATD mode
pre-pass (ref: src/xvc_enc_lib/intra_search.cc:188-303
DetermineSlowIntraModes): instead of looping CU-by-CU and mode-by-mode on
the host, a whole batch of NxN blocks is evaluated against all 67 intra
modes at once (``intra_satd.py``: on the card one kernel that predicts
every mode on chip and sums its SATD; on the CPU the batched predictor of
``intra_batch.py`` and the SATD of ``satd.py``).

The host-side helpers extract blocks and reference lines (open-loop,
against the original frame: the standard encoder look-ahead
formulation); the device step is ``make_intra_satd_fn``.
"""
import numpy as np
import torch

from ..engine import resolve_device
from ..ops import intra_pred as ip
from ..restrictions import Restrictions
from . import intra_satd


def make_intra_satd_fn(n, bitdepth, mode_step=1):
    """Returns fn(orig [B,n,n], top [B,2n+1], left [B,2n]) -> [B,M] int32
    SATD per mode, on the device of its int32 tensor arguments (M=67
    when mode_step == 1, else 2 + ceil(65/mode_step)): on the card one
    ``intra_satd`` launch, on the CPU its plain version.

    mode_step > 1 evaluates planar/DC + every mode_step-th angular (no
    post filter): a cheap upper-bound cost subset."""
    def fn(orig, top, left):
        return intra_satd.intra_satd(orig, top, left, n, bitdepth,
                                     mode_step)

    return fn


def extract_blocks(frame, n, bitdepth, restrictions=None):
    """Host prep: tile a luma frame into NxN blocks + reference lines.

    frame: (H, W) int array; only fully covered blocks are taken.
    Reference samples are taken open-loop from the frame itself with the
    reference codec's availability/padding rules (ref:
    intra_prediction.cc:707-848).  One ``compute_ref_samples`` call per
    block, as in the JAX package.
    Returns (orig [B,n,n], top [B,2n+1], left [B,2n]) int32 numpy.
    """
    restr = restrictions or Restrictions()
    h, w = frame.shape
    bh, bw = h // n, w // n
    orig = np.zeros((bh * bw, n, n), dtype=np.int32)
    top = np.zeros((bh * bw, 2 * n + 1), dtype=np.int32)
    left = np.zeros((bh * bw, 2 * n), dtype=np.int32)
    b = 0
    for by in range(bh):
        for bx in range(bw):
            px, py = bx * n, by * n
            orig[b] = frame[py:py + n, px:px + n]
            has_left = px > 0
            has_above = py > 0
            size_below_left = min(n, h - (py + n)) if has_left else 0
            size_above_right = min(n, w - (px + n)) if has_above else 0
            top[b], left[b] = ip.compute_ref_samples(
                n, n, frame, px, py, has_left, has_above,
                has_left and has_above, size_below_left, size_above_right,
                bitdepth, restr)
            b += 1
    return orig, top, left


def analyze_frame(frame, n=8, bitdepth=8, device=None):
    """Full-frame open-loop intra analysis on ``device`` (the card when
    None).

    Returns dict with per-block mode cost map [B, 67] and best modes [B].
    """
    dev = resolve_device(device)
    orig, top, left = extract_blocks(np.asarray(frame), n, bitdepth)
    fn = make_intra_satd_fn(n, bitdepth)
    costs = fn(*(torch.from_numpy(a).to(dev) for a in (orig, top, left)))
    costs = costs.cpu().numpy()
    return {"costs": costs, "best_mode": costs.argmin(axis=1)}
