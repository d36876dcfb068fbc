"""Whole-frame open-loop intra lookahead on the device.

Port of ``xvc_tpu/tpu/lookahead.py``: all 67-mode SATD cost maps for
every aligned square block of a picture, in one batched device call per
block size, before the encoder's CTU loop starts.

Open-loop means references come from the original picture (classic
encoder lookahead), so candidate ordering can differ from the
closed-loop reference encoder.

The block and reference extraction is host Python, one
``compute_ref_samples`` call per block as in the JAX package; it takes
far longer than the device step and is timed apart from it (``stats``).
"""
import time

import numpy as np
import torch

from ..engine import resolve_device
from . import analysis as an

SIZES = (4, 8, 16, 32)

# Open-loop block/reference extraction for an n-grid: the same walk as
# analysis.extract_blocks (the JAX package keeps two copies of it).
_extract_grid = an.extract_blocks


def frame_intra_lookahead(luma_plane, bitdepth, restr, sizes=SIZES,
                          mode_step=1, device=None, stats=None):
    """Returns {n: costs[bh, bw, M] int32 numpy} open-loop SATD maps for
    the whole picture, one device call per size, on ``device`` (the card
    when None).

    Only fully covered blocks get a map entry (floor grid); sizes larger
    than the picture are left out.  If ``stats`` is a dict it receives
    {n: {"extract_s", "device_s", "blocks"}}: the seconds of the host
    extraction and of the device step (upload, compute, download) of
    each size."""
    dev = resolve_device(device)
    frame = np.ascontiguousarray(luma_plane, dtype=np.int32)
    h, w = frame.shape
    maps = {}
    for n in sizes:
        if h < n or w < n:
            continue
        t0 = time.perf_counter()
        orig, top, left = _extract_grid(frame, n, bitdepth, restr)
        t1 = time.perf_counter()
        fn = an.make_intra_satd_fn(n, bitdepth, mode_step)
        costs = fn(*(torch.from_numpy(a).to(dev)
                     for a in (orig, top, left))).cpu().numpy()
        t2 = time.perf_counter()
        maps[n] = costs.reshape(h // n, w // n, -1)
        if stats is not None:
            stats[n] = {"extract_s": t1 - t0, "device_s": t2 - t1,
                        "blocks": orig.shape[0]}
    return maps
