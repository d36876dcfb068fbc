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
The pin and mesh branches are those of ``xvc_tpu/tpu/lookahead.py:63-98``.
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

    A thread pinned to a slot (``engine.set_pin_device``: the GOP
    pipeline's picture) runs every size on the slot's device and stream.
    Else, with a mesh installed (``engine.set_mesh``), each size's block
    batch, padded with zero blocks to a multiple of the slot count, is
    sharded over the mesh's slots (``parallel/mesh.py``).  The maps are
    the same either way.  Only fully covered blocks get a map entry
    (floor grid); sizes larger than the picture are left out.  If
    ``stats`` is a dict it receives {n: {"extract_s", "device_s",
    "blocks"}}: the seconds of the host extraction and of the device step
    (upload, compute, download) of each size."""
    from ..engine import mesh_for, pin_for
    from ..parallel import mesh as mesh_mod
    dev = resolve_device(device)
    pin = pin_for(dev)
    mesh = mesh_for(dev) if pin is None else None
    frame = np.ascontiguousarray(luma_plane, dtype=np.int32)
    h, w = frame.shape
    maps = {}
    for n in sizes:
        if h < n or w < n:
            continue
        t0 = time.perf_counter()
        orig, top, left = _extract_grid(frame, n, bitdepth, restr)
        t1 = time.perf_counter()
        b = orig.shape[0]
        if pin is not None:
            fn = an.make_intra_satd_fn(n, bitdepth, mode_step)
            with mesh_mod.placed(pin):
                costs = fn(*(torch.from_numpy(a).to(pin.device)
                             for a in (orig, top, left))).cpu().numpy()
        elif mesh is not None:
            pad = (-b) % mesh.size
            if pad:
                orig, top, left = (
                    np.concatenate([a, np.zeros((pad,) + a.shape[1:],
                                                a.dtype)])
                    for a in (orig, top, left))
            fn = mesh_mod.make_sharded_intra_satd_fn(mesh, n, bitdepth,
                                                     mode_step)
            costs = fn(*(torch.from_numpy(a).to(dev)
                         for a in (orig, top, left))).cpu().numpy()[:b]
        else:
            fn = an.make_intra_satd_fn(n, bitdepth, mode_step)
            costs = fn(*(torch.from_numpy(a).to(dev)
                         for a in (orig, top, left))).cpu().numpy()
        t2 = time.perf_counter()
        maps[n] = costs.reshape(h // n, w // n, -1)
        if stats is not None:
            stats[n] = {"extract_s": t1 - t0, "device_s": t2 - t1,
                        "blocks": b}
    return maps
