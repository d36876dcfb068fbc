"""The picture kernels' share of their roofline, in %: the least time the
bytes that the window's pictures need could take at the card's HBM rate,
over the device time that the kernels took in the traced window.

The kernels: ``itx_picture_kernel`` (itx.cu), ``mc_picture_kernel``
(mc.cu), ``luma_walk`` and ``chroma_edges`` (deblock.cu), ``derive_edges``
and ``paint_cu_map`` (deblock_edges.cu), found by name in the trace.  The
bytes are the reference's count (``reference/work.py``) for an average
picture of the stream, times the pictures the window's trace holds: one
``itx_picture_kernel`` a picture.  The scans have a chain estimate and no
bound; they stay out, and their time shows in the breakdown.
"""
from ..peaks import HBM_BYTES_PER_S

KERNELS = {"itx_picture_kernel": ("itx",), "mc_picture_kernel": ("mc",),
           "luma_walk": ("deblock_luma",), "chroma_edges": ("deblock_chroma",),
           "derive_edges": ("deblock_edges",), "paint_cu_map": ()}
PER_PICTURE = "itx_picture_kernel"


def read(run):
    if run.trace is None or not run.work:
        return None
    by_name = run.trace.device_seconds_by_name()
    device_s = sum(by_name.get(k, 0.0) for k in KERNELS)
    pictures = run.trace.launches(PER_PICTURE)
    if device_s <= 0 or pictures == 0:
        return None
    nbytes = sum(run.work[kind] for kinds in KERNELS.values()
                 for kind in kinds) * pictures
    return 100.0 * nbytes / HBM_BYTES_PER_S / device_s
