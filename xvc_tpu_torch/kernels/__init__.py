"""Hand-written Hopper kernels and their launch counts.

Sources live in ``csrc/`` and are compiled by ``build.py`` at first use.
Each wrapper (``gpu/mc.py``, ``gpu/itx.py``, ``gpu/deblock.py``,
``gpu/satd.py``, ``gpu/intra_scan.py``, ``gpu/txrd_prepass.py``,
``gpu/resample.py``, ``gpu/me.py``) adds one to its entry of
``LAUNCHES`` where it launches its kernel (``count_launch``, under a
lock: the workers of a threaded decode launch side by side), and nowhere
else, so a run can show that its main path went through the kernels.
``deblock_edges`` counts one call of ``xvc_deblock_edges``, which
enqueues the map paint and the edge derivation back to back;
``resample`` one launch of ``xvc_resample_picture``, both passes of
every plane of a picture; ``me_sad`` one SAD sweep of the motion search
(one prefetch).
"""
import threading

LAUNCHES = {"mc": 0, "itx": 0, "mc_picture": 0, "itx_picture": 0,
            "deblock_edges": 0, "deblock_luma": 0,
            "deblock_chroma": 0, "satd": 0, "intra_satd": 0, "intra_luma": 0,
            "intra_chroma": 0, "txrd": 0, "resample": 0,
            "me_sad": 0}
_LOCK = threading.Lock()


def count_launch(name):
    with _LOCK:
        LAUNCHES[name] += 1


def reset_launches():
    with _LOCK:
        for key in LAUNCHES:
            LAUNCHES[key] = 0


def on_cuda(*tensors):
    """True if every tensor lies on one CUDA device, False if every one
    lies on the CPU (the wrapper then runs the plain PyTorch version).
    Anything else is an error: a kernel is never skipped for a tensor on
    the card."""
    kinds = {t.device for t in tensors}
    if len(kinds) != 1:
        raise ValueError("tensors on several devices: %r" % (kinds,))
    dev = kinds.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError("unsupported device %r" % (dev,))


def require(t, dtype, ndim, name):
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError("%s must be a contiguous %d-d %s tensor, got %s %r"
                         " contiguous=%s" % (name, ndim, dtype, t.dtype,
                                             tuple(t.shape),
                                             t.is_contiguous()))
