"""Carry reference state across: numpy arrays of the JAX package ->
tensors of this package.

``from_reference`` takes the JAX package's constant tensors and a frame
store's planes, handed over as numpy arrays (this package imports
nothing of ``xvc_tpu``; the caller does the ``np.asarray``), and returns
them as tensors with the dtype and layout this package's functions
expect, so that both packages can compute from the same state.  Keys are
``"<kind>/<name>"``; the kind decides the conversion:

=================  ====================================  ================
kind               reference array                       tensor
=================  ====================================  ================
``angular``        ``intra_batch.angular_weight_tensor    float32, same
                   (n)`` [65, n*n, 2(4n+1)] f32           layout
``hadamard``       ``satd._hadamard_f32(n)`` [n, n] f32   int32 [n, n]
                   (entries +-1)
``itx``            a basis matrix of ``dsp._matrices``    int32 [in, out]
                   [size, size] int
``mc_taps``        ``inter_mc.*_FILTER*`` [phases, taps]  int32
``plane``          a frame store's padded plane           int16 [Hp, Wp]
                   [Hp, Wp] int
=================  ====================================  ================
"""
import numpy as np
import torch

from .engine import resolve_device

# kind -> (tensor dtype, number of dimensions)
_KINDS = {
    "angular": (torch.float32, 3),
    "hadamard": (torch.int32, 2),
    "itx": (torch.int32, 2),
    "mc_taps": (torch.int32, 2),
    "plane": (torch.int16, 2),
}


def from_reference(arrays, device=None):
    """{"kind/name": numpy array} -> {"kind/name": tensor on ``device``}
    (the card when None).  Raises on an unknown kind, a wrong rank, or
    values the target type cannot hold exactly."""
    dev = resolve_device(device)
    out = {}
    for key, arr in arrays.items():
        kind = key.split("/", 1)[0]
        if kind not in _KINDS:
            raise KeyError("unknown kind %r in %r (one of %s)"
                           % (kind, key, ", ".join(sorted(_KINDS))))
        dtype, ndim = _KINDS[kind]
        arr = np.asarray(arr)
        if arr.ndim != ndim:
            raise ValueError("%s: expected %d dimensions, got shape %r"
                             % (key, ndim, arr.shape))
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(dtype)
        if not np.array_equal(t.numpy(), arr):
            raise ValueError("%s: values do not fit %s exactly"
                             % (key, dtype))
        out[key] = t.to(dev)
    return out
