"""Hadamard SATD of square blocks (kernel 4).

Port of ``xvc_tpu/tpu/satd.py`` (``satd_square``, the XLA einsum the
encoder's lookahead calls) and of ``xvc_tpu/tpu/pallas_satd.py``
(``satd8_pallas``, the Pallas kernel for 8x8 blocks): the reference SATD
metric (ref: src/xvc_enc_lib/sample_metric.cc Compute8x8Satd /
Compute4x4Satd).  Blocks of n >= 8 are (n/8)^2 tiles of 8x8, each tile's
sum of |H8 D H8| normalised ``(s + 2) >> 2`` before the tiles are added;
n == 4 is one 4x4 Hadamard with ``(s + 1) >> 1``; the shift by
``bitdepth - 8`` comes last.

On the card every entry launches ``kernels/csrc/satd.cu`` (an integer
butterfly, exact in int32) and nothing else; on the CPU it runs
``satd_plain``, the same butterflies as PyTorch tensor operations.
``satd_pred`` is the fused form the transform-RD prepass uses: it takes
the original blocks and all their predictions and forms the difference
in the kernel.  The lookahead and the per-CU pre-pass, which need no
predictions, take ``intra_satd.py`` (one kernel that predicts every mode
on chip and shares this kernel's butterflies, ``csrc/satd.cuh``).
"""
import torch

from .. import kernels

SIZES = (4, 8, 16, 32, 64)


def _hadamard_last(x):
    """Fast Walsh-Hadamard transform along the last axis (a power of
    two), as integer butterflies."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    h = 1
    while h < n:
        x = x.reshape(lead + (n // (2 * h), 2, h))
        a, b = x[..., 0, :], x[..., 1, :]
        x = torch.stack((a + b, a - b), dim=-2)
        h *= 2
    return x.reshape(lead + (n,))


def satd_plain(diff, bitdepth):
    """Plain PyTorch version of ``satd_square`` (same result): diff
    [..., n, n] int32 -> [...] int32."""
    n = diff.shape[-1]
    lead = diff.shape[:-2]
    if n == 4:
        d = diff
    else:
        t = n // 8
        d = diff.reshape(lead + (t, 8, t, 8)).transpose(-3, -2)
    m = _hadamard_last(_hadamard_last(d).transpose(-1, -2))
    s = m.abs().sum(dim=(-1, -2), dtype=torch.int32)
    if n == 4:
        satd = (s + 1) >> 1
    else:
        satd = ((s + 2) >> 2).sum(dim=(-1, -2), dtype=torch.int32)
    return satd >> (bitdepth - 8)


def _check(t, name):
    n = t.shape[-1] if t.dim() >= 2 else 0
    if t.dtype != torch.int32 or t.dim() < 2 or t.shape[-2] != n or \
            n not in SIZES:
        raise ValueError("%s must be int32 [..., n, n] with n in %r, got %s "
                         "%r" % (name, SIZES, t.dtype, tuple(t.shape)))
    return n


def _launch(src, orig, modes, bitdepth):
    """SATD of every n x n block of ``src`` on the card: of src itself,
    or of orig[b] - src[b, m] when ``orig`` is given."""
    from ..kernels import build
    n = src.shape[-1]
    src = src.contiguous()
    out = torch.empty(src.shape[:-2], dtype=torch.int32, device=src.device)
    ptrs = [src, out]
    if orig is not None:
        orig = orig.contiguous()
        ptrs.append(orig)
    for t in ptrs:
        if t.data_ptr() % 16:
            raise ValueError("satd: tensor storage is not 16-byte aligned")
    if out.numel():
        rc = build.lib().xvc_satd(
            build.ptr(src), build.ptr(orig) if orig is not None else None,
            out.numel(), modes, n, bitdepth, build.ptr(out),
            build.stream_of(src))
        build.check(rc, "satd")
        kernels.count_launch("satd")
    return out


def satd_square(diff, bitdepth):
    """SATD of square blocks, batched over leading dims.

    diff: [..., n, n] int32 sample differences with n in {4, 8, 16, 32,
    64} (|diff| < 2^14).  Returns [...] int32."""
    _check(diff, "diff")
    if not kernels.on_cuda(diff):
        return satd_plain(diff, bitdepth)
    return _launch(diff, None, 1, bitdepth)


def satd8(diff, bitdepth=8):
    """SATD of a batch of 8x8 difference blocks: diff [B, 8, 8] int32 ->
    [B] int32 (the signature of the TPU kernel ``satd8_pallas``)."""
    if diff.dim() != 3 or diff.shape[1:] != (8, 8):
        raise ValueError("satd8 takes [B, 8, 8], got %r"
                         % (tuple(diff.shape),))
    return satd_square(diff, bitdepth)


def satd_pred(orig, preds, bitdepth):
    """SATD of ``orig[:, None] - preds``: orig [B, n, n], preds
    [B, M, n, n] int32 -> [B, M] int32, without forming the difference
    in memory on the card."""
    n = _check(orig, "orig")
    if _check(preds, "preds") != n or orig.dim() != 3 or preds.dim() != 4 \
            or preds.shape[0] != orig.shape[0]:
        raise ValueError("satd_pred: orig %r and preds %r disagree"
                         % (tuple(orig.shape), tuple(preds.shape)))
    if not kernels.on_cuda(orig, preds):
        return satd_plain(orig[:, None] - preds, bitdepth)
    return _launch(preds, orig, preds.shape[1], bitdepth)
