"""Exact integer DSP of the device decode path, in plain PyTorch.

Port of ``xvc_tpu/tpu/dsp.py``: dequantization and the inverse
transform (``_itx_core``), the batched sub-pel MC core
(``_mc_core_builder``), the bi-prediction average, the packed
host/device transfers (``DevBatch``, ``gather_flat``) and the copies the
span table counts (``upload``, ``download``, ``move``).  Every function is
exact int32 arithmetic with the reference's int16 wrap points, so the
result equals the JAX version bit for bit.  These are the plain versions
the CUDA kernels (``gpu/mc.py``, ``gpu/itx.py``) are held against.

Differences from JAX that the port must undo:
  - ``lax.dynamic_slice`` counts a negative start from the end and
    clamps an out-of-range one; torch slicing truncates.  Window origins
    go through ``ds_start``.
  - CUDA PyTorch has no int32 matrix product, so the transform is an
    int64 broadcast-multiply-sum (exact: the terms are bounded, see
    ``kernels/csrc/itx.cu``).
  - int32 overflow is undefined in C++; where the reference wraps (the
    dequant product) the sum is taken in int64 and wrapped explicitly.
"""
import functools

import numpy as np
import torch

from .. import constants as k
from .. import profiling
from ..codec import inter_mc as mc
from ..ops import transform as tx

_HIGH_PREC_SHIFT = 2


def _clip16(x):
    return x.clamp(k.INT16_MIN, k.INT16_MAX)


def _wrap16(x):
    """int16 wrap-around (the reference's short cast)."""
    return x.to(torch.int16).to(torch.int32)


def ds_start(v, dim, size):
    """A window start as lax.dynamic_slice takes it: a negative start
    counts from the end (as in NumPy), then the start is clamped to
    [0, dim - size].  Works on ints and integer tensors."""
    if isinstance(v, torch.Tensor):
        return torch.where(v < 0, v + dim, v).clamp(0, dim - size)
    return min(max(v + dim if v < 0 else v, 0), dim - size)


def _wrap32(x):
    """int64 tensor -> int32 with two's-complement wrap-around."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


# ---------------------------------------------------------------------------
# Dequant + inverse transform
# ---------------------------------------------------------------------------

def dequant_shift(width, height, bitdepth):
    """The dequant shift of ``_dequant_expr`` (negative: shift left)."""
    wl2, hl2 = width.bit_length() - 1, height.bit_length() - 1
    bias = ((wl2 + hl2) % 2) != 0
    transform_shift = k.MAX_TR_DYNAMIC_RANGE - bitdepth - ((wl2 + hl2) >> 1)
    return 6 - transform_shift + (8 if bias else 0)


def _dequant_expr(c, scale, width, height, bitdepth):
    """Exact dequant, wrapping like the reference's C int math
    (ref: quantize.cc:94-125) up to 14 bit; above, where the product of a
    level and the scale passes 2^31, in 64 bits as the JAX package's host
    dequantization and its encoder's reconstruction take it
    (``ops/quant.dequant_np``).  c (B, h, w) int, scale (B,) -> int32."""
    shift = dequant_shift(width, height, bitdepth)
    prod = c.to(torch.int64) * scale.to(torch.int64)[:, None, None]
    wrap = _wrap32 if bitdepth <= 14 else (lambda x: x)
    if shift > 0:
        out = wrap(prod + (1 << (shift - 1))) >> shift
    else:
        out = wrap(prod << (-shift))
    return _clip16(out)


@functools.lru_cache(maxsize=None)
def _matrices(txv, txh, height, width, high_precision):
    hp1 = high_precision or height >= 64 or height == 2
    hp2 = high_precision or width >= 64 or width == 2
    m1, adj1 = tx.get_matrix(k.TransformType(txv), height, hp1)
    m2, adj2 = tx.get_matrix(k.TransformType(txh), width, hp2)
    shift1 = 7 + (_HIGH_PREC_SHIFT if hp1 else 0) + adj1
    shift2 = 20 + (_HIGH_PREC_SHIFT if hp2 else 0) + adj2  # minus bitdepth
    return (m1.astype(np.int32), m2.astype(np.int32), shift1, shift2)


def skip_params(width, height, bitdepth):
    """(shift, scale) of the transform-skip residual."""
    wl2, hl2 = width.bit_length() - 1, height.bit_length() - 1
    bias = ((wl2 + hl2) % 2) != 0
    tshift = k.MAX_TR_DYNAMIC_RANGE - bitdepth - ((wl2 + hl2) >> 1)
    return tshift + (7 if bias else 0), (181 if bias else 1)


def dc_only_residual(dq0, bitdepth):
    """The residual sample of a DC-only block of the DCT-2 family from its
    dequantized DC coefficient (ref: transform.cc, the DC-only inverse):
    ``((dq0 + 1) >> 1) + 2^(shift-1)) >> shift`` with ``shift = 14 -
    bitdepth``.  At 14 bit (shift 0) the native code, which reconstructs
    every stream of both packages' encoders, adds ``1 << -1`` in int64
    arithmetic, which the CPU takes as ``1 << 63`` and which leaves the
    low 32 bits (the value kept) unchanged: ``(dq0 + 1) >> 1``.  Above 14
    bit the shift counts are negative, taken modulo 64, and the result is
    0 for every block; the streams' checksums record that
    (``xvcn_recon_dist``, ``xvcn_pic.inc``; ROADMAP queue 3 F5)."""
    shift = 14 - bitdepth
    if shift > 0:
        return (((dq0 + 1) >> 1) + (1 << (shift - 1))) >> shift
    if shift == 0:
        return (dq0 + 1) >> 1
    return torch.zeros_like(dq0)


def _round_shift(x, s):
    """(x + 2^(s-1)) >> s for int64 x and per-block shifts s (B,)."""
    s = s.to(torch.int64)[:, None, None]
    return (x + torch.bitwise_left_shift(torch.ones_like(s), s - 1)) >> s


def transform_2d(dq, m1, m2, s1, s2, in1, cols):
    """The two transform passes with per-block bases: m1 (B, in1, h)
    indexed [j][i], m2 (B, cols, w) indexed [j][k], shifts s1/s2 (B,).
    int64 broadcast-multiply-sum, one zero-out row or column at a time
    (the einsums 'bji,bjk->bik' and 'bij,bjk->bik')."""
    dq = dq.to(torch.int64)
    m1 = m1.to(torch.int64)
    m2 = m2.to(torch.int64)
    acc = m1[:, 0, :, None] * dq[:, 0, None, :cols]
    for j in range(1, in1):
        acc = acc + m1[:, j, :, None] * dq[:, j, None, :cols]
    t = _clip16(_round_shift(acc, s1))
    acc = t[:, :, 0, None] * m2[:, 0, None, :]
    for j in range(1, cols):
        acc = acc + t[:, :, j, None] * m2[:, j, None, :]
    return _clip16(_round_shift(acc, s2)).to(torch.int32)


def _itx_core(coeff, scale, width, height, bitdepth, txv, txh, variant,
              high_precision):
    """Fused dequant + inverse transform of (B, h, w) coefficient blocks
    (ref: transform.cc inverse paths).  variant: 'gen' | 'dst4' | 'dc' |
    'skip'.  Returns int16 (int32 for 'skip')."""
    b = coeff.shape[0]
    dq = _dequant_expr(coeff, scale, width, height, bitdepth)
    if variant == "skip":
        shift, sc = skip_params(width, height, bitdepth)
        if shift > 0:
            return (dq * sc + (1 << (shift - 1))) >> shift
        return (dq * sc) << (-shift)
    if variant == "dc":
        return dc_only_residual(dq[:, 0, 0], bitdepth)[:, None, None] \
            .expand(b, height, width).to(torch.int16).contiguous()
    dev = coeff.device
    if variant == "dst4":
        m = torch.as_tensor(tx._DST4.astype(np.int32), device=dev)
        m1 = m2 = m.expand(b, 4, 4)
        s1, s2, in1, cols = 7, 20 - bitdepth, 4, 4
    else:
        mat1, mat2, s1, s2 = _matrices(txv, txh, height, width,
                                       high_precision)
        s2 -= bitdepth
        in1 = min(height, k.TRANSFORM_ZERO_OUT_MIN_SIZE)
        cols = min(width, k.TRANSFORM_ZERO_OUT_MIN_SIZE)
        m1 = torch.as_tensor(mat1[:in1, :], device=dev).expand(b, in1,
                                                                height)
        m2 = torch.as_tensor(mat2[:cols, :], device=dev).expand(b, cols,
                                                                width)
    full = lambda v: torch.full((b,), v, dtype=torch.int32, device=dev)
    return transform_2d(dq, m1, m2, full(s1), full(s2), in1,
                        cols).to(torch.int16)


# ---------------------------------------------------------------------------
# Motion compensation
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _filter_table(luma, high_prec):
    if luma:
        t = mc.LUMA_FILTER_HIGH_PREC if high_prec else mc.LUMA_FILTER
    else:
        t = mc.CHROMA_FILTER_HIGH_PREC if high_prec else mc.CHROMA_FILTER
    return np.ascontiguousarray(t, np.int32)


def _mc_core_builder(width, height, luma, bitdepth, high_prec, short_out):
    """Batched sub-pel MC core (ref: inter_prediction.cc:1138-1378).

    Returns compute(planes int16 (R,Hp,Wp), ref_idx, y0, x0, fx, fy)
    -> (B, height, width) int16.  y0/x0 are padded-plane coords of the
    (taps-1)-extended window origin; they (and ref_idx) are taken as
    lax.dynamic_slice takes a start (``ds_start``).  All four fractional
    cases are computed and selected per block, with the reference's wrap
    points."""
    taps = mc.NUM_TAPS_LUMA if luma else mc.NUM_TAPS_CHROMA
    table_np = _filter_table(luma, high_prec)
    half = taps // 2 - 1
    wh, ww = height + taps - 1, width + taps - 1
    max_val = (1 << bitdepth) - 1
    prec_diff = mc.INTERNAL_PRECISION - bitdepth  # -1 at 15 bit
    off = mc.INTERNAL_OFFSET

    def conv_h(src, f):
        out = f[:, 0, None, None] * src[:, :, 0:width]
        for i in range(1, taps):
            out = out + f[:, i, None, None] * src[:, :, i:i + width]
        return out

    def conv_v(src, f):
        out = f[:, 0, None, None] * src[:, 0:height, :]
        for i in range(1, taps):
            out = out + f[:, i, None, None] * src[:, i:i + height, :]
        return out

    def fn(planes, ref_idx, y0, x0, fx, fy):
        dev = planes.device
        R, Hp, Wp = planes.shape
        r = ds_start(ref_idx.long(), R, 1)
        y = ds_start(y0.long(), Hp, wh)
        x = ds_start(x0.long(), Wp, ww)
        rows = y[:, None] + torch.arange(wh, device=dev)[None, :]
        cols = x[:, None] + torch.arange(ww, device=dev)[None, :]
        win = planes[r[:, None, None], rows[:, :, None],
                     cols[:, None, :]].to(torch.int32)
        table = torch.as_tensor(table_np, device=dev)
        nph = table.shape[0]
        f_x = table[fx.long().clamp(0, nph - 1)]
        f_y = table[fy.long().clamp(0, nph - 1)]

        center = win[:, half:half + height, half:half + width]
        if short_out:
            case00 = _wrap16(_wrap16(fullpel_short(center, prec_diff)) - off)
        else:
            case00 = center.clamp(0, max_val)
        ch = conv_h(win[:, half:half + height, :], f_x)
        cv = conv_v(win[:, :, half:half + width], f_y)
        shift1 = mc.FILTER_PRECISION - prec_diff
        offset1 = -(off << shift1)
        temp = _wrap16((conv_h(win, f_x) + offset1) >> shift1)
        if short_out:
            case_h = _wrap16((ch + offset1) >> shift1)
            case_v = _wrap16((cv + offset1) >> shift1)
            case_hv = _wrap16(conv_v(temp, f_y) >> mc.FILTER_PRECISION)
        else:
            fshift = mc.FILTER_PRECISION
            foff = 1 << (fshift - 1)
            case_h = ((ch + foff) >> fshift).clamp(0, max_val)
            case_v = _wrap16((cv + foff) >> fshift).clamp(0, max_val)
            shift2 = mc.FILTER_PRECISION + prec_diff
            offset2 = (off << mc.FILTER_PRECISION) + (1 << (shift2 - 1))
            case_hv = _wrap16((conv_v(temp, f_y) + offset2)
                              >> shift2).clamp(0, max_val)
        zx = (fx == 0)[:, None, None]
        zy = (fy == 0)[:, None, None]
        out = torch.where(zx & zy, case00,
                          torch.where(zy, case_h,
                                      torch.where(zx, case_v, case_hv)))
        return out.to(torch.int16)

    return fn


def fullpel_short(center, prec_diff):
    """A full-pel sample moved to the bi-prediction's 14-bit scale before
    its int16 store: ``center << prec_diff`` (ref: FilterCopyBipred).
    Above 14 bit the count is negative; the native MC of both packages'
    host paths and encoders (``xvcn_mc_unipred``) shifts by it, which
    the CPU takes modulo 32, and the int16 store keeps low bits that are
    0 (numpy's and XLA's shifts by such a count give 0 too): 0."""
    if prec_diff >= 0:
        return center << prec_diff
    return torch.zeros_like(center)


def make_add_avg(width, height, bitdepth):
    """Bi-prediction average of two 14-bit intermediates
    (ref: inter_prediction.cc AddAvg)."""
    shift = max(2, mc.INTERNAL_PRECISION - bitdepth) + 1
    offset = (1 << (shift - 1)) + 2 * mc.INTERNAL_OFFSET
    max_val = (1 << bitdepth) - 1

    def fn(l0, l1):
        return ((l0.to(torch.int32) + l1.to(torch.int32) + offset)
                >> shift).clamp(0, max_val)

    return fn


def pad_pow2(n):
    """Round a batch size up to a power of two (the JAX compile-cache
    bound; kept so both packages build identical job groups)."""
    p = 1
    while p < n:
        p <<= 1
    return p


# ---------------------------------------------------------------------------
# Transfers: one upload per dtype, one download
# ---------------------------------------------------------------------------

def upload(host, device, non_blocking=False):
    """The CPU tensor ``host`` on ``device``: one host-to-device copy,
    counted in the span table's ``xfer.htod`` rows (on the CPU device too,
    where it is no copy)."""
    out = host.to(device, non_blocking=non_blocking)
    profiling.count("xfer.htod", 1, host.numel() * host.element_size())
    return out


def download(t):
    """The tensor ``t`` as a CPU tensor: one device-to-host copy, counted
    in the span table's ``xfer.dtoh`` rows (on the CPU device too, where
    it is no copy).  While spans are on, the host's wait for the card is
    span ``device.wait`` (``profiling.wait_device``)."""
    profiling.wait_device(t)
    host = t.cpu()
    profiling.count("xfer.dtoh", 1, host.numel() * host.element_size())
    return host


def move(t, device, copy=False):
    """The tensor ``t`` of one mesh slot on ``device`` for another slot,
    counted in the span table's ``xfer.move`` rows."""
    out = t.to(device, copy=copy)
    profiling.count("xfer.move", 1, t.numel() * t.element_size())
    return out


class DevBatch:
    """Pack many host arrays into one host-to-device copy per dtype; the
    device side hands out views of the packed buffer."""

    def __init__(self):
        self._host = {"int16": [], "int32": []}
        self._sizes = {"int16": 0, "int32": 0}
        self._dev = {}

    def add(self, arr):
        key = "int16" if arr.dtype == np.int16 else "int32"
        off = self._sizes[key]
        flat = np.ascontiguousarray(arr).reshape(-1)
        self._host[key].append(flat if arr.dtype.name == key
                               else flat.astype(key))
        self._sizes[key] += flat.size
        return (key, off, tuple(arr.shape), flat.size)

    def upload(self, device):
        for key, chunks in self._host.items():
            if not chunks:
                continue
            flat = torch.from_numpy(np.concatenate(chunks))
            if device.type == "cuda":
                flat = flat.pin_memory()
            self._dev[key] = upload(flat, device, non_blocking=True)
        self._host = {"int16": [], "int32": []}

    def get(self, handle):
        """The uploaded array of ``handle`` (a view; never clamped: a
        slice that would run past the buffer is an error)."""
        key, off, shape, size = handle
        buf = self._dev[key]
        if off + size > buf.numel():
            raise IndexError("DevBatch slice [%d, %d) past %d" %
                             (off, off + size, buf.numel()))
        return buf[off:off + size].view(shape)


def gather_flat(outs):
    """Concatenate device tensors of one dtype and download once.
    Returns (numpy flat array, [(offset, shape)]) aligned with outs."""
    offs = []
    pos = 0
    for o in outs:
        offs.append((pos, tuple(o.shape)))
        pos += o.numel()
    if not outs:
        return np.zeros((0,)), offs
    host = download(torch.cat([o.reshape(-1) for o in outs])).numpy()
    return host, offs
