"""Intra luma and chroma reconstruction scans: two hand-written kernels
and their plain PyTorch versions.

Port of ``xvc_tpu/tpu/intra_scan.py`` ``make_intra_scan`` and
``make_intra_chroma_scan`` (with LM).  The JAX version is one
``lax.scan`` whose step gathers the reference line from the evolving
plane, predicts (planar / DC / angular with the exact integer semantics
of ref: intra_prediction.cc:365-558,707-871, and LM chroma, :560-686),
adds the residual and writes the block back.

``intra_scan`` and ``intra_chroma_scan`` are the entry points.  For
tensors on the card they launch ``kernels/csrc/intra_scan.cu``
(``xvc_intra_luma_scan`` replaces ``make_intra_scan``,
``xvc_intra_chroma_scan`` replaces ``make_intra_chroma_scan``): one
launch per picture and scan, the metadata read on the card from the
picture's one upload, the LM parameters derived on the card.  What
bounds a scan on this card is neither bytes nor arithmetic but the
chain of leaves whose reference lines read what other leaves wrote, so
the kernel runs the leaves of a plane on the warps of one block, each
warp waiting only for the leaves that wrote what it reads (the
dependency model is ``gpu/scan_deps.py``); metadata outside the
contract that makes this exact runs in decode order on one warp.  The
wrapper allocates the kernel's scratch (the owner map of the canvas's
units, the ticket order, and status words per plane: the schedule taken
and the rows run, which ``last_status`` reads for tests; the decode never
reads it back); a failed launch raises.  For tensors on the CPU they run
the plain versions.

``intra_scan_plain`` and ``intra_chroma_scan_plain`` are the plain
versions the kernels are held against: a host loop over the leaves in
decode order that branches in Python on the host-known metadata.
Everything that depends only on that metadata -- which plane samples
form the reference line, where the padding copies come from, the
reference filter and the prediction taps and weights -- is worked out on
the host in numpy, as index and weight arrays (the JAX code's ``where``
chains mirrored on indices instead of samples), cached by block shape
and mode.  The device does the data-dependent part: one gather of the
reference line per leaf, weighted sums, clipping and the write-back.
Their LM parameters come from four sums that are read back to the host
and derived in Python with the JAX version's int32 semantics
(``derive_lm``).

Window starts are taken as ``lax.dynamic_slice`` takes them
(``dsp.ds_start`` here, ``ds_start`` in ``csrc/intra_pred.cuh``).
"""
import functools

import numpy as np
import torch

from .. import kernels
from ..ops import intra_pred as ip
from .dsp import ds_start

# Canvas and metadata layout (the JAX module's, so both packages build
# the same scan inputs)
PAD_TL = 8      # plane padding top/left (ref line reads at -1)
PAD_BR = 200    # right/bottom (64x64 window + 128-long ref line reads)
LINE = 320      # >= 3*64 + 2*64 (the availability line buffer)
RLEN = 256      # >= base(65) + 129 (projected angular reference line)

# luma metadata columns
M_PX, M_PY, M_W, M_H, M_MODE, M_HAS_L, M_HAS_A, M_HAS_AL, M_SBL, \
    M_SAR, M_ACTIVE = range(11)
META_COLS = 11
# chroma metadata columns
C_PLANE, C_PX, C_PY, C_W, C_H, C_MODE, C_IS_LM, C_HAS_L, C_HAS_A, \
    C_HAS_AL, C_SBL, C_SAR, C_ACTIVE = range(13)
CMETA_COLS = 13

__all__ = ["intra_scan", "intra_chroma_scan", "intra_scan_plain",
           "intra_chroma_scan_plain", "PAD_TL", "PAD_BR", "META_COLS",
           "CMETA_COLS", "last_status", "PARALLEL", "ORDERED"]

# The status words the scan kernels write per plane: schedule (PARALLEL /
# ORDERED), rows run, breach flags (1: a unit written by two rows, 2: a
# row reads a unit a later row writes, 4: more rows than the done bits
# hold), the warps of the block, and 1 where the tickets went in
# wavefront order (0: decode order).
PARALLEL, ORDERED = 1, 2
STATUS_WORDS = 5
# the scratch of the last launch of each kernel (``last_status`` reads its
# status words)
LAST_SCRATCH = {"intra_luma": None, "intra_chroma": None}


def last_status(name):
    """The status words of the last launch of kernel ``name``
    ("intra_luma" / "intra_chroma"), (planes, STATUS_WORDS) int32 on the
    card: read them after a synchronise."""
    scratch = LAST_SCRATCH[name]
    planes = 1 if name == "intra_luma" else 2
    return scratch[:planes * STATUS_WORDS].view(planes, STATUS_WORDS)


HOR, VER, DIAG = 18, 50, 34
_ANGLE = np.asarray(ip.ANGLE_TABLE_EXT, np.int64)
_INV_ANGLE = np.asarray(ip.INV_ANGLE_TABLE_EXT, np.int64)
_THR_EXT = (0, 20, 20, 14, 2, 0, 20, 0)

# Reference space: the 257 samples top[0..128] then left[0..127].
NREF = 257


def _T(j):
    return np.asarray(j, np.int64)


def _L(j):
    return 129 + np.asarray(j, np.int64)


# Codes of the samples a reference line is built from: colv[i] (the
# column left of the block, 128 rows), rowv[i] (the row above, 130
# columns) and the constant 1 << (bitdepth - 1).
_COL, _ROW, _DC = 0, 128, 258


@functools.lru_cache(maxsize=None)
def _ref_codes(w, h, has_l, has_a, has_al, sbl, sar):
    """compute_ref_samples (ref: intra_prediction.cc:707-848) on source
    codes: the (257,) code of every top/left sample.  Step for step the
    masked gathers of the JAX ref_line, applied to indices."""
    jl = np.arange(LINE)
    ls = w + h
    tls = w
    base = ls + tls
    line = np.full(LINE, _DC, np.int64)
    i_left = ls - 1 - jl
    lv_real = _COL + np.clip(i_left, 0, 127)
    pad_v = _COL + np.clip(h + sbl - 1, 0, 127)
    lv = np.where(i_left < h + sbl, lv_real, pad_v)
    if has_l:
        line = np.where(jl < ls, lv, line)
    if has_al:
        line = np.where((jl >= ls) & (jl < ls + tls), _ROW + 0, line)
    tv = _ROW + np.clip(jl - base + 1, 0, 129)
    if has_a:
        line = np.where((jl >= base) & (jl < base + w), tv, line)
    ar_i = jl - (base + w)
    ar_real = _ROW + np.clip(1 + w + ar_i, 0, 129)
    ar_pad = _ROW + np.clip(w + sar, 0, 129)
    arv = np.where(ar_i < sar, ar_real, ar_pad)
    if has_a and sar > 0:
        line = np.where((jl >= base + w) & (jl < base + w + h), arv, line)

    def at(idx):
        return line[np.clip(idx, 0, LINE - 1)]

    # default directional padding (disable_intra_ref_padding == 0)
    if has_l:
        ref_bl = at(w)
    elif has_al:
        ref_bl = at(ls)
    elif has_a:
        ref_bl = at(ls + tls)
    else:
        ref_bl = at(ls + tls + w)
    if sbl == 0:
        line = np.where(jl < w, ref_bl, line)
    if not has_l:
        line = np.where((jl >= w) & (jl < w + h), at(w - 1), line)
    if not has_al:
        line = np.where((jl >= ls) & (jl < ls + tls), at(ls - 1), line)
    if not has_a:
        line = np.where((jl >= base) & (jl < base + w), at(base - 1), line)
    if sar == 0:
        line = np.where((jl >= base + w) & (jl < base + w + h),
                        at(base + w - 1), line)
    if not (has_l or has_a or has_al or sbl > 0 or sar > 0):
        line = np.full(LINE, _DC, np.int64)
    j129 = np.arange(129)
    j128 = np.arange(128)
    top = np.where(j129 <= w + h, line[np.clip(base - 1 + j129, 0,
                                               LINE - 1)], _DC)
    left = np.where(j128 < w + h, line[np.clip(ls - 1 - j128, 0,
                                               LINE - 1)], _DC)
    return np.concatenate([top, left])


def _ref_index(codes, plane_off, Hp, Wp, px, py):
    """Flat plane indices of a leaf's reference samples (0 where the
    sample is the constant), with the strip starts taken as
    lax.dynamic_slice takes them."""
    ppx, ppy = px + PAD_TL, py + PAD_TL
    cy0 = ds_start(ppy, Hp, 128)
    cx0 = ds_start(ppx - 1, Wp, 1)
    ry0 = ds_start(ppy - 1, Hp, 1)
    rx0 = ds_start(ppx - 1, Wp, 130)
    lut = np.empty(259, np.int64)
    lut[:128] = plane_off + (cy0 + np.arange(128)) * Wp + cx0
    lut[128:258] = plane_off + ry0 * Wp + rx0 + np.arange(130)
    lut[258] = 0
    return lut[codes]


def _leaf_refs(meta, cols, nplanes, Hp, Wp, device):
    """(idx (N, 257) int64, const (N, 257) bool) on ``device`` for the
    active rows of ``meta``; one upload for the picture."""
    px_c, py_c, w_c, h_c, hl_c, ha_c, hal_c, sbl_c, sar_c = cols
    idx = np.zeros((len(meta), NREF), np.int64)
    const = np.zeros((len(meta), NREF), np.bool_)
    for n, m in enumerate(meta):
        codes = _ref_codes(int(m[w_c]), int(m[h_c]), int(m[hl_c] != 0),
                           int(m[ha_c] != 0), int(m[hal_c] != 0),
                           int(m[sbl_c]), int(m[sar_c]))
        pi = ds_start(int(m[C_PLANE]), nplanes, 1) if nplanes > 1 else 0
        idx[n] = _ref_index(codes, pi * Hp * Wp, Hp, Wp, int(m[px_c]),
                            int(m[py_c]))
        const[n] = codes == _DC
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(const).to(device))


# ---------------------------------------------------------------------------
# Per-shape tables (ref space), cached on the host and per device
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _filter_taps(w, h):
    """[1 2 1] reference filter (ref: intra_prediction.cc:850-871) as 4
    taps per sample: filtered = (sum + 2) >> 2; unfiltered samples take
    the same tap four times."""
    n = w + h
    idx = np.empty((4, NREF), np.int64)
    for j in range(129):
        if j >= n:
            t = (j, j, j, j)
        elif j == 0:
            t = (0, 0, 1, 129)
        else:
            t = (j, j, j - 1, min(j + 1, 128))
        idx[:, j] = t
    for j in range(128):
        if j >= n - 1:
            t = (129 + j,) * 4
        elif j == 0:
            t = (129, 129, 0, 130)
        else:
            t = (129 + j, 129 + j, 129 + j - 1, 129 + min(j + 1, 127))
        idx[:, 129 + j] = t
    return (idx,)


def _log2(v):
    return int(v).bit_length() - 1


@functools.lru_cache(maxsize=None)
def _planar(w, h):
    """Planar as 4 weighted taps: pred = (sum + rnd) >> shift."""
    wl2, hl2 = _log2(w), _log2(h)
    y = np.arange(h)[:, None] + np.zeros((1, w), np.int64)
    x = np.arange(w)[None, :] + np.zeros((h, 1), np.int64)
    idx = np.stack([_T(np.minimum(1 + x, 128)),
                    np.broadcast_to(_L(min(h, 127)), (h, w)),
                    _L(np.minimum(y, 127)),
                    np.broadcast_to(_T(min(1 + w, 128)), (h, w))])
    wts = np.stack([(h - 1 - y) << wl2, (y + 1) << wl2,
                    (w - 1 - x) << hl2, (x + 1) << hl2])
    return idx.reshape(4, -1), wts.reshape(4, -1).astype(np.int32)


def _planar_shift(w, h):
    shift = _log2(w) + _log2(h) + 1
    return 1 << (shift - 1), shift


@functools.lru_cache(maxsize=None)
def _angular_geom(w, h, mode):
    """Angular prediction in the (possibly flipped) frame: ref-space taps
    of rv[idx0] / rv[idx0+1], their weights (32-iw, iw), the frame
    (hp, wp), is_hor, the angle, and the post-filter taps (lcol, t0, t1)."""
    is_hor = mode < DIAG
    j129 = np.arange(129)
    j128 = np.arange(128)
    if is_hor:
        t = np.where(j129 == 0, _T(0), _L(np.clip(j129 - 1, 0, 127)))
        lft = _T(np.clip(1 + j128, 0, 128))
        hp, wp = w, h
        ao = HOR - mode
    else:
        t = _T(j129)
        lft = _L(j128)
        hp, wp = h, w
        ao = mode - VER
    angle = int(_ANGLE[min(max(16 + ao, 0), 32)])
    inv_angle = int(_INV_ANGLE[min(max(-ao - 1, 0), 15)])
    num_proj = -((hp * angle) >> 5) - 1 if angle < 0 else 0
    base = num_proj + 1 if angle < 0 else 1
    jr = np.arange(RLEN)
    d = jr - base
    proj_i = -d - 2
    proj_idx = ((128 + (proj_i + 1) * inv_angle) >> 8) - 1
    rv = np.where(d >= -1, t[np.clip(d + 1, 0, 128)],
                  lft[np.clip(proj_idx, 0, 127)])
    yy = np.arange(hp)[:, None]
    xx = np.arange(wp)[None, :]
    asum = (yy + 1) * angle
    iw = np.broadcast_to(asum & 31, (hp, wp))
    idx0 = np.clip(base + (asum >> 5) + xx, 0, RLEN - 1)
    idx1 = np.clip(idx0 + 1, 0, RLEN - 1)
    idx = np.stack([rv[idx0], rv[idx1]]).reshape(2, -1)
    wts = np.stack([32 - iw, iw]).reshape(2, -1).astype(np.int32)
    lcol = lft[np.clip(np.arange(hp), 0, 127)]
    return idx, wts, hp, wp, is_hor, angle, lcol, int(t[0]), int(t[1])


@functools.lru_cache(maxsize=None)
def _dc_geom(w, h, post):
    """DC: taps of the sum, and (post) the edge filter as
    pred = (sum_k A_k ref[I_k] + B dc + 2) >> 2."""
    sum_idx = np.concatenate([_T(np.arange(1, w + 1)), _L(np.arange(h))])
    if not post:
        return (sum_idx,)
    idx = np.zeros((2, h, w), np.int64)
    A = np.zeros((2, h, w), np.int32)
    Bw = np.full((h, w), 4, np.int32)
    for y in range(1, h):
        idx[0, y, 0] = _L(min(y, 127))
        A[0, y, 0] = 1
        Bw[y, 0] = 3
    for x in range(1, w):
        idx[0, 0, x] = _T(min(1 + x, 128))
        A[0, 0, x] = 1
        Bw[0, x] = 3
    idx[0, 0, 0], idx[1, 0, 0] = _T(1), _L(0)
    A[:, 0, 0] = 1
    Bw[0, 0] = 2
    return sum_idx, idx.reshape(2, -1), A.reshape(2, -1), Bw.reshape(-1)


_DEV = {}


def _dev(device, fn, *key):
    """Host tables of ``fn(*key)`` as tensors on ``device`` (cached; the
    workers of a threaded decode keep the first one made)."""
    dkey = (str(device), fn.__name__) + key
    t = _DEV.get(dkey)
    if t is None:
        t = _DEV.setdefault(dkey, tuple(
            torch.as_tensor(np.ascontiguousarray(a), device=device)
            for a in fn(*key) if isinstance(a, np.ndarray)))
    return t


# ---------------------------------------------------------------------------
# Predictors (device part)
# ---------------------------------------------------------------------------

def _weighted(ref, idx, wts, rnd, shift):
    return ((ref[idx] * wts).sum(0) + rnd) >> shift


def _pred_planar(ref, w, h, dev):
    idx, wts = _dev(dev, _planar, w, h)
    rnd, shift = _planar_shift(w, h)
    return _weighted(ref, idx, wts, rnd, shift).view(h, w)


def _pred_dc(ref, w, h, post, dev):
    tabs = _dev(dev, _dc_geom, w, h, post)
    total = w + h
    dc = torch.div(ref[tabs[0]].sum() + (total >> 1), total,
                   rounding_mode="floor")
    if not post:
        return dc.expand(h, w)
    _, idx, A, Bw = tabs
    return (((ref[idx] * A).sum(0) + Bw * dc + 2) >> 2).view(h, w)


def _pred_angular(ref, w, h, mode, post, max_val, dev):
    geo = _angular_geom(w, h, mode)
    _, _, hp, wp, is_hor, angle, lcol, t0, t1 = geo
    idx, wts, lcol_t = _dev(dev, _angular_geom, w, h, mode)
    out = _weighted(ref, idx, wts, 16, 5).view(hp, wp)
    if post and (angle == 0 or abs(angle) <= 1):
        diff = ref[lcol_t] - ref[t0]
        if angle == 0:
            col = (ref[t1] + (diff >> 1)).clamp(0, max_val)
        else:
            col = (out[:, 0] + (diff >> 2)).clamp(0, max_val)
        out = out.clone()
        out[:, 0] = col
    return out.t() if is_hor else out


def _write_back(plane, resi, pred, px, py, w, h, max_val):
    """plane[window] = clip(pred + resi[window]); the 64x64 window start
    is taken as lax.dynamic_slice takes it."""
    Hp, Wp = plane.shape
    wy = ds_start(py + PAD_TL, Hp, 64)
    wx = ds_start(px + PAD_TL, Wp, 64)
    rwin = resi[wy:wy + h, wx:wx + w]
    plane[wy:wy + h, wx:wx + w] = (pred + rwin).clamp_(0, max_val)


# ---------------------------------------------------------------------------
# Luma scan
# ---------------------------------------------------------------------------

_LUMA_COLS = (M_PX, M_PY, M_W, M_H, M_HAS_L, M_HAS_A, M_HAS_AL, M_SBL,
              M_SAR)


def _check_meta(meta, cols):
    if not isinstance(meta, torch.Tensor):
        raise TypeError("meta must be a tensor beside the canvases, got %s"
                        % type(meta).__name__)
    kernels.require(meta, torch.int32, 2, "meta")
    if meta.shape[1] != cols:
        raise ValueError("meta must have %d columns, got %d"
                         % (cols, meta.shape[1]))


def _check_canvas(name, shape, min_h, min_w):
    """The canvas holds the windows both the kernel and the plain version
    read (the one place this is checked)."""
    if shape[-2] < min_h or shape[-1] < min_w:
        raise ValueError("%s %r is smaller than the %d x %d windows the "
                         "scan reads" % (name, tuple(shape), min_h, min_w))


def intra_scan(plane, resi, meta, bitdepth):
    """Reconstruct every intra luma leaf of ``meta`` ((N, META_COLS)
    int32 tensor beside the canvases, in decode order) into ``plane``
    (Hp, Wp) int16, in place; ``resi`` (Hp, Wp) int32 holds the residual
    on the same canvas.  Returns ``plane``.
    On the card this is one launch of ``xvc_intra_luma_scan``."""
    kernels.require(plane, torch.int16, 2, "plane")
    kernels.require(resi, torch.int32, 2, "resi")
    _check_meta(meta, META_COLS)
    if resi.shape != plane.shape:
        raise ValueError("resi %r and plane %r differ in shape"
                         % (tuple(resi.shape), tuple(plane.shape)))
    _check_canvas("plane", plane.shape, 128, 130)
    if not kernels.on_cuda(plane, resi, meta):
        return intra_scan_plain(plane, resi, meta, bitdepth)
    if not len(meta):
        return plane
    from ..kernels import build
    Hp, Wp = plane.shape
    stream = build.stream_of(plane)
    scratch = _scratch(plane.device, stream, 1, Hp, Wp, len(meta), 4)
    rc = build.lib().xvc_intra_luma_scan(
        build.ptr(plane), build.ptr(resi), build.ptr(meta), len(meta), Hp,
        Wp, bitdepth, build.ptr(scratch), stream)
    build.check(rc, "intra_luma")
    kernels.count_launch("intra_luma")
    LAST_SCRATCH["intra_luma"] = scratch
    return plane


_SCRATCH = {}


def _scratch(device, stream, nplanes, Hp, Wp, N, unit):
    """The kernel's int32 scratch: STATUS_WORDS per plane, then per plane
    the owner map of the canvas's unit x unit cells, N ticket entries and
    N row ranks.  The kernel fills all of it, so one tensor per device,
    stream and size serves every launch: the stream puts each launch
    after the one before, also the launches of the workers of a threaded
    decode, which share the current stream (a worker on a stream of its
    own would get a scratch of its own)."""
    size = nplanes * (STATUS_WORDS + -(-Hp // unit) * -(-Wp // unit) + 2 * N)
    key = (device, stream.value, size)
    scratch = _SCRATCH.get(key)
    if scratch is None:
        scratch = _SCRATCH.setdefault(key, torch.empty(
            size, dtype=torch.int32, device=device))
    return scratch


def _active_rows(meta, active_col):
    """The active rows of the metadata tensor, on the host."""
    meta = meta.cpu().numpy()
    return meta[meta[:, active_col] != 0]


def intra_scan_plain(plane, resi, meta, bitdepth):
    """Plain PyTorch version of ``intra_scan``: the host loop over the
    leaves."""
    meta = _active_rows(meta, M_ACTIVE)
    if not len(meta):
        return plane
    dev = plane.device
    Hp, Wp = plane.shape
    dc_def = 1 << (bitdepth - 1)
    max_val = (1 << bitdepth) - 1
    flat = plane.view(-1)
    ridx, rconst = _leaf_refs(meta, _LUMA_COLS, 1, Hp, Wp, dev)
    for n, m in enumerate(meta):
        px, py, w, h, mode = (int(m[M_PX]), int(m[M_PY]), int(m[M_W]),
                              int(m[M_H]), int(m[M_MODE]))
        ref = torch.where(rconst[n], dc_def, flat[ridx[n]].to(torch.int32))
        post = w <= 16 and h <= 16
        if mode == 1:
            pred = _pred_dc(ref, w, h, post, dev)
        else:
            # use_filtered_ref_samples (ref: intra_prediction.cc:342-363)
            size = (_log2(w) + _log2(h)) >> 1
            mode_diff = min(abs(mode - HOR), abs(mode - VER))
            sref = ref
            if mode_diff > _THR_EXT[min(max(size, 0), 7)]:
                (fidx,) = _dev(dev, _filter_taps, w, h)
                sref = (ref[fidx].sum(0) + 2) >> 2
            if mode <= 0:
                pred = _pred_planar(sref, w, h, dev)
            else:
                pred = _pred_angular(sref, w, h, mode, post, max_val, dev)
        _write_back(plane, resi, pred, px, py, w, h, max_val)
    return plane


# ---------------------------------------------------------------------------
# Chroma scan (4:2:0, with LM)
# ---------------------------------------------------------------------------

_CHROMA_COLS = (C_PX, C_PY, C_W, C_H, C_HAS_L, C_HAS_A, C_HAS_AL, C_SBL,
                C_SAR)


@functools.lru_cache(maxsize=None)
def _lm_grid(w, h, has_l, has_a, wp_luma):
    """rescale_luma (ref: intra_prediction.cc:873-954) on the (h+1, w+1)
    LM grid as six taps into the 68 x 72 luma window (flat offsets with
    row stride ``wp_luma``): sub = (sum + 4) >> 3.  Also the sub-grid
    and chroma reference taps of the LM neighbour sums."""
    gy = np.arange(h + 1)[:, None] + np.zeros((1, w + 1), np.int64)
    gx = np.arange(w + 1)[None, :] + np.zeros((h + 1, 1), np.int64)
    yi, xi = gy - 1, gx - 1
    ry, cxl = 2 + 2 * yi, 4 + 2 * xi

    def L(r, c):
        return (np.clip(r, 0, 67) * wp_luma + np.clip(c, 0, 71))

    six = [(ry, cxl - 1, 1), (ry, cxl, 2), (ry, cxl + 1, 1),
           (ry + 1, cxl - 1, 1), (ry + 1, cxl, 2), (ry + 1, cxl + 1, 1)]
    lcol = [(ry, 1, 1), (ry, 2, 2), (ry, 3, 1), (ry + 1, 1, 1),
            (ry + 1, 2, 2), (ry + 1, 3, 1)]
    nl = [(ry, 4, 4), (ry + 1, 4, 4)] + [(ry, 4, 0)] * 4
    valid_y = (yi >= -1) if has_a else (yi >= 0)
    c1 = (gx >= 1) & valid_y & (yi < h) & (xi < w) & \
        (bool(has_l) | (xi >= 1) | (gx == 1))
    use_nl = c1 & (not has_l) & (gx == 1)
    use_in = c1 & ~use_nl
    use_lc = (gx == 0) & valid_y & (yi < h) & bool(has_l)
    idx = np.zeros((6,) + gy.shape, np.int64)
    wts = np.zeros((6,) + gy.shape, np.int32)
    for k, (a, b, c) in enumerate(zip(six, lcol, nl)):
        for use, (r, cc, wt) in ((use_in, a), (use_lc, b), (use_nl, c)):
            idx[k] = np.where(use, L(r, cc), idx[k])
            wts[k] = np.where(use, wt, wts[k])
    # neighbour sums (derive_lm): above row / left column of the grid
    dx = w // h if (has_l and w // h > 1) else 1
    dy = h // w if (has_a and h // w > 1) else 1
    j = np.arange(64)
    am = (j < w) & (j % dx == 0) & bool(has_a)
    lm = (j < h) & (j % dy == 0) & bool(has_l)
    gsz = w + 1
    x_idx = np.concatenate([np.clip(1 + j[am], 0, 32),
                            np.clip(1 + j[lm], 0, 32) * gsz])
    y_idx = np.concatenate([_T(np.clip(1 + j[am], 0, 128)),
                            _L(np.clip(j[lm], 0, 127))])
    blk = ((1 + np.arange(h))[:, None] * gsz + 1 + np.arange(w)[None, :])
    return (idx.reshape(6, -1), wts.reshape(6, -1), x_idx, y_idx,
            blk.reshape(-1), int(am.sum() + lm.sum()))


def _i32(v):
    return ((int(v) + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _log2floor(v):
    return max(int(v), 1).bit_length() - 1


def derive_lm(sums, nbr, has_a, has_l, bitdepth):
    """derive_lm_params (ops/intra_pred.py:304-387) from the four
    neighbour sums, with the JAX version's int32 semantics.  Above 14 bit,
    where the sums of squares pass 2^31, the sums are rounded down by the
    size shift before they are taken to int32, as the host's exact sums
    are (the shift is then at least 1).  Returns (scale, offset, shift)."""
    if bitdepth <= 14:
        sums = [_i32(s) for s in sums]
    sum_x, sum_y, sum_xx, sum_xy = sums
    lg = _log2floor(nbr)
    size_shift = max(lg + (1 if (1 << lg) < nbr else 0), 1)
    sh = max(size_shift - (15 - bitdepth), 0)
    if sh > 0:
        rnd = 1 << (sh - 1)
        sum_x, sum_y, sum_xx, sum_xy = (_i32((s + rnd) >> sh) for s in
                                        (sum_x, sum_y, sum_xx, sum_xy))
    size_shift -= sh
    avg_x = sum_x >> size_shift
    avg_y = sum_y >> size_shift
    x_frac = sum_x & ((1 << size_shift) - 1)
    y_frac = sum_y & ((1 << size_shift) - 1)
    stddev_xy = _i32(sum_xy - _i32(_i32(avg_x * avg_y) << size_shift) -
                     _i32(avg_x * y_frac) - _i32(avg_y * x_frac))
    stddev_xx = _i32(sum_xx - _i32(_i32(avg_x * avg_x) << size_shift) -
                     _i32(2 * avg_x * x_frac))
    shift_xy = 0 if stddev_xy == 0 else \
        max(_log2floor(_i32(abs(stddev_xy))) - bitdepth + 2, 0)
    shift_xx = 0 if stddev_xx == 0 else \
        max(_log2floor(_i32(abs(stddev_xx))) - 5, 0)
    sxy_sh = stddev_xy >> shift_xy
    sxx_sh = stddev_xx >> shift_xx
    total_shift = bitdepth + shift_xx + 4 + 7 - 13 - shift_xy
    degenerate = sxx_sh < (1 << 5)
    q = ((1 << (bitdepth + 4)) + sxx_sh // 2) // max(sxx_sh, 1)
    scale = _i32(sxy_sh * q)
    scale = scale >> total_shift if total_shift >= 0 else \
        _i32(scale << (-total_shift))
    lim = 1 << (15 - 7)
    scale = (1 << 7) * min(max(scale, -lim), lim - 1)
    base_v = -scale - 1 if scale < 0 else scale
    base_shift = _log2floor(base_v) - (5 if scale != 0 else 0)
    shift = 13 - base_shift
    scale = scale >> base_shift if base_shift >= 0 else \
        _i32(scale << (-base_shift))
    offset = _i32(avg_y - (_i32(scale * avg_x) >> shift))
    none_avail = not has_a and not has_l
    if none_avail:
        return 0, 1 << (bitdepth - 1), 0
    if degenerate:
        return 0, avg_y, 0
    return scale, offset, shift


def intra_chroma_scan(planes, resi, luma, meta, bitdepth):
    """Reconstruct every intra chroma row of ``meta`` ((N, CMETA_COLS)
    int32 tensor beside the canvases, one row per (leaf, u/v) in decode
    order) into ``planes`` (2, Hp, Wp) int16, in place; ``resi``
    (2, Hp, Wp) int32.  LM rows read the final
    reconstructed luma canvas ``luma`` (HpL, WpL).  Returns ``planes``.
    On the card this is one launch of ``xvc_intra_chroma_scan``, on the
    stream that ran the luma scan."""
    kernels.require(planes, torch.int16, 3, "planes")
    kernels.require(resi, torch.int32, 3, "resi")
    kernels.require(luma, torch.int16, 2, "luma")
    _check_meta(meta, CMETA_COLS)
    if planes.shape[0] != 2 or resi.shape != planes.shape:
        raise ValueError("planes %r and resi %r must both be (2, Hp, Wp)"
                         % (tuple(planes.shape), tuple(resi.shape)))
    _check_canvas("planes", planes.shape, 128, 130)
    _check_canvas("luma", luma.shape, 68, 72)
    if not kernels.on_cuda(planes, resi, luma, meta):
        return intra_chroma_scan_plain(planes, resi, luma, meta, bitdepth)
    if not len(meta):
        return planes
    from ..kernels import build
    _, Hp, Wp = planes.shape
    HpL, WpL = luma.shape
    stream = build.stream_of(planes)
    scratch = _scratch(planes.device, stream, 2, Hp, Wp, len(meta), 2)
    rc = build.lib().xvc_intra_chroma_scan(
        build.ptr(planes), build.ptr(resi), build.ptr(luma),
        build.ptr(meta), len(meta), Hp, Wp, HpL, WpL, bitdepth,
        build.ptr(scratch), stream)
    build.check(rc, "intra_chroma")
    kernels.count_launch("intra_chroma")
    LAST_SCRATCH["intra_chroma"] = scratch
    return planes


def intra_chroma_scan_plain(planes, resi, luma, meta, bitdepth):
    """Plain PyTorch version of ``intra_chroma_scan``: the host loop
    over the rows, one device sync per LM block."""
    meta = _active_rows(meta, C_ACTIVE)
    if not len(meta):
        return planes
    dev = planes.device
    _, Hp, Wp = planes.shape
    HpL, WpL = luma.shape
    dc_def = 1 << (bitdepth - 1)
    max_val = (1 << bitdepth) - 1
    flat = planes.view(-1)
    lflat = luma.view(-1)
    ridx, rconst = _leaf_refs(meta, _CHROMA_COLS, 2, Hp, Wp, dev)
    for n, m in enumerate(meta):
        pi = ds_start(int(m[C_PLANE]), 2, 1)
        px, py, w, h, mode = (int(m[C_PX]), int(m[C_PY]), int(m[C_W]),
                              int(m[C_H]), int(m[C_MODE]))
        ref = torch.where(rconst[n], dc_def, flat[ridx[n]].to(torch.int32))
        if m[C_IS_LM] != 0:
            has_l, has_a = int(m[C_HAS_L] != 0), int(m[C_HAS_A] != 0)
            gidx, gw, xi, yi, blk = _dev(dev, _lm_grid, w, h, has_l, has_a,
                                         WpL)
            nbr = _lm_grid(w, h, has_l, has_a, WpL)[5]
            wy = ds_start(2 * py - 2 + PAD_TL, HpL, 68)
            wx = ds_start(2 * px - 4 + PAD_TL, WpL, 72)
            win = lflat[gidx + (wy * WpL + wx)].to(torch.int32)
            sub = ((win * gw).sum(0) + 4) >> 3
            X = sub[xi].to(torch.int64)
            Y = ref[yi].to(torch.int64)
            sums = torch.stack([X.sum(), Y.sum(), (X * X).sum(),
                                (X * Y).sum()]).tolist()
            scale, offset, shift = derive_lm(sums, nbr, has_a, has_l,
                                             bitdepth)
            pred = (((scale * sub[blk]) >> shift) + offset) \
                .clamp(0, max_val).view(h, w)
        elif mode <= 0:
            pred = _pred_planar(ref, w, h, dev)
        elif mode == 1:
            pred = _pred_dc(ref, w, h, False, dev)
        else:
            pred = _pred_angular(ref, w, h, mode, False, max_val, dev)
        _write_back(planes[pi], resi[pi], pred, px, py, w, h, max_val)
    return planes
