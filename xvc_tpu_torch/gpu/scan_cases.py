"""Synthetic inputs of the intra luma and chroma scans, made with numpy
alone (no JAX, no torch), so that the CPU tests can hand them to the JAX
package and to the port, and the card tests and chip_smoke.py to a
kernel and its plain version.  tests/test_torch_scan_cases.py holds the
families to what they claim.

A case is a dict: kind ("luma" / "chroma"), bd, plane (int16 canvas, for
chroma (2, Hp, Wp)), resi (int32, same shape), meta (int32 rows in scan
order), luma (the int16 luma canvas LM reads; chroma only); a tiled case
also names its picture's (H, W).  shape_case, corner_case and
lm_wrap_case place leaves that overlap or read later rows, outside the
contract under which the kernels run leaves in parallel
(gpu/scan_deps.py); tiled_case lays a picture out as the codec does,
inside it (with ``interleave``, in an order that keeps the contract but
not the CTUs' rows together).
"""
import itertools

import numpy as np

# metadata columns by name (gpu/intra_scan.py's layout)
LUMA_LAY = dict(px=0, py=1, w=2, h=3, mode=4, has_l=5, has_a=6, has_al=7,
                sbl=8, sar=9, active=10)
CHROMA_LAY = dict(plane=0, px=1, py=2, w=3, h=4, mode=5, is_lm=6, has_l=7,
                  has_a=8, has_al=9, sbl=10, sar=11, active=12)
LUMA_DIMS = (4, 8, 16, 32, 64)
CHROMA_DIMS = (2, 4, 8, 16, 32)


def _rows(lay, rows):
    meta = np.zeros((len(rows), len(lay)), np.int32)
    for i, row in enumerate(rows):
        for key, val in row.items():
            meta[i, lay[key]] = val
    return meta


def _row(rng, kind, w, h, mode, px, py, **over):
    dims = LUMA_DIMS if kind == "luma" else CHROMA_DIMS
    has_l, has_a = int(px > 0), int(py > 0)
    row = dict(px=px, py=py, w=w, h=h, mode=mode, has_l=has_l, has_a=has_a,
               has_al=has_l & has_a,
               sbl=int(rng.choice([0, dims[0], dims[2], dims[4]])),
               sar=int(rng.choice([0, dims[0], dims[2], dims[4]])),
               active=1)
    if kind == "chroma":
        row.update(plane=int(rng.randint(0, 2)), is_lm=0)
    row.update(over)
    return row


def _canvases(rng, kind, bd, hp, wp, lo=None, hi=None):
    lo = 0 if lo is None else lo
    hi = (1 << bd) if hi is None else hi
    shape = (hp, wp) if kind == "luma" else (2, hp, wp)
    case = dict(kind=kind, bd=bd,
                plane=rng.randint(lo, hi, shape).astype(np.int16),
                resi=rng.randint(-60, 60, shape).astype(np.int32),
                luma=None)
    if kind == "chroma":
        case["luma"] = rng.randint(lo, hi, (2 * hp - 64, 2 * wp - 64)) \
            .astype(np.int16)
    return case


def shape_case(kind, w, h, bd, seed=0):
    """One block shape over all 67 modes (and, for chroma, LM with each
    has_l / has_a pair), at varied positions with varied availability, an
    inactive row in the middle that would change the canvas if it ran,
    and -- being one scan -- later leaves that read earlier ones."""
    rng = np.random.RandomState(1000 * w + 10 * h + bd + seed)
    step = 4 if kind == "luma" else 2
    rows = []
    for mode in range(67):
        px = int(rng.randint(0, 24)) * step * (mode % 5 != 0)
        py = int(rng.randint(0, 24)) * step * (mode % 7 != 0)
        rows.append(_row(rng, kind, w, h, mode, px, py))
    if kind == "chroma":
        for has_l in (0, 1):
            for has_a in (0, 1):
                for plane in (0, 1):
                    rows.append(_row(
                        rng, kind, w, h, 0, int(rng.randint(1, 24)) * step,
                        int(rng.randint(1, 24)) * step, is_lm=1, has_l=has_l,
                        has_a=has_a, has_al=has_l & has_a, plane=plane))
    dead = _row(rng, kind, 16, 16, 1, 8, 8, active=0)
    rows.insert(len(rows) // 2, dead)
    case = _canvases(rng, kind, bd, 256, 264)
    lay = LUMA_LAY if kind == "luma" else CHROMA_LAY
    case["meta"] = _rows(lay, rows)
    return case


def corner_case(kind, bd, seed=0):
    """Random leaves on the smallest canvas, half of them at its far
    corner, so that every window start (reference strips, the 64x64
    write window, the LM luma window) is clamped as lax.dynamic_slice
    clamps it; negative modes and plane indices included."""
    rng = np.random.RandomState(77 + bd + seed)
    dims = LUMA_DIMS if kind == "luma" else CHROMA_DIMS
    hp, wp = 128, 136
    rows = []
    for i in range(32):
        w, h = int(rng.choice(dims)), int(rng.choice(dims))
        if i % 2:
            px, py = wp - 8 - w, hp - 8 - h
        else:
            px, py = int(rng.randint(0, 40)), int(rng.randint(0, 40))
        over = {}
        if kind == "chroma":
            over = dict(is_lm=int(rng.rand() < 0.3),
                        plane=int(rng.choice([-1, 0, 1, 2])))
        rows.append(_row(rng, kind, w, h, int(rng.randint(-2, 67)), px, py,
                         **over))
    # a negative mode (planar), planar and DC at the corner and away
    for i, mode in enumerate((-2, 0, 1, 1)):
        rows[i]["mode"] = mode
    rows[-1]["active"] = 0
    case = _canvases(rng, kind, bd, hp, wp)
    if kind == "chroma":
        case["luma"] = rng.randint(0, 1 << bd, (136, 144)).astype(np.int16)
    lay = LUMA_LAY if kind == "luma" else CHROMA_LAY
    case["meta"] = _rows(lay, rows)
    return case


TILED_CTUS = (4, 2)   # CTU columns, CTU rows


def _tiled_leaves(rng, ctu, min_dim):
    """Leaves (x, y, w, h) that tile TILED_CTUS CTUs of ctu x ctu in
    decode (z-)order: quad splits, then binary splits, of mixed depth."""
    leaves = []

    def split(x, y, w, h, depth):
        r = rng.rand()
        if w == h and w >= 2 * min_dim and r < 0.9 - 0.2 * depth:
            s = w // 2
            for dy, dx in ((0, 0), (0, s), (s, 0), (s, s)):
                split(x + dx, y + dy, s, s, depth + 1)
        elif r < 0.95 - 0.2 * depth and max(w, h) >= 2 * min_dim:
            if w >= h and w >= 2 * min_dim:
                split(x, y, w // 2, h, depth + 1)
                split(x + w // 2, y, w // 2, h, depth + 1)
            else:
                split(x, y, w, h // 2, depth + 1)
                split(x, y + h // 2, w, h // 2, depth + 1)
        else:
            leaves.append((x, y, w, h))

    for cy in range(TILED_CTUS[1]):
        for cx in range(TILED_CTUS[0]):
            split(cx * ctu, cy * ctu, ctu, ctu, 0)
    return leaves


def _alternate(groups, a, b):
    """``groups`` ((CTU, rows) in decode order) with the leaves of CTUs
    ``a`` and ``b``, which follow each other, taken in turn."""
    first = next(k for k, (c, _) in enumerate(groups) if c == a)
    mixed = [g for pair in itertools.zip_longest(
        [g for g in groups if g[0] == a], [g for g in groups if g[0] == b])
        for g in pair if g is not None]
    rest = [g for g in groups if g[0] not in (a, b)]
    return rest[:first] + mixed + rest[first:]


def tiled_case(kind, bd, seed=0, interleave=False):
    """A picture as the codec lays it out: leaves of mixed shapes tile
    4 x 2 CTUs (64x64 luma, 32x32 chroma) in z-order; about a fifth of
    them are holes (inter blocks: no row writes them, their samples are
    on the canvas before the scan).  has_l / has_a are the picture
    edges, as the codec sets them, and sbl / sar count the below-left /
    above-right samples decoded before the leaf (inside the picture, at
    most w / h), so every read lands on an earlier row or a hole.  Every
    mode appears; chroma has LM rows and one row per plane for each
    leaf, U then V.

    ``interleave``: the leaves of the last CTU of the first CTU row and
    of the first CTU of the second are taken in turn.  Each of the two
    reads only CTUs before both, so the table stays inside the contract,
    but their rows are no longer consecutive: the kernels then hand out
    their tickets in decode order (``scan_deps.wavefront_order`` gives
    None)."""
    luma = kind == "luma"
    rng = np.random.RandomState(31337 + 7 * bd + seed + (0 if luma else 1))
    dims = LUMA_DIMS if luma else CHROMA_DIMS
    U, ctu = (4, 64) if luma else (2, 32)
    W, H = TILED_CTUS[0] * ctu, TILED_CTUS[1] * ctu
    decoded = np.zeros((H // U, W // U), bool)
    leaves = _tiled_leaves(rng, ctu, dims[0])
    modes = []
    groups = []  # (CTU, the leaf's rows)
    for x, y, w, h in leaves:
        intra = rng.rand() >= 0.2
        if intra:
            sbl = 0
            if x > 0:
                col = decoded[(y + h) // U:, x // U - 1][:w // U]
                sbl = int(np.cumprod(col).sum()) * U
            sar = 0
            if y > 0:
                row = decoded[y // U - 1, (x + w) // U:][:h // U]
                sar = int(np.cumprod(row).sum()) * U
            has_l, has_a = int(x > 0), int(y > 0)
            row = dict(px=x, py=y, w=w, h=h, mode=0, has_l=has_l,
                       has_a=has_a, has_al=has_l & has_a, sbl=sbl, sar=sar,
                       active=1)
            if luma:
                group = [row]
                modes.append(row)
            else:
                is_lm = int(rng.rand() < 0.2)
                group = [dict(row, plane=p, is_lm=is_lm) for p in (0, 1)]
                if not is_lm:
                    modes.append(group)
            groups.append(((y // ctu) * TILED_CTUS[0] + x // ctu, group))
        decoded[y // U:(y + h) // U, x // U:(x + w) // U] = True
    order = np.concatenate([rng.permutation(67)
                            for _ in range(-(-len(modes) // 67))])
    for mode, target in zip(order, modes):
        for row in (target if isinstance(target, list) else [target]):
            row["mode"] = int(mode)
    if interleave:
        groups = _alternate(groups, TILED_CTUS[0] - 1, TILED_CTUS[0])
    rows = [row for _, group in groups for row in group]
    hp = -(-(H + 8 + 200) // 128) * 128
    wp = -(-(W + 8 + 200) // 128) * 128
    case = _canvases(rng, kind, bd, hp, wp)
    case["meta"] = _rows(LUMA_LAY if luma else CHROMA_LAY, rows)
    case["picture"] = (H, W)
    return case


def lm_wrap_case(bd, seed=0):
    """LM rows whose neighbour sums wrap int32: samples over the whole
    int16 range (a canvas the decoder never makes, but the arithmetic is
    defined for it), square and non-square, each has_l / has_a pair."""
    rng = np.random.RandomState(4242 + bd + seed)
    rows = []
    for w, h in ((32, 32), (32, 8), (4, 32), (16, 16), (2, 32), (32, 2)):
        for has_l in (0, 1):
            for has_a in (0, 1):
                rows.append(_row(
                    rng, "chroma", w, h, 0, int(rng.randint(1, 40)) * 2,
                    int(rng.randint(1, 40)) * 2, is_lm=1, has_l=has_l,
                    has_a=has_a, has_al=has_l & has_a,
                    plane=len(rows) % 2))
    case = _canvases(rng, "chroma", bd, 256, 264, -32768, 32768)
    # smooth, bright luma: large sums with a small variance, so that the
    # wrapped products decide
    hl, wl = case["luma"].shape
    ramp = (32000 - (np.arange(hl)[:, None] + np.arange(wl)[None, :]) // 4)
    case["luma"][:, :wl // 2] = ramp[:, :wl // 2].astype(np.int16)
    case["meta"] = _rows(CHROMA_LAY, rows)
    return case
