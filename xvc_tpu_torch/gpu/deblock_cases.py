"""Synthetic inputs for the deblocking kernels, made with numpy from a
seed, for the CPU tests (against the JAX package), the card tests and
``chip_smoke.py`` (each kernel against its plain version).  No torch.

- ``tiled_picture`` tiles a picture with random CUs and returns a
  stand-in for the decoder's picture data that carries what
  ``DeblockingFilter.build_cu_attrs`` reads: the flat parse records, the
  qp and reference-picture tables.  Motion vectors straddle the one-step
  threshold, reference indices repeat, CUs are taller and wider than a
  sub-block, so both ``pred_bi`` branches, every corner choice and every
  boundary strength occur.
- ``luma_case`` gives a blocky plane with per-edge tensors for one luma
  direction: every edge position, a pruned list (gaps of 8, 12, ...), a
  width with ``W % 8 == 4`` whose last strip start is clamped, a height
  that is no multiple of 4, and a plane with an odd width and height
  (its last strip overlaps the one before by 7 samples).
- ``chroma_case`` gives a plane with chroma edges 8 apart.
"""
import numpy as np

from ..ops import deblock as dbk

RECORD_COLS = 72
EDGE_SIZES = ((64, 48), (44, 36), (36, 20))  # the last two: no multiple of 8


class _Qp:
    def __init__(self, luma, chroma):
        self._raw = (luma, chroma, chroma)

    def get_qp_raw(self, comp):
        return self._raw[comp]


class _RefLists:
    def __init__(self, pocs):
        self._pocs = pocs

    def get_num_ref_pics(self, lst):
        return len(self._pocs[lst])

    def get_ref_poc(self, lst, i):
        return self._pocs[lst][i]


class TiledPicture:
    """What the edge derivation reads of a picture."""

    def __init__(self, width, height, records, pred_type, qps, pocs):
        self.width, self.height = width, height
        self._parse_records = records
        self.qps = qps
        self.ref_pic_lists = _RefLists(pocs)
        self._pred_type = pred_type

    def get_prediction_type(self):
        return self._pred_type


_SPLITS = (
    ((0, 0, 16, 16),),
    ((0, 0, 8, 16), (8, 0, 8, 16)),
    ((0, 0, 16, 8), (0, 8, 16, 8)),
    ((0, 0, 8, 8), (8, 0, 8, 8), (0, 8, 8, 8), (8, 8, 8, 8)),
    ((0, 0, 4, 16), (4, 0, 4, 16), (8, 0, 8, 8), (8, 8, 4, 8), (12, 8, 4, 4),
     (12, 12, 4, 4)),
    ((0, 0, 16, 4), (0, 4, 16, 4), (0, 8, 8, 4), (8, 8, 8, 4), (0, 12, 4, 4),
     (4, 12, 12, 4)),
)


def tiled_picture(seed, width, height, pred_type, cu_tree=0, intra_share=0.2):
    """A picture of ``width`` x ``height`` tiled with CUs of 4 to 16
    samples a side (those at the border may reach past it, as a CU of the
    smallest size does when the size is no multiple of it).
    ``pred_type`` is the value ``get_prediction_type`` returns (0 BI,
    1 UNI, 2 INTRA)."""
    rng = np.random.RandomState(seed)
    rects = []
    for y in range(0, height, 16):
        for x in range(0, width, 16):
            for dx, dy, w, h in _SPLITS[rng.randint(len(_SPLITS))]:
                if x + dx < width and y + dy < height:
                    rects.append((x + dx, y + dy, w, h))
    order = rng.permutation(len(rects))  # pool order is not raster order
    rects = np.asarray(rects, np.int32)[order]
    n = len(rects)
    rec = np.zeros((n + 3, RECORD_COLS), np.int32)
    rec[:n, 0] = cu_tree
    rec[:n, 2:6] = rects
    intra = pred_type == 2 or rng.rand(n) < intra_share
    rec[:n, 11] = np.where(intra, 0, 1)
    rec[:n, 12] = rng.randint(0, 4, n)
    rec[:n, 16] = rng.randint(0, 3, n)
    rec[:n, 21] = rng.rand(n) < 0.3
    rec[:n, 35:37] = rng.randint(0, 3, (n, 2))
    # neighbours often share their motion but for a few units
    coarse = rng.randint(-40, 41, (n, 1)) // 8 * 8
    rec[:n, 41:57] = coarse + rng.randint(-9, 10, (n, 16))
    # rows that are no leaves of this tree: a split node, the other tree
    rec[n, 0], rec[n, 6] = cu_tree, 1
    rec[n + 1:, 0] = 1 - cu_tree
    rec[n:, 2:6] = (0, 0, 16, 16)
    qps = [_Qp(22 + 6 * i, 24 + 5 * i) for i in range(4)]
    pocs = ((8, 4, 8), (8, 4, 12))  # repeats: two indices, one picture
    return TiledPicture(width, height, rec, pred_type, qps, pocs)


def blocky_plane(rng, H, W, bd):
    """8x8 steps plus small noise, so that strong, weak and untouched
    edges all occur."""
    blocks = rng.randint(0, 1 << bd, (H // 8 + 1, W // 8 + 1))
    plane = np.repeat(np.repeat(blocks, 8, 0), 8, 1)[:H, :W]
    step = (1 << (bd - 8)) * 6
    plane = (blocks.mean() + (plane - blocks.mean()) // 16 +
             rng.randint(-step, step + 1, (H, W)))
    return np.clip(plane, 0, (1 << bd) - 1).astype(np.int16)


def luma_edges(rng, xs, groups, bd):
    """Random mask, tc and beta (E, groups) for the edge list ``xs``."""
    xs = np.asarray(xs, np.int32)
    qp = rng.randint(18, 52, (len(xs), groups))
    beta = (np.asarray(dbk.BETA_TABLE)[np.clip(qp, 0, 51)]
            << (bd - 8)).astype(np.int32)
    tc = (np.asarray(dbk.TC_TABLE)[np.clip(qp + 2, 0, 53)]
          << (bd - 8)).astype(np.int32)
    mask = (rng.rand(len(xs), groups) < 0.8).astype(np.int32)
    mask[len(xs) // 3] = 0  # one edge that no group filters
    return xs, mask, tc, beta


LUMA_KINDS = ("regular", "pruned", "clamped", "ragged", "odd")


def luma_case(kind, bd, direction, seed=0, size=(48, 96)):
    """plane, xs, mask, tc, beta for one luma direction; ``size`` is
    (lines across the filter direction / 1, samples along it): the plane
    is (size[0], size[1]) for direction 0 and its transpose's shape for
    direction 1, so both directions do the same work."""
    rng = np.random.RandomState(seed + 11 * LUMA_KINDS.index(kind) + bd)
    lines, L = size
    if kind == "clamped":
        L = L // 8 * 8 + 4
    if kind == "ragged":
        lines = lines // 4 * 4 + 2
    if kind == "odd":  # the last strip is clamped onto the one before
        lines, L = lines // 4 * 4 + 1, L // 4 * 4 + 1
    xs = np.arange(4, L, 4)
    if kind == "pruned":
        keep, x = [], 4
        while x < L:
            keep.append(x)
            x += int(rng.choice([4, 8, 12, 16]))
        xs = np.asarray(keep)
    if kind == "clamped":
        xs[-1] = L - 2  # strip start past L - 8
    H, W = (lines, L) if direction == 0 else (L, lines)
    plane = blocky_plane(rng, H, W, bd)
    return (plane,) + luma_edges(rng, xs, lines // 4, bd)


def chroma_case(bd, direction, seed=0, size=(24, 48)):
    """plane, edges, apply, tc for one chroma direction."""
    rng = np.random.RandomState(seed + 40 + bd + direction)
    lines, L = size
    H, W = (lines, L) if direction == 0 else (L, lines)
    plane = blocky_plane(rng, H, W, bd)
    edges = np.arange(8, L, 8).astype(np.int32)
    apply = (rng.rand(len(edges), lines) < 0.7).astype(np.int32)
    tc = (rng.randint(0, 12, (len(edges), lines)) << (bd - 8)).astype(
        np.int32)
    return plane, edges, apply, tc
