"""The dependency model of the intra scans, in numpy alone: which rows of
a picture's scan metadata must be reconstructed before which.

The scan kernels (``kernels/csrc/intra_scan.cu``) run the rows of a
plane on several warps at once; a warp waits only for the rows that
wrote the samples its reference line reads.  This module computes the
same relation on the host for the tests and ``chip_smoke.py`` (the
decode path never calls it): whether a metadata table is inside the
contract that makes that schedule exact, each row's dependencies, the
levels of the dependency graph, its longest path and its widest level.

The canvas is cut into units, 4x4 for luma and 2x2 for chroma.

- A row writes the units of its w x h block, placed where the 64x64
  window start lands (``ds_start`` of the padded position, as the
  kernels and ``lax.dynamic_slice`` take it).
- A row reads the units of the samples its flags select, at the strips'
  ``ds_start`` positions: the left column (``min(h + sbl, w + h)``
  samples down from the block's top row) when ``has_l``, the corner when
  ``has_al``, the row above (``w`` samples and ``min(sar, h)`` more to
  the right) when ``has_a``.  These are exactly the samples the
  reference line is built from (``intra_pred.cuh`` ``load_strips``).
- The contract: no unit is written by two rows, and no row reads a unit
  that a later row writes.  Inside it, row i depends on the owners
  j < i of the units it reads; units no row owns hold inter samples or
  padding, which are there before the scan.  Outside it the kernels run
  the rows one after the other in decode order.

Chroma is taken per plane: a row belongs to plane ``ds_start(plane, 2,
1)``, as the kernel takes it.

The kernel hands the rows to its warps by ticket, and a warp holds its
row until the rows it reads are done, so the order of the tickets
decides how much of the graph's parallelism a block of warps can reach.
``wavefront_order`` is the kernel's order: tiles of 64x64 (chroma 32x32)
by wave tx + 2 ty, then rank in the tile, then tile row, used where no
block straddles two tiles, every tile's rows are consecutive among the
plane's rows in decode order and every row's owners lie in its tile or an
earlier wave.  ``ticket_steps`` counts the steps that a
number of warps taking tickets in an order need, one step per row.
"""
import heapq
from typing import List, NamedTuple

import numpy as np

from .dsp import ds_start
from .intra_scan import (C_ACTIVE, C_H, C_HAS_A, C_HAS_AL, C_HAS_L, C_PLANE,
                         C_PX, C_PY, C_SAR, C_SBL, C_W, M_ACTIVE, M_H,
                         M_HAS_A, M_HAS_AL, M_HAS_L, M_PX, M_PY, M_SAR,
                         M_SBL, M_W, PAD_TL)

__all__ = ["Schedule", "analyse", "unit_size", "read_units", "write_units",
           "wavefront_order", "ticket_steps"]

_COLS = {"luma": (M_PX, M_PY, M_W, M_H, M_HAS_L, M_HAS_A, M_HAS_AL, M_SBL,
                  M_SAR, M_ACTIVE),
         "chroma": (C_PX, C_PY, C_W, C_H, C_HAS_L, C_HAS_A, C_HAS_AL, C_SBL,
                    C_SAR, C_ACTIVE)}


class Schedule(NamedTuple):
    """One plane's rows and their dependency graph.

    ``rows`` are the metadata row indices of the plane's active rows in
    decode order; ``deps[k]`` the sorted row indices that ``rows[k]``
    waits for; ``level[k]`` its level (0 for a row that waits for none);
    ``longest`` the longest path in rows (the number of levels) and
    ``widest`` the most rows on one level.  ``deps``, ``level``,
    ``longest`` and ``widest`` are None outside the contract, where
    ``breach`` says why ("two writers" or "reads a later row")."""
    rows: np.ndarray
    in_contract: bool
    breach: str
    deps: List[np.ndarray]
    level: np.ndarray
    longest: int
    widest: int


def unit_size(kind):
    return 4 if kind == "luma" else 2


def _geom(m, cols):
    px, py, w, h, hl, ha, hal, sbl, sar, _ = (int(m[c]) for c in cols)
    return px, py, w, h, hl != 0, ha != 0, hal != 0, sbl, sar


def write_units(m, kind, Hp, Wp):
    """(uy0, uy1, ux0, ux1), inclusive, of the units row ``m`` writes."""
    U = unit_size(kind)
    px, py, w, h = _geom(m, _COLS[kind])[:4]
    wy = ds_start(py + PAD_TL, Hp, 64)
    wx = ds_start(px + PAD_TL, Wp, 64)
    return wy // U, (wy + h - 1) // U, wx // U, (wx + w - 1) // U


def read_units(m, kind, Hp, Wp):
    """The units row ``m`` reads, as a list of (uy, ux) runs: each run is
    (uy0, uy1, ux0, ux1), inclusive."""
    U = unit_size(kind)
    px, py, w, h, has_l, has_a, has_al, sbl, sar = _geom(m, _COLS[kind])
    ppx, ppy = px + PAD_TL, py + PAD_TL
    runs = []
    if has_l:
        cy0 = ds_start(ppy, Hp, 128)
        cx0 = ds_start(ppx - 1, Wp, 1)
        n = min(max(min(h + sbl, w + h), 1), 128)
        runs.append((cy0 // U, (cy0 + n - 1) // U, cx0 // U, cx0 // U))
    ry0 = ds_start(ppy - 1, Hp, 1)
    rx0 = ds_start(ppx - 1, Wp, 130)
    if has_al:
        runs.append((ry0 // U, ry0 // U, rx0 // U, rx0 // U))
    if has_a:
        end = min(w + max(0, min(sar, h)), 129)
        runs.append((ry0 // U, ry0 // U, (rx0 + 1) // U, (rx0 + end) // U))
    return runs


def _plane_rows(meta, kind, plane):
    cols = _COLS[kind]
    live = meta[:, cols[-1]] != 0
    if kind == "chroma":
        pl = np.asarray([ds_start(int(p), 2, 1) for p in meta[:, C_PLANE]])
        live &= pl == plane
    return np.flatnonzero(live)


def _analyse_plane(meta, kind, Hp, Wp, plane):
    U = unit_size(kind)
    owner = np.full((-(-Hp // U), -(-Wp // U)), -1, np.int64)
    rows = _plane_rows(meta, kind, plane)
    for n in rows:
        y0, y1, x0, x1 = write_units(meta[n], kind, Hp, Wp)
        win = owner[y0:y1 + 1, x0:x1 + 1]
        if (win >= 0).any():
            return Schedule(rows, False, "two writers", None, None, None,
                            None)
        win[...] = n
    deps = []
    for n in rows:
        seen = np.concatenate([
            owner[y0:y1 + 1, x0:x1 + 1].ravel()
            for y0, y1, x0, x1 in read_units(meta[n], kind, Hp, Wp)] +
            [np.zeros(0, np.int64)])
        if (seen > n).any():
            return Schedule(rows, False, "reads a later row", None, None,
                            None, None)
        deps.append(np.unique(seen[(seen >= 0) & (seen != n)]))
    at = {int(n): k for k, n in enumerate(rows)}
    level = np.zeros(len(rows), np.int64)
    for k, d in enumerate(deps):
        if len(d):
            level[k] = 1 + max(level[at[int(j)]] for j in d)
    longest = int(level.max()) + 1 if len(rows) else 0
    widest = int(np.bincount(level).max()) if len(rows) else 0
    return Schedule(rows, True, "", deps, level, longest, widest)


def analyse(kind, meta, canvas_shape):
    """The schedules of a scan's metadata ``meta`` (numpy int32, the
    layout of ``gpu/intra_scan.py``) on a canvas of ``canvas_shape``
    ((Hp, Wp), or (2, Hp, Wp) for chroma): one ``Schedule`` for luma, a
    tuple of two (U, V) for chroma."""
    meta = np.asarray(meta)
    Hp, Wp = canvas_shape[-2:]
    if kind == "luma":
        return _analyse_plane(meta, kind, Hp, Wp, 0)
    return tuple(_analyse_plane(meta, kind, Hp, Wp, p) for p in (0, 1))


def _tiles(meta, kind, rows, Hp, Wp):
    """Each row's tile (that of its first written unit, the tile grid
    starting at the picture's origin and clamped to the canvas), its wave
    and tile row, and whether its block straddles tiles."""
    U, T = unit_size(kind), (64 if kind == "luma" else 32)
    TH, TW = -(-Hp // T), -(-Wp // T)

    def unit_tile(uy, ux):
        ty = min(max((uy * U - PAD_TL) // T, 0), TH - 1)
        return ty, min(max((ux * U - PAD_TL) // T, 0), TW - 1)

    tile, wave, trow, straddle = [], [], [], False
    for n in rows:
        y0, y1, x0, x1 = write_units(meta[n], kind, Hp, Wp)
        ty, tx = unit_tile(y0, x0)
        straddle |= unit_tile(y1, x1) != (ty, tx)
        tile.append(ty * TW + tx)
        wave.append(tx + 2 * ty)
        trow.append(ty)
    return np.asarray(tile), np.asarray(wave), np.asarray(trow), straddle


def wavefront_order(kind, meta, canvas_shape, sched):
    """The kernel's wavefront ticket order of one plane's ``Schedule``
    (inside the contract): its row indices by (wave, rank in the tile,
    tile row), or None where the kernel takes decode order instead."""
    meta = np.asarray(meta)
    Hp, Wp = canvas_shape[-2:]
    rows = sched.rows
    tile, wave, ty, straddle = _tiles(meta, kind, rows, Hp, Wp)
    if straddle:
        return None
    at = {int(n): k for k, n in enumerate(rows)}
    rank = np.zeros(len(rows), np.int64)
    for t in np.unique(tile):
        # consecutive among the plane's rows
        ks = np.flatnonzero(tile == t)
        if ks[-1] - ks[0] + 1 != len(ks):
            return None
        rank[ks] = np.arange(len(ks))
    for k, deps in enumerate(sched.deps):
        for j in deps:
            o = at[int(j)]
            if tile[o] != tile[k] and wave[o] >= wave[k]:
                return None
    return rows[np.lexsort((ty, rank, wave))]


def ticket_steps(sched, order, warps):
    """Steps that ``warps`` warps need when they take the rows of
    ``sched`` by ticket in ``order`` (row indices), a warp holding its
    row until the rows it depends on are done, each row one step."""
    at = {int(n): k for k, n in enumerate(sched.rows)}
    finish = np.zeros(len(sched.rows))
    free = [(0.0, w) for w in range(warps)]
    for n in order:
        k = at[int(n)]
        t, w = heapq.heappop(free)
        start = max([t] + [finish[at[int(j)]] for j in sched.deps[k]])
        finish[k] = start + 1
        heapq.heappush(free, (finish[k], w))
    return int(finish.max()) if len(finish) else 0
