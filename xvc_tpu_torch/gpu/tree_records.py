"""The record table and coefficient arena of a picture the Python parse
read, built from its CU tree.

The device reconstruction (``flat_recon.FlatReconstructor``, the replay
path ``recon.Reconstructor``, ``itx.itx_picture``, ``mc.mc_picture``,
the deblock CU maps) reads a picture as the native parse exports it
(``native/pic.parse_picture``, ``xvcn_pic.inc`` ``xvcn_export_parse``):
one int32 row of ``PARSE_REC_STRIDE`` columns per CU node of either
tree, in the layout of ``records.py``, and an int32 arena of the coded
blocks' coefficients.  ``build`` makes the same table from the tree of
``codec/cu_decoder.CuDecoder.decode_ctu``, row for row: the inverse of
``native/pic._replay_tree``.  The JAX package has no such step (its
``JaxReconstructor`` walks the tree).

Row order is the native pool's allocation order: the CTU roots of the
primary tree in raster order, then the secondary tree's, then, CTU by
CTU and tree by tree, the children of each split as the parse made
them (all children of a split at once, then the first child's subtree
first).  The derive walk that follows each CTU's parse in the native
code (``parse_derive_cu``) is replayed here a CTU at a time from a
clear CU table: each leaf in decode order is marked, its below-left and
above-right availability taken, its decode-order index given, and an
inter leaf's final motion vectors derived (``inter_mv.calculate_mv``).
The coefficients of a CTU follow its walk: per tree, per leaf in decode
order, per coded component, the (h, w) block row by row, stored as the
native arena stores it (int16 values).
"""
import numpy as np

from .. import constants as k
from ..codec import inter_mv
from ..native.pic import PARSE_REC_STRIDE
from .records import (C_CBF0, C_COEFF0, C_DCONLY0, C_DEPTH, C_DIR,
                      C_FULLPEL, C_H, C_IMC, C_IML, C_LIC, C_MERGE,
                      C_MERGEIDX, C_MV, C_ORDER, C_PRED, C_QP, C_REF0,
                      C_REF1, C_ROOTCBF, C_SAR, C_SBL, C_SKIP, C_SPLIT,
                      C_TREE, C_TSKIP0, C_TT00, C_TT01, C_TT10, C_TT11,
                      C_TXSEL, C_W, C_X, C_Y, C_AFFINE)

C_MVP0 = 37          # mvp_idx[list]
C_MVD = 57           # [list][corner][x/y]: 57 + 4*l + 2*c (+1 for y)


def _allocation_order(pd, trees):
    """Every CU node in native pool order, with its children's indices
    (-1 where a child lies outside the picture)."""
    nodes = []
    for tree in trees:
        nodes.extend(pd.ctus[tree])
    index = {id(cu): i for i, cu in enumerate(nodes)}
    children = {}

    def split(cu):
        if cu.split == k.SplitType.NONE:
            return
        subs = []
        for sub in cu.sub_cus:
            if sub is None:
                subs.append(-1)
                continue
            index[id(sub)] = len(nodes)
            subs.append(len(nodes))
            nodes.append(sub)
        children[id(cu)] = subs
        for sub in cu.sub_cus:
            if sub is not None:
                split(sub)

    for rsaddr in range(pd.get_number_of_ctus()):
        for tree in trees:
            split(pd.get_ctu(tree, rsaddr))
    return nodes, index, children


def _leaves(cu):
    """The leaves under ``cu`` in decode order."""
    if cu.split == k.SplitType.NONE:
        yield cu
        return
    for sub in cu.sub_cus:
        if sub is not None:
            yield from _leaves(sub)


def build(cu_decoder):
    """(records int32 (N, PARSE_REC_STRIDE), coefficient arena int32)
    of the picture ``cu_decoder`` parsed.  Derives the final motion
    vectors of its inter leaves and leaves every leaf marked in the CU
    table, as the native parse leaves them."""
    pd = cu_decoder.pic
    trees = [k.CuTree.PRIMARY]
    if pd.has_secondary_cu_tree():
        trees.append(k.CuTree.SECONDARY)
    nodes, index, children = _allocation_order(pd, trees)
    rec = np.zeros((len(nodes), PARSE_REC_STRIDE), np.int32)
    rec[:, C_ORDER] = -1
    rec[:, C_COEFF0:C_COEFF0 + 3] = -1
    coeff = []
    used = 0
    order = 0
    # the derive walk reads the table as the native parse left it when
    # the CTU was parsed: earlier CTUs walked, later ones not yet read
    for tree in trees:
        pd.cu_table[tree] = [None] * len(pd.cu_table[tree])
    tiled = pd.tile_rows > 1
    for rsaddr in range(pd.get_number_of_ctus()):
        if tiled:
            pd.tile_ctx_top_y = pd.tile_top_y_of_row(
                rsaddr // pd.ctu_num_x)
        for tree in trees:
            for cu in _leaves(pd.get_ctu(tree, rsaddr)):
                pd.mark_used_in_pic(cu)
                r = rec[index[id(cu)]]
                r[C_SBL] = cu.get_cu_size_below_left(0) if cu.pos_x > 0 \
                    else 0
                r[C_SAR] = cu.get_cu_size_above_right(0) if cu.pos_y > 0 \
                    else 0
                r[C_ORDER] = order
                order += 1
                if cu.is_inter():
                    inter_mv.calculate_mv(cu_decoder.inter, cu)
        for tree in trees:
            for cu in _leaves(pd.get_ctu(tree, rsaddr)):
                r = rec[index[id(cu)]]
                for comp in pd.get_components(cu.cu_tree):
                    if not cu.cbf[comp] or cu.coeff[comp] is None:
                        continue
                    block = cu.coeff[comp].astype(np.int16).reshape(-1)
                    r[C_COEFF0 + comp] = used
                    coeff.append(block)
                    used += block.size
    if tiled:
        pd.tile_ctx_top_y = 0
    for i, cu in enumerate(nodes):
        _fill_row(rec[i], cu, children.get(id(cu)))
    arena = np.concatenate(coeff).astype(np.int32) if coeff else \
        np.zeros(0, np.int32)
    return rec, arena


def _fill_row(r, cu, subs):
    """The columns of one node that come from the CU itself (the walk
    filled availability, order and coefficient offsets)."""
    r[C_TREE] = cu.cu_tree
    r[C_DEPTH] = cu.depth
    r[C_X] = cu.pos_x
    r[C_Y] = cu.pos_y
    r[C_W] = cu.width
    r[C_H] = cu.height
    r[C_QP] = cu.qp.get_qp_raw(0)
    r[C_IML] = k.INTRA_MODE_INVALID
    r[C_IMC] = k.INTRA_MODE_INVALID
    r[C_MERGEIDX] = -1
    r[C_TXSEL] = -1
    if subs is not None:
        r[C_SPLIT] = cu.split
        r[C_SPLIT + 1:C_SPLIT + 5] = subs + [-1] * (4 - len(subs))
        return
    r[C_SPLIT + 1:C_SPLIT + 5] = -1
    r[C_PRED] = cu.pred_mode
    r[C_SKIP] = cu.skip_flag
    r[C_MERGE] = cu.merge_flag
    r[C_MERGEIDX] = cu.merge_idx
    r[C_DIR] = cu.inter_dir
    r[C_FULLPEL] = cu.fullpel_mv
    r[C_AFFINE] = cu.use_affine
    r[C_LIC] = cu.use_lic
    r[C_ROOTCBF] = cu.root_cbf
    for comp in range(3):
        r[C_CBF0 + comp] = cu.cbf[comp]
        r[C_TSKIP0 + comp] = cu.transform_skip[comp]
        r[C_DCONLY0 + comp] = cu.dc_only[comp]
    r[C_TT00], r[C_TT01] = cu.tx_type[0]
    r[C_TT10], r[C_TT11] = cu.tx_type[1]
    r[C_TXSEL] = cu.tx_select_idx
    r[C_REF0], r[C_REF1] = cu.ref_idx
    r[C_MVP0], r[C_MVP0 + 1] = cu.mvp_idx
    r[C_IML] = cu.intra_mode_luma
    r[C_IMC] = cu.intra_mode_chroma
    for lst in range(2):
        for corner in range(4):
            r[C_MV + 8 * lst + 2 * corner:C_MV + 8 * lst + 2 * corner + 2] = \
                cu.mv[lst][corner]
        for corner in range(2):
            r[C_MVD + 4 * lst + 2 * corner:C_MVD + 4 * lst + 2 * corner + 2] = \
                cu.mvd[lst][corner]
