"""In-loop deblocking filter.

Behavioral equivalent of the reference deblocking filter
(ref: src/xvc_common_lib/deblocking_filter.cc): vertical edges then
horizontal edges on a 4-pel (ext) or 8-pel grid, HEVC-style strong/weak
luma filtering, chroma only at boundary strength 2.

Copy of the tables and the per-CU attribute records of
``xvc_tpu/ops/deblock.py``.  The filter itself runs on the device
(``gpu/deblock.py``), the edge decisions and the per-4x4 CU map
included; ``DeblockingFilter`` only carries the picture, the offsets and
the restrictions to it and builds the attribute table: from the parse
records of a decoded picture, or from the CU tree of a picture the
Python CU encoder coded.
"""
import numpy as np

from .. import constants as k


TC_TABLE = (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1,
            1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6,
            7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24)
BETA_TABLE = (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7, 8, 9,
              10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30,
              32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60,
              62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88)

SUBBLOCK_SIZE = 8
SUBBLOCK_SIZE_EXT = 4
FILTER_GROUP_SIZE = 4
CHROMA_FILTER_RESOLUTION = 8


class DeblockingFilter:
    def __init__(self, pic_data, rec_pic, beta_offset, tc_offset,
                 restrictions):
        self.pic = pic_data
        self.rec = rec_pic
        self.beta_offset = beta_offset
        self.tc_offset = tc_offset
        self.restr = restrictions

    def build_cu_attrs(self, cu_tree):
        """Per-CU attribute records (27 int32 columns: x, y, w, h, intra,
        cbf, qp luma, qp chroma, ref poc l0, l1, ref idx l0, then the
        motion vectors [list][corner][xy]) of the leaves of ``cu_tree``,
        vectorized from the native parse's flat CU records
        (native/pic.py parse_picture), and the number of leaves.  A tree
        without leaves gives one row of zeros and 0.  The per-4x4 CU map
        is painted from columns 0-3 on the device (gpu/deblock.py).  A
        picture without parse records (one the Python CU encoder coded)
        gives the same rows from its CU tree's leaves."""
        pic = self.pic
        rec = getattr(pic, "_parse_records", None)
        if rec is None:
            return self._attrs_from_tree(cu_tree)
        leaf = (rec[:, 6] == 0) & (rec[:, 0] == int(cu_tree))
        lr = rec[leaf]
        n = lr.shape[0]
        if n == 0:
            return np.zeros((1, 27), np.int32), 0
        attrs = np.zeros((n, 27), np.int32)
        attrs[:, 0:4] = lr[:, 2:6]
        is_intra = lr[:, 11] == 0
        attrs[:, 4] = is_intra
        attrs[:, 5] = lr[:, 21] != 0
        if pic.qps is None:
            pic._build_qps()  # deferred by light init (flat decode path)
        qp_lut0 = np.array([q.get_qp_raw(0) for q in pic.qps], np.int32)
        qp_lut1 = np.array([q.get_qp_raw(1) for q in pic.qps], np.int32)
        attrs[:, 6] = qp_lut0[lr[:, 12]]
        attrs[:, 7] = qp_lut1[lr[:, 12]]
        rpl = pic.ref_pic_lists
        inter_dir = lr[:, 16]
        for lst in (0, 1):
            poc_lut = np.zeros(8, np.int32)  # ref_idx OOB -> poc 0
            for i in range(min(rpl.get_num_ref_pics(lst), 8)):
                poc_lut[i] = rpl.get_ref_poc(lst, i)
            has = (inter_dir != 1) if lst == 0 else (inter_dir >= 1)
            poc = np.where(has, poc_lut[np.clip(lr[:, 35 + lst], 0, 7)], -1)
            attrs[:, 8 + lst] = np.where(is_intra, 0, poc)
        attrs[:, 10] = np.where(is_intra, 0, lr[:, 35])
        attrs[:, 11:27] = lr[:, 41:57]
        return attrs, n

    def _attrs_from_tree(self, cu_tree):
        """``build_cu_attrs`` of a picture's CU tree, leaf by leaf in
        coding order (ref: xvc_tpu/ops/deblock.py _build_cu_maps)."""
        rows = []

        def visit(cu):
            if cu is None:
                return
            if cu.split != k.SplitType.NONE:
                for sub in cu.sub_cus:
                    visit(sub)
                return
            intra = cu.is_intra()
            row = [cu.pos_x, cu.pos_y, cu.width, cu.height,
                   1 if intra else 0, 1 if cu.cbf[0] else 0,
                   cu.qp.get_qp_raw(0), cu.qp.get_qp_raw(1),
                   0 if intra else cu.get_ref_poc(0),
                   0 if intra else cu.get_ref_poc(1),
                   0 if intra else cu.ref_idx[0]]
            for lst in (0, 1):
                for mv in cu.mv[lst]:
                    row += [int(mv[0]), int(mv[1])]
            rows.append(row)

        for ctu in self.pic.ctus[int(cu_tree)]:
            visit(ctu)
        if not rows:
            return np.zeros((1, 27), np.int32), 0
        return np.array(rows, np.int32), len(rows)
