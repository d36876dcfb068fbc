"""Coding-unit tree and per-picture CU bookkeeping.

Behavioral equivalent of the reference CU data model
(ref: src/xvc_common_lib/coding_unit.{h,cc}, picture_data.{h,cc}).
The 4x4-granular CU lookup table mirrors PictureData::GetCuAt semantics,
including the +1 padded stride that guards below/right out-of-bounds
lookups.
"""
import numpy as np

from .. import constants as k
from ..ops.quant import Qp

# Transform type maps for transform-select (ref: coding_unit.cc:360-385)
_INTRA_TX_MAP = (
    (k.TransformType.DST7, k.TransformType.DCT8),
    (k.TransformType.DST7, k.TransformType.DST1),
    (k.TransformType.DST7, k.TransformType.DCT5),
)
_INTER_TX_MAP = (k.TransformType.DCT8, k.TransformType.DST7)
_INTRA_VER_MAP = (
    2, 1, 0, 1, 0, 1, 0, 1, 0, 0, 0, 0, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1,
    2, 2, 2, 2, 2, 1, 0, 1, 0, 1, 0)
_INTRA_HOR_MAP = (
    2, 1, 0, 1, 0, 1, 0, 1, 2, 2, 2, 2, 2, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1,
    0, 0, 0, 0, 0, 1, 0, 1, 0, 1, 0)
_INTRA_EXT_VER_MAP = (
    2, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1,
    0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 2, 2,
    2, 2, 2, 2, 2, 2, 2, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0)
_INTRA_EXT_HOR_MAP = (
    2, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1,
    0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0)


class CodingUnit:
    __slots__ = (
        "pic", "cu_tree", "depth", "pos_x", "pos_y", "width", "height",
        "split", "sub_cus", "pred_mode", "qp",
        "intra_mode_luma", "intra_mode_chroma",
        "inter_dir", "skip_flag", "merge_flag", "merge_idx", "fullpel_mv",
        "use_affine", "use_lic", "mv", "mvd", "ref_idx", "mvp_idx",
        "root_cbf", "cbf", "transform_skip", "dc_only", "tx_type",
        "tx_select_idx", "coeff",
    )

    def __init__(self, pic, cu_tree, depth, pos_x, pos_y, width, height):
        self.pic = pic
        self.cu_tree = cu_tree
        self.depth = depth
        self.pos_x = pos_x
        self.pos_y = pos_y
        self.width = width
        self.height = height
        self.split = k.SplitType.NONE
        self.sub_cus = []
        self.pred_mode = k.PredictionMode.INTRA
        self.qp = pic.pic_qp
        self.reset_prediction_state()

    def reset_prediction_state(self):
        self.intra_mode_luma = k.INTRA_MODE_INVALID
        self.intra_mode_chroma = k.INTRA_MODE_INVALID
        self.inter_dir = k.InterDir.L0
        self.skip_flag = False
        self.merge_flag = False
        self.merge_idx = -1
        self.fullpel_mv = False
        self.use_affine = False
        self.use_lic = False
        # mv[list][corner] = (x, y) in 1/16-pel
        self.mv = [[(0, 0)] * 4, [(0, 0)] * 4]
        self.mvd = [[(0, 0), (0, 0)], [(0, 0), (0, 0)]]
        self.ref_idx = [0, 0]
        self.mvp_idx = [0, 0]
        self.root_cbf = False
        self.cbf = [False, False, False]
        self.transform_skip = [False, False, False]
        self.dc_only = [False, False, False]
        # tx_type[plane][dir]; plane 0=luma 1=chroma
        self.tx_type = [[k.TransformType.DEFAULT, k.TransformType.DEFAULT],
                        [k.TransformType.DEFAULT, k.TransformType.DEFAULT]]
        self.tx_select_idx = -1
        # coeff[comp] = int32 ndarray (h, w), allocated lazily
        self.coeff = [None, None, None]

    # ---- geometry ----
    def pos(self, comp):
        if comp == 0:
            return self.pos_x, self.pos_y
        return (self.pos_x >> self.pic.chroma_shift_x,
                self.pos_y >> self.pic.chroma_shift_y)

    def size(self, comp):
        if comp == 0:
            return self.width, self.height
        return (self.width >> self.pic.chroma_shift_x,
                self.height >> self.pic.chroma_shift_y)

    @property
    def binary_depth(self):
        quad_size_log2 = (k.CTU_SIZE >> self.depth).bit_length() - 1
        return ((quad_size_log2 - (self.width.bit_length() - 1)) +
                (quad_size_log2 - (self.height.bit_length() - 1)))

    def is_binary_split_valid(self):
        max_split_depth = self.pic.max_binary_split_depth
        max_split_size = self.pic.get_max_binary_split_size(self.cu_tree)
        return (self.binary_depth < max_split_depth and
                self.width <= max_split_size and
                self.height <= max_split_size and
                (self.width > k.MIN_BINARY_SPLIT_SIZE or
                 self.height > k.MIN_BINARY_SPLIT_SIZE))

    def is_fully_within_picture(self):
        return (self.pos_x + self.width <= self.pic.width and
                self.pos_y + self.height <= self.pic.height)

    def is_intra(self):
        return self.pred_mode == k.PredictionMode.INTRA

    def is_inter(self):
        return self.pred_mode == k.PredictionMode.INTER

    # ---- neighbors (via the 4x4 CU table) ----
    def get_cu_left(self):
        if self.pos_x == 0:
            return None
        return self.pic.get_cu_at(self.cu_tree,
                                  self.pos_x - k.MIN_BLOCK_SIZE, self.pos_y)

    def get_cu_above(self):
        if self.pos_y == 0:
            return None
        return self.pic.get_cu_at(self.cu_tree, self.pos_x,
                                  self.pos_y - k.MIN_BLOCK_SIZE)

    def get_cu_above_if_same_ctu(self):
        if (self.pos_y % k.CTU_SIZE) == 0:
            return None
        return self.pic.get_cu_at(self.cu_tree, self.pos_x,
                                  self.pos_y - k.MIN_BLOCK_SIZE)

    def get_cu_above_left(self):
        if self.pos_x == 0 or self.pos_y == 0:
            return None
        return self.pic.get_cu_at(self.cu_tree,
                                  self.pos_x - k.MIN_BLOCK_SIZE,
                                  self.pos_y - k.MIN_BLOCK_SIZE)

    def get_cu_above_corner(self):
        if self.pos_y == 0:
            return None
        return self.pic.get_cu_at(self.cu_tree,
                                  self.pos_x + self.width - k.MIN_BLOCK_SIZE,
                                  self.pos_y - k.MIN_BLOCK_SIZE)

    def get_cu_above_right(self):
        if self.pos_y == 0:
            return None
        return self.pic.get_cu_at(self.cu_tree, self.pos_x + self.width,
                                  self.pos_y - k.MIN_BLOCK_SIZE)

    def get_cu_left_corner(self):
        if self.pos_x == 0:
            return None
        return self.pic.get_cu_at(self.cu_tree,
                                  self.pos_x - k.MIN_BLOCK_SIZE,
                                  self.pos_y + self.height -
                                  k.MIN_BLOCK_SIZE)

    def get_cu_left_below(self):
        if self.pos_x == 0:
            return None
        return self.pic.get_cu_at(self.cu_tree,
                                  self.pos_x - k.MIN_BLOCK_SIZE,
                                  self.pos_y + self.height)

    def get_cu_with_corner(self, direction):
        """direction: one of 'above_left', 'above', 'above_corner',
        'above_right', 'left', 'left_corner', 'left_below'.
        Returns (cu, mv_corner) (ref: coding_unit.cc:179-225)."""
        m = k.MIN_BLOCK_SIZE
        if direction == "above_left":
            cu = self.get_cu_above_left()
            x, y = self.pos_x - m, self.pos_y - m
        elif direction == "above":
            cu = self.get_cu_above()
            x, y = self.pos_x, self.pos_y - m
        elif direction == "above_corner":
            cu = self.get_cu_above_corner()
            x, y = self.pos_x + self.width - m, self.pos_y - m
        elif direction == "above_right":
            cu = self.get_cu_above_right()
            x, y = self.pos_x + self.width, self.pos_y - m
        elif direction == "left":
            cu = self.get_cu_left()
            x, y = self.pos_x - m, self.pos_y
        elif direction == "left_corner":
            cu = self.get_cu_left_corner()
            x, y = self.pos_x - m, self.pos_y + self.height - m
        else:  # left_below
            cu = self.get_cu_left_below()
            x, y = self.pos_x - m, self.pos_y + self.height
        if cu is None:
            return None, 0
        return cu, cu.get_mv_corner(x, y)

    def get_cu_size_above_right(self, comp):
        """(ref: coding_unit.cc:304-319)"""
        chroma_shift = max(self.pic.chroma_shift_x, self.pic.chroma_shift_y)
        posy = self.pos_y - k.MIN_BLOCK_SIZE
        if posy < 0:
            return 0
        posx = self.pos_x + self.width - k.MIN_BLOCK_SIZE
        i = self.height
        while i >= 0:
            if self.pic.get_cu_at(self.cu_tree, posx + i, posy) is not None:
                return i if comp == 0 else (i >> chroma_shift)
            i -= k.MIN_BLOCK_SIZE
        return 0

    def get_cu_size_below_left(self, comp):
        chroma_shift = max(self.pic.chroma_shift_x, self.pic.chroma_shift_y)
        posx = self.pos_x - k.MIN_BLOCK_SIZE
        if posx < 0:
            return 0
        posy = self.pos_y + self.height - k.MIN_BLOCK_SIZE
        i = self.width
        while i >= 0:
            if self.pic.get_cu_at(self.cu_tree, posx, posy + i) is not None:
                return i if comp == 0 else (i >> chroma_shift)
            i -= k.MIN_BLOCK_SIZE
        return 0

    def get_predicted_qp(self):
        tmp = self.get_cu_left()
        if tmp is not None:
            return tmp.qp.get_qp_raw(0)
        tmp = self.get_cu_above()
        if tmp is not None:
            return tmp.qp.get_qp_raw(0)
        return self.pic.pic_qp.get_qp_raw(0)

    def derive_sibling_split_restriction(self, parent_split):
        if self.pic.is_intra_pic():
            return k.SplitRestriction.NONE
        if (parent_split == k.SplitType.VERTICAL and
                self.split == k.SplitType.HORIZONTAL):
            if self.width >= k.MIN_CU_SIZE and self.binary_depth == 1:
                return k.SplitRestriction.NO_HORIZONTAL
            return k.SplitRestriction.NONE
        if (parent_split == k.SplitType.HORIZONTAL and
                self.split == k.SplitType.VERTICAL):
            return k.SplitRestriction.NO_VERTICAL
        return k.SplitRestriction.NONE

    # ---- transform ----
    def can_transform_skip(self, comp):
        w, h = self.size(comp)
        return w * h <= k.TRANSFORM_SKIP_MAX_AREA

    def get_transform_type(self, comp, idx):
        return self.tx_type[0 if comp == 0 else 1][idx]

    def set_transform_from_select_idx(self, comp, select_idx, restrictions):
        if comp != 0:
            return
        self.tx_select_idx = select_idx
        if restrictions.disable_ext2_transform_select:
            d = k.TransformType.DEFAULT
            self.tx_type = [[d, d], [d, d]]
        elif select_idx < 0:
            d = k.TransformType.DCT2
            self.tx_type = [[d, d], [d, d]]
        else:
            if self.is_intra():
                mode = self.intra_mode_luma
                if not restrictions.disable_ext2_intra_67_modes:
                    t0 = _INTRA_TX_MAP[_INTRA_EXT_VER_MAP[mode]][
                        select_idx >> 1]
                    t1 = _INTRA_TX_MAP[_INTRA_EXT_HOR_MAP[mode]][
                        select_idx & 1]
                else:
                    t0 = _INTRA_TX_MAP[_INTRA_VER_MAP[mode]][select_idx >> 1]
                    t1 = _INTRA_TX_MAP[_INTRA_HOR_MAP[mode]][select_idx & 1]
            else:
                t0 = _INTER_TX_MAP[select_idx >> 1]
                t1 = _INTER_TX_MAP[select_idx & 1]
            self.tx_type[0] = [t0, t1]
            self.tx_type[1] = [k.TransformType.DCT2, k.TransformType.DCT2]

    def get_coeff(self, comp):
        if self.coeff[comp] is None:
            w, h = self.size(comp)
            self.coeff[comp] = np.zeros((h, w), dtype=np.int32)
        return self.coeff[comp]

    # ---- intra ----
    def get_intra_mode(self, comp):
        if comp == 0:
            return self.intra_mode_luma
        if self.intra_mode_chroma == k.INTRA_CHROMA_DM:
            if self.cu_tree == k.CuTree.PRIMARY:
                return self.intra_mode_luma
            luma_cu = self.pic.get_cu_at(k.CuTree.PRIMARY,
                                         self.pos_x, self.pos_y)
            return luma_cu.intra_mode_luma
        return self.intra_mode_chroma

    # ---- inter ----
    def can_use_affine(self):
        return self.width > 8 and self.height > 8

    def can_affine_merge(self):
        if self.width * self.height < 64:
            return False
        for tmp in (self.get_cu_left_corner(), self.get_cu_above_corner(),
                    self.get_cu_above_right(), self.get_cu_left_below(),
                    self.get_cu_above_left()):
            if tmp is not None and tmp.use_affine:
                return True
        return False

    def has_mv(self, ref_list):
        return (self.inter_dir == k.InterDir.BI or
                (ref_list == 0 and self.inter_dir == k.InterDir.L0) or
                (ref_list == 1 and self.inter_dir == k.InterDir.L1))

    def get_force_mvd_zero(self, ref_list):
        return (self.pic.force_bipred_l1_mvd_zero and
                self.inter_dir == k.InterDir.BI and ref_list == 1)

    def has_zero_mvd(self):
        if self.inter_dir == k.InterDir.BI:
            return self.mvd[0][0] == (0, 0) and self.mvd[1][0] == (0, 0)
        if self.inter_dir == k.InterDir.L0:
            return self.mvd[0][0] == (0, 0)
        return self.mvd[1][0] == (0, 0)

    def get_ref_poc(self, ref_list):
        if not self.has_mv(ref_list):
            return -1
        return self.pic.ref_pic_lists.get_ref_poc(ref_list,
                                                  self.ref_idx[ref_list])

    def get_mv_corner(self, x, y):
        return (2 * (1 if (y - self.pos_y) >= (self.height >> 1) else 0) +
                (1 if (x - self.pos_x) >= (self.width >> 1) else 0))

    # ---- split ----
    def do_split(self, split_type):
        self.split = split_type
        sub_w, sub_h = self.width >> 1, self.height >> 1
        p = self.pic
        if split_type == k.SplitType.QUAD:
            d = self.depth + 1
            self.sub_cus = [
                p.create_cu(self.cu_tree, d, self.pos_x, self.pos_y,
                            sub_w, sub_h),
                p.create_cu(self.cu_tree, d, self.pos_x + sub_w, self.pos_y,
                            sub_w, sub_h),
                p.create_cu(self.cu_tree, d, self.pos_x, self.pos_y + sub_h,
                            sub_w, sub_h),
                p.create_cu(self.cu_tree, d, self.pos_x + sub_w,
                            self.pos_y + sub_h, sub_w, sub_h),
            ]
        elif split_type == k.SplitType.HORIZONTAL:
            self.sub_cus = [
                p.create_cu(self.cu_tree, self.depth, self.pos_x, self.pos_y,
                            self.width, sub_h),
                p.create_cu(self.cu_tree, self.depth, self.pos_x,
                            self.pos_y + sub_h, self.width, sub_h),
            ]
        elif split_type == k.SplitType.VERTICAL:
            self.sub_cus = [
                p.create_cu(self.cu_tree, self.depth, self.pos_x, self.pos_y,
                            sub_w, self.height),
                p.create_cu(self.cu_tree, self.depth, self.pos_x + sub_w,
                            self.pos_y, sub_w, self.height),
            ]

    def un_split(self):
        self.sub_cus = []
        self.split = k.SplitType.NONE


class RefEntry:
    __slots__ = ("poc", "pic_data", "rec_pic", "orig_pic")

    def __init__(self, poc, pic_data, rec_pic, orig_pic):
        self.poc = poc
        self.pic_data = pic_data
        self.rec_pic = rec_pic
        self.orig_pic = orig_pic

    @property
    def tid(self):
        return self.pic_data.tid

    @property
    def pic_type(self):
        return self.pic_data.get_prediction_type()


class ReferencePictureLists:
    """L0/L1 reference picture list entries
    (ref: src/xvc_common_lib/reference_picture_lists.{h,cc})."""

    def __init__(self):
        self.entries = [[], []]  # per list: list of RefEntry
        self.current_poc = -1
        self.only_back_references = True

    def reset(self, current_poc):
        self.entries = [[], []]
        self.current_poc = current_poc
        self.only_back_references = True

    def set_ref_pic(self, ref_list, ref_idx, poc, pic_data, rec_pic,
                    orig_pic=None):
        lst = self.entries[ref_list]
        while len(lst) <= ref_idx:
            lst.append(None)
        lst[ref_idx] = RefEntry(poc, pic_data, rec_pic, orig_pic)
        if poc > self.current_poc:
            self.only_back_references = False

    def has_ref_poc(self, ref_list, poc):
        for e in self.entries[ref_list]:
            if e is not None and e.poc == poc:
                return True
        return False

    def has_only_back_references_flag(self):
        return self.only_back_references

    def zero_out_references(self):
        # Keep POC entries (needed for cross-picture TMVP scaling) but
        # release picture memory (ref: reference_picture_lists.cc:124-135).
        for lst in self.entries:
            for e in lst:
                if e is not None:
                    e.pic_data = None
                    e.rec_pic = None
                    e.orig_pic = None

    def get_coding_unit_at(self, ref_list, ref_idx, cu_tree, posx, posy):
        pd = self.entries[ref_list][ref_idx].pic_data
        return pd.get_cu_at(cu_tree, posx, posy)

    def get_num_ref_pics(self, ref_list):
        return len(self.entries[ref_list])

    def get_ref_poc(self, ref_list, ref_idx):
        if ref_idx < len(self.entries[ref_list]):
            return self.entries[ref_list][ref_idx].poc
        return 0

    def get_ref_pic_tid(self, ref_list, ref_idx):
        if ref_idx < len(self.entries[ref_list]):
            return self.entries[ref_list][ref_idx].tid
        return -1

    def get_ref_pic_type(self, ref_list, ref_idx):
        if ref_idx < len(self.entries[ref_list]):
            return self.entries[ref_list][ref_idx].pic_type
        return None

    def get_ref_pic(self, ref_list, ref_idx):
        return self.entries[ref_list][ref_idx].rec_pic

    def get_ref_pic_data(self, ref_list, ref_idx):
        return self.entries[ref_list][ref_idx].pic_data

    def has_only_back_references(self, current_poc):
        for lst in self.entries:
            for e in lst:
                if e.poc > current_poc:
                    return False
        return True

    @staticmethod
    def is_ref_pic_list_used(ref_list, inter_dir):
        if inter_dir == k.InterDir.BI:
            return True
        return (ref_list == 0) == (inter_dir == k.InterDir.L0)


class PictureData:
    """Per-picture CU grid + high-level picture state."""

    def __init__(self, chroma_format, width, height, bitdepth):
        self.chroma_format = chroma_format
        self.width = width
        self.height = height
        self.bitdepth = bitdepth
        self.chroma_shift_x = k.chroma_shift_x(chroma_format)
        self.chroma_shift_y = k.chroma_shift_y(chroma_format)
        self.max_num_components = k.num_components(chroma_format)
        self.ctu_num_x = (width + k.CTU_SIZE - 1) // k.CTU_SIZE
        self.ctu_num_y = (height + k.CTU_SIZE - 1) // k.CTU_SIZE
        # CU table stride mirrors the reference's padded layout so that
        # above-right / below-left lookups are safely out of range.
        num_cu_x = (width + k.MAX_BLOCK_SIZE - 1) // k.MIN_BLOCK_SIZE
        num_cu_y = (height + k.MAX_BLOCK_SIZE - 1) // k.MIN_BLOCK_SIZE
        self.cu_stride = num_cu_x + 1
        self.cu_rows = num_cu_y + 1
        self.cu_table = [
            [None] * (self.cu_stride * self.cu_rows),
            [None] * (self.cu_stride * self.cu_rows)]
        self.ctus = [[], []]
        self.num_cu_trees = 1
        self.cu_tree_components = [[0, 1, 2] if self.max_num_components > 1
                                   else [0], []]
        self.max_binary_split_depth = 0
        # hl syntax
        self.nal_type = k.NalUnitType.INTRA_PICTURE
        self.poc = -1
        self.doc = -1
        self.soc = -1
        self.tid = -1
        self.sub_gop_length = 0
        self.highest_layer = False
        self.adaptive_qp = 0
        self.deblock = True
        self.beta_offset = 0
        self.tc_offset = 0
        self.lic_active = False
        self.pic_qp = None
        self.qps = []
        self.ref_pic_lists = ReferencePictureLists()
        self.force_bipred_l1_mvd_zero = False
        self.tmvp_valid = False
        self.tmvp_ref_list = 0
        self.tmvp_ref_idx = 0
        self.restrictions = None
        # CTU-tile-row extension state (xvc_tpu, SURVEY §2.5/§5): while
        # coding the CTUs of one tile, tile_ctx_top_y is the tile's top
        # luma row and get_cu_at masks every lookup above it, cutting
        # CABAC contexts / MPM / MVP / qp prediction / intra
        # availability at the tile boundary.  Cleared (0) outside the
        # coding pass so deblocking and cross-picture TMVP see the full
        # picture.
        self.tile_rows = 1
        self.tile_row_starts = [0]
        self.tile_ctx_top_y = 0

    def init(self, segment, pic_qp: Qp, recalculate_lambda, light=False):
        """light=True skips the per-picture CU/qp object allocation: the
        native whole-picture decoder keeps CU state in C++ and only needs
        the derived header-level fields (tmvp, trees, force flags)."""
        r = segment.restrictions
        self.restrictions = r
        self.tile_ctx_top_y = 0
        self.set_tiles(getattr(segment, "tile_rows", 1))
        if (not r.disable_ext_two_cu_trees and self.is_intra_pic() and
                self.max_num_components > 1):
            self.num_cu_trees = 2
            self.cu_tree_components = [[0], [1, 2]]
        elif self.max_num_components > 1:
            self.num_cu_trees = 1
            self.cu_tree_components = [[0, 1, 2], []]
        else:
            self.num_cu_trees = 1
            self.cu_tree_components = [[0], []]
        self.max_binary_split_depth = segment.max_binary_split_depth
        self.pic_qp = pic_qp
        # parameters for lazy qp-table construction (light init defers
        # it; the flat decode path only touches a handful of raw qps)
        self._qp_params = (recalculate_lambda, segment.chroma_qp_offset_table,
                           segment.chroma_qp_offset_u,
                           segment.chroma_qp_offset_v)
        if light:
            self.qps = None
        else:
            self._build_qps()
        if not light:
            for tree in range(k.MAX_NUM_CU_TREES):
                n = self.cu_stride * self.cu_rows
                self.cu_table[tree] = [None] * n
                self.ctus[tree] = []
            self._allocate_all_ctus(k.CuTree.PRIMARY)
            if self.num_cu_trees > 1:
                self._allocate_all_ctus(k.CuTree.SECONDARY)
        self.force_bipred_l1_mvd_zero = self._determine_force_l1_mvd_zero(r)
        self.tmvp_ref_list = self._determine_tmvp_ref_list(r)
        pic_type = self.ref_pic_lists.get_ref_pic_type(self.tmvp_ref_list,
                                                       self.tmvp_ref_idx)
        self.tmvp_valid = pic_type in (k.PicturePredictionType.UNI,
                                       k.PicturePredictionType.BI)

    def _allocate_all_ctus(self, cu_tree):
        for y in range(self.ctu_num_y):
            for x in range(self.ctu_num_x):
                cu = self.create_cu(cu_tree, 0, x * k.CTU_SIZE,
                                    y * k.CTU_SIZE, k.CTU_SIZE, k.CTU_SIZE)
                self.ctus[int(cu_tree)].append(cu)

    def _determine_force_l1_mvd_zero(self, restrictions):
        if self.is_intra_pic() or \
                restrictions.disable_ext2_inter_bipred_l1_mvd_zero:
            return False
        return self.ref_pic_lists.has_only_back_references_flag()

    def _determine_tmvp_ref_list(self, restrictions):
        self.tmvp_ref_idx = 0
        if (self.get_prediction_type() != k.PicturePredictionType.BI or
                restrictions.disable_inter_tmvp_ref_list_derivation):
            return 0
        tid_l0 = self.ref_pic_lists.get_ref_pic_tid(0, 0)
        tid_l1 = self.ref_pic_lists.get_ref_pic_tid(1, 0)
        if not restrictions.disable_ext_tmvp_exclude_intra_from_ref_list:
            if self.ref_pic_lists.get_ref_pic_type(0, 0) == \
                    k.PicturePredictionType.INTRA:
                return 1
            if self.ref_pic_lists.get_ref_pic_type(1, 0) == \
                    k.PicturePredictionType.INTRA:
                return 0
        return 1 if tid_l1 >= tid_l0 else 0

    def get_prediction_type(self):
        t = self.nal_type
        if t in (k.NalUnitType.INTRA_ACCESS_PICTURE,
                 k.NalUnitType.INTRA_PICTURE):
            return k.PicturePredictionType.INTRA
        if t in (k.NalUnitType.PREDICTED_ACCESS_PICTURE,
                 k.NalUnitType.PREDICTED_PICTURE):
            return k.PicturePredictionType.UNI
        return k.PicturePredictionType.BI

    def is_intra_pic(self):
        return self.get_prediction_type() == k.PicturePredictionType.INTRA

    def has_secondary_cu_tree(self):
        return self.num_cu_trees > 1

    def get_components(self, cu_tree):
        return self.cu_tree_components[int(cu_tree)]

    def get_max_depth(self, cu_tree):
        return (k.MAX_CU_DEPTH if cu_tree == k.CuTree.PRIMARY
                else k.MAX_CU_DEPTH_CHROMA)

    def get_max_binary_split_size(self, cu_tree):
        if not self.is_intra_pic():
            return k.MAX_BINARY_SPLIT_SIZE_INTER
        return (k.MAX_BINARY_SPLIT_SIZE_INTRA1
                if cu_tree == k.CuTree.PRIMARY
                else k.MAX_BINARY_SPLIT_SIZE_INTRA2)

    def get_ctu(self, cu_tree, rsaddr):
        return self.ctus[int(cu_tree)][rsaddr]

    def get_number_of_ctus(self):
        return len(self.ctus[0])

    def get_cu_at(self, cu_tree, posx, posy):
        if posy < self.tile_ctx_top_y:
            return None  # above the current tile: unavailable
        idx = (posy // k.MIN_BLOCK_SIZE) * self.cu_stride + \
            (posx // k.MIN_BLOCK_SIZE)
        return self.cu_table[int(cu_tree)][idx]

    def tile_top_y_of_row(self, ctu_row):
        """Top luma row of the tile containing this CTU row."""
        top = 0
        for start in self.tile_row_starts:
            if start > ctu_row:
                break
            top = start
        return top * k.CTU_SIZE

    def set_tiles(self, tile_rows):
        """Install the CTU-tile-row split: tile r covers CTU rows
        [starts[r], starts[r+1]).  Returns the per-tile (row0, row1)
        list.  Clamped so every tile has at least one CTU row."""
        r = min(max(1, tile_rows), self.ctu_num_y)
        self.tile_rows = r
        self.tile_row_starts = [t * self.ctu_num_y // r for t in range(r)]
        bounds = self.tile_row_starts + [self.ctu_num_y]
        return [(bounds[t], bounds[t + 1]) for t in range(r)]

    def _build_qps(self):
        recalculate_lambda, tab, off_u, off_v = self._qp_params
        pic_qp = self.pic_qp
        self.qps = []
        for i in range(k.MAX_ALLOWED_QP + 1):
            if recalculate_lambda:
                lambda_tmp = 0.57 * 2.0 ** ((i - 12) / 3.0)
            else:
                lambda_tmp = pic_qp.get_lambda() * \
                    2.0 ** ((i - pic_qp.get_qp_raw(0)) / 3.0)
            self.qps.append(Qp(i, self.chroma_format, self.bitdepth,
                               lambda_tmp, tab, off_u, off_v))

    def get_qp_obj(self, raw_qp):
        if self.qps is None:
            self._build_qps()  # deferred by light init
        return self.qps[min(max(raw_qp, 0), k.MAX_ALLOWED_QP)]

    def create_cu(self, cu_tree, depth, posx, posy, width, height):
        if posx >= self.width or posy >= self.height:
            return None
        return CodingUnit(self, cu_tree, depth, posx, posy, width, height)

    def mark_used_in_pic(self, cu):
        if cu.split != k.SplitType.NONE:
            for sub in cu.sub_cus:
                if sub is not None:
                    self.mark_used_in_pic(sub)
            return
        tree = int(cu.cu_tree)
        ix = cu.pos_x // k.MIN_BLOCK_SIZE
        iy = cu.pos_y // k.MIN_BLOCK_SIZE
        nx = cu.width // k.MIN_BLOCK_SIZE
        ny = cu.height // k.MIN_BLOCK_SIZE
        table = self.cu_table[tree]
        for y in range(ny):
            base = (iy + y) * self.cu_stride + ix
            for x in range(nx):
                table[base + x] = cu

    def clear_mark_cu_in_pic(self, cu):
        tree = int(cu.cu_tree)
        ix = cu.pos_x // k.MIN_BLOCK_SIZE
        iy = cu.pos_y // k.MIN_BLOCK_SIZE
        nx = cu.width // k.MIN_BLOCK_SIZE
        ny = cu.height // k.MIN_BLOCK_SIZE
        table = self.cu_table[tree]
        for y in range(ny):
            base = (iy + y) * self.cu_stride + ix
            for x in range(nx):
                table[base + x] = None
