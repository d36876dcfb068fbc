"""Coding-unit tree, picture-level state and reference picture lists.

Behavioral equivalent of the reference CU data model and picture data
(ref: src/xvc_common_lib/coding_unit.{h,cc}, picture_data.{h,cc},
reference_picture_lists.{h,cc}).  Copy of ``CodingUnit``,
``PictureData``, ``RefEntry`` and ``ReferencePictureLists`` of
``xvc_tpu/codec/cu.py``, trimmed to what decoding reads: the flat path
reconstructs from the native parse's record table alone; the replay path
(``gpu/recon.py``) also rebuilds the CU tree (``native/pic.py``
``_replay_tree``) for its host tail, whose neighbour queries go through
the 4x4-granular CU table below (``PictureData::GetCuAt`` semantics,
including the +1 padded stride that guards below/right lookups).  CU
fields that only the parse or the encoder read (skip, merge, MVD,
transform selection, coefficients, qp) are left out; tiles are not on
the port's path.
"""
from .. import constants as k
from ..ops.quant import Qp


class CodingUnit:
    __slots__ = (
        "pic", "cu_tree", "depth", "pos_x", "pos_y", "width", "height",
        "split", "sub_cus", "pred_mode", "intra_mode_luma",
        "intra_mode_chroma", "inter_dir", "use_affine", "use_lic", "mv",
        "ref_idx", "cbf",
    )

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
    """High-level state of one picture.  CU-level state lives in the
    native parse's record table (``_parse_records``) and, for a picture
    initialised with ``tree=True``, in the CU tree the replay rebuilds
    from it.  The native encoder keeps its CU state in C++; the picture
    encoder reads the header-level fields here (``init`` with
    ``pic_qp``), and the encoded picture's motion field for the TMVP of
    later pictures (``_xvcn_mvfield``, ``native/enc.py``)."""

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
        self.cu_table = [None, None]
        self.ctus = [[], []]
        self.num_cu_trees = 1
        self.cu_tree_components = [[0, 1, 2] if self.max_num_components > 1
                                   else [0], []]
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
        self.qps = None
        self.pic_qp = None
        self.max_binary_split_depth = 0
        self.ref_pic_lists = ReferencePictureLists()
        self.force_bipred_l1_mvd_zero = False
        self.tmvp_valid = False
        self.tmvp_ref_list = 0
        self.tmvp_ref_idx = 0

    def init(self, segment, tree=False, pic_qp=None):
        """Derive the header-level fields of a new picture (CU trees,
        TMVP source, forced-zero L1 MVD); with ``tree`` also allocate the
        CTUs and the CU table of the CU tree the replay fills.  The
        encoder passes the picture's ``Qp`` (the light init of the JAX
        package's native encode path)."""
        r = segment.restrictions
        self.pic_qp = pic_qp
        self.max_binary_split_depth = segment.max_binary_split_depth
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
        self.ctus = [[], []]
        self.cu_table = [None, None]
        if tree:
            for t in range(self.num_cu_trees):
                self.cu_table[t] = [None] * (self.cu_stride * self.cu_rows)
                self.ctus[t] = [
                    self.create_cu(t, 0, x * k.CTU_SIZE, y * k.CTU_SIZE,
                                   k.CTU_SIZE, k.CTU_SIZE)
                    for y in range(self.ctu_num_y)
                    for x in range(self.ctu_num_x)]
        # the qp table is built on demand (the flat decode path only
        # touches a handful of raw qps)
        self._qp_params = (segment.chroma_qp_offset_table,
                           segment.chroma_qp_offset_u,
                           segment.chroma_qp_offset_v)
        self.qps = None
        self.force_bipred_l1_mvd_zero = self._determine_force_l1_mvd_zero(r)
        self.tmvp_ref_list = self._determine_tmvp_ref_list(r)
        pic_type = self.ref_pic_lists.get_ref_pic_type(self.tmvp_ref_list,
                                                       self.tmvp_ref_idx)
        self.tmvp_valid = pic_type in (k.PicturePredictionType.UNI,
                                       k.PicturePredictionType.BI)

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

    def get_max_binary_split_size(self, cu_tree):
        if not self.is_intra_pic():
            return k.MAX_BINARY_SPLIT_SIZE_INTER
        return (k.MAX_BINARY_SPLIT_SIZE_INTRA1
                if cu_tree == k.CuTree.PRIMARY
                else k.MAX_BINARY_SPLIT_SIZE_INTRA2)

    def _build_qps(self):
        tab, off_u, off_v = self._qp_params
        self.qps = [Qp(i, self.chroma_format, self.bitdepth, 0.0, tab,
                       off_u, off_v)
                    for i in range(k.MAX_ALLOWED_QP + 1)]

    # ---- the CU tree (pictures initialised with tree=True) ----
    def get_components(self, cu_tree):
        return self.cu_tree_components[int(cu_tree)]

    def get_ctu(self, cu_tree, rsaddr):
        return self.ctus[int(cu_tree)][rsaddr]

    def get_number_of_ctus(self):
        return len(self.ctus[0])

    def get_cu_at(self, cu_tree, posx, posy):
        idx = (posy // k.MIN_BLOCK_SIZE) * self.cu_stride + \
            (posx // k.MIN_BLOCK_SIZE)
        return self.cu_table[int(cu_tree)][idx]

    def create_cu(self, cu_tree, depth, posx, posy, width, height):
        """A CU with the reference's reset_prediction_state defaults, or
        None where its origin lies outside the picture."""
        if posx >= self.width or posy >= self.height:
            return None
        cu = CodingUnit()
        cu.pic = self
        cu.cu_tree = cu_tree
        cu.depth = depth
        cu.pos_x = posx
        cu.pos_y = posy
        cu.width = width
        cu.height = height
        cu.split = k.SplitType.NONE
        cu.sub_cus = []
        cu.pred_mode = k.PredictionMode.INTRA
        cu.intra_mode_luma = k.INTRA_MODE_INVALID
        cu.intra_mode_chroma = k.INTRA_MODE_INVALID
        cu.inter_dir = k.InterDir.L0
        cu.use_affine = False
        cu.use_lic = False
        cu.mv = _MV0
        cu.ref_idx = _IDX0
        cu.cbf = _F3
        return cu

    def _paint(self, cu, value):
        ix = cu.pos_x // k.MIN_BLOCK_SIZE
        iy = cu.pos_y // k.MIN_BLOCK_SIZE
        nx = cu.width // k.MIN_BLOCK_SIZE
        table = self.cu_table[int(cu.cu_tree)]
        for y in range(cu.height // k.MIN_BLOCK_SIZE):
            base = (iy + y) * self.cu_stride + ix
            table[base:base + nx] = [value] * nx

    def mark_used_in_pic(self, cu):
        if cu.split != k.SplitType.NONE:
            for sub in cu.sub_cus:
                if sub is not None:
                    self.mark_used_in_pic(sub)
            return
        self._paint(cu, cu)

    def clear_mark_cu_in_pic(self, cu):
        self._paint(cu, None)


# Shared defaults of fresh CUs: the replay assigns new containers to the
# fields that differ and never mutates these in place.
_MV0 = [[(0, 0)] * 4, [(0, 0)] * 4]
_IDX0 = [0, 0]
_F3 = [False, False, False]
