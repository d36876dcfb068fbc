"""Picture-level state and reference picture lists.

Behavioral equivalent of the reference picture data and reference lists
(ref: src/xvc_common_lib/picture_data.{h,cc},
reference_picture_lists.{h,cc}).  Copy of ``PictureData``, ``RefEntry``
and ``ReferencePictureLists`` of ``xvc_tpu/codec/cu.py``, without the
Python coding-unit tree: the port parses natively and reconstructs from
the flat record table.
"""
from .. import constants as k
from ..ops.quant import Qp


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
    native parse's record table (``_parse_records``), not in Python
    objects."""

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
        self.num_cu_trees = 1
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
        self.ref_pic_lists = ReferencePictureLists()
        self.force_bipred_l1_mvd_zero = False
        self.tmvp_valid = False
        self.tmvp_ref_list = 0
        self.tmvp_ref_idx = 0

    def init(self, segment):
        """Derive the header-level fields of a new picture (CU trees,
        TMVP source, forced-zero L1 MVD)."""
        r = segment.restrictions
        if (not r.disable_ext_two_cu_trees and self.is_intra_pic() and
                self.max_num_components > 1):
            self.num_cu_trees = 2
        else:
            self.num_cu_trees = 1
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

    def _build_qps(self):
        tab, off_u, off_v = self._qp_params
        self.qps = [Qp(i, self.chroma_format, self.bitdepth, 0.0, tab,
                       off_u, off_v)
                    for i in range(k.MAX_ALLOWED_QP + 1)]
