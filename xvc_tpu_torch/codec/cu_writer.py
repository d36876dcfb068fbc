"""Serialize a decided CU tree to the syntax writer.

Behavioral equivalent of the reference CU writer
(ref: src/xvc_enc_lib/cu_writer.cc).  Copy of
``xvc_tpu/codec/cu_writer.py``.
"""
from .. import constants as k
from . import intra_modes


class CuWriter:
    def __init__(self, pic_data, restrictions):
        self.pic = pic_data
        self.restr = restrictions
        self.ctu_has_coeffs = False

    def write_ctu(self, ctu, writer):
        self.ctu_has_coeffs = False
        self.pic.clear_mark_cu_in_pic(ctu)
        self.write_cu(ctu, k.SplitRestriction.NONE, writer)
        return self.ctu_has_coeffs

    def write_cu(self, cu, split_restriction, writer):
        self.write_split(cu, split_restriction, writer)
        if cu.split != k.SplitType.NONE:
            sub_split_restriction = k.SplitRestriction.NONE
            for sub_cu in cu.sub_cus:
                if sub_cu is not None:
                    self.write_cu(sub_cu, sub_split_restriction, writer)
                    sub_split_restriction = \
                        sub_cu.derive_sibling_split_restriction(cu.split)
        else:
            self.pic.mark_used_in_pic(cu)
            for comp in self.pic.get_components(cu.cu_tree):
                self.write_component(cu, comp, writer)

    def write_split(self, cu, split_restriction, writer):
        split_type = cu.split
        binary_depth = cu.binary_depth
        max_depth = self.pic.get_max_depth(cu.cu_tree)
        if cu.depth < max_depth and binary_depth == 0:
            if cu.is_fully_within_picture():
                writer.write_split_quad(cu, max_depth, split_type)
        if split_type != k.SplitType.QUAD:
            if cu.is_binary_split_valid():
                writer.write_split_binary(cu, split_restriction, split_type)

    def write_component(self, cu, comp, writer):
        if comp == 0:
            if not self.pic.is_intra_pic():
                writer.write_skip_flag(cu, cu.skip_flag)
                if cu.skip_flag:
                    self.write_merge_prediction(cu, comp, writer)
                    return
                writer.write_pred_mode(cu.pred_mode)
            if self.restr.disable_ext_implicit_partition_type:
                writer.write_partition_type(cu)
        elif cu.skip_flag:
            return
        if cu.is_intra():
            self.write_intra_prediction(cu, comp, writer)
        else:
            self.write_inter_prediction(cu, comp, writer)
        self.write_residual_data(cu, comp, writer)

    def write_intra_prediction(self, cu, comp, writer):
        luma_cu = cu if cu.cu_tree == k.CuTree.PRIMARY else \
            self.pic.get_cu_at(k.CuTree.PRIMARY, cu.pos_x, cu.pos_y)
        luma_mode = luma_cu.intra_mode_luma
        if comp == 0:
            mpm = intra_modes.get_predictor_luma(cu, self.restr)
            writer.write_intra_mode(luma_mode, mpm)
        elif comp == 1:
            chroma_preds = intra_modes.get_predictors_chroma(luma_mode,
                                                             self.restr)
            if not self.restr.disable_intra_chroma_predictor:
                writer.write_intra_chroma_mode(cu.intra_mode_chroma,
                                               chroma_preds)

    def write_inter_prediction(self, cu, comp, writer):
        if comp != 0:
            return
        writer.write_merge_flag(cu.merge_flag)
        if cu.merge_flag:
            self.write_merge_prediction(cu, comp, writer)
            return
        if self.pic.get_prediction_type() == k.PicturePredictionType.BI:
            writer.write_inter_dir(cu, cu.inter_dir)
        if cu.can_use_affine():
            writer.write_affine_flag(cu, False, cu.use_affine)
        for ref_list in range(2):
            if not self._ref_list_used(ref_list, cu.inter_dir):
                continue
            num_refs = self.pic.ref_pic_lists.get_num_ref_pics(ref_list)
            writer.write_inter_ref_idx(cu.ref_idx[ref_list], num_refs)
            if cu.get_force_mvd_zero(ref_list):
                pass
            elif cu.use_affine:
                writer.write_inter_mvd(cu.mvd[ref_list][0])
                writer.write_inter_mvd(cu.mvd[ref_list][1])
            else:
                writer.write_inter_mvd(cu.mvd[ref_list][0])
            writer.write_inter_mvp_idx(cu, cu.mvp_idx[ref_list])
        if not cu.has_zero_mvd() and not cu.use_affine:
            writer.write_inter_fullpel_mv_flag(cu, cu.fullpel_mv)
        if self.pic.lic_active and not cu.use_affine:
            writer.write_lic_flag(cu.use_lic)

    @staticmethod
    def _ref_list_used(ref_list, inter_dir):
        if inter_dir == k.InterDir.BI:
            return True
        return (ref_list == 0) == (inter_dir == k.InterDir.L0)

    def write_merge_prediction(self, cu, comp, writer):
        if cu.can_affine_merge():
            writer.write_affine_flag(cu, True, cu.use_affine)
        if not cu.use_affine:
            writer.write_merge_idx(cu.merge_idx)

    def write_residual_data(self, cu, comp, writer):
        cbf = self.write_cbf_invariant(cu, comp, writer)
        if cbf:
            self.ctu_has_coeffs = True
            self.write_residual_data_internal(cu, comp, writer)

    def write_residual_data_rdo_cbf(self, cu, comp, writer):
        cbf = cu.cbf[comp]
        writer.write_cbf(cu, comp, cbf)
        if cbf:
            self.write_residual_data_internal(cu, comp, writer)

    def write_residual_data_internal(self, cu, comp, writer):
        coeff = cu.get_coeff(comp)
        use_transform_select = False
        if comp == 0:
            use_transform_select = cu.tx_select_idx >= 0
            writer.write_transform_select_enable(cu, use_transform_select)
        writer.write_transform_skip(cu, comp, cu.transform_skip[comp])
        num_coeff = writer.write_coefficients(cu, comp, coeff)
        if comp == 0 and use_transform_select:
            if not cu.transform_skip[comp] and \
                    (cu.is_inter() or
                     num_coeff >= k.TRANSFORM_SELECT_MIN_SIG_COEFFS):
                writer.write_transform_select_idx(cu, cu.tx_select_idx)

    def write_cbf_invariant(self, cu, comp, writer):
        if cu.is_inter() and (not cu.merge_flag or
                              self.restr.disable_inter_skip_mode):
            root_cbf = cu.root_cbf
            if comp == 0:
                writer.write_root_cbf(root_cbf)
            if not root_cbf:
                return False
        cbf = cu.cbf[comp]
        if cu.is_intra():
            writer.write_cbf(cu, comp, cbf)
        elif comp == 0:
            writer.write_cbf(cu, 1, cu.cbf[1])
            writer.write_cbf(cu, 2, cu.cbf[2])
            if cu.cbf[1] or cu.cbf[2] or \
                    self.restr.disable_transform_root_cbf:
                writer.write_cbf(cu, 0, cbf)
        return cbf
