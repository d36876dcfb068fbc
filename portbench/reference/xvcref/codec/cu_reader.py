"""CU-tree syntax parsing (decoder side).

Behavioral equivalent of the reference CU reader
(ref: src/xvc_dec_lib/cu_reader.cc).
"""
from .. import constants as k
from . import intra_modes


class CuReader:
    def __init__(self, pic_data, restrictions):
        self.pic = pic_data
        self.restr = restrictions
        self.ctu_has_coeffs = False

    def read_ctu(self, cu, reader):
        self.ctu_has_coeffs = False
        self._read_cu(cu, k.SplitRestriction.NONE, reader)
        return self.ctu_has_coeffs

    def _read_cu(self, cu, split_restriction, reader):
        split = self._read_split(cu, split_restriction, reader)
        if split != k.SplitType.NONE:
            cu.do_split(split)
            sub_split_restriction = k.SplitRestriction.NONE
            for sub_cu in cu.sub_cus:
                if sub_cu is not None:
                    sub_cu.qp = cu.qp
                    self._read_cu(sub_cu, sub_split_restriction, reader)
                    sub_split_restriction = \
                        sub_cu.derive_sibling_split_restriction(split)
        else:
            cu.split = k.SplitType.NONE
            self.pic.mark_used_in_pic(cu)
            for comp in self.pic.get_components(cu.cu_tree):
                self._read_component(cu, comp, reader)

    def _read_split(self, cu, split_restriction, reader):
        split = k.SplitType.NONE
        binary_depth = cu.binary_depth
        max_depth = self.pic.get_max_depth(cu.cu_tree)
        if cu.depth < max_depth and binary_depth == 0:
            if cu.is_fully_within_picture():
                split = reader.read_split_quad(cu, max_depth)
            else:
                split = k.SplitType.QUAD
        if split != k.SplitType.QUAD:
            if cu.is_binary_split_valid():
                split = reader.read_split_binary(cu, split_restriction)
        return split

    def _read_component(self, cu, comp, reader):
        if comp == 0:
            if not self.pic.is_intra_pic():
                skip_flag = reader.read_skip_flag(cu)
                cu.skip_flag = skip_flag
                if skip_flag:
                    cu.pred_mode = k.PredictionMode.INTER
                    cu.merge_flag = True
                    self._read_merge_prediction(cu, comp, reader)
                    return
                cu.pred_mode = reader.read_pred_mode()
            else:
                cu.pred_mode = k.PredictionMode.INTRA
                cu.skip_flag = False
            if self.restr.disable_ext_implicit_partition_type:
                reader.read_partition_type(cu)
        elif cu.skip_flag:
            cu.cbf[comp] = False
            return

        if cu.is_intra():
            self._read_intra_prediction(cu, comp, reader)
        else:
            self._read_inter_prediction(cu, comp, reader)
        self._read_residual_data(cu, comp, reader)

    def _read_intra_prediction(self, cu, comp, reader):
        if comp == 0:
            mpm = intra_modes.get_predictor_luma(cu, self.restr)
            cu.intra_mode_luma = reader.read_intra_mode(mpm)
        elif comp == 1:
            luma_cu = self.pic.get_cu_at(k.CuTree.PRIMARY,
                                         cu.pos_x, cu.pos_y)
            luma_mode = luma_cu.intra_mode_luma
            chroma_preds = intra_modes.get_predictors_chroma(luma_mode,
                                                             self.restr)
            chroma_mode = k.INTRA_CHROMA_DM
            if not self.restr.disable_intra_chroma_predictor:
                chroma_mode = reader.read_intra_chroma_mode(chroma_preds)
            cu.intra_mode_chroma = chroma_mode

    def _read_inter_prediction(self, cu, comp, reader):
        if comp != 0:
            return
        merge = reader.read_merge_flag()
        cu.merge_flag = merge
        if merge:
            self._read_merge_prediction(cu, comp, reader)
            return
        if self.pic.get_prediction_type() == k.PicturePredictionType.BI:
            cu.inter_dir = reader.read_inter_dir(cu)
        else:
            cu.inter_dir = k.InterDir.L0
        if cu.can_use_affine():
            cu.use_affine = reader.read_affine_flag(cu, False)
        else:
            cu.use_affine = False
        for ref_list in range(2):
            if not self._ref_list_used(ref_list, cu.inter_dir):
                continue
            num_refs = self.pic.ref_pic_lists.get_num_ref_pics(ref_list)
            cu.ref_idx[ref_list] = reader.read_inter_ref_idx(num_refs)
            if cu.get_force_mvd_zero(ref_list):
                cu.mvd[ref_list][0] = (0, 0)
            elif cu.use_affine:
                cu.mvd[ref_list][0] = reader.read_inter_mvd()
                cu.mvd[ref_list][1] = reader.read_inter_mvd()
            else:
                cu.mvd[ref_list][0] = reader.read_inter_mvd()
            cu.mvp_idx[ref_list] = reader.read_inter_mvp_idx(cu)
        if not cu.has_zero_mvd() and not cu.use_affine:
            cu.fullpel_mv = reader.read_inter_fullpel_mv_flag(cu)
        if self.pic.lic_active and not cu.use_affine:
            cu.use_lic = reader.read_lic_flag()

    @staticmethod
    def _ref_list_used(ref_list, inter_dir):
        if inter_dir == k.InterDir.BI:
            return True
        return (ref_list == 0) == (inter_dir == k.InterDir.L0)

    def _read_merge_prediction(self, cu, comp, reader):
        if cu.can_affine_merge():
            cu.use_affine = reader.read_affine_flag(cu, True)
        if cu.use_affine:
            cu.merge_idx = 0
        else:
            cu.merge_idx = reader.read_merge_idx()

    def _read_residual_data(self, cu, comp, reader):
        cbf = self._read_cbf_invariant(cu, comp, reader)
        coeff = cu.get_coeff(comp)
        coeff[:] = 0
        if cbf:
            self.ctu_has_coeffs = True
            self._read_residual_data_internal(cu, comp, reader)

    def _read_residual_data_internal(self, cu, comp, reader):
        coeff = cu.get_coeff(comp)
        use_transform_select = False
        if comp == 0:
            use_transform_select = reader.read_transform_select_enable(cu)
            if not use_transform_select:
                cu.set_transform_from_select_idx(comp, -1, self.restr)
        transform_skip = reader.read_transform_skip(cu, comp)
        cu.transform_skip[comp] = transform_skip
        num_coeff = reader.read_coefficients(cu, comp, coeff)
        if comp == 0 and use_transform_select:
            tx_select_idx = 0
            if not transform_skip and \
                    (cu.is_inter() or
                     num_coeff >= k.TRANSFORM_SELECT_MIN_SIG_COEFFS):
                tx_select_idx = reader.read_transform_select_idx(cu)
            cu.set_transform_from_select_idx(comp, tx_select_idx, self.restr)
        cu.dc_only[comp] = num_coeff == 1 and coeff[0, 0] != 0

    def _read_cbf_invariant(self, cu, comp, reader):
        """(ref: cu_reader.cc:232-276)"""
        if cu.is_inter() and (not cu.merge_flag or
                              self.restr.disable_inter_skip_mode):
            if comp == 0:
                root_cbf = reader.read_root_cbf()
                cu.root_cbf = root_cbf
                if not root_cbf:
                    if cu.merge_flag:
                        cu.skip_flag = True
                    cu.cbf = [False, False, False]
                    return False
            elif not cu.root_cbf:
                return False
        if cu.is_intra():
            cbf = reader.read_cbf(cu, comp)
        elif comp == 0:
            cbf_u = reader.read_cbf(cu, 1)
            cbf_v = reader.read_cbf(cu, 1)
            cu.cbf[1] = cbf_u
            cu.cbf[2] = cbf_v
            if cbf_u or cbf_v or self.restr.disable_transform_root_cbf:
                cbf = reader.read_cbf(cu, comp)
            else:
                cbf = True  # implicitly signaled through root cbf
            if self.restr.disable_inter_skip_mode and cu.merge_flag and \
                    not cbf and not cbf_u and not cbf_v:
                cu.skip_flag = True
        else:
            cbf = cu.cbf[comp]  # signaled from luma
        cu.cbf[comp] = cbf
        return cbf
