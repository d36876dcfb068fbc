"""Syntax-element writer over the CABAC encoder + RDO bit counting.

Behavioral equivalent of the reference syntax writer
(ref: src/xvc_enc_lib/syntax_writer.cc).  An RdoSyntaxWriter is the same
object with a counting-only entropy encoder and copied context states.

Copy of ``xvc_tpu/syntax/writer.py``, over the native
library: the real bitstream is written by the native CABAC engine, and
residual blocks are coded (and counted, for the counting writers of the
RD search) by its residual writer; the JAX module's Python residual
coder is not copied.
"""
from .. import constants as k
from .. import native
from .. import scan
from ..cabac.contexts import OFFSETS, CabacContexts
from ..cabac.entropy_encoder import EntropyEncoder
from ..native.engines import NativeEntropyEncoder, count_write_coefficients


class SyntaxWriter:
    def __init__(self, qp, pic_type, bit_writer, restrictions):
        self.restr = restrictions
        self.ctx = CabacContexts(restrictions)
        self.ctx.reset_states(qp.get_qp_raw(0), pic_type)
        self.enc = NativeEntropyEncoder(
            bit_writer, self.ctx.state,
            ctx_update=not restrictions.disable_cabac_ctx_update)
        self._restr_mask = native.restr_bits(restrictions)

    @classmethod
    def rdo_clone(cls, writer, bits_written=None, frac_bits=None):
        """Counting-only copy with cloned context states
        (ref: syntax_writer.cc:851-871)."""
        w = cls.__new__(cls)
        w.restr = writer.restr
        w._restr_mask = writer._restr_mask
        w.ctx = CabacContexts.__new__(CabacContexts)
        w.ctx.restr = writer.restr
        w.ctx.state = writer.ctx.state.copy()
        if bits_written is None:
            bits_written = writer.enc.get_num_written_bits()
        if frac_bits is None:
            frac_bits = writer.enc.get_fractional_bits()
        w.enc = EntropyEncoder(w.ctx.state,
                               ctx_update=writer.enc.ctx_update,
                               written_bits=bits_written,
                               fractional_bits=frac_bits)
        return w

    def copy_from(self, other):
        """Restore state from another writer (RDO backtracking)."""
        self.ctx.state[:] = other.ctx.state
        self.enc.frac_bits = other.enc.frac_bits

    def get_num_written_bits(self):
        return self.enc.get_num_written_bits()

    def get_fractional_bits(self):
        return self.enc.get_fractional_bits()

    def finish(self):
        self.enc.encode_bin_trm(1)
        self.enc.finish()

    # ---- element writers ----
    def write_affine_flag(self, cu, is_merge, use_affine):
        if self.restr.disable_ext2_inter_affine or \
                (is_merge and self.restr.disable_ext2_inter_affine_merge):
            return
        ctx = self.ctx.get_affine_ctx(cu.get_cu_left(), cu.get_cu_above())
        self.enc.encode_bin(1 if use_affine else 0, ctx)

    def write_cbf(self, cu, comp, cbf):
        if self.restr.disable_transform_cbf:
            return
        if comp == 0:
            self.enc.encode_bin(1 if cbf else 0, OFFSETS["cu_cbf_luma"])
        else:
            self.enc.encode_bin(1 if cbf else 0, OFFSETS["cu_cbf_chroma"])

    def write_inter_dir(self, cu, inter_dir):
        ctx = self.ctx.get_inter_dir_bi_ctx(cu)
        self.enc.encode_bin(1 if inter_dir == k.InterDir.BI else 0, ctx)
        if inter_dir != k.InterDir.BI:
            self.enc.encode_bin(0 if inter_dir == k.InterDir.L0 else 1,
                                OFFSETS["inter_dir"] + 4)

    def write_inter_fullpel_mv_flag(self, cu, fullpel):
        if self.restr.disable_ext2_inter_adaptive_fullpel_mv:
            return
        ctx = self.ctx.get_inter_fullpel_mv_ctx(cu.get_cu_left(),
                                                cu.get_cu_above())
        self.enc.encode_bin(1 if fullpel else 0, ctx)

    def write_inter_mvd(self, mvd):
        abs_x, abs_y = abs(mvd[0]), abs(mvd[1])
        if self.restr.disable_inter_mvd_greater_than_flags:
            self.write_exp_golomb(abs_x, 1)
            if abs_x:
                self.enc.encode_bypass(1 if mvd[0] < 0 else 0)
            self.write_exp_golomb(abs_y, 1)
            if abs_y:
                self.enc.encode_bypass(1 if mvd[1] < 0 else 0)
            return
        self.enc.encode_bin(1 if mvd[0] else 0, OFFSETS["inter_mvd"])
        self.enc.encode_bin(1 if mvd[1] else 0, OFFSETS["inter_mvd"])
        if abs_x:
            self.enc.encode_bin(1 if abs_x > 1 else 0,
                                OFFSETS["inter_mvd"] + 1)
        if abs_y:
            self.enc.encode_bin(1 if abs_y > 1 else 0,
                                OFFSETS["inter_mvd"] + 1)
        if abs_x:
            if abs_x > 1:
                self.write_exp_golomb(abs_x - 2, 1)
            self.enc.encode_bypass(1 if mvd[0] < 0 else 0)
        if abs_y:
            if abs_y > 1:
                self.write_exp_golomb(abs_y - 2, 1)
            self.enc.encode_bypass(1 if mvd[1] < 0 else 0)

    def write_inter_mvp_idx(self, cu, mvp_idx):
        if (not cu.use_affine and self.restr.disable_inter_mvp) or \
                (cu.use_affine and self.restr.disable_ext2_inter_affine_mvp):
            return
        self.write_unary_max_symbol(mvp_idx, k.NUM_INTER_MV_PREDICTORS - 1,
                                    OFFSETS["inter_mvp_idx"],
                                    OFFSETS["inter_mvp_idx"])

    def write_inter_ref_idx(self, ref_idx, num_refs_available):
        if num_refs_available == 1:
            return
        self.enc.encode_bin(1 if ref_idx != 0 else 0,
                            OFFSETS["inter_ref_idx"])
        if not ref_idx or num_refs_available == 2:
            return
        ref_idx -= 1
        self.enc.encode_bin(1 if ref_idx != 0 else 0,
                            OFFSETS["inter_ref_idx"] + 1)
        if not ref_idx:
            return
        for i in range(1, num_refs_available - 2):
            b = 0 if i == ref_idx else 1
            self.enc.encode_bypass(b)
            if not b:
                break

    def write_intra_mode(self, intra_mode, mpm):
        num_mpm = k.NUM_INTRA_MPM_EXT \
            if not self.restr.disable_ext2_intra_6_predictors \
            else k.NUM_INTRA_MPM
        mpm_index = -1
        for i in range(num_mpm):
            if intra_mode == mpm[i]:
                mpm_index = i
        self.enc.encode_bin(1 if mpm_index >= 0 else 0,
                            OFFSETS["intra_pred_luma"])
        if mpm_index >= 0:
            if not self.restr.disable_ext2_intra_6_predictors:
                self.enc.encode_bin(
                    1 if mpm_index > 0 else 0,
                    self.ctx.get_intra_predictor_ctx(mpm[0]))
                if mpm_index > 0:
                    self.enc.encode_bin(
                        1 if mpm_index > 1 else 0,
                        self.ctx.get_intra_predictor_ctx(mpm[1]))
                    if mpm_index > 1:
                        self.enc.encode_bin(
                            1 if mpm_index > 2 else 0,
                            self.ctx.get_intra_predictor_ctx(mpm[2]))
                        if mpm_index > 2:
                            self.enc.encode_bypass(
                                1 if mpm_index > 3 else 0)
                            if mpm_index > 3:
                                self.enc.encode_bypass(
                                    1 if mpm_index > 4 else 0)
            else:
                num_bits = 1 + (1 if mpm_index > 0 else 0)
                self.enc.encode_bypass_bins(
                    mpm_index + (1 if mpm_index > 0 else 0), num_bits)
            return
        if not self.restr.disable_ext2_intra_6_predictors:
            mpm_sorted = sorted(mpm[:k.NUM_INTRA_MPM_EXT])
            mode_index = int(intra_mode)
            for i in range(k.NUM_INTRA_MPM_EXT - 1, -1, -1):
                if mode_index >= mpm_sorted[i]:
                    mode_index -= 1
            if not self.restr.disable_ext2_intra_67_modes:
                if mode_index <= k.NBR_INTRA_MODES_EXT - 8:
                    self.enc.encode_bypass_bins(mode_index, 6)
                else:
                    self.enc.encode_bypass_bins(mode_index >> 2, 4)
            else:
                self.enc.encode_bypass_bins(mode_index, 5)
        else:
            mpm_sorted = sorted(mpm[:k.NUM_INTRA_MPM])
            mode_index = int(intra_mode)
            for i in range(k.NUM_INTRA_MPM - 1, -1, -1):
                if mode_index >= mpm_sorted[i]:
                    mode_index -= 1
            if not self.restr.disable_ext2_intra_67_modes:
                self.enc.encode_bypass_bins(mode_index, 6)
            else:
                self.enc.encode_bypass_bins(mode_index, 5)

    def write_intra_chroma_mode(self, chroma_mode, chroma_preds):
        if chroma_mode == k.INTRA_CHROMA_DM:
            self.enc.encode_bin(0, OFFSETS["intra_pred_chroma"])
            return
        self.enc.encode_bin(1, OFFSETS["intra_pred_chroma"])
        if not self.restr.disable_ext2_intra_chroma_from_luma:
            if chroma_mode == k.INTRA_MODE_LM_CHROMA:
                self.enc.encode_bin(0, OFFSETS["intra_pred_chroma"] + 1)
                return
            self.enc.encode_bin(1, OFFSETS["intra_pred_chroma"] + 1)
        chroma_index = 0
        for i in range(1, len(chroma_preds) - 1):
            if chroma_mode == chroma_preds[i]:
                chroma_index = i
        self.enc.encode_bypass_bins(chroma_index, 2)

    def write_lic_flag(self, use_lic):
        if self.restr.disable_ext2_inter_local_illumination_comp:
            return
        self.enc.encode_bin(1 if use_lic else 0, OFFSETS["lic_flag"])

    def write_merge_flag(self, merge):
        if self.restr.disable_inter_merge_mode:
            return
        self.enc.encode_bin(1 if merge else 0, OFFSETS["inter_merge_flag"])

    def write_merge_idx(self, merge_idx):
        if self.restr.disable_inter_merge_candidates:
            return
        max_merge_cand = k.NUM_INTER_MERGE_CANDIDATES
        self.enc.encode_bin(1 if merge_idx != 0 else 0,
                            OFFSETS["inter_merge_idx"])
        if merge_idx != 0:
            bins = (1 << merge_idx) - 2
            if merge_idx == max_merge_cand - 1:
                bins >>= 1
            num_bins = merge_idx - (1 if merge_idx == max_merge_cand - 1
                                    else 0)
            self.enc.encode_bypass_bins(bins, num_bins)

    def write_partition_type(self, cu, part_2nx2n=True):
        if cu.pred_mode == k.PredictionMode.INTRA:
            if cu.depth == k.MAX_CU_DEPTH:
                self.enc.encode_bin(1 if part_2nx2n else 0,
                                    OFFSETS["cu_part_size"])
            return
        self.enc.encode_bin(1 if part_2nx2n else 0, OFFSETS["cu_part_size"])

    def write_pred_mode(self, pred_mode):
        self.enc.encode_bin(
            1 if pred_mode == k.PredictionMode.INTRA else 0,
            OFFSETS["cu_pred_mode"])

    def write_qp(self, qp_value, predicted_qp, aqp_mode):
        if aqp_mode == 1:
            self.enc.encode_bypass_bins(qp_value, 7)
            return
        if qp_value == predicted_qp:
            self.enc.encode_bin(1, OFFSETS["delta_qp"])
            return
        self.enc.encode_bin(0, OFFSETS["delta_qp"])
        if qp_value in (predicted_qp - 1, predicted_qp + 10):
            self.enc.encode_bypass_bins(2, 2)
        elif qp_value in (predicted_qp + 1, predicted_qp - 10):
            self.enc.encode_bypass_bins(3, 2)
        else:
            self.enc.encode_bypass_bins(0, 1)
            for d in range(8):
                if qp_value in (predicted_qp + 2 + d, predicted_qp - 9 + d):
                    self.enc.encode_bypass_bins(d, 3)
                    break

    def write_root_cbf(self, root_cbf):
        if self.restr.disable_transform_root_cbf:
            return
        self.enc.encode_bin(1 if root_cbf else 0, OFFSETS["cu_root_cbf"])

    def write_skip_flag(self, cu, skip):
        if self.restr.disable_inter_skip_mode or \
                self.restr.disable_inter_merge_mode:
            return
        ctx = self.ctx.get_skip_flag_ctx(cu.get_cu_left(), cu.get_cu_above())
        self.enc.encode_bin(1 if skip else 0, ctx)

    def write_split_binary(self, cu, split_restriction, split):
        ctx = self.ctx.get_split_binary_ctx(cu)
        self.enc.encode_bin(0 if split == k.SplitType.NONE else 1, ctx)
        if split == k.SplitType.NONE:
            return
        if cu.width == k.MIN_BINARY_SPLIT_SIZE or \
                cu.height == k.MIN_BINARY_SPLIT_SIZE:
            return
        if split_restriction in (k.SplitRestriction.NO_VERTICAL,
                                 k.SplitRestriction.NO_HORIZONTAL):
            return
        offset = 0 if cu.width == cu.height else \
            (1 if cu.width > cu.height else 2)
        self.enc.encode_bin(1 if split == k.SplitType.VERTICAL else 0,
                            OFFSETS["cu_split_binary"] + 3 + offset)

    def write_split_quad(self, cu, max_depth, split):
        ctx = self.ctx.get_split_flag_ctx(cu, max_depth)
        self.enc.encode_bin(1 if split == k.SplitType.QUAD else 0, ctx)

    def write_transform_skip(self, cu, comp, transform_skip):
        if self.restr.disable_ext2_transform_skip or \
                not cu.can_transform_skip(comp):
            return
        ctx = OFFSETS["transform_skip_flag"] + (0 if comp == 0 else 1)
        self.enc.encode_bin(1 if transform_skip else 0, ctx)

    def write_transform_select_enable(self, cu, enable):
        if self.restr.disable_ext2_transform_select:
            return
        self.enc.encode_bin(1 if enable else 0,
                            OFFSETS["transform_select_flag"] + cu.depth)

    def write_transform_select_idx(self, cu, type_idx):
        if self.restr.disable_ext2_transform_select:
            return
        base = OFFSETS["transform_select_idx"]
        ctx1 = base + (0 if cu.is_intra() else 2)
        ctx2 = base + (1 if cu.is_intra() else 3)
        self.enc.encode_bin(type_idx & 1, ctx1)
        self.enc.encode_bin(1 if (type_idx >> 1) else 0, ctx2)

    def write_end_of_slice(self, end_of_slice):
        self.enc.encode_bin_trm(1 if end_of_slice else 0)

    # ---- residual coding ----
    def write_coefficients(self, cu, comp, coeff):
        w, h = cu.size(comp)
        subblock_shift = 1 if (w == 2 or h == 2) else k.SUBBLOCK_SHIFT
        intra_mode = cu.get_intra_mode(comp) if cu.is_intra() else 0
        scan_order = scan.determine_scan_order(cu, comp == 0, intra_mode,
                                               self.restr)
        if isinstance(self.enc, NativeEntropyEncoder):
            return self.enc.write_coefficients_native(
                self._restr_mask, w, h, subblock_shift, comp == 0,
                scan_order, coeff)
        return count_write_coefficients(
            self.enc, self._restr_mask, w, h, subblock_shift, comp == 0,
            scan_order, coeff)

    def write_exp_golomb(self, abs_level, golomb_rice_k):
        bins = 0
        num_bins = 0
        while abs_level >= (1 << golomb_rice_k):
            bins = bins * 2 + 1
            num_bins += 1
            abs_level -= 1 << golomb_rice_k
            golomb_rice_k += 1
        bins *= 2
        num_bins += 1
        bins = (bins << golomb_rice_k) | abs_level
        num_bins += golomb_rice_k
        self.enc.encode_bypass_bins(bins, num_bins)

    def write_unary_max_symbol(self, symbol, max_val, ctx_start, ctx_rest):
        self.enc.encode_bin(1 if symbol > 0 else 0, ctx_start)
        if not symbol or max_val == 1:
            return
        not_max = symbol < max_val
        while True:
            symbol -= 1
            if not symbol:
                break
            self.enc.encode_bin(1, ctx_rest)
        if not_max:
            self.enc.encode_bin(0, ctx_rest)
