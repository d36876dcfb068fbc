"""Syntax-element reader over the CABAC decoder.

Behavioral equivalent of the reference syntax reader
(ref: src/xvc_dec_lib/syntax_reader.cc).  Context references are integer
indices into the flat context array of CabacContexts.
"""
import numpy as np

from .. import constants as k
from .. import scan
from ..cabac.contexts import OFFSETS, CabacContexts
from ..cabac.entropy_decoder import EntropyDecoder


class SyntaxReader:
    def __init__(self, qp, pic_type, bit_reader, restrictions):
        self.restr = restrictions
        self.ctx = CabacContexts(restrictions)
        self.ctx.reset_states(qp.get_qp_raw(0), pic_type)
        self.dec = EntropyDecoder(bit_reader, self.ctx.state,
                                  ctx_update=not
                                  restrictions.disable_cabac_ctx_update)
        self.dec.start()

    def finish(self):
        if not self.dec.decode_bin_trm():
            return False
        self.dec.finish()
        return True

    # ---- prediction-level elements ----

    def read_affine_flag(self, cu, is_merge):
        if self.restr.disable_ext2_inter_affine or \
                (is_merge and self.restr.disable_ext2_inter_affine_merge):
            return False
        ctx = self.ctx.get_affine_ctx(cu.get_cu_left(), cu.get_cu_above())
        return self.dec.decode_bin(ctx) != 0

    def read_cbf(self, cu, comp):
        if self.restr.disable_transform_cbf:
            return True
        if comp == 0:
            return self.dec.decode_bin(OFFSETS["cu_cbf_luma"]) != 0
        return self.dec.decode_bin(OFFSETS["cu_cbf_chroma"]) != 0

    def read_inter_dir(self, cu):
        ctx = self.ctx.get_inter_dir_bi_ctx(cu)
        if self.dec.decode_bin(ctx) != 0:
            return k.InterDir.BI
        b = self.dec.decode_bin(OFFSETS["inter_dir"] + 4)
        return k.InterDir.L0 if b == 0 else k.InterDir.L1

    def read_inter_fullpel_mv_flag(self, cu):
        if self.restr.disable_ext2_inter_adaptive_fullpel_mv:
            return False
        ctx = self.ctx.get_inter_fullpel_mv_ctx(cu.get_cu_left(),
                                                cu.get_cu_above())
        return self.dec.decode_bin(ctx) != 0

    def read_inter_mvd(self):
        if self.restr.disable_inter_mvd_greater_than_flags:
            mvd_x = self.read_exp_golomb(1)
            if mvd_x:
                if self.dec.decode_bypass():
                    mvd_x = -mvd_x
            mvd_y = self.read_exp_golomb(1)
            if mvd_y:
                if self.dec.decode_bypass():
                    mvd_y = -mvd_y
            return (mvd_x, mvd_y)
        non_zero_x = self.dec.decode_bin(OFFSETS["inter_mvd"])
        non_zero_y = self.dec.decode_bin(OFFSETS["inter_mvd"])
        mvd_x = mvd_y = 0
        if non_zero_x:
            mvd_x = 1 + self.dec.decode_bin(OFFSETS["inter_mvd"] + 1)
        if non_zero_y:
            mvd_y = 1 + self.dec.decode_bin(OFFSETS["inter_mvd"] + 1)
        if mvd_x:
            if mvd_x > 1:
                mvd_x += self.read_exp_golomb(1)
            if self.dec.decode_bypass():
                mvd_x = -mvd_x
        if mvd_y:
            if mvd_y > 1:
                mvd_y += self.read_exp_golomb(1)
            if self.dec.decode_bypass():
                mvd_y = -mvd_y
        return (mvd_x, mvd_y)

    def read_inter_mvp_idx(self, cu):
        if (not cu.use_affine and self.restr.disable_inter_mvp) or \
                (cu.use_affine and self.restr.disable_ext2_inter_affine_mvp):
            return 0
        return self.read_unary_max_symbol(k.NUM_INTER_MV_PREDICTORS - 1,
                                          OFFSETS["inter_mvp_idx"],
                                          OFFSETS["inter_mvp_idx"])

    def read_inter_ref_idx(self, num_refs_available):
        if num_refs_available == 1:
            return 0
        ref_idx = self.dec.decode_bin(OFFSETS["inter_ref_idx"])
        if not ref_idx or num_refs_available == 2:
            return ref_idx
        ref_idx += self.dec.decode_bin(OFFSETS["inter_ref_idx"] + 1)
        if ref_idx == 1:
            return ref_idx
        ref_idx = 1
        while ref_idx < num_refs_available - 2:
            if not self.dec.decode_bypass():
                break
            ref_idx += 1
        return ref_idx + 1

    def read_intra_mode(self, mpm):
        """mpm: IntraPredictorLuma-like object (list + num_neighbor_modes)."""
        is_mpm_coded = self.dec.decode_bin(OFFSETS["intra_pred_luma"])
        if is_mpm_coded:
            if not self.restr.disable_ext2_intra_6_predictors:
                mpm_index = self.dec.decode_bin(
                    self.ctx.get_intra_predictor_ctx(mpm[0]))
                if mpm_index > 0:
                    mpm_index += self.dec.decode_bin(
                        self.ctx.get_intra_predictor_ctx(mpm[1]))
                    if mpm_index > 1:
                        mpm_index += self.dec.decode_bin(
                            self.ctx.get_intra_predictor_ctx(mpm[2]))
                        if mpm_index > 2:
                            mpm_index += self.dec.decode_bypass()
                            if mpm_index > 3:
                                mpm_index += self.dec.decode_bypass()
                return mpm[mpm_index]
            mpm_index = self.dec.decode_bypass()
            if mpm_index:
                mpm_index += self.dec.decode_bypass()
            return mpm[mpm_index]
        if not self.restr.disable_ext2_intra_6_predictors:
            if not self.restr.disable_ext2_intra_67_modes:
                intra_mode = self.dec.decode_bypass_bins(4)
                intra_mode <<= 2
                if intra_mode <= k.NBR_INTRA_MODES_EXT - 8:
                    intra_mode += self.dec.decode_bypass_bins(2)
            else:
                intra_mode = self.dec.decode_bypass_bins(5)
            mpm_sorted = sorted(mpm[:k.NUM_INTRA_MPM_EXT])
            for m in mpm_sorted:
                if intra_mode >= m:
                    intra_mode += 1
            return intra_mode
        if not self.restr.disable_ext2_intra_67_modes:
            intra_mode = self.dec.decode_bypass_bins(6)
        else:
            intra_mode = self.dec.decode_bypass_bins(5)
        mpm_sorted = sorted(mpm[:k.NUM_INTRA_MPM])
        for m in mpm_sorted:
            if intra_mode >= m:
                intra_mode += 1
        return intra_mode

    def read_intra_chroma_mode(self, chroma_preds):
        not_dm = self.dec.decode_bin(OFFSETS["intra_pred_chroma"])
        if not not_dm:
            return k.INTRA_CHROMA_DM
        if not self.restr.disable_ext2_intra_chroma_from_luma:
            not_lm = self.dec.decode_bin(OFFSETS["intra_pred_chroma"] + 1)
            if not not_lm:
                return k.INTRA_MODE_LM_CHROMA
        chroma_index = self.dec.decode_bypass_bins(2)
        return chroma_preds[chroma_index]

    def read_lic_flag(self):
        if self.restr.disable_ext2_inter_local_illumination_comp:
            return False
        return self.dec.decode_bin(OFFSETS["lic_flag"]) != 0

    def read_merge_flag(self):
        if self.restr.disable_inter_merge_mode:
            return False
        return self.dec.decode_bin(OFFSETS["inter_merge_flag"]) != 0

    def read_merge_idx(self):
        if self.restr.disable_inter_merge_candidates:
            return 0
        max_merge_cand = k.NUM_INTER_MERGE_CANDIDATES
        merge_idx = self.dec.decode_bin(OFFSETS["inter_merge_idx"])
        if merge_idx:
            while merge_idx < max_merge_cand - 1 and self.dec.decode_bypass():
                merge_idx += 1
        return merge_idx

    def read_partition_type(self, cu):
        if cu.pred_mode == k.PredictionMode.INTRA:
            if cu.depth == k.MAX_CU_DEPTH:
                self.dec.decode_bin(OFFSETS["cu_part_size"])
            return
        self.dec.decode_bin(OFFSETS["cu_part_size"])

    def read_pred_mode(self):
        is_intra = self.dec.decode_bin(OFFSETS["cu_pred_mode"])
        return k.PredictionMode.INTRA if is_intra else k.PredictionMode.INTER

    def read_qp(self, predicted_qp, base_qp, aqp_mode):
        """(ref: syntax_reader.cc:615-643)"""
        if aqp_mode == 1:
            return self.dec.decode_bypass_bins(7)
        val = self.dec.decode_bin(OFFSETS["delta_qp"])
        if val == 1:
            return predicted_qp
        val = self.dec.decode_bypass_bins(1)
        if val == 1:
            val = self.dec.decode_bypass_bins(1)
            tmp_qp = predicted_qp + 10 if val == 0 else predicted_qp + 1
        else:
            val = self.dec.decode_bypass_bins(3)
            tmp_qp = predicted_qp + 2 + val
        if tmp_qp > base_qp + 7:
            tmp_qp -= 11
        elif tmp_qp < base_qp - 3:
            tmp_qp += 11
        return tmp_qp

    def read_root_cbf(self):
        if self.restr.disable_transform_root_cbf:
            return True
        return self.dec.decode_bin(OFFSETS["cu_root_cbf"]) != 0

    def read_skip_flag(self, cu):
        if self.restr.disable_inter_skip_mode or \
                self.restr.disable_inter_merge_mode:
            return False
        ctx = self.ctx.get_skip_flag_ctx(cu.get_cu_left(), cu.get_cu_above())
        return self.dec.decode_bin(ctx) != 0

    def read_split_binary(self, cu, split_restriction):
        ctx = self.ctx.get_split_binary_ctx(cu)
        if not self.dec.decode_bin(ctx):
            return k.SplitType.NONE
        if cu.width == k.MIN_BINARY_SPLIT_SIZE or \
                split_restriction == k.SplitRestriction.NO_VERTICAL:
            return k.SplitType.HORIZONTAL
        if cu.height == k.MIN_BINARY_SPLIT_SIZE or \
                split_restriction == k.SplitRestriction.NO_HORIZONTAL:
            return k.SplitType.VERTICAL
        offset = 0 if cu.width == cu.height else \
            (1 if cu.width > cu.height else 2)
        bin2 = self.dec.decode_bin(OFFSETS["cu_split_binary"] + 3 + offset)
        return k.SplitType.VERTICAL if bin2 else k.SplitType.HORIZONTAL

    def read_split_quad(self, cu, max_depth):
        ctx = self.ctx.get_split_flag_ctx(cu, max_depth)
        b = self.dec.decode_bin(ctx)
        return k.SplitType.QUAD if b else k.SplitType.NONE

    def read_transform_skip(self, cu, comp):
        if self.restr.disable_ext2_transform_skip or \
                not cu.can_transform_skip(comp):
            return False
        ctx = OFFSETS["transform_skip_flag"] + (0 if comp == 0 else 1)
        return self.dec.decode_bin(ctx) != 0

    def read_transform_select_enable(self, cu):
        if self.restr.disable_ext2_transform_select:
            return False
        ctx = OFFSETS["transform_select_flag"] + cu.depth
        return self.dec.decode_bin(ctx) != 0

    def read_transform_select_idx(self, cu):
        if self.restr.disable_ext2_transform_select:
            return 0
        base = OFFSETS["transform_select_idx"]
        ctx1 = base + (0 if cu.is_intra() else 2)
        ctx2 = base + (1 if cu.is_intra() else 3)
        type_idx = 0
        if self.dec.decode_bin(ctx1):
            type_idx += 1
        if self.dec.decode_bin(ctx2):
            type_idx += 2
        return type_idx

    def read_end_of_slice(self):
        return self.dec.decode_bin_trm() != 0

    # ---- residual coding ----

    def read_coefficients(self, cu, comp, dst_coeff):
        """dst_coeff: (h, w) int32 array, filled in place; returns #sig."""
        w, h = cu.size(comp)
        subblock_shift = 1 if (w == 2 or h == 2) else k.SUBBLOCK_SHIFT
        return self._read_coeff_subblock(cu, comp, dst_coeff,
                                         subblock_shift)

    def _read_coeff_subblock(self, cu, comp, dst, subblock_shift):
        restr = self.restr
        width, height = cu.size(comp)
        width_log2 = width.bit_length() - 1
        height_log2 = height.bit_length() - 1
        log2size = width_log2
        subblock_mask = (1 << subblock_shift) - 1
        subblock_size = 1 << (subblock_shift * 2)
        is_luma = comp == 0

        subblock_width = width >> subblock_shift
        subblock_height = height >> subblock_shift
        nbr_subblocks = subblock_width * subblock_height
        subblock_csbf = [0] * nbr_subblocks
        intra_mode = cu.get_intra_mode(comp) if cu.is_intra() else 0
        scan_order = scan.determine_scan_order(cu, is_luma, intra_mode, restr)
        scan_subblock_table = scan.derive_subblock_scan(
            scan_order, subblock_width, subblock_height)
        scan_table = (scan.SCAN_COEFF_2X2[scan_order] if subblock_shift == 1
                      else scan.SCAN_COEFF_4X4[scan_order])

        subblock_last_index = nbr_subblocks - 1
        subblock_last_coeff_offset = 1
        coeff_num_non_zero = 0
        total_num_sig_coeff = 0
        subblock_coeff = [0] * subblock_size
        subblock_pos = [0] * subblock_size
        subblock_pos[0] = -1
        last_nonzero_pos = -1
        first_nonzero_pos = subblock_size

        if not restr.disable_transform_last_position:
            pos_last_x, pos_last_y = self._read_coeff_last_pos(
                width, height, is_luma, scan_order)
            pos_last_index = self._determine_last_index(
                subblock_width, subblock_height, pos_last_x, pos_last_y,
                scan_subblock_table, scan_table, subblock_shift)
            pos_last = (pos_last_y << log2size) + pos_last_x
            subblock_last_index = pos_last_index >> (2 * subblock_shift)
            subblock_last_coeff_offset = \
                ((subblock_last_index + 1) << (2 * subblock_shift)) - \
                pos_last_index + 1
            if restr.disable_transform_cbf and \
                    restr.disable_transform_subblock_csbf and \
                    pos_last_x == 0 and pos_last_y == 0:
                subblock_last_coeff_offset -= 1
            else:
                subblock_coeff[0] = 1
                coeff_num_non_zero = 1
                dst[pos_last_y, pos_last_x] = 1
            subblock_pos[0] = pos_last
            subblock_last_offset = subblock_last_index << (2 * subblock_shift)
            last_nonzero_pos = pos_last_index - subblock_last_offset
            first_nonzero_pos = pos_last_index - subblock_last_offset

        c1 = 1
        for subblock_index in range(subblock_last_index, -1, -1):
            subblock_scan = scan_subblock_table[subblock_index]
            subblock_scan_y = subblock_scan // subblock_width
            subblock_scan_x = subblock_scan - subblock_scan_y * subblock_width
            subblock_pos_x = subblock_scan_x << subblock_shift
            subblock_pos_y = subblock_scan_y << subblock_shift

            is_last_subblock = (subblock_index == subblock_last_index and
                                not restr.disable_transform_last_position and
                                not restr.disable_transform_cbf)
            is_first_subblock = (subblock_index == 0 and
                                 not restr.disable_transform_cbf)
            if is_last_subblock or is_first_subblock or \
                    restr.disable_transform_subblock_csbf:
                subblock_csbf[subblock_scan] = 1
                _, pattern_sig_ctx = self.ctx.get_subblock_csbf_ctx(
                    is_luma, subblock_csbf, subblock_scan_x, subblock_scan_y,
                    subblock_width, subblock_height)
            else:
                ctx, pattern_sig_ctx = self.ctx.get_subblock_csbf_ctx(
                    is_luma, subblock_csbf, subblock_scan_x, subblock_scan_y,
                    subblock_width, subblock_height)
                subblock_csbf[subblock_scan] = self.dec.decode_bin(ctx)
            if not subblock_csbf[subblock_scan]:
                continue

            # significance flags
            for coeff_index in range(subblock_size -
                                     subblock_last_coeff_offset, -1, -1):
                scan_offset = scan_table[coeff_index]
                coeff_scan_x = subblock_pos_x + (scan_offset & subblock_mask)
                coeff_scan_y = subblock_pos_y + \
                    (scan_offset >> subblock_shift)
                not_first_subblock = subblock_index > 0 and \
                    not restr.disable_transform_subblock_csbf
                if coeff_index == 0 and not_first_subblock and \
                        coeff_num_non_zero == 0:
                    sig = True
                else:
                    ctx = self.ctx.get_coeff_sig_ctx(
                        is_luma, pattern_sig_ctx, scan_order,
                        coeff_scan_x, coeff_scan_y, dst,
                        width_log2, height_log2)
                    sig = self.dec.decode_bin(ctx) != 0
                if sig:
                    subblock_coeff[coeff_num_non_zero] = 1
                    subblock_pos[coeff_num_non_zero] = \
                        (coeff_scan_y << log2size) + coeff_scan_x
                    coeff_num_non_zero += 1
                    dst[coeff_scan_y, coeff_scan_x] = 1
                    if last_nonzero_pos == -1:
                        last_nonzero_pos = coeff_index
                    first_nonzero_pos = coeff_index
                else:
                    dst[coeff_scan_y, coeff_scan_x] = 0
            subblock_last_coeff_offset = 1
            if not coeff_num_non_zero:
                continue

            ctx_set = 2 if (subblock_index > 0 and is_luma) else 0
            if c1 == 0:
                ctx_set += 1
            c1 = 1
            first_c2_idx = -1

            max_num_c1_flags = k.MAX_NUM_C1_FLAGS
            if restr.disable_transform_residual_greater_than_flags:
                max_num_c1_flags = 0
            for i in range(coeff_num_non_zero):
                if i == max_num_c1_flags:
                    break
                coeff_scan_y = subblock_pos[i] >> log2size
                coeff_scan_x = subblock_pos[i] - (coeff_scan_y << log2size)
                ctx = self.ctx.get_coeff_greater1_ctx(
                    is_luma, ctx_set, c1, coeff_scan_x, coeff_scan_y,
                    i == 0 and is_last_subblock, dst, width, height)
                greater1 = self.dec.decode_bin(ctx)
                if greater1:
                    c1 = 0
                    if first_c2_idx == -1 and \
                            not restr.disable_transform_residual_greater2:
                        first_c2_idx = i
                    subblock_coeff[i] = 2
                    dst[coeff_scan_y, coeff_scan_x] = 2
                elif 0 < c1 < 3:
                    c1 += 1

            if first_c2_idx >= 0:
                coeff_scan_y = subblock_pos[first_c2_idx] >> log2size
                coeff_scan_x = subblock_pos[first_c2_idx] - \
                    (coeff_scan_y << log2size)
                ctx = self.ctx.get_coeff_greater2_ctx(
                    is_luma, ctx_set, coeff_scan_x, coeff_scan_y,
                    first_c2_idx == 0 and is_last_subblock, dst,
                    width, height)
                abs_lvl = self.dec.decode_bin(ctx)
                subblock_coeff[first_c2_idx] += abs_lvl
                dst[coeff_scan_y, coeff_scan_x] += abs_lvl

            sign_hidden = False
            if not restr.disable_transform_sign_hiding and \
                    last_nonzero_pos - first_nonzero_pos > \
                    k.SIGN_HIDING_THRESHOLD:
                sign_hidden = True
            last_nonzero_pos = -1
            first_nonzero_pos = subblock_size

            if sign_hidden:
                coeff_signs = self.dec.decode_bypass_bins(
                    coeff_num_non_zero - 1)
                coeff_signs <<= 32 - (coeff_num_non_zero - 1)
            else:
                coeff_signs = self.dec.decode_bypass_bins(coeff_num_non_zero)
                coeff_signs <<= 32 - coeff_num_non_zero
            coeff_signs &= 0xFFFFFFFF

            if c1 == 0 or coeff_num_non_zero > max_num_c1_flags:
                first_coeff_greater2 = 0 if \
                    restr.disable_transform_residual_greater2 else 1
                golomb_rice_k = 0
                for i in range(coeff_num_non_zero):
                    coeff_scan_y = subblock_pos[i] >> log2size
                    coeff_scan_x = subblock_pos[i] - \
                        (coeff_scan_y << log2size)
                    base_level = (2 + first_coeff_greater2) \
                        if i < max_num_c1_flags else 1
                    if subblock_coeff[i] == base_level:
                        if not restr.disable_ext2_cabac_alt_residual_ctx:
                            golomb_rice_k = self.ctx.get_coeff_golomb_rice_k(
                                coeff_scan_x, coeff_scan_y, width, height,
                                dst)
                        abs_lvl = self._read_coeff_remain_exp_golomb(
                            golomb_rice_k)
                        subblock_coeff[i] += abs_lvl
                        dst[coeff_scan_y, coeff_scan_x] += abs_lvl
                        if subblock_coeff[i] > 3 * (1 << golomb_rice_k) and \
                                not restr.disable_transform_adaptive_exp_golomb:
                            golomb_rice_k = min(golomb_rice_k + 1, 4)
                    if subblock_coeff[i] >= 2:
                        first_coeff_greater2 = 0

            abs_sum = 0
            for i in range(coeff_num_non_zero):
                coeff_scan_y = subblock_pos[i] >> log2size
                coeff_scan_x = subblock_pos[i] - (coeff_scan_y << log2size)
                coeff = subblock_coeff[i]
                abs_sum += coeff
                if i == coeff_num_non_zero - 1 and sign_hidden:
                    sign = -1 if (abs_sum & 1) else 1
                    dst[coeff_scan_y, coeff_scan_x] = sign * coeff
                else:
                    sign = -1 if (coeff_signs & 0x80000000) else 0
                    dst[coeff_scan_y, coeff_scan_x] = \
                        (coeff ^ sign) - sign
                    coeff_signs = (coeff_signs << 1) & 0xFFFFFFFF
            total_num_sig_coeff += coeff_num_non_zero
            coeff_num_non_zero = 0

        if not total_num_sig_coeff and subblock_pos[0] != -1:
            coeff_scan_y = subblock_pos[0] >> log2size
            coeff_scan_x = subblock_pos[0] - (coeff_scan_y << log2size)
            dst[coeff_scan_y, coeff_scan_x] = 0
        return total_num_sig_coeff

    def _read_coeff_last_pos(self, width, height, is_luma, scan_order):
        if scan_order == k.ScanOrder.VERTICAL:
            width, height = height, width
        group_idx_x = int(scan.LAST_POS_GROUP_IDX[width - 1])
        group_idx_y = int(scan.LAST_POS_GROUP_IDX[height - 1])
        pos_last_x = 0
        while pos_last_x < group_idx_x:
            ctx = self.ctx.get_coeff_last_pos_ctx(is_luma, width, height,
                                                  pos_last_x, True)
            if not self.dec.decode_bin(ctx):
                break
            pos_last_x += 1
        pos_last_y = 0
        while pos_last_y < group_idx_y:
            ctx = self.ctx.get_coeff_last_pos_ctx(is_luma, width, height,
                                                  pos_last_y, False)
            if not self.dec.decode_bin(ctx):
                break
            pos_last_y += 1
        if pos_last_x > 3:
            offset = 0
            count = (pos_last_x - 2) >> 1
            for i in range(count - 1, -1, -1):
                offset += self.dec.decode_bypass() << i
            pos_last_x = int(scan.LAST_POS_MIN_IN_GROUP[pos_last_x]) + offset
        if pos_last_y > 3:
            offset = 0
            count = (pos_last_y - 2) >> 1
            for i in range(count - 1, -1, -1):
                offset += self.dec.decode_bypass() << i
            pos_last_y = int(scan.LAST_POS_MIN_IN_GROUP[pos_last_y]) + offset
        if scan_order == k.ScanOrder.VERTICAL:
            pos_last_x, pos_last_y = pos_last_y, pos_last_x
        return pos_last_x, pos_last_y

    @staticmethod
    def _determine_last_index(subblock_width, subblock_height,
                              pos_last_x, pos_last_y, subblock_scan_table,
                              coeff_scan_table, subblock_shift):
        subblock_mask = (1 << subblock_shift) - 1
        subblock_size = 1 << (2 * subblock_shift)
        nbr_subblocks = subblock_width * subblock_height
        for subblock_i in range(nbr_subblocks):
            subblock_scan = subblock_scan_table[subblock_i]
            sy = subblock_scan // subblock_width
            sx = subblock_scan - sy * subblock_width
            spx = sx << subblock_shift
            spy = sy << subblock_shift
            for coeff_index in range(subblock_size):
                so = coeff_scan_table[coeff_index]
                cx = spx + (so & subblock_mask)
                cy = spy + (so >> subblock_shift)
                if cx == pos_last_x and cy == pos_last_y:
                    return (subblock_i << (2 * subblock_shift)) + coeff_index
        raise ValueError("last position not found")

    def _read_coeff_remain_exp_golomb(self, golomb_rice_k):
        if not self.restr.disable_ext2_cabac_alt_residual_ctx:
            threshold = int(scan.GOLOMB_RICE_RANGE_EXT[golomb_rice_k])
        else:
            threshold = k.COEFF_REMAIN_BIN_REDUCTION
        prefix = 0
        while self.dec.decode_bypass() != 0:
            prefix += 1
        if prefix < threshold:
            code_word = self.dec.decode_bypass_bins(golomb_rice_k)
            return (prefix << golomb_rice_k) + code_word
        code_word = self.dec.decode_bypass_bins(
            prefix - threshold + golomb_rice_k)
        return code_word + \
            (((1 << (prefix - threshold)) + threshold - 1) << golomb_rice_k)

    def read_exp_golomb(self, golomb_rice_k):
        abs_level = 0
        b = 1
        while b:
            b = self.dec.decode_bypass()
            abs_level += b << golomb_rice_k
            golomb_rice_k += 1
        golomb_rice_k -= 1
        if golomb_rice_k:
            abs_level += self.dec.decode_bypass_bins(golomb_rice_k)
        return abs_level

    def read_unary_max_symbol(self, max_val, ctx_start, ctx_rest):
        symbol = self.dec.decode_bin(ctx_start)
        if not symbol or max_val == 1:
            return symbol
        symbol = 0
        while True:
            b = self.dec.decode_bin(ctx_rest)
            symbol += 1
            if not b or symbol >= max_val - 1:
                break
        if b and symbol == max_val - 1:
            symbol += 1
        return symbol
