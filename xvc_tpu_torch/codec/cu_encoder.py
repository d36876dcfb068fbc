"""The Python CU encoder: the CTU search of the pictures the native
encoder does not code.

The production encode path is the native whole-picture RDO
(``native/csrc/xvcn_enc.inc``, dispatched from ``picture_encoder.py``).
This module is its byte-identical Python twin, which the picture encoder
takes where the JAX package takes its own (``native/enc.usable_for``:
the lookahead's mode reordering, the per-CU device SATD pre-pass,
device motion estimation, CTU tile rows, or the native encoder switched
off): top-down recursive RDO over quad + binary splits with cloned
writer state and reconstruct-state snapshots
(ref: src/xvc_enc_lib/cu_encoder.cc behavioral contract).  Copy of
``xvc_tpu/codec/cu_encoder.py``, with the split DP's pruning
(``gpu/wavefront_rdo.py``); its device hooks run on the encoder's torch
device: the intra half's in ``intra_search.py``, the inter half's (the
motion search, ``inter_me.py``) in ``gpu/me.py`` under ``XVC_ME=jax``.
"""
import math

import numpy as np

from .. import constants as k
from ..gpu import wavefront_rdo as wf
from ..syntax.writer import SyntaxWriter
from .cu_cache import CuCache
from .cu_writer import CuWriter
from .intra_recon import IntraReconstructor
from .intra_search import IntraSearch
from .transform_encoder import TransformEncoder

_COST_MAX = (1 << 62)


def save_cu_state(cu, rec_pic, comps):
    """ReconstructionState snapshot (reco + coeff) for whole CU tree."""
    state = {"comps": {}, "tree": _snapshot_tree(cu)}
    for comp in comps:
        cx, cy = cu.pos(comp)
        w, h = cu.size(comp)
        state["comps"][comp] = (
            rec_pic.plane_view(comp)[cy:cy + h, cx:cx + w].copy())
    return state


def load_cu_state(cu_region, rec_pic, state, comps):
    for comp in comps:
        cx, cy = cu_region.pos(comp)
        w, h = cu_region.size(comp)
        rec_pic.plane_view(comp)[cy:cy + h, cx:cx + w] = \
            state["comps"][comp]


def _snapshot_tree(cu):
    return None  # tree itself swapped via temp CU objects


class CuEncoder(TransformEncoder):
    def __init__(self, orig_pic, rec_pic, pic_data, settings, device):
        super().__init__(rec_pic.bitdepth, pic_data.max_num_components,
                         orig_pic, settings)
        self.orig_pic = orig_pic
        self.rec_pic = rec_pic
        self.pic = pic_data
        self.device = device
        self.restr = pic_data.restrictions
        self.cu_writer = CuWriter(pic_data, self.restr)
        self.intra_recon = IntraReconstructor(pic_data, rec_pic.bitdepth,
                                              self.restr)
        self.intra_search = IntraSearch(rec_pic.bitdepth, pic_data, orig_pic,
                                        settings, self.cu_writer, device)
        self.inter_search = None  # set by PictureEncoder, inter pictures
        self.cu_cache = CuCache(pic_data)
        self.last_ctu_frac_bits = 0
        self._aqp_flat = None
        # {n: force map} quad-split decisions from the device DP
        # (gpu/wavefront_rdo.py), set by PictureEncoder when
        # settings.tpu_split_dp is on; None = full search everywhere
        self.split_dp = None

    # expose intra prediction for intra search
    def predict_intra_mode(self, cu, comp, mode, rec_pic):
        return self.intra_recon.predict_intra_mode(cu, comp, mode, rec_pic)

    def get_ref_samples(self, cu, comp, rec_pic):
        return self.intra_recon.get_ref_samples(cu, comp, rec_pic)

    def begin_ref_scope(self, cu):
        self.intra_recon.begin_ref_scope(cu)

    def end_ref_scope(self):
        self.intra_recon.end_ref_scope()

    def encode_ctu(self, rsaddr, bitstream_writer):
        """(ref: cu_encoder.cc:84-121)"""
        frac_bits = bitstream_writer.get_fractional_bits()
        rdo_writer = SyntaxWriter.rdo_clone(bitstream_writer, 0, frac_bits)
        ctu = self.pic.get_ctu(k.CuTree.PRIMARY, rsaddr)
        ctu_qp = self.pic.pic_qp.get_qp_raw(0)
        if self.settings.adaptive_qp:
            ctu_qp += self.calc_delta_qp_from_variance(ctu)
        ctu.qp = self.pic.get_qp_obj(ctu_qp)
        ctu = self._compress_cu_root(ctu, rdo_writer, ctu.qp)
        self.pic.ctus[int(k.CuTree.PRIMARY)][rsaddr] = ctu
        if self.pic.has_secondary_cu_tree():
            ctu2 = self.pic.get_ctu(k.CuTree.SECONDARY, rsaddr)
            ctu2.qp = self.pic.get_qp_obj(ctu_qp)
            rdo_writer2 = SyntaxWriter.rdo_clone(bitstream_writer)
            ctu2 = self._compress_cu_root(ctu2, rdo_writer2, ctu2.qp)
            self.pic.ctus[int(k.CuTree.SECONDARY)][rsaddr] = ctu2
        self.last_ctu_frac_bits = rdo_writer.get_fractional_bits()
        self.write_ctu(rsaddr, bitstream_writer)

    def _compress_cu_root(self, ctu, rdo_writer, qp):
        holder = [ctu]
        self.compress_cu(holder, 0, k.SplitRestriction.NONE, rdo_writer, qp)
        return holder[0]

    def compress_cu(self, best_cu_holder, rdo_depth, split_restriction,
                    writer, qp):
        """(ref: cu_encoder.cc:123-273). best_cu_holder is a 1-item list."""
        max_tr_size = 64 if not self.restr.disable_ext_transform_size_64 \
            else 32
        cu = best_cu_holder[0]
        cu.qp = qp
        depth = cu.depth
        do_quad_split = cu.binary_depth == 0 and \
            depth < self.pic.get_max_depth(cu.cu_tree)
        can_binary_split = cu.is_binary_split_valid() and \
            cu.is_fully_within_picture() and \
            cu.width <= max_tr_size and cu.height <= max_tr_size
        do_hor_split = can_binary_split and \
            split_restriction != k.SplitRestriction.NO_HORIZONTAL and \
            cu.height > k.MIN_BINARY_SPLIT_SIZE
        do_ver_split = can_binary_split and \
            split_restriction != k.SplitRestriction.NO_VERTICAL and \
            cu.width > k.MIN_BINARY_SPLIT_SIZE
        do_full = cu.is_fully_within_picture() and \
            cu.width <= max_tr_size and cu.height <= max_tr_size
        do_split_any = do_quad_split or do_hor_split or do_ver_split

        if self.split_dp is not None and cu.binary_depth == 0 and \
                cu.cu_tree == k.CuTree.PRIMARY and \
                cu.is_fully_within_picture():
            # bottom-up batched RDO: the device DP settles decisive
            # quad-split decisions, replacing the top-down trial of
            # ref: cu_encoder.cc:123-273 at those nodes; ambiguous nodes
            # keep the full search
            dec = wf.decision_for(self.split_dp, cu.pos_x, cu.pos_y,
                                  cu.width, cu.height)
            if dec == wf.FORCE_SPLIT and do_quad_split:
                do_full = False
                do_hor_split = do_ver_split = False
            elif dec == wf.FORCE_LEAF:
                do_quad_split = False
                do_split_any = do_hor_split or do_ver_split

        if not do_split_any:
            return self.compress_no_split(best_cu_holder, rdo_depth,
                                          split_restriction, writer)
        best_cost = _COST_MAX
        best_dist = 0
        best_state = None
        best_writer = SyntaxWriter.rdo_clone(writer)
        comps = self.pic.get_components(cu.cu_tree)
        temp_holder = [self.pic.create_cu(cu.cu_tree, cu.depth, cu.pos_x,
                                          cu.pos_y, cu.width, cu.height)]
        temp_holder[0].qp = qp

        if cu.binary_depth == 0:
            self.cu_cache.invalidate(cu.cu_tree, cu.depth)

        if do_full:
            start_bits = writer.get_num_written_bits()
            best_dist = self.compress_no_split(best_cu_holder, rdo_depth,
                                               split_restriction, best_writer)
            cu = best_cu_holder[0]
            full_bits = best_writer.get_num_written_bits() - start_bits
            best_cost = best_dist + int(full_bits * qp.get_lambda() + 0.5)
            best_state = save_cu_state(cu, self.rec_pic, comps)

        if self.settings.fast_cu_split_based_on_full_cu and do_full and \
                self._can_skip_any_split_for_cu(cu):
            writer.copy_from(best_writer)
            return best_dist

        best_binary_depth_gt1 = False
        hor_cost = 0
        if do_hor_split:
            splitcu_writer = SyntaxWriter.rdo_clone(writer)
            split_cost, split_dist = self._compress_split_cu(
                temp_holder, rdo_depth, qp, k.SplitType.HORIZONTAL,
                split_restriction, splitcu_writer)
            hor_cost = split_cost
            for sub in temp_holder[0].sub_cus:
                if sub is not None and sub.split != k.SplitType.NONE:
                    best_binary_depth_gt1 = True
            if split_cost < best_cost:
                best_cu_holder[0], temp_holder[0] = \
                    temp_holder[0], best_cu_holder[0]
                cu = best_cu_holder[0]
                if not do_quad_split and not do_ver_split:
                    writer.copy_from(splitcu_writer)
                    return split_dist
                best_cost, best_dist = split_cost, split_dist
                best_writer = splitcu_writer
                best_state = save_cu_state(cu, self.rec_pic, comps)
            else:
                load_cu_state(cu, self.rec_pic, best_state, comps)
                self.pic.mark_used_in_pic(cu)

        if do_ver_split:
            splitcu_writer = SyntaxWriter.rdo_clone(writer)
            split_cost, split_dist = self._compress_split_cu(
                temp_holder, rdo_depth, qp, k.SplitType.VERTICAL,
                split_restriction, splitcu_writer)
            if split_cost < hor_cost:
                best_binary_depth_gt1 = False
                for sub in temp_holder[0].sub_cus:
                    if sub is not None and sub.split != k.SplitType.NONE:
                        best_binary_depth_gt1 = True
            if split_cost < best_cost:
                best_cu_holder[0], temp_holder[0] = \
                    temp_holder[0], best_cu_holder[0]
                cu = best_cu_holder[0]
                if not do_quad_split:
                    writer.copy_from(splitcu_writer)
                    return split_dist
                best_cost, best_dist = split_cost, split_dist
                best_writer = splitcu_writer
                best_state = save_cu_state(cu, self.rec_pic, comps)
            else:
                load_cu_state(cu, self.rec_pic, best_state, comps)
                self.pic.mark_used_in_pic(cu)

        if self.settings.fast_quad_split_based_on_binary_split and \
                do_quad_split and do_hor_split and do_ver_split and \
                self._can_skip_quad_split_for_cu(cu, best_binary_depth_gt1):
            writer.copy_from(best_writer)
            return best_dist

        if do_quad_split:
            splitcu_writer = SyntaxWriter.rdo_clone(writer)
            split_cost, split_dist = self._compress_split_cu(
                temp_holder, rdo_depth, qp, k.SplitType.QUAD,
                split_restriction, splitcu_writer)
            if split_cost < best_cost:
                best_cu_holder[0], temp_holder[0] = \
                    temp_holder[0], best_cu_holder[0]
                writer.copy_from(splitcu_writer)
                return split_dist
            load_cu_state(cu, self.rec_pic, best_state, comps)
            self.pic.mark_used_in_pic(cu)

        writer.copy_from(best_writer)
        return best_dist

    def _compress_split_cu(self, cu_holder, rdo_depth, qp, split_type,
                           split_restriction, rdo_writer):
        """(ref: cu_encoder.cc:275-305)"""
        cu = cu_holder[0]
        if cu.split != k.SplitType.NONE:
            cu.un_split()
        cu.do_split(split_type)
        self.pic.clear_mark_cu_in_pic(cu)
        dist = 0
        start_bits = rdo_writer.get_num_written_bits()
        sub_split_restriction = k.SplitRestriction.NONE
        for i, sub_cu in enumerate(cu.sub_cus):
            if sub_cu is not None:
                holder = [sub_cu]
                dist += self.compress_cu(holder, rdo_depth + 1,
                                         sub_split_restriction, rdo_writer,
                                         qp)
                cu.sub_cus[i] = holder[0]
                sub_split_restriction = \
                    holder[0].derive_sibling_split_restriction(split_type)
        self.cu_writer.write_split(cu, split_restriction, rdo_writer)
        bits = rdo_writer.get_num_written_bits() - start_bits
        cost = dist + int(bits * qp.get_lambda() + 0.5)
        return cost, dist

    def compress_no_split(self, best_cu_holder, rdo_depth, split_restriction,
                          writer):
        """(ref: cu_encoder.cc:366-411)"""
        cu = best_cu_holder[0]
        qp = cu.qp
        if cu.split != k.SplitType.NONE:
            cu.un_split()
        cache_result = self.cu_cache.lookup(cu)
        best_dist = 0
        if self.pic.is_intra_pic():
            cost, best_dist = self.compress_intra(cu, qp, writer)
        else:
            best_dist = self._compress_inter_pic(best_cu_holder, qp,
                                                 rdo_depth, cache_result,
                                                 writer)
            cu = best_cu_holder[0]
        self.pic.mark_used_in_pic(cu)
        if cache_result.cacheable:
            self.cu_cache.store(cu)
        for comp in self.pic.get_components(cu.cu_tree):
            self.cu_writer.write_component(cu, comp, writer)
        self.cu_writer.write_split(cu, split_restriction, writer)
        return best_dist

    def compress_intra(self, cu, qp, bitstream_writer):
        """(ref: cu_encoder.cc:517-540)"""
        cu.reset_prediction_state()
        cu.pred_mode = k.PredictionMode.INTRA
        cu.skip_flag = False
        self.intra_recon.invalidate_lm_cache()
        rdo_writer = SyntaxWriter.rdo_clone(bitstream_writer, 0)
        dist = 0
        comps = self.pic.get_components(cu.cu_tree)
        if comps and comps[0] == 0:
            dist += self.intra_search.compress_intra_luma(
                cu, qp, bitstream_writer, self, self.rec_pic, self)
            self.cu_writer.write_component(cu, 0, rdo_writer)
        if len(comps) > 1:
            dist += self.intra_search.compress_intra_chroma(
                cu, qp, bitstream_writer, self, self.rec_pic, self)
            self.cu_writer.write_component(cu, 1, rdo_writer)
            self.cu_writer.write_component(cu, 2, rdo_writer)
        bits = rdo_writer.get_num_written_bits()
        cost = dist + int(bits * qp.get_lambda() + 0.5)
        return cost, dist

    def _compress_inter_pic(self, best_cu_holder, qp, rdo_depth,
                            cache_result, writer):
        from .inter_me import compress_inter_pic
        return compress_inter_pic(self, best_cu_holder, qp, rdo_depth,
                                  cache_result, writer)

    def get_cu_cost_without_split(self, cu, qp, bitstream_writer, ssd):
        rdo_writer = SyntaxWriter.rdo_clone(bitstream_writer, 0)
        for comp in self.pic.get_components(cu.cu_tree):
            self.cu_writer.write_component(cu, comp, rdo_writer)
        bits = rdo_writer.get_num_written_bits()
        cost = ssd + int(bits * qp.get_lambda() + 0.5)
        return cost, ssd

    def write_ctu(self, rsaddr, writer):
        """(ref: cu_encoder.cc:688-735)"""
        writer.enc.reset_bit_counting()
        ctu = self.pic.get_ctu(k.CuTree.PRIMARY, rsaddr)
        write_delta_qp = self.cu_writer.write_ctu(ctu, writer)
        if self.pic.has_secondary_cu_tree():
            ctu2 = self.pic.get_ctu(k.CuTree.SECONDARY, rsaddr)
            write_delta_qp |= self.cu_writer.write_ctu(ctu2, writer)
        predicted_qp = ctu.get_predicted_qp()
        if self.pic.adaptive_qp > 0 and write_delta_qp:
            writer.write_qp(ctu.qp.get_qp_raw(0), predicted_qp,
                            self.pic.adaptive_qp)
        else:
            derived_qp = predicted_qp if self.pic.adaptive_qp == 2 else \
                self.pic.pic_qp.get_qp_raw(0)
            self._set_qp_for_all_cus_in_ctu(ctu, derived_qp)
            if self.pic.has_secondary_cu_tree():
                ctu2 = self.pic.get_ctu(k.CuTree.SECONDARY, rsaddr)
                self._set_qp_for_all_cus_in_ctu(ctu2, derived_qp)
        if self.restr.disable_ext_implicit_last_ctu:
            writer.write_end_of_slice(False)

    def _set_qp_for_all_cus_in_ctu(self, ctu, qp_raw):
        qp = self.pic.get_qp_obj(qp_raw)
        ctu.qp = qp
        for i in range(0, ctu.height, k.MIN_BLOCK_SIZE):
            for j in range(0, ctu.width, k.MIN_BLOCK_SIZE):
                tmp = self.pic.get_cu_at(ctu.cu_tree, ctu.pos_x + j,
                                         ctu.pos_y + i)
                if tmp is not None:
                    tmp.qp = qp

    def calc_delta_qp_from_variance(self, cu):
        """(ref: cu_encoder.cc:308-363)

        The reference reads full 16x16 variance windows from the UNPADDED
        orig picture whose Y/U/V planes live in one contiguous buffer, so
        windows at the bottom picture boundary run past the luma plane
        into the chroma planes.  Emulated here with a flat concatenated
        buffer for byte-exact parity.
        """
        strength = self.settings.aqp_strength / 10.0
        OFFSET = 15
        VAR_BLOCKSIZE = 16
        MEAN_DIV = 2
        luma = 0
        x, y = cu.pos_x, cu.pos_y
        h = cu.height // VAR_BLOCKSIZE
        w = cu.height // VAR_BLOCKSIZE  # (sic: reference uses height twice)
        if self._aqp_flat is None:
            ncomp = self.pic.max_num_components
            self._aqp_flat = np.concatenate(
                [self.orig_pic.plane_view(c).astype(np.int64).ravel()
                 for c in range(ncomp)])
        flat = self._aqp_flat
        stride = self.orig_pic.plane_view(luma).shape[1]
        variances = [(1 << 64) - 1] * (h * w)
        blocks = 0
        for i in range(h):
            if y + i * VAR_BLOCKSIZE >= self.pic.height:
                continue
            for j in range(w):
                if x + j * VAR_BLOCKSIZE >= self.pic.width:
                    continue
                base = (y + i * VAR_BLOCKSIZE) * stride + x + j * VAR_BLOCKSIZE
                idx = base + (np.arange(VAR_BLOCKSIZE)[:, None] * stride +
                              np.arange(VAR_BLOCKSIZE)[None, :])
                blk = flat[np.minimum(idx.ravel(), len(flat) - 1)]
                num = VAR_BLOCKSIZE * VAR_BLOCKSIZE
                ssum = int(blk.sum())
                squares = int((blk * blk).sum())
                variances[blocks] = \
                    (256 * (squares - (ssum * ssum) // num)) // num
                blocks += 1
        variances.sort()
        variance = 1 + variances[blocks // MEAN_DIV]
        bd = self.orig_pic.bitdepth
        dqp = strength * (1.5 * math.log(variance) - OFFSET - 2 * (bd - 8))
        return min(max(int(dqp), -3), 7)

    def _can_skip_any_split_for_cu(self, cu):
        threshold = 2 if self.pic.highest_layer else 3
        return cu.skip_flag and cu.binary_depth >= threshold

    def _can_skip_quad_split_for_cu(self, cu, binary_depth_gt1):
        cu_top_left = self.pic.get_cu_at(cu.cu_tree, cu.pos_x, cu.pos_y)
        cu_bottom_right = self.pic.get_cu_at(
            cu.cu_tree, cu.pos_x + cu.width - 1, cu.pos_y + cu.height - 1)
        if self.settings.fast_quad_split_based_on_binary_split == 1 and \
                binary_depth_gt1:
            return False
        best_is_no_split = cu_top_left.binary_depth == 0
        best_is_single_bt = (cu_top_left.binary_depth == 1 and
                             cu_bottom_right.binary_depth == 1)
        mbsd = self.pic.max_binary_split_depth
        if mbsd in (1, 2):
            return best_is_no_split and not self.pic.is_intra_pic()
        if mbsd == 3:
            return best_is_no_split or \
                (best_is_single_bt and not self.pic.is_intra_pic())
        if mbsd == 4:
            return best_is_no_split or best_is_single_bt
        return False
