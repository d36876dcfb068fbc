"""Per-component transform mode RD evaluation.

Behavioral equivalent of the reference transform encoder
(ref: src/xvc_enc_lib/transform_encoder.cc).  Copy of
``xvc_tpu/codec/transform_encoder.py`` with its native route: the
forward transform on the host (``ops/transform.py``), quantization
(``rdo_quant.py``), then dequantization, the inverse transform, the
reconstruction and its distortion in one call of the native library
(``xvcn_recon_dist``); the JAX module's numpy twin of that last step is
not copied.
"""
import numpy as np

from .. import constants as k
from .. import native
from ..ops import metrics as met
from ..ops import quant as q
from ..ops import transform as tx
from ..syntax.writer import SyntaxWriter
from .rdo_quant import RdoQuant

# 4x4 DST-7 basis for the fused native reconstruct path
_DST4_I32 = np.ascontiguousarray(tx._DST4, dtype=np.int32)

_DIST_MAX = (1 << 62)
_COST_MAX = (1 << 62)


class TxSearchFlags:
    NONE = 0
    NORMAL_TX = 1
    CBF_ZERO = 2
    TRANSFORM_TSKIP = 4
    TRANSFORM_SELECT = 8
    FULL_EVAL = 1 | 2 | 4 | 8


def save_comp_state(cu, rec_pic, comp):
    """Snapshot reco + coeff + tx state for one component
    (ref: coding_unit.cc SaveStateTo ResidualState)."""
    cx, cy = cu.pos(comp)
    w, h = cu.size(comp)
    plane = rec_pic.plane_view(comp)
    return {
        "reco": plane[cy:cy + h, cx:cx + w].copy(),
        "coeff": cu.get_coeff(comp).copy(),
        "cbf": cu.cbf[comp],
        "transform_skip": cu.transform_skip[comp],
        "dc_only": cu.dc_only[comp],
        "tx_type": [list(cu.tx_type[0 if comp == 0 else 1])],
        "tx_select_idx": cu.tx_select_idx,
    }


def load_comp_state(cu, rec_pic, comp, state):
    cx, cy = cu.pos(comp)
    w, h = cu.size(comp)
    plane = rec_pic.plane_view(comp)
    plane[cy:cy + h, cx:cx + w] = state["reco"]
    cu.get_coeff(comp)[:, :] = state["coeff"]
    cu.cbf[comp] = state["cbf"]
    cu.transform_skip[comp] = state["transform_skip"]
    cu.dc_only[comp] = state["dc_only"]
    cu.tx_type[0 if comp == 0 else 1] = list(state["tx_type"][0])
    if comp == 0:
        cu.tx_select_idx = state["tx_select_idx"]


class TransformEncoder:
    """Owns prediction buffers + transform/quant RD loops."""

    def __init__(self, bitdepth, num_components, orig_pic, settings):
        self.settings = settings
        self.bitdepth = bitdepth
        self.min_pel = 0
        self.max_pel = (1 << bitdepth) - 1
        self.num_components = num_components
        self.orig_pic = orig_pic
        mt = met.MetricType.STRUCTURAL_SSD if settings.structural_ssd \
            else met.MetricType.SSD
        self.cu_metric = met.SampleMetric(bitdepth, mt,
                                          settings.structural_strength)
        self.fwd_quant = RdoQuant(bitdepth, settings)
        # prediction buffers per component
        self.pred = [None, None, None]
        self.temp_resi_orig = None
        self.temp_resi = None
        self._best_comp_state = {}

    def set_pred_buffer(self, comp, pred):
        self.pred[comp] = pred

    def get_pred_buffer(self, comp):
        return self.pred[comp]

    def compress_and_eval_transform(self, cu, comp, qp, writer, orig_pic,
                                    search_flags, prev_cost, cu_writer,
                                    rec_pic, out_dist_zero=None):
        """(ref: transform_encoder.cc:53-201).
        Returns (cost, dist_reco, dist_resi[, dist_zero via list])."""
        settings = self.settings
        restr = cu.pic.restrictions

        def get_transform_cost(dist):
            if dist >= _DIST_MAX:
                return (_COST_MAX, dist, dist)
            dist_resi = dist
            if settings.fast_inter_transform_dist and \
                    not settings.structural_ssd and cu.is_inter() and \
                    cu.cbf[comp]:
                dist_resi = self.cu_metric.compare(
                    qp, comp, self.temp_resi_orig, self.temp_resi)
            rdo_writer = SyntaxWriter.rdo_clone(writer, 0)
            if cu.is_intra() and comp == 0:
                cu_writer.write_component(cu, comp, rdo_writer)
            else:
                cu_writer.write_residual_data_rdo_cbf(cu, comp, rdo_writer)
            bits = rdo_writer.get_num_written_bits()
            cost = dist_resi + int(bits * qp.get_lambda() + 0.5)
            return (cost, dist, dist_resi)

        best_cost = (_COST_MAX, 0, 0)
        if prev_cost is not None:
            best_cost = (prev_cost, 0, 0)
        best_is_applied = prev_cost is not None

        def save_best():
            self._best_comp_state[comp] = save_comp_state(cu, rec_pic, comp)

        if search_flags & TxSearchFlags.NORMAL_TX:
            if best_is_applied:
                best_is_applied = False
                save_best()
            cu.transform_skip[comp] = False
            cu.set_transform_from_select_idx(comp, -1, restr)
            dist_normal = self.transform_and_reconstruct(
                cu, comp, qp, writer, orig_pic, rec_pic)
            cost = get_transform_cost(dist_normal)
            if cost[0] < best_cost[0]:
                best_cost = cost
                best_is_applied = True

        if search_flags & TxSearchFlags.CBF_ZERO:
            cx, cy = cu.pos(comp)
            w, h = cu.size(comp)
            orig_blk = orig_pic.plane_view(comp)[cy:cy + h, cx:cx + w]
            dist_zero = self.cu_metric.compare(qp, comp, orig_blk,
                                               self.pred[comp])
            if out_dist_zero is not None:
                out_dist_zero.append(dist_zero)
            if cu.cbf[comp]:
                zero_writer = SyntaxWriter.rdo_clone(writer, 0)
                if not restr.disable_transform_cbf:
                    zero_writer.write_cbf(cu, comp, False)
                else:
                    if best_is_applied:
                        best_is_applied = False
                        save_best()
                    cu.root_cbf = True
                    self._clear_cbf(cu, comp, restr)
                    self._reconstruct_zero_cbf(cu, comp, rec_pic)
                    cu_writer.write_residual_data_rdo_cbf(cu, comp,
                                                          zero_writer)
                bits_zero = zero_writer.get_num_written_bits()
                cost = dist_zero + int(bits_zero * qp.get_lambda() + 0.5)
                if cost < best_cost[0]:
                    self._clear_cbf(cu, comp, restr)
                    self._reconstruct_zero_cbf(cu, comp, rec_pic)
                    best_cost = (cost, dist_zero, dist_zero)
                    best_is_applied = True

        if (search_flags & TxSearchFlags.TRANSFORM_TSKIP) and \
                cu.can_transform_skip(comp) and \
                not restr.disable_ext2_transform_skip:
            if best_is_applied:
                best_is_applied = False
                save_best()
            cu.transform_skip[comp] = True
            cu.set_transform_from_select_idx(comp, -1, restr)
            dist_txskip = self.transform_and_reconstruct(
                cu, comp, qp, writer, orig_pic, rec_pic)
            cost = get_transform_cost(dist_txskip)
            if cost[0] < best_cost[0]:
                best_cost = cost
                best_is_applied = True

        best_has_coeff = cu.cbf[comp] if best_is_applied else \
            self._best_comp_state[comp]["cbf"]
        nbr_tx_select_idx = 0
        if (search_flags & TxSearchFlags.TRANSFORM_SELECT) and comp == 0 and \
                not restr.disable_ext2_transform_select:
            nbr_tx_select_idx = k.MAX_TRANSFORM_SELECT_IDX
        if settings.fast_transform_select_eval and \
                (search_flags & TxSearchFlags.CBF_ZERO) and \
                not best_has_coeff:
            nbr_tx_select_idx = 0
        for tx_select in range(nbr_tx_select_idx):
            if best_is_applied:
                best_is_applied = False
                save_best()
            cu.transform_skip[comp] = False
            cu.set_transform_from_select_idx(comp, tx_select, restr)
            dist = self.transform_and_reconstruct(cu, comp, qp, writer,
                                                  orig_pic, rec_pic)
            cost = get_transform_cost(dist)
            if cost[0] < best_cost[0]:
                best_cost = cost
                best_is_applied = True

        if not best_is_applied:
            load_comp_state(cu, rec_pic, comp, self._best_comp_state[comp])
        return best_cost

    @staticmethod
    def _clear_cbf(cu, comp, restr):
        """(ref: coding_unit.cc:338-350)"""
        cu.cbf[comp] = False
        if restr.disable_transform_cbf:
            cu.cbf[comp] = cu.root_cbf
        cu.transform_skip[comp] = False
        cu.set_transform_from_select_idx(comp, -1, restr)
        cu.get_coeff(comp)[:, :] = 0

    def _reconstruct_zero_cbf(self, cu, comp, rec_pic):
        cx, cy = cu.pos(comp)
        w, h = cu.size(comp)
        rec_pic.plane_view(comp)[cy:cy + h, cx:cx + w] = self.pred[comp]

    def transform_and_reconstruct(self, cu, comp, qp, syntax_writer,
                                  orig_pic, rec_pic):
        """(ref: transform_encoder.cc:203-285)"""
        restr = cu.pic.restrictions
        cx, cy = cu.pos(comp)
        width, height = cu.size(comp)
        skip_transform = cu.transform_skip[comp]
        cu_coeff = cu.get_coeff(comp)

        orig_blk = orig_pic.plane_view(comp)[cy:cy + height, cx:cx + width]
        pred = self.pred[comp]
        self.temp_resi_orig = orig_blk.astype(np.int32) - pred

        if not skip_transform:
            coeff_full = self._forward_transform(cu, comp,
                                                 self.temp_resi_orig)
        else:
            coeff_full = tx.transform_skip_forward_np(self.temp_resi_orig,
                                                      self.bitdepth)

        if self.settings.rdo_quant:
            non_zero = self.fwd_quant.quant_rdo(
                cu, comp, qp, cu.pic.get_prediction_type(), syntax_writer,
                coeff_full, cu_coeff)
        else:
            non_zero = self.fwd_quant.quant_fast(
                cu, comp, qp, cu.pic.get_prediction_type(), coeff_full,
                cu_coeff)
        cu.dc_only[comp] = non_zero == 1 and cu_coeff[0, 0] != 0
        if comp == 0 and cu.tx_select_idx > 0 and cu.is_intra() and \
                non_zero < k.TRANSFORM_SELECT_MIN_SIG_COEFFS:
            return _DIST_MAX
        if comp == 0 and cu.tx_select_idx >= 0 and cu.is_inter() and \
                not non_zero:
            return _DIST_MAX
        if skip_transform and not non_zero:
            return _DIST_MAX
        cbf = non_zero != 0
        if not cbf and restr.disable_transform_cbf:
            cu_coeff[:, :] = 0
            cbf = True
        cu.cbf[comp] = cbf

        rec_plane = rec_pic.plane_view(comp)
        if cbf:
            return self._recon_dist_native(cu, comp, qp, cu_coeff,
                                           skip_transform, pred, orig_blk,
                                           rec_plane, cx, cy)
        rec_plane[cy:cy + height, cx:cx + width] = pred
        return self.cu_metric.compare(qp, comp, orig_blk, pred)

    def _recon_dist_native(self, cu, comp, qp, cu_coeff, skip_transform,
                           pred, orig_blk, rec_plane, cx, cy):
        """Fused dequant + inverse transform + reconstruct + metric in
        one native call (xvcn_recon_dist); bit-identical to the split
        path, pinned by the byte-exact encode goldens."""
        restr = cu.pic.restrictions
        width, height = cu.size(comp)
        bd = self.bitdepth
        wl2, hl2 = width.bit_length() - 1, height.bit_length() - 1
        bias = ((wl2 + hl2) % 2) != 0
        tshift = q.get_transform_shift(width, height, bd)
        dq_scale = qp.get_inv_scale(comp) * (181 if bias else 1)
        dq_shift = q.IQUANT_SHIFT - tshift + (8 if bias else 0)
        skip_shift = skip_scale = dc_shift = 0
        m1p = m2p = None
        shift1 = shift2 = zo = 0
        dflt = (k.TransformType.DEFAULT, k.TransformType.DCT2)
        t0 = cu.get_transform_type(comp, 0)
        t1 = cu.get_transform_type(comp, 1)
        hp = not restr.disable_ext2_transform_high_precision
        if skip_transform:
            kind = 2
            skip_shift = tshift + (7 if bias else 0)
            skip_scale = 181 if bias else 1
        else:
            can_dst4 = (comp == 0 and cu.is_intra() and
                        t0 == k.TransformType.DEFAULT and
                        t1 == k.TransformType.DEFAULT and
                        width == 4 and height == 4 and
                        not restr.disable_ext2_transform_dst)
            if can_dst4:
                kind = 0
                m1p = m2p = _DST4_I32
                shift1, shift2 = 7, 20 - bd
                zo = k.TRANSFORM_ZERO_OUT_MIN_SIZE
            elif cu.dc_only[comp] and t0 in dflt and t1 in dflt:
                kind = 1
                dc_shift = 14 - bd
            else:
                kind = 0
                hp1 = hp or height >= 64 or height == 2
                hp2 = hp or width >= 64 or width == 2
                m1p, adj1 = tx._matrix_i32(int(t0), height, hp1)
                m2p, adj2 = tx._matrix_i32(int(t1), width, hp2)
                shift1 = 7 + (2 if hp1 else 0) + adj1
                shift2 = 20 - bd + (2 if hp2 else 0) + adj2
                zo = k.TRANSFORM_ZERO_OUT_MIN_SIZE
        mkind = self.cu_metric.type
        if mkind == met.MetricType.STRUCTURAL_SSD and comp != 0:
            mkind = met.MetricType.SSD
        resi = np.empty((height, width), dtype=np.int32)
        rec_region = rec_plane[cy:cy + height, cx:cx + width]
        predc = pred if (pred.dtype == np.int32 and
                         pred.flags.c_contiguous) else \
            np.ascontiguousarray(pred, np.int32)
        stride = rec_plane.strides[0] // 4
        dist = native.lib().xvcn_recon_dist(
            cu_coeff.ctypes.data, height, width,
            dq_scale, dq_shift, kind,
            0 if m1p is None else m1p.ctypes.data,
            0 if m2p is None else m2p.ctypes.data,
            shift1, shift2, zo, skip_shift, skip_scale, dc_shift,
            predc.ctypes.data, predc.strides[0] // 4,
            orig_blk.ctypes.data, orig_blk.strides[0] // 4,
            rec_region.ctypes.data, stride,
            resi.ctypes.data, bd, int(mkind), qp.get_qp_raw(0),
            float(self.cu_metric.structural_strength))
        self.temp_resi = resi
        return int(dist * qp.distortion_weight[comp])

    def _forward_transform(self, cu, comp, resi):
        restr = cu.pic.restrictions
        t0 = cu.get_transform_type(comp, 0)
        t1 = cu.get_transform_type(comp, 1)
        high_precision = not restr.disable_ext2_transform_high_precision
        width, height = cu.size(comp)
        can_dst_4x4 = (comp == 0 and cu.is_intra() and
                       t0 == k.TransformType.DEFAULT and
                       t1 == k.TransformType.DEFAULT)
        if can_dst_4x4 and width == 4 and height == 4 and \
                not restr.disable_ext2_transform_dst:
            return tx.forward_transform_dst4_np(resi, self.bitdepth,
                                                high_precision)
        return tx.forward_transform(resi, t0, t1, self.bitdepth,
                                    high_precision)

    def get_cu_bits_residual(self, cu, bitstream_writer, cu_writer):
        rdo_writer = SyntaxWriter.rdo_clone(bitstream_writer, 0)
        for comp in range(self.num_components):
            cu_writer.write_residual_data_rdo_cbf(cu, comp, rdo_writer)
        return rdo_writer.get_num_written_bits()

    def get_cu_bits_full(self, cu, bitstream_writer, cu_writer):
        rdo_writer = SyntaxWriter.rdo_clone(bitstream_writer, 0)
        for comp in range(self.num_components):
            cu_writer.write_component(cu, comp, rdo_writer)
        return rdo_writer.get_num_written_bits()
