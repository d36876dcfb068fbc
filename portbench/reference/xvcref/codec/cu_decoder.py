"""CU reconstruction: predict + dequant + inverse transform + add.

Behavioral equivalent of the reference CU decoder
(ref: src/xvc_dec_lib/cu_decoder.cc).  Uses the exact-integer numpy ops;
the batched JAX path mirrors these kernels for TPU execution.
"""
import numpy as np

from .. import constants as k
from . import inter_mc as mc
from ..ops import quant as q
from ..ops import transform as tx
from .cu_reader import CuReader
from .intra_recon import IntraReconstructor


class CuDecoder:
    def __init__(self, rec_pic, pic_data, restrictions):
        self.rec = rec_pic
        self.pic = pic_data
        self.restr = restrictions
        self.min_pel = 0
        self.max_pel = (1 << rec_pic.bitdepth) - 1
        self.cu_reader = CuReader(pic_data, restrictions)
        self.inter = mc.InterPredictor(pic_data, rec_pic, rec_pic.bitdepth,
                                       restrictions)
        self.intra = IntraReconstructor(pic_data, rec_pic.bitdepth,
                                        restrictions)

    def decode_ctu(self, rsaddr, reader, reconstruct=True):
        """Parse one CTU and (optionally) reconstruct it in place.

        With reconstruct=False only the CABAC parse runs (the leaves
        stay marked from the parse itself, which is equivalent to the
        post-decompress mark state); the batched device path
        (xvc_tpu/tpu/recon.py) then reconstructs the whole picture.
        """
        self._read_ctu(rsaddr, reader)
        if not reconstruct:
            return
        ctu = self.pic.get_ctu(k.CuTree.PRIMARY, rsaddr)
        self.pic.clear_mark_cu_in_pic(ctu)
        self._decompress_cu(ctu)
        if self.pic.has_secondary_cu_tree():
            ctu2 = self.pic.get_ctu(k.CuTree.SECONDARY, rsaddr)
            self.pic.clear_mark_cu_in_pic(ctu2)
            self._decompress_cu(ctu2)

    def _read_ctu(self, rsaddr, reader):
        ctu = self.pic.get_ctu(k.CuTree.PRIMARY, rsaddr)
        read_delta_qp = self.cu_reader.read_ctu(ctu, reader)
        if self.pic.has_secondary_cu_tree():
            ctu2 = self.pic.get_ctu(k.CuTree.SECONDARY, rsaddr)
            read_delta_qp |= self.cu_reader.read_ctu(ctu2, reader)
        qp_raw = self.pic.pic_qp.get_qp_raw(0)
        if self.pic.adaptive_qp > 0 and read_delta_qp:
            predicted_qp = ctu.get_predicted_qp()
            qp_raw = reader.read_qp(predicted_qp, qp_raw,
                                    self.pic.adaptive_qp)
        elif self.pic.adaptive_qp == 2:
            qp_raw = ctu.get_predicted_qp()
        self._set_qp_recursive(ctu, qp_raw)
        if self.pic.has_secondary_cu_tree():
            ctu2 = self.pic.get_ctu(k.CuTree.SECONDARY, rsaddr)
            self._set_qp_recursive(ctu2, qp_raw)
        if self.restr.disable_ext_implicit_last_ctu:
            if reader.read_end_of_slice():
                raise ValueError("unexpected end of slice")

    def _set_qp_recursive(self, cu, qp_raw):
        cu.qp = self.pic.get_qp_obj(qp_raw)
        for sub in cu.sub_cus:
            if sub is not None:
                self._set_qp_recursive(sub, qp_raw)

    def _decompress_cu(self, cu):
        if cu.split != k.SplitType.NONE:
            for sub in cu.sub_cus:
                if sub is not None:
                    sub.qp = cu.qp
                    self._decompress_cu(sub)
        else:
            self.pic.mark_used_in_pic(cu)
            self.intra.invalidate_lm_cache()
            for comp in self.pic.get_components(cu.cu_tree):
                self._decompress_component(cu, comp, cu.qp)

    def _decompress_component(self, cu, comp, qp):
        cx, cy = cu.pos(comp)
        width, height = cu.size(comp)
        cbf = cu.cbf[comp]
        plane = self.rec.plane_view(comp)

        if cu.is_intra():
            pred = self.predict_intra(cu, comp)
        else:
            self.inter.calculate_mv(cu)
            pred = self.inter.motion_compensation(cu, comp)
        if not cbf:
            plane[cy:cy + height, cx:cx + width] = pred
            return

        coeff = cu.get_coeff(comp)
        dq = q.dequant_np(coeff, comp, qp, width, height, self.rec.bitdepth)
        if not cu.transform_skip[comp]:
            resi = self._inverse_transform(cu, comp, dq)
        else:
            resi = tx.transform_skip_inverse_np(dq, self.rec.bitdepth)
        reco = np.clip(pred + resi, self.min_pel, self.max_pel)
        plane[cy:cy + height, cx:cx + width] = reco

    def _inverse_transform(self, cu, comp, dq):
        t0 = cu.get_transform_type(comp, 0)
        t1 = cu.get_transform_type(comp, 1)
        high_precision = not self.restr.disable_ext2_transform_high_precision
        can_dst_4x4 = (comp == 0 and cu.is_intra() and
                       t0 == k.TransformType.DEFAULT and
                       t1 == k.TransformType.DEFAULT)
        width, height = cu.size(comp)
        if can_dst_4x4 and width == 4 and height == 4 and \
                not self.restr.disable_ext2_transform_dst:
            return tx.inverse_transform_dst4_np(dq, self.rec.bitdepth,
                                                high_precision)
        return tx.inverse_transform_np(dq, t0, t1, self.rec.bitdepth,
                                       high_precision,
                                       dc_only=cu.dc_only[comp])

    # ---- intra ----
    def predict_intra(self, cu, comp):
        mode = cu.get_intra_mode(comp)
        return self.intra.predict_intra_mode(cu, comp, mode, self.rec)
