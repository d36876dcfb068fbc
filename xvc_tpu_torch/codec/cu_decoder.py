"""The Python parse of a CTU, and host block prediction of the replay
path's sequential tail.

Behavioral equivalent of the reference CU decoder
(ref: src/xvc_dec_lib/cu_decoder.cc).  Copy of ``CuDecoder`` of
``xvc_tpu/codec/cu_decoder.py`` without its host reconstruction (the
dequant, inverse transform and sample writes of ``_decompress_cu``):
``decode_ctu`` parses a CTU (``CuReader``) as the JAX package's does
with ``reconstruct=False``; ``gpu/tree_records.py`` turns the parsed
tree into the record table the device reconstruction reads; the tail
(``gpu/recon.py``) predicts with ``inter`` and ``predict_intra``, and
the residual comes from the device.
"""
from .. import constants as k
from . import inter_mc as mc
from .cu_reader import CuReader
from .intra_recon import IntraReconstructor


class CuDecoder:
    def __init__(self, rec_pic, pic_data, restrictions):
        self.rec = rec_pic
        self.pic = pic_data
        self.restr = restrictions
        self.cu_reader = CuReader(pic_data, restrictions)
        self.inter = mc.InterPredictor(pic_data, rec_pic, rec_pic.bitdepth,
                                       restrictions)
        self.intra = IntraReconstructor(pic_data, rec_pic.bitdepth,
                                        restrictions)

    def decode_ctu(self, rsaddr, reader):
        """Parse one CTU of both trees, its qp and the end-of-slice bin;
        the leaves stay marked from the parse itself."""
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

    def predict_intra(self, cu, comp):
        mode = cu.get_intra_mode(comp)
        return self.intra.predict_intra_mode(cu, comp, mode, self.rec)
