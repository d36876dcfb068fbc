"""Host block prediction of the replay path's sequential tail.

Behavioral equivalent of the reference CU decoder's prediction half
(ref: src/xvc_dec_lib/cu_decoder.cc).  Copy of the reconstruction half
of ``CuDecoder`` of ``xvc_tpu/codec/cu_decoder.py`` (its ``inter`` and
``intra`` predictors and ``predict_intra``); the parse (``CuReader``)
runs natively here, and the residual comes from the device
(``gpu/recon.py``).
"""
from . import inter_mc as mc
from .intra_recon import IntraReconstructor


class CuDecoder:
    def __init__(self, rec_pic, pic_data, restrictions):
        self.rec = rec_pic
        self.pic = pic_data
        self.restr = restrictions
        self.inter = mc.InterPredictor(pic_data, rec_pic, rec_pic.bitdepth,
                                       restrictions)
        self.intra = IntraReconstructor(pic_data, rec_pic.bitdepth,
                                        restrictions)

    def predict_intra(self, cu, comp):
        mode = cu.get_intra_mode(comp)
        return self.intra.predict_intra_mode(cu, comp, mode, self.rec)
