"""Per-picture decoding through the flat device path on a torch device.

A subclass of ``xvc_tpu.codec.picture_decoder.PictureDecoder``: header
handling, checksum and output are the base class's; ``_decode_impl``
replaces the reconstruction with native parse -> ``FlatReconstructor``
-> device deblock, in the order of the base's flat branch.  A picture
the flat path cannot decode raises ``NotImplementedError`` naming the
reason; nothing falls back to the host path.
"""
from xvc_tpu import constants as k
from xvc_tpu.codec import picture_decoder as base
from xvc_tpu.native import pic as native_pic
from xvc_tpu.ops.deblock import DeblockingFilter
from xvc_tpu.ops.quant import Qp
from ..gpu import flat_recon
from ..gpu.deblock import deblock_picture


class PictureDecoder(base.PictureDecoder):
    def __init__(self, pic_format_chroma, width, height, bitdepth,
                 crop_width=0, crop_height=0, *, device):
        super().__init__(pic_format_chroma, width, height, bitdepth,
                         crop_width, crop_height)
        self.device = device

    def init_pic(self, segment, header, ref_pic_list, output_pic_format,
                 user_data):
        flat_recon.release_slot(self.rec_pic)  # buffer recycled
        super().init_pic(segment, header, ref_pic_list, output_pic_format,
                         user_data)

    def decode(self, segment, prev_segment, bit_reader, post_process=True):
        return self._decode_impl(segment, prev_segment, bit_reader,
                                 post_process)

    def _decode_impl(self, segment, prev_segment, bit_reader,
                     post_process=True):
        pd = self.pic_data
        self.finish_post()
        restr = segment.restrictions
        if getattr(segment, "tile_rows", 1) >= 2:
            raise NotImplementedError("tile_rows >= 2 (CTU-tile-row "
                                      "extension) is not on the flat path")
        if not native_pic.parse_available():
            raise NotImplementedError("the native picture parse is not "
                                      "available")
        reason = flat_recon.ineligible_reason(pd, restr)
        if reason is not None:
            raise NotImplementedError("picture not decodable on the flat "
                                      "device path: " + reason)
        qp = Qp(self.pic_qp, pd.chroma_format, pd.bitdepth, 0.0,
                segment.chroma_qp_offset_table, segment.chroma_qp_offset_u,
                segment.chroma_qp_offset_v)
        pd.init(segment, qp, True, light=True)
        pd.mv_resolved = False
        pd._parse_records = None
        success = native_pic.parse_picture(self, segment, bit_reader, qp,
                                           replay=False)
        planes = flat_recon.FlatReconstructor(self, segment,
                                              self.device).run()
        if pd.deblock:
            filt = DeblockingFilter(pd, self.rec_pic, pd.beta_offset,
                                    pd.tc_offset, restr)
            deblock_picture(filt, planes, self.device)
            flat_recon.store_and_download(self.rec_pic, planes, self.device)
        pad_needed = pd.tid == 0 or not pd.highest_layer
        alt_needed = (pd.nal_type == k.NalUnitType.INTRA_ACCESS_PICTURE and
                      prev_segment.open_gop)
        if pad_needed:
            self.rec_pic.pad_border()
        if alt_needed:
            self._generate_alternative_rec_pic(segment, prev_segment)
        pd.ref_pic_lists.zero_out_references()
        if post_process:
            success = self.postprocess(segment, bit_reader) and success
        return success
