"""Decoder session on a torch device.

A subclass of ``xvc_tpu.codec.decoder.Decoder`` whose picture decoders
are this package's (``codec/picture_decoder.py``) on the session's
device.  NAL demux, buffering and output order are the base class's.
"""
from xvc_tpu.codec import decoder as base
from xvc_tpu.nal import split_nal_units
from ..engine import resolve_device
from .picture_decoder import PictureDecoder


class Decoder(base.Decoder):
    # Parse errors of a corrupt stream keep the session alive, as in the
    # base class.  RuntimeError (NotImplementedError, CUDA and kernel
    # faults) and MemoryError are not parse errors here: they propagate.
    _PARSE_ERRORS = (ValueError, KeyError, IndexError, OverflowError,
                     ZeroDivisionError)

    def __init__(self, device, num_threads=0):
        if num_threads > 0:
            raise NotImplementedError("picture-level threads are not "
                                      "supported on the device path yet")
        super().__init__(num_threads=0)
        self.device = resolve_device(device)

    def _get_free_picture_decoder(self, sh):
        def new():
            return PictureDecoder(sh.chroma_format, sh.internal_width,
                                  sh.internal_height, sh.internal_bitdepth,
                                  sh.crop_width, sh.crop_height,
                                  device=self.device)

        if len(self.pic_decoders) < self.pic_buffering_num + 1:
            pic = new()
            self.pic_decoders.append(pic)
            return pic
        best = None
        for pic in self.pic_decoders:
            if pic.ref_count > 0 or not pic.output_status_done:
                continue
            if best is None or pic.pic_data.poc < best.pic_data.poc:
                best = pic
        if best is None:
            raise RuntimeError("no free picture decoder")
        if (sh.internal_width != best.pic_data.width or
                sh.internal_height != best.pic_data.height or
                sh.chroma_format != best.pic_data.chroma_format or
                sh.internal_bitdepth != best.pic_data.bitdepth):
            self.pic_decoders[self.pic_decoders.index(best)] = best = new()
        return best


def decode_stream(data, max_pics=None, device="cpu"):
    """Decode a length-prefixed stream on ``device``; return the output
    pictures.  Pictures are pulled with the blocking
    ``get_decoded_picture`` after every NAL and after the flush, so none
    is left behind."""
    dec = Decoder(device)
    pics = []
    for nal in split_nal_units(data):
        dec.decode_nal(nal)
        while True:
            pic = dec.get_decoded_picture()
            if pic is None:
                break
            pics.append(pic)
            if max_pics and len(pics) >= max_pics:
                return pics
    dec.flush()
    while True:
        pic = dec.get_decoded_picture()
        if pic is None:
            break
        pics.append(pic)
    return pics
