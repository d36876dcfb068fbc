"""Public decoder API on a torch device (ref: xvcdec.h).

``DecoderSession(params, device=None)`` is the decoder half of
``xvc_tpu/api.py`` over this package's decoder: it decodes through the
flat device path, on the card unless ``device`` names another.
"""
from dataclasses import dataclass

from . import constants as k
from .codec.decoder import Decoder

__all__ = ["DecoderParameters", "DecoderSession"]


@dataclass
class DecoderParameters:
    """(ref: xvcdec.h xvc_decoder_parameters)"""
    output_width: int = 0
    output_height: int = 0
    output_chroma_format: int = k.ChromaFormat.UNDEFINED
    output_color_matrix: int = 0
    output_bitdepth: int = 0
    max_framerate: float = 0
    dither: int = 0
    threads: int = 0


class DecoderSession:
    """Decoder handle (ref: xvcdec.cc xvc_dec_decoder_create) on
    ``device`` (None: the card, or "cpu", "cuda", "cuda:N")."""

    def __init__(self, params: DecoderParameters = None, device=None):
        self.params = params or DecoderParameters()
        self._dec = Decoder(device, num_threads=self.params.threads)
        self._dec.output_width = self.params.output_width
        self._dec.output_height = self.params.output_height
        self._dec.output_bitdepth = self.params.output_bitdepth
        ocf = self.params.output_chroma_format
        if ocf is None or int(ocf) < 0:
            ocf = k.ChromaFormat.UNDEFINED
        self._dec.output_chroma_format = ocf
        self._dec.output_color_matrix = self.params.output_color_matrix
        self._dec.dither = self.params.dither != 0
        max_fps = self.params.max_framerate or k.TIME_SCALE
        self._dec.decoder_ticks = int(k.TIME_SCALE / max_fps + 0.5)
        self._pending = []

    @property
    def device(self):
        return self._dec.device

    def decode_nal(self, nal_bytes: bytes, user_data: int = 0):
        self._dec.decode_nal(nal_bytes, user_data)
        pic = self._dec.get_decoded_picture()
        if pic is not None:
            self._pending.append(pic)

    def get_picture(self):
        """Returns the next decoded picture (OutputPicture) or None."""
        if self._pending:
            return self._pending.pop(0)
        return self._dec.get_decoded_picture()

    def flush(self):
        self._dec.flush()
        while True:
            pic = self._dec.get_decoded_picture()
            if pic is None:
                return
            self._pending.append(pic)

    @property
    def num_corrupted_pics(self):
        return self._dec.num_corrupted_pics

    def check_conformance(self):
        """(ref: xvcdec.cc decoder_check_conformance). Returns
        (ok, num_corrupted_pics)."""
        n = self.num_corrupted_pics
        return n == 0, n
