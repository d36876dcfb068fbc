"""Public decoder API on a torch device.

``DecoderSession(params, device=...)`` has the methods of
``xvc_tpu.api.DecoderSession`` (ref: xvcdec.h) and decodes through this
package's flat device path.
"""
from xvc_tpu import api as base
from xvc_tpu import constants as k
from xvc_tpu.api import DecoderParameters
from .codec.decoder import Decoder

__all__ = ["DecoderParameters", "DecoderSession"]


class DecoderSession(base.DecoderSession):
    """Decoder handle on ``device`` ("cpu" or "cuda"); the methods are
    the base class's (decode_nal, get_picture, flush,
    num_corrupted_pics, check_conformance)."""

    def __init__(self, params: DecoderParameters = None, device="cpu"):
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
