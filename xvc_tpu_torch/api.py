"""Public codec API on a torch device (ref: xvcenc.h, xvcdec.h).

Copy of ``xvc_tpu/api.py`` over this package's encoder and decoder:
``EncoderSession(params, device=None)`` encodes with the native CTU
search, or the Python CU encoder where the JAX package takes its own
(``tpu_intra_lookahead``, ``XVC_INTRA_PREPASS=jax``, ``XVC_ME=jax``,
``XVC_ENC_NATIVE=0``), and runs the encoder's device stages (the split
DP, the transform-RD prepass, the lookahead, the per-CU SATD pre-pass,
the motion search's SAD sweeps, the Python path's deblocking) on the card
unless ``device`` names another, with ``params.threads`` picture threads;
what the port lacks raises ``NotImplementedError`` when the session is
made (``codec/encoder.py``).  ``DecoderSession(params, device=None)`` decodes
through the device paths the same way; where the span table is enabled
(``profiling.enable``), ``get_picture`` adds each picture's wait from its
decode's return to its hand-out to the row ``session.output_wait``.
"""
import time
from dataclasses import dataclass

from . import constants as k
from . import profiling
from .codec.decoder import Decoder
from .codec.encoder import Encoder
from .codec.encoder_settings import EncoderSettings

__all__ = ["EncoderParameters", "EncoderSession", "encoder_parameters_check",
           "encoder_parameters_apply_rd_preset", "DecoderParameters",
           "DecoderSession"]

# the encoder's return codes (ref: xvcenc.h xvc_enc_return_code)
OK = 0
ERR_SIZE_TOO_SMALL = 11
ERR_SIZE_TOO_LARGE = 12
ERR_BITDEPTH_OUT_OF_RANGE = 13
ERR_INVALID_PARAM = 16
ERR_NO_SUCH_PRESET = 17

DEFAULT_SUB_GOP_LENGTH = 16


@dataclass
class EncoderParameters:
    """(ref: xvcenc.h xvc_encoder_parameters / xvcenc.cc:40-100)"""
    width: int = 0
    height: int = 0
    chroma_format: int = k.ChromaFormat.YUV420
    color_matrix: int = 0
    input_bitdepth: int = 8
    internal_bitdepth: int = 8
    framerate: float = 60
    sub_gop_length: int = 0        # 0 = auto
    max_keypic_distance: int = 640
    closed_gop: int = 0
    low_delay: int = 0
    num_ref_pics: int = -1         # -1 = from speed preset
    restricted_mode: int = 0
    chroma_qp_offset_table: int = 0
    chroma_qp_offset_u: int = 0
    chroma_qp_offset_v: int = 0
    deblock: int = 1
    beta_offset: int = 0
    tc_offset: int = 0
    qp: int = 32
    flat_lambda: int = 0
    lambda_a: float = 0.0
    lambda_b: float = 0.0
    speed_mode: int = -1           # -1 = default (slow)
    tune_mode: int = 0
    checksum_mode: int = 0
    leading_pictures: int = 0
    threads: int = 0
    explicit_encoder_settings: str = ""


def encoder_parameters_check(p: EncoderParameters) -> int:
    """(ref: xvcenc.cc xvc_enc_parameters_check)"""
    if p.width < 2 or p.height < 2:
        return ERR_SIZE_TOO_SMALL
    if p.width > 65535 or p.height > 65535:
        return ERR_SIZE_TOO_LARGE
    if p.internal_bitdepth < 8 or p.internal_bitdepth > 14 or \
            p.input_bitdepth < 8 or p.input_bitdepth > 16:
        return ERR_BITDEPTH_OUT_OF_RANGE
    if p.qp < k.MIN_ALLOWED_QP or p.qp > k.MAX_ALLOWED_QP:
        return ERR_INVALID_PARAM
    if p.sub_gop_length > 64:
        return ERR_INVALID_PARAM
    return OK


def encoder_parameters_apply_rd_preset(preset: int,
                                       p: EncoderParameters) -> int:
    """Multi-pass RD presets (ref: xvcenc.cc:91-124)."""
    import math
    if preset == 0:
        p.flat_lambda = 0
        p.leading_pictures = 0
    elif preset == 1:
        p.leading_pictures = 1
    elif preset == 2:
        p.flat_lambda = p.sub_gop_length if p.sub_gop_length > 0 \
            else DEFAULT_SUB_GOP_LENGTH
    elif preset == 3:
        p.leading_pictures = 1
        p.lambda_a = math.pow(2.0, -5 / 3.0)
        p.lambda_b = 1.0 / 22
    else:
        return ERR_NO_SUCH_PRESET
    return OK


class EncoderSession:
    """Encoder handle (ref: xvcenc.cc xvc_enc_encoder_create) on
    ``device`` (None: the card, or "cpu", "cuda", "cuda:N")."""

    def __init__(self, params: EncoderParameters, device=None):
        rc = encoder_parameters_check(params)
        if rc != OK:
            raise ValueError(f"invalid encoder parameters (code {rc})")
        self.params = params
        enc = Encoder(params.internal_bitdepth,
                      num_threads=params.threads, device=device)
        settings = EncoderSettings()
        settings.initialize_speed(
            1 if params.speed_mode < 0 else params.speed_mode)
        if params.restricted_mode:
            settings.initialize_restricted(params.restricted_mode)
        if params.tune_mode:
            settings.tune(params.tune_mode)
        if params.explicit_encoder_settings:
            settings.parse_explicit_settings(
                params.explicit_encoder_settings)
        settings.leading_pictures = params.leading_pictures
        settings.flat_lambda = params.flat_lambda
        if params.lambda_a != 0:
            settings.lambda_scale_a = params.lambda_a
        if params.lambda_b != 0:
            settings.lambda_scale_b = params.lambda_b
        if params.num_ref_pics >= 0:
            settings.default_num_ref_pics = params.num_ref_pics
        enc.set_resolution(params.width, params.height)
        enc.set_chroma_format(params.chroma_format)
        enc.set_color_matrix(params.color_matrix)
        enc.set_deblock(params.deblock)
        if params.deblock == 3:
            enc.set_beta_offset(params.beta_offset)
            enc.set_tc_offset(params.tc_offset)
        enc.set_checksum_mode(params.checksum_mode)
        enc.set_qp(params.qp)
        enc.set_low_delay(params.low_delay != 0)
        enc.set_chroma_qp_offsets(params.chroma_qp_offset_table,
                                  params.chroma_qp_offset_u,
                                  params.chroma_qp_offset_v)
        enc.input_bitdepth = params.input_bitdepth
        enc.framerate = params.framerate
        enc.set_encoder_settings(settings)
        sub_gop = params.sub_gop_length
        if sub_gop == 0:
            sub_gop = DEFAULT_SUB_GOP_LENGTH \
                if enc.segment_header.num_ref_pics > 0 else 1
        enc.set_sub_gop_length(sub_gop)
        if params.max_keypic_distance == 0:
            seg_len = ((1 << 62) // sub_gop) * sub_gop
        else:
            seg_len = (params.max_keypic_distance // sub_gop) * sub_gop
        enc.set_segment_length(seg_len)
        if params.closed_gop > 0:
            enc.set_closed_gop_interval(seg_len * params.closed_gop)
        else:
            enc.set_closed_gop_interval(((1 << 62) // sub_gop) * sub_gop)
        self._enc = enc
        self.rec_pictures = []  # reconstruction output queue (POC order)
        self.total_sse = 0
        self.nal_stats = []  # per-NAL stats (ref: xvcenc.h xvc_enc_nal_stats)

    @property
    def device(self):
        return self._enc.device

    def _collect(self, out_nals):
        nals = []
        for n in out_nals:
            self.total_sse += n.sse
            self.nal_stats.append(n)
            nals.append(n.bytes)
        return nals

    def encode(self, picture_bytes: bytes):
        """Encode one picture; returns list of NAL byte strings."""
        nals = self._collect(self._enc.encode(picture_bytes))
        self._capture_rec()
        return nals

    def encode_planes(self, planes, strides=None):
        """Encode from separate Y/U/V plane arrays (2-D, row-major),
        the xvc_enc_encoder_encode2 equivalent (ref: xvcenc.cc:367-404).
        strides are implicit in the arrays; extra row padding is
        stripped via the array views themselves."""
        import numpy as np
        chunks = []
        for plane in planes:
            arr = np.ascontiguousarray(plane)
            chunks.append(arr.tobytes())
        return self.encode(b"".join(chunks))

    def flush(self):
        """Flush all pending pictures; returns list of NAL byte strings."""
        nals = []
        while True:
            out, more = self._enc.flush()
            nals.extend(self._collect(out))
            self._capture_rec()
            if not more:
                break
        return nals

    def _capture_rec(self):
        poc, rec = getattr(self._enc, "out_rec", (None, None))
        if poc is not None:
            self.rec_pictures.append(rec)
        self._enc.out_rec = (None, None)


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
        with profiling.span("decode.session"):
            self._init(params, device)

    def _init(self, params, device):
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
        pic = self._pending.pop(0) if self._pending else \
            self._dec.get_decoded_picture()
        if pic is not None and pic.decoded_at is not None and \
                profiling.enabled():
            profiling.add_span_time("session.output_wait",
                                    time.perf_counter() - pic.decoded_at)
        return pic

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
