"""Segment header + hierarchical sub-GOP POC/DOC/TID mapping.

Behavioral equivalent of the reference segment layer
(ref: src/xvc_common_lib/segment_header.{h,cc},
 src/xvc_dec_lib/segment_header_reader.cc:28-98,
 src/xvc_enc_lib/segment_header_writer.cc:31-93).
The DOC<->POC<->TID tables are normative data of the GOP structure.
"""
from dataclasses import dataclass, field

from . import constants as k
from .bitio import BitReader
from .restrictions import Restrictions, read_restrictions

_MAX_PICNUM = k.TIME_SCALE + 1

# Minor-version bit marking the xvc_tpu extension dialect (tile mode).
# Extension streams also set nal_rfe on every NAL so reference decoders
# skip them cleanly instead of misparsing.
EXT_MINOR_BIT = 0x8000

# Normative sub-GOP mapping tables (ref: segment_header.cc:32-147)
DOC_TO_POC = [
    [0] * 17,
    [0, 1] + [0] * 15,
    [0, 2, 1] + [0] * 14,
    [0, 3, 2, 1] + [0] * 13,
    [0, 4, 2, 1, 3] + [0] * 12,
    [0, 5, 3, 2, 1, 4] + [0] * 11,
    [0, 6, 2, 4, 1, 3, 5] + [0] * 10,
    [0, 7, 4, 2, 6, 1, 3, 5] + [0] * 9,
    [0, 8, 4, 2, 6, 1, 3, 5, 7] + [0] * 8,
    [0, 9, 5, 3, 2, 7, 1, 4, 6, 8] + [0] * 7,
    [0, 10, 2, 4, 6, 8, 1, 3, 5, 7, 9] + [0] * 6,
    [0, 11, 6, 3, 9, 2, 5, 8, 1, 4, 7, 10] + [0] * 5,
    [0, 12, 4, 8, 2, 6, 10, 1, 3, 5, 7, 9, 11] + [0] * 4,
    [0, 13, 7, 4, 10, 2, 6, 9, 12, 1, 3, 5, 8, 11] + [0] * 3,
    [0, 14, 2, 4, 6, 8, 10, 12, 1, 3, 5, 7, 9, 11, 13] + [0] * 2,
    [0, 15, 8, 4, 12, 2, 6, 10, 14, 1, 3, 5, 7, 9, 11, 13] + [0],
    [0, 16, 8, 4, 12, 2, 6, 10, 14, 1, 3, 5, 7, 9, 11, 13, 15],
]

POC_TO_DOC = [
    [0] * 17,
    [0, 1] + [0] * 15,
    [0, 2, 1] + [0] * 14,
    [0, 3, 2, 1] + [0] * 13,
    [0, 3, 2, 4, 1] + [0] * 12,
    [0, 4, 3, 2, 5, 1] + [0] * 11,
    [0, 4, 2, 5, 3, 6, 1] + [0] * 10,
    [0, 5, 3, 6, 2, 7, 4, 1] + [0] * 9,
    [0, 5, 3, 6, 2, 7, 4, 8, 1] + [0] * 8,
    [0, 6, 4, 3, 7, 2, 8, 5, 9, 1] + [0] * 7,
    [0, 6, 2, 7, 3, 8, 4, 9, 5, 10, 1] + [0] * 6,
    [0, 8, 5, 3, 9, 6, 2, 10, 7, 4, 11, 1] + [0] * 5,
    [0, 7, 4, 8, 2, 9, 5, 10, 3, 11, 6, 12, 1] + [0] * 4,
    [0, 9, 5, 10, 3, 11, 6, 2, 12, 7, 4, 13, 8, 1] + [0] * 3,
    [0, 8, 2, 9, 3, 10, 4, 11, 5, 12, 6, 13, 7, 14, 1] + [0] * 2,
    [0, 9, 5, 10, 3, 11, 6, 12, 2, 13, 7, 14, 4, 15, 8, 1] + [0],
    [0, 9, 5, 10, 3, 11, 6, 12, 2, 13, 7, 14, 4, 15, 8, 16, 1],
]

DOC_TO_TID = [
    [0] * 17,
    [0] * 17,
    [0, 0, 1] + [0] * 14,
    [0, 0, 1, 2] + [0] * 13,
    [0, 0, 1, 2, 2] + [0] * 12,
    [0, 0, 1, 2, 3, 3] + [0] * 11,
    [0, 0, 1, 1, 2, 2, 2] + [0] * 10,
    [0, 0, 1, 2, 2, 3, 3, 3] + [0] * 9,
    [0, 0, 1, 2, 2, 3, 3, 3, 3] + [0] * 8,
    [0, 0, 1, 2, 3, 3, 4, 4, 4, 4] + [0] * 7,
    [0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 2] + [0] * 6,
    [0, 0, 1, 2, 2, 3, 3, 3, 4, 4, 4, 4] + [0] * 5,
    [0, 0, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3, 3] + [0] * 4,
    [0, 0, 1, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 4] + [0] * 3,
    [0, 0, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2] + [0] * 2,
    [0, 0, 1, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4] + [0],
    [0, 0, 1, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4],
]

DOC_TO_POC_32 = [0, 32, 16, 8, 24, 4, 12, 20, 28, 2, 6, 10, 14, 18, 22, 26,
                 30, 1, 3, 5, 7, 9, 11, 13, 15, 17, 19, 21, 23, 25, 27, 29, 31]
POC_TO_DOC_32 = [0, 17, 9, 18, 5, 19, 10, 20, 3, 21, 11, 22, 6, 23, 12, 24,
                 2, 25, 13, 26, 7, 27, 14, 28, 4, 29, 15, 30, 8, 31, 16, 32, 1]
DOC_TO_TID_32 = [0, 0, 1, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4,
                 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5]

DOC_TO_POC_64 = [0, 64, 32, 16, 48, 8, 24, 40, 56, 4, 12, 20, 28, 36, 44, 52,
                 60, 2, 6, 10, 14, 18, 22, 26, 30, 34, 38, 42, 46, 50, 54, 58,
                 62] + list(range(1, 64, 2))
POC_TO_DOC_64 = [0, 33, 17, 34, 9, 35, 18, 36, 5, 37, 19, 38, 10, 39, 20, 40,
                 3, 41, 21, 42, 11, 43, 22, 44, 6, 45, 23, 46, 12, 47, 24, 48,
                 2, 49, 25, 50, 13, 51, 26, 52, 7, 53, 27, 54, 14, 55, 28, 56,
                 4, 57, 29, 58, 15, 59, 30, 60, 8, 61, 31, 62, 16, 63, 32, 64,
                 1]
DOC_TO_TID_64 = [0, 0, 1, 2, 2, 3, 3, 3, 3] + [4] * 8 + [5] * 16 + [6] * 32

PICS_IN_SUBBITSTREAM = [
    [0, 0, 0, 0, 0],
    [1, _MAX_PICNUM, _MAX_PICNUM, _MAX_PICNUM, _MAX_PICNUM],
    [1, 2, _MAX_PICNUM, _MAX_PICNUM, _MAX_PICNUM],
    [1, 2, 3, _MAX_PICNUM, _MAX_PICNUM],
    [1, 2, 4, _MAX_PICNUM, _MAX_PICNUM],
    [1, 2, 3, 5, _MAX_PICNUM],
    [1, 3, 6, 6, _MAX_PICNUM],
    [1, 2, 4, 7, _MAX_PICNUM],
    [1, 2, 4, 8, _MAX_PICNUM],
    [1, 2, 3, 5, 9],
    [1, 5, 10, 10, 10],
    [1, 2, 4, 7, 11],
    [1, 3, 6, 12, 12],
    [1, 2, 4, 8, 13],
    [1, 7, 14, 14, 14],
    [1, 2, 4, 8, 15],
    [1, 2, 4, 8, 16],
]
PICS_IN_SUBBITSTREAM_32 = [1, 2, 4, 8, 16, 32]
PICS_IN_SUBBITSTREAM_64 = [1, 2, 4, 8, 16, 32, 64]


def _doc_to_poc(sub_gop_length, doc):
    if sub_gop_length <= 16:
        return DOC_TO_POC[sub_gop_length][doc]
    if sub_gop_length == 32:
        return DOC_TO_POC_32[doc]
    if sub_gop_length == 64:
        return DOC_TO_POC_64[doc]
    if doc == 0:
        return 0
    if doc == 1:
        return sub_gop_length
    return doc - 1


def _poc_to_doc(sub_gop_length, poc):
    if sub_gop_length <= 16:
        return POC_TO_DOC[sub_gop_length][poc]
    if sub_gop_length == 32:
        return POC_TO_DOC_32[poc]
    if sub_gop_length == 64:
        return POC_TO_DOC_64[poc]
    if poc == 0:
        return 0
    if poc == sub_gop_length:
        return 1
    return poc + 1


def _doc_to_tid(sub_gop_length, doc):
    if sub_gop_length <= 16:
        return DOC_TO_TID[sub_gop_length][doc]
    if sub_gop_length == 32:
        return DOC_TO_TID_32[doc]
    if sub_gop_length == 64:
        return DOC_TO_TID_64[doc]
    if doc <= 1:
        return 0
    return 1


def calc_poc_from_doc(doc, sub_gop_length, sub_gop_start_poc):
    if doc < 1:
        return 0
    doc_rem = ((doc - sub_gop_start_poc - 1) % sub_gop_length) + 1
    return _doc_to_poc(sub_gop_length, doc_rem) + sub_gop_start_poc


def calc_tid_from_doc(doc, sub_gop_length, sub_gop_start_poc):
    if doc < 1:
        return 0
    doc_rem = ((doc - sub_gop_start_poc - 1) % sub_gop_length) + 1
    return _doc_to_tid(sub_gop_length, doc_rem)


def get_max_tid(sub_gop_length):
    if sub_gop_length == 1:
        return 0
    if sub_gop_length == 8:
        return 3
    if sub_gop_length == 16:
        return 4
    if sub_gop_length == 32:
        return 5
    if sub_gop_length == 64:
        return 6
    if sub_gop_length <= 16:
        return max(DOC_TO_TID[sub_gop_length])
    return 1


def get_framerate_max_tid(decoder_ticks, bitstream_ticks, sub_gop_length):
    if sub_gop_length <= 16:
        for t in range(4, -1, -1):
            if (PICS_IN_SUBBITSTREAM[sub_gop_length][t] * decoder_ticks
                    <= sub_gop_length * bitstream_ticks):
                return t
    if sub_gop_length == 32:
        for t in range(5, -1, -1):
            if (PICS_IN_SUBBITSTREAM_32[t] * decoder_ticks
                    <= sub_gop_length * bitstream_ticks):
                return t
    if sub_gop_length == 64:
        for t in range(6, -1, -1):
            if (PICS_IN_SUBBITSTREAM_64[t] * decoder_ticks
                    <= sub_gop_length * bitstream_ticks):
                return t
    if decoder_ticks <= bitstream_ticks:
        return 6
    return 0


def get_framerate(max_tid, bitstream_ticks, sub_gop_length):
    if bitstream_ticks == 0 or sub_gop_length == 0:
        return 0.0
    if sub_gop_length <= 16:
        return (PICS_IN_SUBBITSTREAM[sub_gop_length][max_tid] * k.TIME_SCALE
                / (sub_gop_length * bitstream_ticks))
    if sub_gop_length == 32:
        return (PICS_IN_SUBBITSTREAM_32[max_tid] * k.TIME_SCALE
                / (sub_gop_length * bitstream_ticks))
    if sub_gop_length == 64:
        return (PICS_IN_SUBBITSTREAM_64[max_tid] * k.TIME_SCALE
                / (sub_gop_length * bitstream_ticks))
    if max_tid == 0:
        return k.TIME_SCALE / (sub_gop_length * bitstream_ticks)
    return k.TIME_SCALE / bitstream_ticks


@dataclass
class SegmentHeader:
    codec_identifier: int = -1
    major_version: int = -1
    minor_version: int = -1
    soc: int = -1
    chroma_format: int = k.ChromaFormat.UNDEFINED
    color_matrix: int = k.ColorMatrix.UNDEFINED
    internal_bitdepth: int = -1
    bitstream_ticks: int = 0
    max_sub_gop_length: int = 0
    open_gop: bool = False
    low_delay: bool = False
    leading_pictures: int = 0
    num_ref_pics: int = 0
    max_binary_split_depth: int = -1
    checksum_mode: int = k.ChecksumMode.MIN_OVERHEAD
    source_padding: bool = False
    adaptive_qp: int = 0
    chroma_qp_offset_table: int = 0
    chroma_qp_offset_u: int = 0
    chroma_qp_offset_v: int = 0
    deblocking_mode: int = k.DeblockingMode.DISABLED
    beta_offset: int = 0
    tc_offset: int = 0
    restrictions: Restrictions = field(default_factory=Restrictions)
    output_width: int = 0
    output_height: int = 0
    # CTU-tile-row extension (xvc_tpu, not in the reference): >= 2
    # splits each picture into that many CTU-row tiles with independent
    # CABAC contexts and prediction cut at tile tops (SURVEY.md §2.5/§5
    # in-picture scale-out).  Signaled only in rfe-flagged segment
    # headers with EXT_MINOR_BIT set, which baseline decoders ignore
    # wholesale (ref: decoder.cc:84-113 drops rfe NALs).
    tile_rows: int = 1

    @property
    def internal_width(self):
        m = k.MIN_CU_SIZE
        return m * ((self.output_width + m - 1) // m)

    @property
    def internal_height(self):
        m = k.MIN_CU_SIZE
        return m * ((self.output_height + m - 1) // m)

    @property
    def crop_width(self):
        return (self.internal_width - self.output_width
                if self.source_padding else 0)

    @property
    def crop_height(self):
        return (self.internal_height - self.output_height
                if self.source_padding else 0)


class DecoderState:
    """Conformance states mirrored from the reference decoder enum."""
    NO_SEGMENT_HEADER = 0
    SEGMENT_HEADER_DECODED = 1
    PIC_DECODED = 2
    DECODER_VERSION_TOO_LOW = 3
    BITSTREAM_VERSION_TOO_LOW = 4
    BITSTREAM_BITDEPTH_TOO_HIGH = 5
    CHECKSUM_MISMATCH = 6


def read_segment_header(bit_reader: BitReader, soc: int,
                        ext_allowed: bool = False):
    """Parse segment header payload (after NAL unit header byte).

    Returns (state, SegmentHeader|None, accept_xvc_bit_zero).
    ext_allowed=True (the NAL carried nal_rfe=1): the header is accepted
    only if it is an xvc_tpu extension header (EXT_MINOR_BIT set in the
    minor version); otherwise (None, None, False) is returned and the
    caller must ignore the NAL without any state change — exactly the
    reference's behavior for unknown rfe NALs.
    """
    sh = SegmentHeader()
    sh.codec_identifier = bit_reader.read_bits(24)
    if sh.codec_identifier != k.XVC_CODEC_IDENTIFIER:
        if ext_allowed:
            return None, None, False
        return DecoderState.NO_SEGMENT_HEADER, None, False
    sh.major_version = bit_reader.read_bits(16)
    if sh.major_version > k.XVC_MAJOR_VERSION:
        if ext_allowed:
            return None, None, False
        return DecoderState.DECODER_VERSION_TOO_LOW, None, False
    accept_xvc_bit_zero = sh.major_version == 1
    sh.minor_version = bit_reader.read_bits(16)
    is_ext = bool(sh.minor_version & EXT_MINOR_BIT)
    if ext_allowed and not is_ext:
        return None, None, False
    if is_ext and not ext_allowed:
        # EXT_MINOR_BIT without nal_rfe: treat as a plain (large) minor
        # version like the reference would — no extension fields follow.
        is_ext = False
    sh.minor_version &= ~EXT_MINOR_BIT
    supported = (sh.major_version == k.XVC_MAJOR_VERSION
                 and sh.minor_version >= k.XVC_MINOR_VERSION)
    for old_major, old_minor in k.SUPPORTED_OLD_VERSIONS:
        if old_major == sh.major_version and old_minor <= sh.minor_version:
            supported = True
    if not supported:
        return DecoderState.BITSTREAM_VERSION_TOO_LOW, None, accept_xvc_bit_zero
    sh.output_width = bit_reader.read_bits(k.PIC_SIZE_BITS)
    sh.output_height = bit_reader.read_bits(k.PIC_SIZE_BITS)
    sh.chroma_format = k.ChromaFormat(bit_reader.read_bits(4))
    sh.internal_bitdepth = bit_reader.read_bits(4) + 8
    if sh.internal_bitdepth > 16:
        return (DecoderState.BITSTREAM_BITDEPTH_TOO_HIGH, None,
                accept_xvc_bit_zero)
    sh.bitstream_ticks = bit_reader.read_bits(24)
    sh.max_sub_gop_length = bit_reader.read_bits(8)
    sh.color_matrix = k.ColorMatrix(bit_reader.read_bits(3))
    sh.open_gop = bit_reader.read_bit() != 0
    sh.num_ref_pics = bit_reader.read_bits(4)
    sh.max_binary_split_depth = bit_reader.read_bits(2)
    sh.checksum_mode = k.ChecksumMode(bit_reader.read_bits(1))
    sh.adaptive_qp = bit_reader.read_bits(2)
    sh.chroma_qp_offset_table = bit_reader.read_bits(2)
    if bit_reader.read_bit():
        d = k.CHROMA_OFFSET_BITS
        sh.chroma_qp_offset_u = bit_reader.read_bits(d) - (1 << (d - 1))
        sh.chroma_qp_offset_v = bit_reader.read_bits(d) - (1 << (d - 1))
    sh.deblocking_mode = k.DeblockingMode(bit_reader.read_bits(2))
    if sh.deblocking_mode == k.DeblockingMode.CUSTOM:
        d = k.DEBLOCK_OFFSET_BITS
        sh.beta_offset = bit_reader.read_bits(d) - (1 << (d - 1))
        sh.tc_offset = bit_reader.read_bits(d) - (1 << (d - 1))
    if sh.major_version > 1:
        sh.low_delay = bit_reader.read_bit() != 0
        sh.leading_pictures = bit_reader.read_bits(1)
        sh.source_padding = bit_reader.read_bit() != 0
    if is_ext:
        sh.tile_rows = bit_reader.read_bits(8)
        if sh.tile_rows < 2:
            return None, None, False
    sh.restrictions = read_restrictions(bit_reader, sh.major_version)
    bit_reader.skip_bits()
    sh.soc = soc
    return DecoderState.SEGMENT_HEADER_DECODED, sh, accept_xvc_bit_zero


def parse_nal_unit_header(bit_reader: BitReader, accept_xvc_bit_zero=False,
                          with_rfe=False):
    """Returns NalUnitType or None if the NAL should be ignored.

    with_rfe=True returns (NalUnitType|None, rfe) and does NOT drop
    rfe-flagged NALs — the caller decides whether it understands the
    extension (codec/decoder.py); with_rfe=False keeps the reference
    behavior of ignoring them (ref: src/xvc_dec_lib/decoder.cc:84-113).
    """
    header = bit_reader.read_byte()
    xvc_bit_one = (header >> 7) & 1
    if xvc_bit_one == 0:
        nal_type_guess = (header >> 1) & 31
        if accept_xvc_bit_zero and nal_type_guess in (
                int(k.NalUnitType.INTRA_ACCESS_PICTURE),
                int(k.NalUnitType.PREDICTED_PICTURE),
                int(k.NalUnitType.BIPREDICTED_PICTURE),
                int(k.NalUnitType.SEGMENT_HEADER)):
            pass
        elif header == k.ENCAPSULATION_CODE:
            bit_reader.read_byte()
            header = bit_reader.read_byte()
        else:
            return (None, 0) if with_rfe else None
    nal_rfe = (header >> 6) & 1
    nal_type = k.NalUnitType((header >> 1) & 31)
    if with_rfe:
        return nal_type, nal_rfe
    if nal_rfe == 1:
        return None
    return nal_type
