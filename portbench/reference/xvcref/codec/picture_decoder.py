"""Per-picture decoding: header parse, CTU loop, deblock, checksum.

Behavioral equivalent of the reference picture decoder
(ref: src/xvc_dec_lib/picture_decoder.cc).
"""
from dataclasses import dataclass

from .. import constants as k
from .. import segment as seg
from ..ops.deblock import DeblockingFilter
from ..ops.quant import Qp
from ..syntax.reader import SyntaxReader
from . import checksum as cksum
from . import output
from .cu import PictureData, ReferencePictureLists
from .cu_decoder import CuDecoder
from .yuv import YuvPicture


@dataclass
class PicNalHeader:
    nal_unit_type: int = 0
    soc: int = 0
    poc: int = 0
    doc: int = 0
    tid: int = 0
    pic_qp: int = 0
    highest_layer: bool = False
    deblock: bool = True
    allow_lic: bool = False


def decode_header(segment_header, bit_reader, state, prev_sub_gop_length,
                  doc, soc_counter, num_buffered_nals, restrictions):
    """Reconstruct POC/DOC/TID from the picture NAL header.

    state: dict with keys sub_gop_end_poc, sub_gop_start_poc,
    sub_gop_length (mutated).  (ref: picture_decoder.cc:52-141)
    """
    header_byte = bit_reader.read_bits(8)
    nal_unit_type = k.NalUnitType((header_byte >> 1) & 31)
    buffer_flag = bit_reader.read_bits(1)
    soc = (soc_counter - 1) & 0xFF if buffer_flag else soc_counter
    tid = bit_reader.read_bits(3)
    if nal_unit_type == k.NalUnitType.INTRA_ACCESS_PICTURE and \
            segment_header.leading_pictures:
        state["sub_gop_length"] = segment_header.max_sub_gop_length
        state["sub_gop_start_poc"] += k.MAX_SUB_GOP_LENGTH if doc > 1 else 0
        state["sub_gop_end_poc"] = state["sub_gop_start_poc"]
    elif tid == 0:
        length = segment_header.max_sub_gop_length
        if num_buffered_nals:
            state["sub_gop_length"] = prev_sub_gop_length
        elif nal_unit_type == k.NalUnitType.INTRA_ACCESS_PICTURE:
            state["sub_gop_length"] = 1
        elif length > 0:
            state["sub_gop_length"] = length
        elif doc > 0:
            state["sub_gop_length"] = 1
        state["sub_gop_start_poc"] = state["sub_gop_end_poc"]
    elif segment_header.max_sub_gop_length > state["sub_gop_length"]:
        state["sub_gop_length"] = segment_header.max_sub_gop_length
    pic_qp = bit_reader.read_bits(7) - k.QP_SIGNAL_BASE
    allow_lic = False
    if not restrictions.disable_ext2_inter_local_illumination_comp:
        allow_lic = bit_reader.read_bit() != 0
    deblock = segment_header.deblocking_mode != k.DeblockingMode.DISABLED
    if segment_header.deblocking_mode == k.DeblockingMode.PER_PICTURE:
        deblock = bit_reader.read_bit() != 0
    bit_reader.skip_bits()

    if doc > state["sub_gop_end_poc"]:
        state["sub_gop_start_poc"] = state["sub_gop_end_poc"]
    while doc > state["sub_gop_start_poc"] + state["sub_gop_length"]:
        state["sub_gop_start_poc"] += state["sub_gop_length"]
    if doc > 0 and doc <= state["sub_gop_start_poc"]:
        doc = state["sub_gop_start_poc"] + 1
    # Bounded tid resync: the reference loop (picture_decoder.cc:111-118)
    # is unbounded and spins forever on a corrupt tid; valid resync
    # (dropped temporal layers / truncated sub-GOPs) converges within a
    # sub-GOP span, so cap the walk and reject the NAL beyond it.
    resync_cap = 4 * k.MAX_SUB_GOP_LENGTH + 16
    while not segment_header.low_delay and \
            seg.calc_tid_from_doc(doc, state["sub_gop_length"],
                                  state["sub_gop_start_poc"]) != tid:
        doc += 1
        if doc > state["sub_gop_end_poc"]:
            state["sub_gop_start_poc"] = state["sub_gop_end_poc"]
        resync_cap -= 1
        if resync_cap <= 0:
            raise ValueError("unresolvable tid in picture header")
    if tid == 0:
        state["sub_gop_end_poc"] = seg.calc_poc_from_doc(
            doc, state["sub_gop_length"], state["sub_gop_start_poc"])
    poc = seg.calc_poc_from_doc(doc, state["sub_gop_length"],
                                state["sub_gop_start_poc"])
    if segment_header.low_delay:
        poc = doc
    return PicNalHeader(
        nal_unit_type=nal_unit_type, soc=soc, poc=poc, doc=doc, tid=tid,
        pic_qp=pic_qp,
        highest_layer=(tid == seg.get_max_tid(state["sub_gop_length"])),
        deblock=deblock, allow_lic=allow_lic)


class PictureDecoder:
    """Holds reconstruction state for one picture; recycled via the pool."""

    def __init__(self, pic_format_chroma, width, height, bitdepth,
                 crop_width=0, crop_height=0):
        self.pic_data = PictureData(pic_format_chroma, width, height,
                                    bitdepth)
        self.rec_pic = YuvPicture(pic_format_chroma, width, height, bitdepth,
                                  True, crop_width, crop_height)
        self.alt_rec_pic = None
        self.output_status_done = True  # has been output
        self.ref_count = 0
        self.pic_qp = 0
        self.output_format = None
        self.user_data = 0
        self.is_conforming = True
        self.output_pic_bytes = b""
        self.pic_hash = b""
        # called after a picture's parse and reconstruction, before its
        # deblocking: the benchmark counts the kernels' work from the tree
        self.on_parsed = None

    def get_alternative_rec_pic(self, segment_header):
        """Allocate (but do not fill) the cross-segment alternative
        reconstruction; content is produced by the picture's own decode
        via generate_alternative_rec_pic, exactly like the reference so
        reference-list preparation stays thread-safe
        (ref: picture_decoder.cc:226-241)."""
        if self.alt_rec_pic is not None:
            return self.alt_rec_pic
        sh = segment_header
        self.alt_rec_pic = YuvPicture(sh.chroma_format, sh.internal_width,
                                      sh.internal_height,
                                      sh.internal_bitdepth, True,
                                      sh.crop_width, sh.crop_height)
        return self.alt_rec_pic

    def generate_alternative_rec_pic(self, segment_header):
        """Fill the alternative reconstruction by rescaling rec_pic
        (ref: picture_decoder.cc:242-293)."""
        from ..ops import resample
        alt = self.get_alternative_rec_pic(segment_header)
        for c in range(k.num_components(segment_header.chroma_format)):
            if (self.rec_pic.chroma_format == k.ChromaFormat.MONOCHROME
                    and c != 0):
                alt.plane_view(c)[:] = 1 << (alt.bitdepth - 1)
                continue
            resample.resample_pic_plane(alt, c, self.rec_pic)
        alt.pad_border()
        return alt

    def init_pic(self, segment, header, ref_pic_list, output_pic_format,
                 user_data):
        self.pic_qp = header.pic_qp
        self.output_format = output_pic_format
        self.user_data = user_data
        self.output_status_done = False
        self.ref_count = 0
        self.alt_rec_pic = None
        self.rec_pic._dev_planes = None  # invalidate device ref cache
        self.rec_pic._dev_pre_deblock = None
        self.rec_pic.invalidate_shadow16()  # buffer recycled
        pd = self.pic_data
        pd.nal_type = header.nal_unit_type
        pd.soc = header.soc
        pd.poc = header.poc
        pd.doc = header.doc
        pd.tid = header.tid
        pd.sub_gop_length = segment.max_sub_gop_length
        pd.highest_layer = header.highest_layer and not segment.low_delay
        pd.adaptive_qp = segment.adaptive_qp
        pd.deblock = header.deblock
        pd.beta_offset = segment.beta_offset
        pd.tc_offset = segment.tc_offset
        pd.lic_active = header.allow_lic
        pd.ref_pic_lists = ref_pic_list

    def decode(self, segment, prev_segment, bit_reader, post_process=True):
        """Decode one picture on the host: the CABAC parse and the
        reconstruction CTU by CTU, then deblocking, border padding and
        the checksum (ref: picture_decoder.cc:143-240)."""
        pd = self.pic_data
        restr = segment.restrictions
        qp = Qp(self.pic_qp, pd.chroma_format, pd.bitdepth, 0.0,
                segment.chroma_qp_offset_table, segment.chroma_qp_offset_u,
                segment.chroma_qp_offset_v)
        if getattr(segment, "tile_rows", 1) >= 2:
            return self._decode_tiles(segment, prev_segment, bit_reader,
                                      qp, post_process)
        pd.init(segment, qp, True)
        pd.mv_resolved = False
        pd._parse_records = None
        cu_decoder = CuDecoder(self.rec_pic, pd, restr)
        reader = SyntaxReader(qp, pd.get_prediction_type(), bit_reader,
                              restr)
        for rsaddr in range(pd.get_number_of_ctus()):
            cu_decoder.decode_ctu(rsaddr, reader, reconstruct=True)
        if self.on_parsed is not None:
            self.on_parsed(self)
        if pd.deblock:
            DeblockingFilter(pd, self.rec_pic, pd.beta_offset,
                             pd.tc_offset, restr).deblock_picture()
        success = reader.finish()
        return self._finish(segment, prev_segment, bit_reader,
                            post_process) and success

    def _decode_tiles(self, segment, prev_segment, bit_reader, qp,
                      post_process):
        """Tile-extension picture decode: R CTU-row tiles, each parsed
        from its own size-prefixed CABAC substream with pd.tile_ctx_top_y
        masking neighbor/intra availability above the tile, then one
        whole-picture deblock pass across tile edges."""
        from ..bitio import BitReader
        pd = self.pic_data
        restr = segment.restrictions
        pd.init(segment, qp, True)
        pd.mv_resolved = False
        pd._parse_records = None
        tiles = pd.set_tiles(segment.tile_rows)
        sizes = [bit_reader.read_bits(32) for _ in tiles]
        success = True
        cu_decoder = CuDecoder(self.rec_pic, pd, restr)
        for (row0, row1), size in zip(tiles, sizes):
            payload = bit_reader.read_bytes(size)
            reader = SyntaxReader(qp, pd.get_prediction_type(),
                                  BitReader(payload), restr)
            pd.tile_ctx_top_y = row0 * k.CTU_SIZE
            for row in range(row0, row1):
                for cx in range(pd.ctu_num_x):
                    cu_decoder.decode_ctu(row * pd.ctu_num_x + cx, reader,
                                          reconstruct=True)
            if not reader.finish():
                success = False
        pd.tile_ctx_top_y = 0
        if self.on_parsed is not None:
            self.on_parsed(self)
        if pd.deblock:
            DeblockingFilter(pd, self.rec_pic, pd.beta_offset,
                             pd.tc_offset, restr).deblock_picture()
        return self._finish(segment, prev_segment, bit_reader,
                            post_process) and success

    def _finish(self, segment, prev_segment, bit_reader, post_process):
        pd = self.pic_data
        pad_needed = pd.tid == 0 or not pd.highest_layer
        alt_needed = (pd.nal_type == k.NalUnitType.INTRA_ACCESS_PICTURE
                      and prev_segment.open_gop)
        if pad_needed:
            self.rec_pic.pad_border()
        if alt_needed:
            self._generate_alternative_rec_pic(segment, prev_segment)
        pd.ref_pic_lists.zero_out_references()
        if post_process:
            return self.postprocess(segment, bit_reader)
        return True

    def _generate_alternative_rec_pic(self, segment, prev_segment):
        ps = prev_segment
        if (ps.chroma_format == k.ChromaFormat.UNDEFINED or
                ps.internal_width <= 0 or ps.internal_height <= 0 or
                (ps.chroma_format == segment.chroma_format and
                 ps.internal_width == segment.internal_width and
                 ps.internal_height == segment.internal_height and
                 ps.internal_bitdepth == segment.internal_bitdepth)):
            return
        self.generate_alternative_rec_pic(prev_segment)

    def postprocess(self, segment, bit_reader):
        success = True
        if self.pic_data.tid == 0 or \
                segment.checksum_mode == k.ChecksumMode.MAX_ROBUST:
            success = self._validate_checksum(segment, bit_reader)
        else:
            self.pic_hash = b""
        out_fmt = dict(self.output_format)
        if not out_fmt.get("width"):
            out_fmt["width"] = self.rec_pic.get_display_width(0)
        if not out_fmt.get("height"):
            out_fmt["height"] = self.rec_pic.get_display_height(0)
        if out_fmt.get("chroma_format",
                       k.ChromaFormat.UNDEFINED) == k.ChromaFormat.UNDEFINED:
            out_fmt["chroma_format"] = self.rec_pic.chroma_format
        if not out_fmt.get("bitdepth"):
            out_fmt["bitdepth"] = self.rec_pic.bitdepth
        self.output_pic_bytes = output.convert_to(self.rec_pic, out_fmt)
        return success

    def _validate_checksum(self, segment, bit_reader):
        restr = segment.restrictions
        method = k.ChecksumMethod.CRC if \
            restr.disable_high_level_default_checksum_method else \
            k.ChecksumMethod.MD5
        self.pic_hash = cksum.hash_picture(self.rec_pic, method,
                                           segment.checksum_mode)
        if segment.major_version <= 1:
            bit_reader.read_byte()
        expected = bit_reader.read_bytes(len(self.pic_hash))
        return expected == self.pic_hash
