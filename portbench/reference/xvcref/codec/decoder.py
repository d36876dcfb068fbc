"""Decoder session: NAL demux, picture buffering, output reordering.

Behavioral equivalent of the reference decoder session
(ref: src/xvc_dec_lib/decoder.cc), one picture at a time on the host; it
keeps the reference's sliding-window ordering semantics.
"""
from dataclasses import dataclass, field

from .. import constants as k
from .. import segment as seg
from ..bitio import BitReader
from .picture_decoder import PictureDecoder, decode_header
from .ref_lists import ReferenceListSorter
from ..segment import DecoderState


@dataclass
class OutputPicture:
    bytes: bytes
    poc: int
    doc: int
    soc: int
    tid: int
    qp: int
    width: int
    height: int
    bitdepth: int
    chroma_format: int
    user_data: int = 0
    conforming: bool = True
    nal_unit_type: int = 0
    framerate: float = 0.0
    l0: list = field(default_factory=list)
    l1: list = field(default_factory=list)


class Decoder:
    def __init__(self, on_parsed=None):
        self.on_parsed = on_parsed
        self.curr_segment_header = seg.SegmentHeader()
        self.prev_segment_header = seg.SegmentHeader()
        self.state = DecoderState.NO_SEGMENT_HEADER
        self.soc = -1 & 0xFF
        self.doc = 0
        self.num_tail_pics = 0
        self.num_pics_in_buffer = 0
        self.pic_buffering_num = 0
        self.sliding_window_length = 0
        self.additional_decoder_buffers = 0
        self.sub_gop_start_poc = 0
        self.sub_gop_end_poc = 0
        self.sub_gop_length = 0
        self.max_tid = 0
        self.decoder_ticks = 0
        self.enforce_sliding_window = False
        self.accept_xvc_bit_zero = False
        self.nal_buffer = []  # (nal_bytes, user_data)
        self.pic_decoders = []
        self.zero_tid_pic_dec = []
        self.num_corrupted_pics = 0
        self.output_width = 0
        self.output_height = 0
        self.output_bitdepth = 0
        self.output_chroma_format = k.ChromaFormat.UNDEFINED
        self.output_color_matrix = k.ColorMatrix.UNDEFINED
        self.dither = False

    # Corrupt payloads must never kill the session: the reference
    # decoder returns error codes / flags conformance instead of
    # aborting (ref: decoder.cc:480-495, test/xvc_test/
    # decoder_api_test.cc).  Any parse-level exception from garbage
    # input is contained here.
    _PARSE_ERRORS = (ValueError, KeyError, IndexError, OverflowError,
                     ZeroDivisionError, RuntimeError, MemoryError)

    # ---- public API ----
    def decode_nal(self, nal, user_data=0):
        try:
            bit_reader = BitReader(nal)
            nal_type, rfe = seg.parse_nal_unit_header(
                bit_reader, self.accept_xvc_bit_zero, with_rfe=True)
            if nal_type is None:
                return False
            if rfe:
                # rfe NALs are ignored unless they belong to the
                # xvc_tpu tile extension: an ext segment header (probed
                # by its EXT_MINOR_BIT) or a picture of an active tile
                # segment.  Everything else keeps the reference's
                # drop-silently behavior (ref: decoder.cc:84-113).
                if nal_type == k.NalUnitType.SEGMENT_HEADER:
                    return self._decode_segment_header_nal(bit_reader,
                                                           ext=True)
                if self.curr_segment_header.tile_rows < 2:
                    return False
            if nal_type == k.NalUnitType.SEGMENT_HEADER:
                return self._decode_segment_header_nal(bit_reader)
            if self.state in (DecoderState.NO_SEGMENT_HEADER,
                              DecoderState.DECODER_VERSION_TOO_LOW,
                              DecoderState.BITSTREAM_BITDEPTH_TOO_HIGH,
                              DecoderState.BITSTREAM_VERSION_TOO_LOW):
                return False
            if int(nal_type) <= int(k.NalUnitType.RESERVED_PICTURE_TYPE_10):
                return self._decode_picture_nal(nal, user_data, bit_reader)
            return False
        except self._PARSE_ERRORS:
            self.num_corrupted_pics += 1
            self.state = DecoderState.CHECKSUM_MISMATCH
            return False

    def flush(self):
        """(ref: decoder.cc:332-362 FlushBufferedNalUnits)"""
        self.enforce_sliding_window = False
        self.soc = (self.soc + 1) & 0xFF
        self.prev_segment_header = self.curr_segment_header
        if self.nal_buffer:
            if self.curr_segment_header.open_gop and \
                    self.curr_segment_header.num_ref_pics > 0:
                self.num_pics_in_buffer -= len(self.nal_buffer)
                self.nal_buffer = []
            else:
                if self.curr_segment_header.num_ref_pics == 0:
                    self.soc = (self.soc - 1) & 0xFF
                elif self.sub_gop_length > 1:
                    self.doc += 1
                    self.sub_gop_start_poc = self.sub_gop_end_poc
                    self.sub_gop_end_poc += self.sub_gop_length
                for nal, ud in self.nal_buffer:
                    try:
                        self._decode_one_buffered_nal(nal, ud)
                    except self._PARSE_ERRORS:
                        self.num_corrupted_pics += 1
                self.nal_buffer = []
        self.state = DecoderState.NO_SEGMENT_HEADER

    def get_decoded_picture(self):
        """Returns OutputPicture or None (lowest un-output POC)."""
        if not self._has_picture_ready_for_output():
            return None
        best = None
        for pic in self.pic_decoders:
            if not pic.output_status_done and \
                    (best is None or pic.pic_data.poc < best.pic_data.poc):
                best = pic
        if best is None:
            return None
        best.output_status_done = True
        self.num_pics_in_buffer -= 1
        poc_offset = -1 if self.curr_segment_header.leading_pictures else 0
        return OutputPicture(
            bytes=best.output_pic_bytes,
            poc=best.pic_data.poc + poc_offset,
            doc=best.pic_data.doc + poc_offset,
            soc=best.pic_data.soc,
            tid=best.pic_data.tid,
            qp=best.pic_qp,
            width=self.output_width, height=self.output_height,
            bitdepth=self.output_bitdepth,
            chroma_format=self.output_chroma_format,
            user_data=best.user_data,
            conforming=best.is_conforming,
            nal_unit_type=int(best.pic_data.nal_type),
            l0=[best.pic_data.ref_pic_lists.get_ref_poc(0, i) + poc_offset
                for i in range(
                    best.pic_data.ref_pic_lists.get_num_ref_pics(0))]
            if not best.pic_data.is_intra_pic() else [],
            l1=[best.pic_data.ref_pic_lists.get_ref_poc(1, i) + poc_offset
                for i in range(
                    best.pic_data.ref_pic_lists.get_num_ref_pics(1))]
            if not best.pic_data.is_intra_pic() else [],
            framerate=seg.get_framerate(
                self.max_tid, self.curr_segment_header.bitstream_ticks,
                self.curr_segment_header.max_sub_gop_length)
            if self.curr_segment_header.bitstream_ticks else 0.0)

    def _has_picture_ready_for_output(self):
        """(ref: decoder.h:67-70)"""
        return (not self.enforce_sliding_window or
                self.num_pics_in_buffer >= self.sliding_window_length)

    # ---- internals ----
    def _decode_segment_header_nal(self, bit_reader, ext=False):
        if ext:
            # probe first: a non-extension rfe segment header must be
            # ignored with NO state change (reference drops rfe NALs)
            state, _, _ = seg.read_segment_header(
                BitReader(bit_reader.buf[bit_reader.get_position():]),
                0, ext_allowed=True)
            if state is None:
                return False
        if len(self.nal_buffer) > self.num_tail_pics:
            while self.nal_buffer and \
                    self.num_pics_in_buffer < self.pic_buffering_num:
                nal, ud = self.nal_buffer.pop(0)
                self._decode_one_buffered_nal(nal, ud)
            self.num_pics_in_buffer -= len(self.nal_buffer)
            self.nal_buffer = []
            self.num_tail_pics = 0
        self.prev_segment_header = self.curr_segment_header
        self.soc = (self.soc + 1) & 0xFF
        state, sh, accept = seg.read_segment_header(bit_reader, self.soc,
                                                    ext_allowed=ext)
        self.accept_xvc_bit_zero = accept
        self.state = state
        if state != DecoderState.SEGMENT_HEADER_DECODED:
            self.curr_segment_header = seg.SegmentHeader()
            return False
        self.curr_segment_header = sh
        if self.doc == 0 and sh.leading_pictures > 0:
            self.doc += 1
        self.sub_gop_length = sh.max_sub_gop_length
        if self.sub_gop_length + 1 > self.sliding_window_length:
            self.sliding_window_length = self.additional_decoder_buffers + \
                self.sub_gop_length + 1
        self.pic_buffering_num = self.sliding_window_length + sh.num_ref_pics
        if self.output_width == 0:
            self.output_width = sh.output_width
        if self.output_height == 0:
            self.output_height = sh.output_height
        if self.output_chroma_format == k.ChromaFormat.UNDEFINED:
            self.output_chroma_format = sh.chroma_format
        if self.output_color_matrix == k.ColorMatrix.UNDEFINED:
            self.output_color_matrix = sh.color_matrix
        if self.output_bitdepth == 0:
            self.output_bitdepth = sh.internal_bitdepth
        self.max_tid = seg.get_framerate_max_tid(
            self.decoder_ticks, sh.bitstream_ticks, self.sub_gop_length)
        return True

    def _decode_picture_nal(self, nal, user_data, bit_reader):
        buffer_flag = bit_reader.read_bit()
        tid = bit_reader.read_bits(3)
        new_max_tid = seg.get_framerate_max_tid(
            self.decoder_ticks, self.curr_segment_header.bitstream_ticks,
            self.curr_segment_header.max_sub_gop_length)
        if new_max_tid < self.max_tid or tid == 0:
            self.max_tid = new_max_tid
        if tid > self.max_tid:
            return True  # dropped
        self.enforce_sliding_window = True
        self.num_pics_in_buffer += 1
        if buffer_flag == 0 and self.num_tail_pics > 0:
            self.nal_buffer.insert(0, (nal, user_data))
        else:
            self.nal_buffer.append((nal, user_data))
        if self.state == DecoderState.SEGMENT_HEADER_DECODED:
            self.state = DecoderState.PIC_DECODED
        if buffer_flag:
            self.num_tail_pics += 1
            return True
        while self.nal_buffer and \
                (self.num_pics_in_buffer - len(self.nal_buffer) + 1 <
                 self.pic_buffering_num):
            nal2, ud2 = self.nal_buffer.pop(0)
            self._decode_one_buffered_nal(nal2, ud2)
        return True

    def _decode_one_buffered_nal(self, nal, user_data):
        """(ref: decoder.cc:229-330)"""
        bit_reader = BitReader(nal)
        segment_header = self.curr_segment_header
        header_byte = bit_reader.read_byte()
        xvc_bit_one = (header_byte >> 7) & 1
        if xvc_bit_one == 0 and not self.accept_xvc_bit_zero:
            bit_reader.read_bits(16)
        buffer_flag = bit_reader.read_bits(1)
        bit_reader.rewind(9)
        if buffer_flag:
            segment_header = self.prev_segment_header
            self.num_tail_pics -= 1

        state = {"sub_gop_end_poc": self.sub_gop_end_poc,
                 "sub_gop_start_poc": self.sub_gop_start_poc,
                 "sub_gop_length": self.sub_gop_length}
        pic_header = decode_header(
            segment_header, bit_reader, state,
            self.prev_segment_header.max_sub_gop_length, self.doc, self.soc,
            self.num_tail_pics, segment_header.restrictions)
        self.sub_gop_end_poc = state["sub_gop_end_poc"]
        self.sub_gop_start_poc = state["sub_gop_start_poc"]
        self.sub_gop_length = state["sub_gop_length"]
        self.doc = pic_header.doc + 1

        is_intra_nal = pic_header.nal_unit_type in (
            k.NalUnitType.INTRA_PICTURE, k.NalUnitType.INTRA_ACCESS_PICTURE)
        from .cu import ReferencePictureLists
        sorter = ReferenceListSorter(segment_header,
                                     self.prev_segment_header.open_gop)
        rpl = ReferencePictureLists()
        deps = sorter.prepare(pic_header.poc, pic_header.tid, is_intra_nal,
                              self.pic_decoders, rpl,
                              segment_header.leading_pictures)
        for dep in deps:
            dep.ref_count += 1
        pic_dec = self._get_free_picture_decoder(segment_header)
        pic_dec.on_parsed = self.on_parsed
        output_fmt = {"width": self.output_width,
                      "height": self.output_height,
                      "chroma_format": self.output_chroma_format,
                      "color_matrix": self.output_color_matrix,
                      "bitdepth": self.output_bitdepth,
                      "dither": self.dither}
        pic_dec.init_pic(segment_header, pic_header, rpl, output_fmt,
                         user_data)
        if pic_header.tid == 0:
            pic_dec.ref_count += 1
            self.zero_tid_pic_dec.append(pic_dec)
            while len(self.zero_tid_pic_dec) > \
                    segment_header.num_ref_pics + 1:
                pic = self.zero_tid_pic_dec.pop(0)
                pic.ref_count -= 1
        try:
            success = pic_dec.decode(segment_header,
                                     self.prev_segment_header,
                                     bit_reader, True)
        except self._PARSE_ERRORS:
            # Corrupt/truncated payload: keep the session alive and mark
            # the picture non-conforming (ref: the C++ decoder never
            # throws; garbage parses surface as checksum mismatches,
            # decoder.cc:480-495).
            success = False
        self._on_picture_decoded(pic_dec, success, deps)

    def _get_free_picture_decoder(self, sh):
        # +1 slack, as the decoder this is copied from keeps it
        if len(self.pic_decoders) < self.pic_buffering_num + 1:
            pic = PictureDecoder(sh.chroma_format, sh.internal_width,
                                 sh.internal_height, sh.internal_bitdepth,
                                 sh.crop_width, sh.crop_height)
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
            idx = self.pic_decoders.index(best)
            best = PictureDecoder(sh.chroma_format, sh.internal_width,
                                  sh.internal_height, sh.internal_bitdepth,
                                  sh.crop_width, sh.crop_height)
            self.pic_decoders[idx] = best
        return best

    def _on_picture_decoded(self, pic_dec, success, deps):
        pic_dec.output_status_done = False
        for dep in deps:
            dep.ref_count -= 1
        self._finalize_conformance(pic_dec, success)

    def _finalize_conformance(self, pic_dec, success):
        pic_dec.is_conforming = success
        if success:
            if self.state != DecoderState.CHECKSUM_MISMATCH:
                self.state = DecoderState.PIC_DECODED
        else:
            self.state = DecoderState.CHECKSUM_MISMATCH
            self.num_corrupted_pics += 1
