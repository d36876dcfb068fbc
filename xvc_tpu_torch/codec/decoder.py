"""Decoder session on a torch device: NAL demux, picture buffering,
output reordering.

Behavioral equivalent of the reference decoder session
(ref: src/xvc_dec_lib/decoder.cc), keeping its sliding-window ordering
semantics.  Copy of ``xvc_tpu/codec/decoder.py`` whose picture decoders
are this package's (``codec/picture_decoder.py``) on the session's
device, with its picture-level threads (``num_threads > 0``:
``parallel/pipeline.py``, all workers on the session's one device).  Not
here: the deferred checksum of the native host decode and the lazy
non-blocking pull, so every pull is a blocking pull and never drops a
picture.  The session's own work (headers, reference lists, picture
decoders, the output picture) is span ``decode.session``, in ranges that
never hold a ``PictureDecoder.decode``.
"""
from dataclasses import dataclass, field

from .. import constants as k
from .. import segment as seg
from ..bitio import BitReader
from ..engine import resolve_device
from ..nal import split_nal_units
from ..parallel import pipeline
from ..profiling import span
from ..segment import DecoderState
from .cu import ReferencePictureLists
from .picture_decoder import PictureDecoder, decode_header, \
    describes_picture
from .ref_lists import ReferenceListSorter


class DamagedHeaderError(ValueError):
    """The pictures after a segment header that cannot describe a picture
    left no free picture decoder: a parse error of a corrupt stream."""


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
    # the perf_counter reading when the picture's decode returned, where
    # the span table was enabled then (profiling: session.output_wait)
    decoded_at: float = field(default=None, repr=False, compare=False)


class Decoder:
    def __init__(self, device=None, num_threads=0):
        self.device = resolve_device(device)
        # a clamped pool of 1 worker cannot overlap anything: such a
        # session decodes sequentially (identical output by construction)
        self.pipeline = (pipeline.DecodePipeline(num_threads,
                                                 self._PARSE_ERRORS)
                         if num_threads > 0 and
                         pipeline._pool_size(num_threads) > 1 else None)
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

    # Parse errors of a corrupt stream must never kill the session: the
    # reference decoder returns error codes / flags conformance instead
    # of aborting (ref: decoder.cc:480-495).  RuntimeError
    # (NotImplementedError, CUDA and kernel faults) and MemoryError are
    # not parse errors here: they propagate.  A segment header that cannot
    # describe a picture is one (its pictures are non-conforming, and
    # running out of picture decoders after it raises DamagedHeaderError).
    _PARSE_ERRORS = (ValueError, KeyError, IndexError, OverflowError,
                     ZeroDivisionError)

    # ---- public API ----
    def decode_nal(self, nal, user_data=0):
        try:
            with span("decode.session"):
                bit_reader = BitReader(nal)
                kind = self._nal_kind(bit_reader)
                if kind == "picture" and \
                        not self._buffer_picture_nal(nal, user_data,
                                                     bit_reader):
                    return True
            if kind == "picture":
                self._decode_due_pictures()
                return True
            if kind in ("segment", "ext_segment"):
                return self._decode_segment_header_nal(
                    bit_reader, ext=kind == "ext_segment")
            return False
        except self._PARSE_ERRORS:
            self.num_corrupted_pics += 1
            self.state = DecoderState.CHECKSUM_MISMATCH
            return False

    def _nal_kind(self, bit_reader):
        """What the NAL after its header is to this session: "segment",
        "ext_segment", "picture", or None (ignored)."""
        nal_type, rfe = seg.parse_nal_unit_header(
            bit_reader, self.accept_xvc_bit_zero, with_rfe=True)
        if nal_type is None:
            return None
        if rfe:
            # rfe NALs are ignored unless they belong to the
            # xvc_tpu tile extension: an ext segment header (probed
            # by its EXT_MINOR_BIT) or a picture of an active tile
            # segment.  Everything else keeps the reference's
            # drop-silently behavior (ref: decoder.cc:84-113).
            if nal_type == k.NalUnitType.SEGMENT_HEADER:
                return "ext_segment"
            if self.curr_segment_header.tile_rows < 2:
                return None
        if nal_type == k.NalUnitType.SEGMENT_HEADER:
            return "segment"
        if self.state in (DecoderState.NO_SEGMENT_HEADER,
                          DecoderState.DECODER_VERSION_TOO_LOW,
                          DecoderState.BITSTREAM_BITDEPTH_TOO_HIGH,
                          DecoderState.BITSTREAM_VERSION_TOO_LOW):
            return None
        if int(nal_type) <= int(k.NalUnitType.RESERVED_PICTURE_TYPE_10):
            return "picture"
        return None

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
        self._wait_for_picture(best)
        with span("decode.session"):
            return self._output_picture(best)

    def _output_picture(self, best):
        """The OutputPicture of the decoded ``best``, now handed out."""
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
            if self.curr_segment_header.bitstream_ticks else 0.0,
            decoded_at=best.decoded_at)

    def _wait_for_picture(self, pic_dec):
        """Harvest a threaded picture decode (ref: thread_decoder.cc
        WaitAll / decoder.cc:364-433); a worker's error other than a
        parse error is raised here."""
        job = pic_dec.pending_job
        if job is not None:
            pic_dec.pending_job = None
            success = job.future.result(timeout=pipeline.WAIT_SECONDS)
            self._on_picture_decoded(pic_dec, success, job.deps)

    def _has_picture_ready_for_output(self):
        """(ref: decoder.h:67-70)"""
        return (not self.enforce_sliding_window or
                self.num_pics_in_buffer >= self.sliding_window_length)

    # ---- internals ----
    def _decode_segment_header_nal(self, bit_reader, ext=False):
        if ext:
            # probe first: a non-extension rfe segment header must be
            # ignored with NO state change (reference drops rfe NALs)
            with span("decode.session"):
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
        with span("decode.session"):
            return self._read_segment_header(bit_reader, ext)

    def _read_segment_header(self, bit_reader, ext):
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

    def _buffer_picture_nal(self, nal, user_data, bit_reader):
        """Take a picture NAL into the NAL buffer; False where no picture
        is due for decoding now (one dropped, or a tail picture kept)."""
        buffer_flag = bit_reader.read_bit()
        tid = bit_reader.read_bits(3)
        new_max_tid = seg.get_framerate_max_tid(
            self.decoder_ticks, self.curr_segment_header.bitstream_ticks,
            self.curr_segment_header.max_sub_gop_length)
        if new_max_tid < self.max_tid or tid == 0:
            self.max_tid = new_max_tid
        if tid > self.max_tid:
            return False  # dropped
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
            return False
        return True

    def _decode_due_pictures(self):
        while self.nal_buffer and \
                (self.num_pics_in_buffer - len(self.nal_buffer) + 1 <
                 self.pic_buffering_num):
            nal2, ud2 = self.nal_buffer.pop(0)
            self._decode_one_buffered_nal(nal2, ud2)

    def _decode_one_buffered_nal(self, nal, user_data):
        """(ref: decoder.cc:229-330)"""
        with span("decode.session"):
            pic_dec, deps, segment_header, bit_reader = \
                self._prepare_picture(nal, user_data)
        if self.pipeline is not None:
            pic_dec.pending_job = self.pipeline.submit(
                pic_dec, deps, segment_header, self.prev_segment_header,
                bit_reader)
            return
        try:
            success = pic_dec.decode(segment_header,
                                     self.prev_segment_header, bit_reader)
        except self._PARSE_ERRORS:
            # Corrupt/truncated payload: keep the session alive and mark
            # the picture non-conforming (ref: the C++ decoder never
            # throws; garbage parses surface as checksum mismatches,
            # decoder.cc:480-495).
            success = False
        self._on_picture_decoded(pic_dec, success, deps)

    def _prepare_picture(self, nal, user_data):
        """The picture header, the reference lists and a free picture
        decoder, initialised: (picture decoder, the pictures it depends
        on, its segment header, the reader at its payload)."""
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
        sorter = ReferenceListSorter(segment_header,
                                     self.prev_segment_header.open_gop)
        rpl = ReferencePictureLists()
        deps = sorter.prepare(pic_header.poc, pic_header.tid, is_intra_nal,
                              self.pic_decoders, rpl,
                              segment_header.leading_pictures)
        for dep in deps:
            dep.ref_count += 1
        pic_dec = self._get_free_picture_decoder(segment_header)
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
        return pic_dec, deps, segment_header, bit_reader

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
            if not describes_picture(sh):
                raise DamagedHeaderError("no free picture decoder after a "
                                         "damaged segment header")
            raise RuntimeError("no free picture decoder")
        if (sh.internal_width != best.pic_data.width or
                sh.internal_height != best.pic_data.height or
                sh.chroma_format != best.pic_data.chroma_format or
                sh.internal_bitdepth != best.pic_data.bitdepth):
            self.pic_decoders[self.pic_decoders.index(best)] = best = new()
        return best

    def _on_picture_decoded(self, pic_dec, success, deps):
        pic_dec.output_status_done = False
        for dep in deps:
            dep.ref_count -= 1
        pic_dec.is_conforming = success
        if success:
            if self.state != DecoderState.CHECKSUM_MISMATCH:
                self.state = DecoderState.PIC_DECODED
        else:
            self.state = DecoderState.CHECKSUM_MISMATCH
            self.num_corrupted_pics += 1

def decode_stream(data, max_pics=None, device=None, num_threads=0):
    """Decode a length-prefixed stream on ``device`` (the card when
    None), with ``num_threads`` picture workers; return the output
    pictures."""
    dec = Decoder(device, num_threads)
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
