"""Per-picture decoding on a torch device: header parse, CABAC parse,
device reconstruction, device deblock, checksum and output.

Behavioral equivalent of the reference picture decoder
(ref: src/xvc_dec_lib/picture_decoder.cc).  Header handling, checksum
and output are copies of ``xvc_tpu/codec/picture_decoder.py``;
``decode`` dispatches as that module's ``_decode_impl`` does between its
parses and device paths: native parse -> ``FlatReconstructor`` when
``flat_recon.eligible`` allows it, else native parse with the CU-tree
replay -> ``recon.Reconstructor`` (LIC, 4:2:2 / 4:4:4, restricted intra
toolsets).  A picture above 14 bit, or any picture under
``XVC_PIC_NATIVE=0``, takes the Python parse (``CuDecoder.decode_ctu``
over ``SyntaxReader``; ``gpu/tree_records.py`` makes its record table)
and then the replay path, never the flat one.  Then device deblock.  A
picture of a segment with two or more CTU tile rows takes the same
paths: the native parse, or the Python parse's ``_parse_tiles`` (the
JAX package's ``_decode_tiles``), reads its per-tile substreams with
every lookup cut at the tile's top, the reconstruction applies the same
cut to intra availability, and deblocking stays one whole-picture pass.
A picture above 15 bit raises ``NotImplementedError``: its samples do
not fit the int16 device surfaces.  With a mesh installed
(``engine.set_mesh``) and no pin, ``decode`` pins the picture to one of
the mesh's slots (``xvc_tpu/codec/picture_decoder.py:184-236``): its
device stages run on the slot's device and stream and its
reconstruction is stored in the slot's frame store, from which pictures
pinned elsewhere move it once.  A segment header that cannot
describe a picture (damaged: chroma format UNDEFINED, a zero dimension)
is no such reason: its pictures decode as non-conforming, as in the
reference.
"""
import threading
import time
from dataclasses import dataclass

from .. import constants as k
from .. import segment as seg
from ..bitio import BitReader
from ..engine import (get_pin_device, mesh_for, set_pin_device,
                      use_native_pic_decode)
from ..gpu import flat_recon
from ..gpu import recon
from ..gpu import tree_records
from ..gpu.deblock import deblock_picture
from ..native import pic as native_pic
from ..ops import resample
from ..ops.deblock import DeblockingFilter
from ..ops.quant import Qp
from ..parallel.mesh import placed
from .. import profiling
from ..profiling import span
from . import checksum as cksum
from . import output
from ..syntax.reader import SyntaxReader
from .cu import PictureData
from .cu_decoder import CuDecoder
from .yuv import YuvPicture


_PICTURE_FORMATS = (k.ChromaFormat.MONOCHROME, k.ChromaFormat.YUV420,
                    k.ChromaFormat.YUV422, k.ChromaFormat.YUV444)


def describes_picture(segment):
    """False for a segment header that cannot describe a picture (a
    damaged one: chroma format UNDEFINED or a zero dimension)."""
    return (segment.chroma_format in _PICTURE_FORMATS and
            segment.internal_width > 0 and segment.internal_height > 0)


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
                 crop_width=0, crop_height=0, *, device):
        self.device = device
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
        # when ``decode`` last returned, where the span table was enabled
        # (the session's output wait starts there)
        self.decoded_at = None
        # the decode of a threaded session (parallel/pipeline.py), and the
        # set when the reconstruction is final (its dependents wait on it)
        self.pending_job = None
        # set by the decode pipeline: its pictures overlap, so the mesh
        # pin rotates over the slots
        self._pipelined = False
        self.recon_done = threading.Event()
        self.recon_done.set()
        # the session's thread (reference lists) and this picture's worker
        # (its own decode) both ask for the alternative reconstruction
        self._alt_lock = threading.Lock()

    def get_alternative_rec_pic(self, segment_header):
        """Allocate (but do not fill) the cross-segment alternative
        reconstruction; content is produced by the picture's own decode
        via generate_alternative_rec_pic, exactly like the reference so
        reference-list preparation stays thread-safe
        (ref: picture_decoder.cc:226-241)."""
        with self._alt_lock:
            if self.alt_rec_pic is None:
                sh = segment_header
                self.alt_rec_pic = YuvPicture(
                    sh.chroma_format, sh.internal_width, sh.internal_height,
                    sh.internal_bitdepth, True, sh.crop_width,
                    sh.crop_height)
            return self.alt_rec_pic

    def generate_alternative_rec_pic(self, segment_header,
                                     border_padded=False, device=None):
        """Fill the alternative reconstruction by rescaling rec_pic on the
        picture's device (``device``, default the session's; ref:
        picture_decoder.cc:242-293): one call that writes a frame-store
        slot of the alternative picture, where its dependents find it
        (``flat_recon.ensure_slot`` uploads nothing), and fills its padded
        host planes with one download.  ``border_padded``: rec_pic's host
        border was padded."""
        alt = self.get_alternative_rec_pic(segment_header)
        resample.resample_pic(alt, self.rec_pic, device or self.device,
                              border_padded)
        return alt

    def init_pic(self, segment, header, ref_pic_list, output_pic_format,
                 user_data):
        self.pic_qp = header.pic_qp
        self.output_format = output_pic_format
        self.user_data = user_data
        self.output_status_done = False
        self.ref_count = 0
        self.alt_rec_pic = None
        flat_recon.release_slot(self.rec_pic)  # buffer recycled
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

    def decode(self, segment, prev_segment, bit_reader, on_recon=None):
        """Decode one picture on ``self.device``; returns conformance
        success.  ``on_recon`` is called once the reconstruction is final
        (stored, padded, its alternative made), before the checksum and
        the output conversion.

        With a mesh installed and no pin, the picture is pinned to a slot:
        the first of this process's slots in a sequential session, whose
        pictures chain through their references (spreading them would
        only add moves), and slot ``(doc // 2) % n`` under the decode
        pipeline, whose pictures overlap (pairs share a slot: adjacent
        pictures usually reference each other).  The moves of the
        references decoded on other slots start before the parse.
        Placement changes no integer result: pinned and unmeshed decodes
        give the same bytes.  Where the span table is enabled, the return
        is stamped in ``decoded_at``."""
        try:
            return self._decode_placed(segment, prev_segment, bit_reader,
                                       on_recon)
        finally:
            self.decoded_at = time.perf_counter() \
                if profiling.enabled() else None

    def _decode_placed(self, segment, prev_segment, bit_reader, on_recon):
        mesh = mesh_for(self.device)
        if mesh is None or get_pin_device() is not None:
            return self._decode(segment, prev_segment, bit_reader, on_recon,
                                self.device)
        slots = mesh.local_slots
        pin = slots[(self.pic_data.doc // 2) % len(slots)] \
            if self._pipelined else slots[0]
        set_pin_device(pin)
        try:
            with placed(pin):
                self._prefetch_ref_slots(pin.device)
                return self._decode(segment, prev_segment, bit_reader,
                                    on_recon, pin.device)
        finally:
            set_pin_device(None)

    def _prefetch_ref_slots(self, device):
        """Move the reference planes stored on other slots into this
        slot's store now, before the parse, instead of at the first MC
        dispatch (``flat_recon.ensure_slot`` would make them there)."""
        rpl = self.pic_data.ref_pic_lists
        for lst in range(2):
            for i in range(rpl.get_num_ref_pics(lst)):
                rec = rpl.entries[lst][i].rec_pic
                if rec is not None and getattr(rec, "_torch_slots", None):
                    flat_recon.ensure_slot(rec, device)

    def _decode(self, segment, prev_segment, bit_reader, on_recon, device):
        pd = self.pic_data
        restr = segment.restrictions
        if not describes_picture(segment):
            # damaged segment header: nothing to reconstruct, the picture
            # is corrupt (the reference's parse fails the same way)
            self.output_pic_bytes = b""
            return False
        if pd.bitdepth > 15:
            # 16-bit samples do not fit the int16 device surfaces
            raise NotImplementedError(
                "bitdepth %d > 15 is not on the device paths (ROADMAP "
                "queue 1 item 6)" % pd.bitdepth)
        python_parse = pd.bitdepth > 14 or not use_native_pic_decode()
        # the flat path decodes a picture whole: under a mesh it takes a
        # pinned picture, and the replay path shards an unpinned one
        flat = not python_parse and flat_recon.eligible(pd, restr) and \
            (mesh_for(device) is None or get_pin_device() is not None)
        qp = Qp(self.pic_qp, pd.chroma_format, pd.bitdepth, 0.0,
                segment.chroma_qp_offset_table, segment.chroma_qp_offset_u,
                segment.chroma_qp_offset_v)
        pd._parse_records = None
        with span("decode.parse"):
            if python_parse:
                pd.init(segment, tree=True, pic_qp=qp,
                        recalculate_lambda=True, encoder=True)
                success = self._python_parse(segment, bit_reader, qp)
            else:
                pd.init(segment, tree=not flat)
                success = native_pic.parse_picture(
                    self, segment, bit_reader, qp, replay=not flat)
        if flat:
            with span("decode.flat"):
                planes = flat_recon.FlatReconstructor(self, segment,
                                                      device).run()
        else:
            with span("decode.recon"):
                planes = recon.Reconstructor(self, segment, device).run()
        if pd.deblock:
            with span("decode.deblock"):
                filt = DeblockingFilter(pd, self.rec_pic, pd.beta_offset,
                                        pd.tc_offset, restr)
                deblock_picture(filt, planes, device)
                flat_recon.store_and_download(self.rec_pic, planes,
                                              device, "deblock")
        pad_needed = pd.tid == 0 or not pd.highest_layer
        alt_needed = (pd.nal_type == k.NalUnitType.INTRA_ACCESS_PICTURE and
                      prev_segment.open_gop)
        # the port's post step is host Python (border pad, checksum,
        # output conversion), so its span is not the reference's
        # decode.native.post
        with span("decode.post"):
            if pad_needed:
                self.rec_pic.pad_border()
            if alt_needed:
                self._generate_alternative_rec_pic(segment, prev_segment,
                                                   pad_needed, device)
            pd.ref_pic_lists.zero_out_references()
            if on_recon is not None:
                on_recon()
            success = self.postprocess(segment, bit_reader, pad_needed,
                                       device) and success
        return success

    def _python_parse(self, segment, bit_reader, qp):
        """Parse the picture with the Python parse, then build its record
        table and coefficient arena (``pd._parse_records``,
        ``pd._parse_coeff``) from the CU tree.  Returns conformance
        success (the terminating bin of every substream)."""
        pd = self.pic_data
        restr = segment.restrictions
        cu_decoder = CuDecoder(self.rec_pic, pd, restr)
        if pd.tile_rows >= 2:
            success = self._parse_tiles(cu_decoder, bit_reader, qp, restr)
        else:
            reader = SyntaxReader(qp, pd.get_prediction_type(), bit_reader,
                                  restr)
            for rsaddr in range(pd.get_number_of_ctus()):
                cu_decoder.decode_ctu(rsaddr, reader)
            success = reader.finish()
        pd._parse_records, pd._parse_coeff = tree_records.build(cu_decoder)
        return success

    def _parse_tiles(self, cu_decoder, bit_reader, qp, restr):
        """The CTU-tile-row extension on the Python parse (the parse half
        of the JAX package's ``_decode_tiles``): one 32-bit size a tile
        (the split of ``PictureData.set_tiles``), then each tile's
        payload with its own reader and fresh contexts, every lookup
        above the tile's top unavailable."""
        pd = self.pic_data
        tiles = pd.set_tiles(pd.tile_rows)
        sizes = [bit_reader.read_bits(32) for _ in tiles]
        success = True
        for (row0, row1), size in zip(tiles, sizes):
            reader = SyntaxReader(qp, pd.get_prediction_type(),
                                  BitReader(bit_reader.read_bytes(size)),
                                  restr)
            pd.tile_ctx_top_y = row0 * k.CTU_SIZE
            for rsaddr in range(row0 * pd.ctu_num_x, row1 * pd.ctu_num_x):
                cu_decoder.decode_ctu(rsaddr, reader)
            if not reader.finish():
                success = False
        pd.tile_ctx_top_y = 0
        return success

    def _resolved_output_format(self):
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
        return out_fmt

    def _generate_alternative_rec_pic(self, segment, prev_segment,
                                      border_padded, device):
        ps = prev_segment
        if (ps.chroma_format == k.ChromaFormat.UNDEFINED or
                ps.internal_width <= 0 or ps.internal_height <= 0 or
                (ps.chroma_format == segment.chroma_format and
                 ps.internal_width == segment.internal_width and
                 ps.internal_height == segment.internal_height and
                 ps.internal_bitdepth == segment.internal_bitdepth)):
            return
        self.generate_alternative_rec_pic(prev_segment, border_padded,
                                          device)

    def postprocess(self, segment, bit_reader, border_padded=False,
                    device=None):
        success = True
        if self.pic_data.tid == 0 or \
                segment.checksum_mode == k.ChecksumMode.MAX_ROBUST:
            success = self._validate_checksum(segment, bit_reader)
        else:
            self.pic_hash = b""
        self.output_pic_bytes = output.convert_to(
            self.rec_pic, self._resolved_output_format(),
            device or self.device, border_padded)
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
