"""Per-picture encoding: QP/lambda derivation, device stages, the CTU
search, deblocking, checksum, PSNR.

Behavioral equivalent of the reference picture encoder
(ref: src/xvc_enc_lib/picture_encoder.cc).  Copy of
``xvc_tpu/codec/picture_encoder.py``: the device stages
(the transform-RD prepass, ``gpu/txrd_prepass.py``, and the split DP,
``gpu/lookahead.py`` + ``gpu/wavefront_rdo.py``) run on the encoder's
torch device.  The picture is then coded by the native encoder
(``native/enc.py``), which takes their maps, or, where the JAX package
takes its Python CU encoder (``native/enc.usable_for``), by the port's
(``cu_encoder.py``): with the whole-picture intra lookahead
(``tpu_intra_lookahead``, ``gpu/lookahead.py``), the per-CU SATD
pre-pass and, on inter pictures, the motion search's fullpel SAD sweeps
(``XVC_ME=jax``, ``gpu/me.py``) on the device, and the picture's
deblocking on the device (``gpu/deblock.py``, built from the CU tree).
The Python CU encoder also codes the CTU-tile-row extension
(``tile_rows >= 2``): each tile row with its own CABAC engine and
contexts, prediction cut at its top, its size before the payloads.
"""
import math
import threading

import numpy as np

from .. import constants as k
from .. import segment as seg
from ..bitio import BitWriter
from ..gpu import dsp
from ..gpu.deblock import deblock_picture
from ..gpu.flat_recon import _intra_restrictions_default
from ..native import enc as native_enc
from ..ops import metrics as met
from ..ops.deblock import DeblockingFilter
from ..ops.quant import Qp
from ..profiling import add_span_time, span
from ..syntax.writer import SyntaxWriter
from . import checksum as cksum
from .cu import PictureData
from .cu_encoder import CuEncoder
from .yuv import YuvPicture


class PictureEncoder:
    def __init__(self, chroma_format, width, height, bitdepth,
                 crop_width=0, crop_height=0, device=None):
        self.device = device
        self.orig_pic = YuvPicture(chroma_format, width, height, bitdepth,
                                   False, crop_width, crop_height)
        self.pic_data = PictureData(chroma_format, width, height, bitdepth)
        self.rec_pic = YuvPicture(chroma_format, width, height, bitdepth,
                                  True, 0, 0)
        self.output_status = "has_been_output"
        self.buffer_flag = False
        self.ref_count = 0
        self.user_data = 0
        self.pic_hash = b""
        self.rec_sse = 0
        self.rec_psnr = [0.0, 0.0, 0.0]
        # the encode of a threaded session (parallel/pipeline.py): set when
        # the reconstruction is final (its dependents wait on it), and the
        # exception that ended it
        self.recon_done = threading.Event()
        self.recon_done.set()
        self.encode_error = None

    # interface used by ReferenceListSorter
    def get_alternative_rec_pic(self, segment_header):
        raise NotImplementedError

    def init_pic(self, segment, doc, poc, tid, is_access_picture,
                 restrictions):
        """(ref: picture_encoder.cc:56-93)"""
        max_tid = seg.get_max_tid(segment.max_sub_gop_length)
        self.output_status = "ready"
        self.buffer_flag = False
        self.rec_pic.invalidate_shadow16()  # buffer recycled
        self.rec_pic.drop_device_luma()
        pd = self.pic_data
        pd.doc = doc
        pd.poc = poc
        pd.tid = tid
        pd.soc = segment.soc
        pd.sub_gop_length = segment.max_sub_gop_length
        pd.highest_layer = tid == max_tid and not segment.low_delay
        pd.adaptive_qp = segment.adaptive_qp
        pd.beta_offset = segment.beta_offset
        pd.tc_offset = segment.tc_offset
        dm = segment.deblocking_mode
        if dm == k.DeblockingMode.DISABLED:
            pd.deblock = False
        elif dm in (k.DeblockingMode.ENABLED, k.DeblockingMode.CUSTOM):
            pd.deblock = True
        else:
            pd.deblock = tid == 0
        if is_access_picture:
            pd.nal_type = k.NalUnitType.INTRA_ACCESS_PICTURE
        elif segment.num_ref_pics == 0:
            pd.nal_type = k.NalUnitType.INTRA_PICTURE
        elif restrictions.disable_inter_bipred:
            pd.nal_type = k.NalUnitType.PREDICTED_PICTURE
        else:
            pd.nal_type = k.NalUnitType.BIPREDICTED_PICTURE

    def encode(self, segment, segment_qp, buffer_flag, settings):
        """(ref: picture_encoder.cc:95-164). Returns NAL bytes."""
        pd = self.pic_data
        picture_type = pd.get_prediction_type()
        sub_gop_length = segment.max_sub_gop_length
        max_tid = seg.get_max_tid(sub_gop_length)
        pic_tid = pd.tid
        if settings.flat_lambda > 0:
            sub_gop_length = min(sub_gop_length, settings.flat_lambda)
            max_tid = seg.get_max_tid(sub_gop_length)
            pic_tid = max_tid
        pic_qp_val = derive_picture_qp(settings, segment_qp, picture_type,
                                       pic_tid)
        pic_lambda = calculate_lambda(settings, segment, pic_qp_val,
                                      picture_type, sub_gop_length, pic_tid,
                                      max_tid)
        scaled_qp = get_qp_from_lambda(pd.bitdepth, pic_lambda)
        base_qp = Qp(scaled_qp, pd.chroma_format, pd.bitdepth, pic_lambda,
                     settings.chroma_qp_offset_table,
                     settings.chroma_qp_offset_u, settings.chroma_qp_offset_v)
        use_native = native_enc.usable_for(settings)
        if use_native:
            pd.init(segment, pic_qp=base_qp)
        else:
            pd.init(segment, tree=True, pic_qp=base_qp,
                    recalculate_lambda=settings.adaptive_qp > 0,
                    encoder=True)
        allow_lic = self._determine_allow_lic(pd, segment.restrictions)
        pd.lic_active = allow_lic

        bit_writer = BitWriter()
        if settings.encapsulation_mode != 0:
            bit_writer.write_bits(k.ENCAPSULATION_CODE, 8)
            bit_writer.write_bits(1, 8)
        self._write_header(segment, pd, buffer_flag, bit_writer)

        txrd_cands = None
        if settings.tpu_txrd_prepass > 0:
            with span("encode.txrd_prepass"):
                txrd_cands = self._compute_txrd_prepass(
                    pd, segment, base_qp, settings)
        split_dp = None
        if settings.tpu_split_dp:
            # bottom-up batched split RDO: device SATD lookahead maps +
            # open-loop zero-MV inter SAD maps, settled by one DP on the
            # device; decisive decisions prune the native search's
            # top-down recursion
            with span("encode.split_dp"):
                split_dp = self._compute_split_dp(pd, segment, base_qp)
        if use_native:
            self._encode_native(segment, settings, base_qp, bit_writer,
                                split_dp, txrd_cands)
        else:
            self._encode_python(segment, settings, base_qp, bit_writer,
                                split_dp, txrd_cands)

        if pd.tid == 0 or not pd.highest_layer:
            self.rec_pic.pad_border()
        pd.ref_pic_lists.zero_out_references()
        if pd.tid == 0 or segment.checksum_mode == k.ChecksumMode.MAX_ROBUST:
            self._write_checksum(segment, bit_writer, segment.checksum_mode)
        else:
            self.pic_hash = b""
        self._calculate_stats(base_qp)
        return bit_writer.get_bytes()

    def _encode_native(self, segment, settings, base_qp, bit_writer,
                       split_dp, txrd_cands):
        """Whole-picture CTU RDO + entropy write + deblocking in one
        native call (native/csrc/xvcn_enc.inc)."""
        pd = self.pic_data
        split_buf = None
        if split_dp is not None:
            from ..gpu.wavefront_rdo import pack_force_maps
            split_buf = pack_force_maps(split_dp, pd.width, pd.height)
        cand_buf = None
        if txrd_cands is not None:
            from ..gpu.txrd_prepass import pack_intra_cands
            cand_k = next(iter(txrd_cands.values())).shape[2]
            cand_buf = pack_intra_cands(txrd_cands, pd.width,
                                        pd.height, cand_k)
        with span("encode.native"):
            payload = native_enc.encode_picture(
                self, segment, settings, base_qp,
                split_force=split_buf, intra_cands=cand_buf,
                intra_cands_k=(cand_k if cand_buf is not None else 0))
        bit_writer.write_bytes(payload)

    def _encode_python(self, segment, settings, base_qp, bit_writer,
                       split_dp, txrd_cands):
        """The Python CU encoder's CTU loop into ``bit_writer``, then the
        picture's deblocking on the device."""
        pd = self.pic_data
        cu_encoder = CuEncoder(self.orig_pic, self.rec_pic, pd, settings,
                               self.device)
        cu_encoder.split_dp = split_dp
        cu_encoder.intra_search.txrd_cands = txrd_cands
        if not pd.is_intra_pic():
            from .inter_me import InterSearch
            cu_encoder.inter_search = InterSearch(cu_encoder)
        if settings.tpu_intra_lookahead:
            from ..gpu.lookahead import frame_intra_lookahead
            stats = {}
            with span("encode.intra_lookahead"):
                cu_encoder.intra_search.lookahead = frame_intra_lookahead(
                    self.orig_pic.plane_view(0), pd.bitdepth,
                    segment.restrictions, device=self.device, stats=stats)
            for st in stats.values():  # one device step a block size
                add_span_time("encode.intra_lookahead.extract",
                              st["extract_s"])
                add_span_time("encode.intra_lookahead.device",
                              st["device_s"])
        with span("encode.python"):
            if segment.tile_rows >= 2:
                self._encode_tiles(segment, base_qp, bit_writer, cu_encoder)
            else:
                writer = SyntaxWriter(base_qp, pd.get_prediction_type(),
                                      bit_writer, segment.restrictions)
                for rsaddr in range(pd.get_number_of_ctus()):
                    cu_encoder.encode_ctu(rsaddr, writer)
                writer.finish()
        if pd.deblock:
            with span("encode.deblock"):
                self._deblock_on_device(segment)

    def _encode_tiles(self, segment, base_qp, bit_writer, cu_encoder):
        """CTU-tile-row extension: each tile row is coded with its own
        CABAC engine and contexts and prediction cut at the tile top
        (``pd.tile_ctx_top_y`` masks neighbour lookups); the substream
        sizes prefix the payloads, so that a decoder can parse the tiles
        independently.  The tile top is cleared before deblocking."""
        pd = self.pic_data
        payloads = []
        for row0, row1 in pd.set_tiles(segment.tile_rows):
            tw = BitWriter()
            twriter = SyntaxWriter(base_qp, pd.get_prediction_type(), tw,
                                   segment.restrictions)
            pd.tile_ctx_top_y = row0 * k.CTU_SIZE
            for row in range(row0, row1):
                for cx in range(pd.ctu_num_x):
                    cu_encoder.encode_ctu(row * pd.ctu_num_x + cx, twriter)
            twriter.finish()
            payloads.append(tw.get_bytes())
        pd.tile_ctx_top_y = 0
        for p in payloads:
            bit_writer.write_bits(len(p), 32)
        for p in payloads:
            bit_writer.write_bytes(p)

    def _deblock_on_device(self, segment):
        """Deblock the reconstruction on the device: the visible planes
        go up (one upload), the edges are derived from the CU tree and
        filtered there, and the planes come back (one download)."""
        pd, rec = self.pic_data, self.rec_pic
        comps = range(pd.max_num_components)
        batch = dsp.DevBatch()
        handles = [batch.add(rec.plane_view(c).astype(np.int16))
                   for c in comps]
        batch.upload(self.device)
        planes = {c: batch.get(h) for c, h in zip(comps, handles)}
        filt = DeblockingFilter(pd, rec, pd.beta_offset, pd.tc_offset,
                                segment.restrictions)
        deblock_picture(filt, planes, self.device)
        flat, offs = dsp.gather_flat([planes[c] for c in comps])
        for c, (off, shape) in zip(comps, offs):
            rec.plane_view(c)[:] = \
                flat[off:off + int(np.prod(shape))].reshape(shape)

    def _compute_txrd_prepass(self, pd, segment, base_qp, settings):
        """Device transform-RD intra candidate maps (or None when the
        restriction set deviates from the default intra toolset the
        batched device predictor implements: then the exact per-CU
        search runs everywhere)."""
        restr = segment.restrictions
        if restr.disable_ext2_intra_67_modes or \
                not _intra_restrictions_default(restr):
            return None
        from ..gpu.txrd_prepass import frame_txrd_prepass
        return frame_txrd_prepass(
            self.orig_pic.plane_view(0), pd.bitdepth, base_qp,
            pd.is_intra_pic(), keep=settings.tpu_txrd_prepass,
            device=self.device)

    def _compute_split_dp(self, pd, segment, base_qp):
        """Device cost maps + on-device split DP -> force maps (or None
        when the picture shape yields no maps).

        16/32/64 SATD maps over a 4x mode subset (every 4th angular +
        planar/DC: an upper-bound cost is plenty for 5%-margin
        decisions); inter pictures add open-loop zero-MV SAD leaves
        against the refs' original planes and allow only FORCE_LEAF
        ("detail -> split" is unsound without true-motion costs)."""
        from ..gpu import wavefront_rdo as wf
        from ..gpu.lookahead import frame_intra_lookahead
        # the per-mode product scales ~n^3 per pixel, so the 64 maps use
        # a coarser mode subset than 16/32 (flat-vs-not is what the DP
        # needs at 64)
        maps = frame_intra_lookahead(self.orig_pic.plane_view(0),
                                     pd.bitdepth, segment.restrictions,
                                     sizes=(16, 32), mode_step=4,
                                     device=self.device)
        maps.update(frame_intra_lookahead(
            self.orig_pic.plane_view(0), pd.bitdepth,
            segment.restrictions, sizes=(64,), mode_step=8,
            device=self.device))
        if not maps:
            return None
        inter_sad = None
        if not pd.is_intra_pic():
            refs = []
            nl = 2 if pd.get_prediction_type() == \
                k.PicturePredictionType.BI else 1
            for lst in range(nl):
                for i in range(pd.ref_pic_lists.get_num_ref_pics(lst)):
                    entry = pd.ref_pic_lists.entries[lst][i]
                    if entry.orig_pic is not None:
                        refs.append(entry.orig_pic.plane_view(0))
            inter_sad = wf.frame_zero_mv_sad(
                self.orig_pic.plane_view(0), refs, pd.bitdepth,
                sizes=(16, 32, 64), device=self.device)
        return wf.split_dp_from_lookahead(
            maps, base_qp.lambda_sqrt, inter_sad,
            max_binary_size=pd.get_max_binary_split_size(k.CuTree.PRIMARY),
            binary_depth_ok=segment.max_binary_split_depth > 0,
            allow_force_split=pd.is_intra_pic(), device=self.device)

    def _write_header(self, segment, pd, buffer_flag, bit_writer):
        """(ref: picture_encoder.cc:173-197)"""
        restr = segment.restrictions
        bit_writer.write_bits(1, 1)   # xvc_bit_one
        # tile-extension streams flag every NAL rfe so baseline
        # decoders skip them (see segment.py EXT_MINOR_BIT)
        bit_writer.write_bits(
            1 if getattr(segment, "tile_rows", 1) >= 2 else 0, 1)
        bit_writer.write_bits(int(pd.nal_type), 5)
        bit_writer.write_bits(1, 1)   # nal_rfl
        bit_writer.write_bits(1 if buffer_flag else 0, 1)
        bit_writer.write_bits(pd.tid, 3)
        pic_qp = pd.pic_qp.get_qp_raw(0)
        bit_writer.write_bits(pic_qp + k.QP_SIGNAL_BASE, 7)
        if not restr.disable_ext2_inter_local_illumination_comp:
            bit_writer.write_bit(1 if pd.lic_active else 0)
        if segment.deblocking_mode == k.DeblockingMode.PER_PICTURE:
            bit_writer.write_bit(1 if pd.deblock else 0)
        bit_writer.pad_zero_bits()

    def _write_checksum(self, segment, bit_writer, checksum_mode):
        restr = segment.restrictions
        method = k.ChecksumMethod.CRC \
            if restr.disable_high_level_default_checksum_method \
            else k.ChecksumMethod.MD5
        self.pic_hash = cksum.hash_picture(self.rec_pic, method,
                                           checksum_mode)
        if segment.major_version <= 1:
            bit_writer.write_byte(len(self.pic_hash))
        bit_writer.write_bytes(self.pic_hash)

    def _determine_allow_lic(self, pd, restrictions):
        """(ref: picture_encoder.cc:230-281)"""
        SAMPLE_THRESHOLD = 0.06
        if pd.get_prediction_type() == k.PicturePredictionType.INTRA or \
                restrictions.disable_ext2_inter_local_illumination_comp:
            return False
        orig = self.orig_pic.plane_view(0)
        num_buckets = 1 << self.orig_pic.bitdepth
        hist_orig = np.bincount(orig.ravel(), minlength=num_buckets)
        num_lists = 2 if pd.get_prediction_type() == \
            k.PicturePredictionType.BI else 1
        h, w = orig.shape
        for ref_list in range(num_lists):
            for ref_idx in range(pd.ref_pic_lists.get_num_ref_pics(ref_list)):
                entry = pd.ref_pic_lists.entries[ref_list][ref_idx]
                ref_pic = entry.orig_pic
                if ref_pic is None:
                    continue
                ref = ref_pic.plane_view(0)
                hist_ref = np.bincount(ref.ravel(), minlength=num_buckets)
                err_sum = int(np.abs(hist_orig - hist_ref).sum())
                if err_sum > int(SAMPLE_THRESHOLD * w * h):
                    return True
        return False

    def _calculate_stats(self, base_qp):
        sse = 0
        for c in range(self.pic_data.max_num_components):
            rec = self.rec_pic.plane_view(c)
            orig = self.orig_pic.plane_view(c)
            diff = rec.astype(np.int64) - orig.astype(np.int64)
            # reference forces 8-bit metric precision for sse
            shift = 2 * (self.pic_data.bitdepth - 8)
            sse += int((diff * diff).sum()) >> shift
            self.rec_psnr[c] = met.compute_picture_psnr(rec, orig)
        self.rec_sse = sse


def derive_picture_qp(settings, segment_qp, pic_type, tid):
    """(ref: picture_encoder.cc:216-228)"""
    if pic_type == k.PicturePredictionType.INTRA:
        pic_qp = segment_qp + settings.intra_qp_offset
    else:
        pic_qp = segment_qp + tid + 1
    return min(max(pic_qp, k.MIN_ALLOWED_QP), k.MAX_ALLOWED_QP)


def get_qp_from_lambda(bitdepth, lambda_val):
    qp = int(math.floor(3.0 * math.log(lambda_val / 0.57) / math.log(2.0)
                        + 0.5))
    return min(max(12 + qp, k.MIN_ALLOWED_QP), k.MAX_ALLOWED_QP)


def calculate_lambda(settings, segment_header, qp, pic_type, sub_gop_length,
                     temporal_id, max_temporal_id):
    """(ref: picture_encoder.cc:312-354)"""
    qp_temp = qp - 12
    lambda_val = 2.0 ** (qp_temp / 3.0)
    scale_factor = settings.lambda_scale_a * \
        2.0 ** (settings.lambda_scale_b * qp_temp)
    pic_type_factor = 0.57 if pic_type == k.PicturePredictionType.INTRA \
        else 0.68
    subgop_factor = 1.0 - min(max(0.05 * (sub_gop_length - 1), 0.0), 0.5)
    hierarchical_factor = 1.0
    if temporal_id > 0 and temporal_id == max_temporal_id and \
            not segment_header.low_delay:
        subgop_factor = 1.0
        hierarchical_factor = min(max(qp_temp / 6.0, 2.0), 4.0)
    elif temporal_id > 0:
        hierarchical_factor = min(max(qp_temp / 6.0, 2.0), 4.0)
        hierarchical_factor *= 0.8
    if sub_gop_length == 16 and \
            pic_type != k.PicturePredictionType.INTRA and \
            not segment_header.low_delay:
        if settings.smooth_lambda_scaling == 0:
            temporal_factor = (0.6, 0.2, 0.33, 0.33, 0.4)
            hierarchical_factor = 1.0 if temporal_id == 0 else \
                min(max(qp_temp / 6.0, 2.0), 4.0)
            return temporal_factor[temporal_id] * hierarchical_factor * \
                lambda_val
        temporal_factor = (0.14, 0.2, 0.33, 0.33, 0.4)
        hierarchical_factor = min(max(qp_temp / 6.0, 2.0), 4.0)
        return temporal_factor[temporal_id] * hierarchical_factor * lambda_val
    return lambda_val * scale_factor * pic_type_factor * subgop_factor * \
        hierarchical_factor
