"""Encoder session: GOP structure, segment headers, NAL ordering.

Behavioral equivalent of the reference encoder session
(ref: src/xvc_enc_lib/encoder.cc).  Copy of ``xvc_tpu/codec/encoder.py``
on a torch device: ``Encoder(..., device=None)`` runs the encoder's
device stages on the card unless ``device`` names another.  Each picture
is coded by the native encoder or, where the JAX package takes its
Python CU encoder (``native/enc.usable_for``: ``tpu_intra_lookahead``,
``XVC_INTRA_PREPASS=jax``, ``XVC_ME=jax``, CTU tile rows,
``XVC_ENC_NATIVE=0``), by the port's copy of it, intra and inter
pictures.  With ``num_threads > 0`` the pictures of a sub-GOP burst are
coded on worker threads
(``parallel/pipeline.EncodePipeline``), each once its reference pictures
are reconstructed, and harvested in DOC order on the session's thread:
the same stream as the sequential encode.  With a mesh installed
(``engine.set_mesh``) each worker is pinned to slot ``doc % n`` of this
process's slots, where its picture's lookahead and motion-search sweeps
run; a pool clamped to one worker takes the sequential path.  With
``multihost_gop`` (``xvc_tpu/codec/encoder.py:151-163``, ``:444-452``)
the pictures are split over the processes of a ``torch.distributed``
group by DOC (``parallel/multihost.py``): the owner codes a picture and
sends its NAL bytes and reconstruction to the others.
"""
import numpy as np

from .. import constants as k
from .. import segment as seg
from ..engine import mesh_for, resolve_device
from ..parallel.pipeline import EncodePipeline, _pool_size
from .encoder_settings import EncoderSettings
from .picture_encoder import PictureEncoder
from .ref_lists import ReferenceListSorter


class EncodedNal:
    def __init__(self, bytes_, buffer_flag, nal_unit_type, poc, doc, soc,
                 tid, qp=0, user_data=0, sse=0, psnr=None, l0=None, l1=None):
        self.bytes = bytes_
        self.buffer_flag = buffer_flag
        self.nal_unit_type = nal_unit_type
        self.poc = poc
        self.doc = doc
        self.soc = soc
        self.tid = tid
        self.l0 = l0 or []
        self.l1 = l1 or []
        self.qp = qp
        self.user_data = user_data
        self.sse = sse
        self.psnr = psnr or [0.0, 0.0, 0.0]


class Encoder:
    def __init__(self, internal_bitdepth=8, num_threads=0, device=None):
        self.device = resolve_device(device)
        # 1 effective worker = no overlap, only hand-off overhead; route
        # to the sequential path (identical bitstream by construction)
        self.pipeline = (EncodePipeline(num_threads)
                         if num_threads > 0 and _pool_size(num_threads) > 1
                         else None)
        self._encode_jobs = []
        self.segment_header = seg.SegmentHeader()
        self.segment_header.codec_identifier = k.XVC_CODEC_IDENTIFIER
        self.segment_header.major_version = k.XVC_MAJOR_VERSION
        self.segment_header.minor_version = k.XVC_MINOR_VERSION
        self.segment_header.internal_bitdepth = internal_bitdepth
        self.segment_header.soc = 0
        self.prev_segment_header = seg.SegmentHeader()
        self.settings = EncoderSettings()
        self.multihost_gop = False
        self.input_bitdepth = 8
        self.framerate = 60.0
        self.segment_length = 640
        self.closed_gop_interval = 1 << 60
        self.poc = 0
        self.doc = 0
        self.sub_gop_start_poc = 0
        self.last_rec_poc = -1
        self.pic_encoders = []
        self.pic_buffering_num = 0
        self.extra_num_buffered_subgops = 0
        self.initialized = False
        self.segment_qp = 32
        self.doc_bitstream_order = []
        self.pending_out_nals = {}
        self.api_output_nals = []

    # ---- configuration ----
    def set_resolution(self, width, height):
        self.segment_header.output_width = width
        self.segment_header.output_height = height

    def set_qp(self, qp):
        self.segment_qp = qp

    def set_sub_gop_length(self, length):
        self.segment_header.max_sub_gop_length = length

    def set_num_ref_pics(self, num):
        self.segment_header.num_ref_pics = num

    def set_chroma_format(self, fmt):
        self.segment_header.chroma_format = fmt

    def set_deblock(self, mode):
        self.segment_header.deblocking_mode = k.DeblockingMode(mode)

    def set_checksum_mode(self, mode):
        self.segment_header.checksum_mode = k.ChecksumMode(mode)

    def set_low_delay(self, low_delay):
        self.segment_header.low_delay = low_delay

    def set_segment_length(self, length):
        self.segment_length = length

    def set_closed_gop_interval(self, interval):
        self.closed_gop_interval = interval

    def set_framerate(self, framerate):
        self.framerate = framerate

    def set_color_matrix(self, color_matrix):
        self.segment_header.color_matrix = color_matrix

    def set_beta_offset(self, offset):
        self.segment_header.beta_offset = offset

    def set_tc_offset(self, offset):
        self.segment_header.tc_offset = offset

    def set_chroma_qp_offsets(self, table, offset_u, offset_v):
        self.segment_header.chroma_qp_offset_table = table
        self.segment_header.chroma_qp_offset_u = offset_u
        self.segment_header.chroma_qp_offset_v = offset_v

    def set_encoder_settings(self, settings):
        """(ref: encoder.cc:202-230)"""
        assert self.poc == 0
        self.settings = settings
        sh = self.segment_header
        sh.num_ref_pics = settings.default_num_ref_pics
        sh.leading_pictures = settings.leading_pictures
        sh.max_binary_split_depth = settings.max_binary_split_depth
        sh.source_padding = settings.source_padding != 0
        sh.tile_rows = max(1, settings.tile_rows)
        sh.chroma_qp_offset_table = settings.chroma_qp_offset_table
        sh.chroma_qp_offset_u = settings.chroma_qp_offset_u
        sh.chroma_qp_offset_v = settings.chroma_qp_offset_v
        sh.adaptive_qp = settings.adaptive_qp
        restr = sh.restrictions
        if settings.restricted_mode:
            from ..restrictions import enable_restricted_mode
            enable_restricted_mode(restr, settings.restricted_mode)
        if settings.fast_transform_size_64:
            restr.disable_ext_transform_size_64 = True
        if settings.fast_transform_select:
            restr.disable_ext2_transform_select = True
        if settings.fast_inter_local_illumination_comp:
            restr.disable_ext2_inter_local_illumination_comp = True
        if settings.fast_inter_adaptive_fullpel_mv:
            restr.disable_ext2_inter_adaptive_fullpel_mv = True
        for name in (settings.explicit_restrictions or ()):
            # free-form signaled restriction flags (the encoder-side
            # analog of -restricted-mode for single flags; written to
            # and obeyed from the segment header like any restriction)
            if not hasattr(restr, name):
                raise ValueError("unknown restriction flag: %r" % (name,))
            setattr(restr, name, True)
        self.multihost_gop = bool(settings.multihost_gop)
        if self.multihost_gop:
            # the processes exchange only the reconstruction planes; the
            # TMVP motion fields stay in the process that coded them, so
            # the signaled planes-only profile is mandatory
            from ..parallel.multihost import GOP_PIPELINE_PROFILE
            missing = [n for n in GOP_PIPELINE_PROFILE
                       if not getattr(restr, n)]
            if missing:
                raise ValueError(
                    "multihost_gop requires the GOP pipeline restriction "
                    "profile; missing: %s (set settings."
                    "explicit_restrictions = multihost.GOP_PIPELINE_PROFILE)"
                    % ", ".join(missing))

    # ---- encoding ----
    def encode(self, pic_bytes, user_data=0):
        """Encode one input picture; returns list of EncodedNal."""
        if not self.initialized:
            self.initialized = True
            self._initialize()
        self.api_output_nals = []
        sh = self.segment_header

        doc = seg.calc_doc_from_poc(self.poc, sh.max_sub_gop_length,
                                    self.sub_gop_start_poc)
        tid = seg.calc_tid_from_doc(doc, sh.max_sub_gop_length,
                                    self.sub_gop_start_poc)
        if sh.low_delay:
            doc = self.poc

        encode_segment_header = (self.poc % self.segment_length) == 0
        if sh.leading_pictures > 0:
            encode_segment_header = (
                self.poc >= sh.max_sub_gop_length and
                ((self.poc - sh.max_sub_gop_length) %
                 self.segment_length) == 0)
        if tid == 0 and self.poc > 0:
            self.sub_gop_start_poc = self.doc + sh.max_sub_gop_length

        if encode_segment_header:
            self._start_new_segment()
        sh = self.segment_header

        pic_enc = self._prepare_new_input_picture(
            sh, doc, self.poc, tid, encode_segment_header, pic_bytes,
            user_data)
        if encode_segment_header:
            self._determine_buffer_flags(pic_enc)
        if tid == 0:
            self._update_reference_counts(self.poc)

        if self.settings.leading_pictures == 0 and self.poc == 0:
            self._encode_one_picture(pic_enc)
            self.doc = 0
        elif tid == 0:
            for _ in range(sh.max_sub_gop_length):
                for pic in self.pic_encoders:
                    if pic.pic_data.doc == self.doc + 1:
                        self._encode_one_picture(pic)
        self.poc += 1
        self._harvest_encode_jobs()
        self.out_rec = (None, None)
        if len(self.pic_encoders) + sh.max_sub_gop_length >= \
                self.pic_buffering_num:
            self.out_rec = self.reconstruct_next_picture()
        self._prepare_output_nals()
        return list(self.api_output_nals)

    def flush(self):
        """(ref: encoder.cc:149-200). Returns (nals, more_to_flush)."""
        self.api_output_nals = []
        if self.poc > 0:
            self.poc -= 1
        if self.doc < self.poc:
            if self.doc == 0 and self.segment_header.leading_pictures:
                # Early flush before a full sub-GOP in leading-pictures
                # mode: disable leading pictures and renumber the
                # buffered pictures to the normal structure
                # (ref: encoder.cc:158-167 + RewriteLeadingPictures
                # :602-628 — which crashes in the reference binary on
                # this path; ours encodes a valid stream,
                # tests/test_api.py::test_leading_pictures_early_flush).
                first_pic = self._rewrite_leading_pictures()
                if first_pic is not None:
                    self._encode_one_picture(first_pic)
                    self.doc = 0
            pics_to_encode = self.poc - self.doc
            num_encoded = 0
            while num_encoded < pics_to_encode:
                found = False
                for pic in self.pic_encoders:
                    if pic.pic_data.doc == self.doc + 1:
                        self._encode_one_picture(pic)
                        found = True
                        num_encoded += 1
                if not found:
                    self.doc += 1
        self.poc += 1
        self._harvest_encode_jobs()
        self.out_rec = self.reconstruct_next_picture()
        self._prepare_output_nals()
        more = (self.doc + 1 < self.poc or
                len(self.doc_bitstream_order) > 0 or
                len(self.pending_out_nals) > 0)
        return list(self.api_output_nals), more

    def flush_all(self):
        nals = []
        while True:
            out, more = self.flush()
            nals.extend(out)
            if not more:
                break
        return nals

    def _rewrite_leading_pictures(self):
        """Convert every buffered (unencoded) picture from the leading
        structure to the normal one: poc -= 1, doc/tid recomputed from
        the non-leading sub-GOP tables, poc 0 becomes the intra access
        picture.  Returns the new poc-0 picture
        (ref: encoder.cc:602-628)."""
        sh = self.segment_header
        sh.leading_pictures = 0
        self.settings.leading_pictures = 0
        self.poc -= 1
        pic_zero = None
        for pic in self.pic_encoders:
            if pic.output_status != "ready":
                continue  # recycled/encoded entries keep their numbers
            pd = pic.pic_data
            poc = pd.poc - 1
            pd.poc = poc
            pd.doc = seg.calc_doc_from_poc(poc, sh.max_sub_gop_length,
                                           self.sub_gop_start_poc)
            pd.tid = seg.calc_tid_from_doc(pd.doc, sh.max_sub_gop_length,
                                           self.sub_gop_start_poc)
            max_tid = seg.get_max_tid(sh.max_sub_gop_length)
            pd.highest_layer = pd.tid == max_tid and not sh.low_delay
            if poc == 0:
                pd.nal_type = k.NalUnitType.INTRA_ACCESS_PICTURE
                pic_zero = pic
        return pic_zero

    # ---- internals ----
    def _initialize(self):
        """(ref: encoder.cc:232-261)"""
        sh = self.segment_header
        if self.settings.leading_pictures > 0 and \
                (sh.max_sub_gop_length == 1 or sh.low_delay):
            self.settings.leading_pictures = 0
            sh.leading_pictures = 0
        elif self.settings.leading_pictures:
            sh.leading_pictures = self.settings.leading_pictures
        if self.settings.leading_pictures > 0:
            self.poc = 1
            self.last_rec_poc = 0
        self.pic_buffering_num = sh.num_ref_pics + sh.max_sub_gop_length + 1

    def _start_new_segment(self):
        """(ref: encoder.cc:263-276)"""
        import copy
        self.prev_segment_header = self.segment_header
        self.segment_header = copy.deepcopy(self.prev_segment_header)
        if ((self.poc + self.segment_length) %
                self.closed_gop_interval) == 0:
            self.segment_header.open_gop = False
        else:
            self.segment_header.open_gop = True
        if (not self.settings.leading_pictures and self.poc != 0) or \
                (self.settings.leading_pictures and
                 self.poc != self.segment_header.max_sub_gop_length):
            self.segment_header.soc = (self.segment_header.soc + 1) & 0xFF

    def _prepare_new_input_picture(self, sh, doc, poc, tid,
                                   is_access_picture, pic_bytes, user_data):
        """(ref: encoder.cc:445-480)"""
        ref_cnt = sh.max_sub_gop_length \
            if (self.settings.leading_pictures or poc > 0) else 1
        if tid == 0 and sh.max_sub_gop_length > 1 and \
                not self.extra_num_buffered_subgops:
            ref_cnt += 1
        if tid == 0:
            ref_cnt += sh.num_ref_pics + self.extra_num_buffered_subgops
        pic_enc = self._get_new_picture_encoder()
        pic_enc.init_pic(sh, doc, poc, tid, is_access_picture,
                         sh.restrictions)
        pic_enc.ref_count = ref_cnt
        pic_enc.user_data = user_data
        self._convert_input(pic_enc, pic_bytes, sh)
        return pic_enc

    def _convert_input(self, pic_enc, pic_bytes, sh):
        """Input conversion incl. 8-alignment padding
        (ref: resample.cc CopyFromBytesWithPadding)."""
        w = sh.output_width
        h = sh.output_height
        dtype = np.uint8 if self.input_bitdepth <= 8 else np.uint16
        sx = k.chroma_shift_x(sh.chroma_format)
        sy = k.chroma_shift_y(sh.chroma_format)
        upshift = sh.internal_bitdepth - self.input_bitdepth
        arr = np.frombuffer(pic_bytes, dtype=dtype)
        off = 0
        for c in range(k.num_components(sh.chroma_format)):
            cw = w >> (sx if c else 0)
            ch = h >> (sy if c else 0)
            plane_in = arr[off:off + cw * ch].reshape(ch, cw).astype(np.int32)
            off += cw * ch
            if upshift:
                plane_in = plane_in << upshift
            view = pic_enc.orig_pic.plane_view(c)
            view[:ch, :cw] = plane_in
            # replicate padding to internal (8-aligned) size
            if view.shape[1] > cw:
                view[:ch, cw:] = view[:ch, cw - 1:cw]
            if view.shape[0] > ch:
                view[ch:, :] = view[ch - 1:ch, :]

    def _determine_buffer_flags(self, intra_pic):
        """(ref: encoder.cc:482-513)"""
        sh = self.segment_header
        if sh.leading_pictures and intra_pic.pic_data.doc == 1:
            return
        for pic_enc in self.pic_encoders:
            pic_sh = sh if pic_enc.pic_data.soc == sh.soc \
                else self.prev_segment_header
            if pic_enc.output_status == "ready" and \
                    pic_enc.pic_data.poc < intra_pic.pic_data.poc:
                if pic_sh.open_gop:
                    pic_enc.buffer_flag = True
                insert_at = len(self.doc_bitstream_order)
                best_val = None
                for i, doc_val in enumerate(self.doc_bitstream_order):
                    if (best_val is None or doc_val < best_val) and \
                            doc_val > pic_enc.pic_data.doc:
                        insert_at = i
                        best_val = doc_val
                self.doc_bitstream_order.insert(insert_at,
                                                pic_enc.pic_data.doc)

    def _update_reference_counts(self, last_subgop_end_poc):
        """(ref: encoder.cc:515-562)"""
        sh = self.segment_header
        last_subgop_start_poc = 0 \
            if last_subgop_end_poc < sh.max_sub_gop_length \
            else last_subgop_end_poc - sh.max_sub_gop_length + 1
        subgop_pics = [p for p in self.pic_encoders
                       if p.pic_data.poc >= last_subgop_start_poc]
        if not subgop_pics:
            return
        for pic_enc in subgop_pics:
            pd = pic_enc.pic_data
            pic_sh = sh if pd.soc == sh.soc else self.prev_segment_header
            sorter = ReferenceListSorter(pic_sh,
                                         self.prev_segment_header.open_gop)
            deps = sorter.prepare(pd.poc, pd.tid, pd.is_intra_pic(),
                                  self.pic_encoders, None,
                                  pic_sh.leading_pictures)
            dep_pocs = {d.pic_data.poc for d in deps}
            for pic2 in subgop_pics:
                if pic2.pic_data.poc not in dep_pocs:
                    pic2.ref_count -= 1

    def _encode_one_picture(self, pic_enc):
        """(ref: encoder.cc:278-326)"""
        sh = self.segment_header \
            if pic_enc.pic_data.soc == self.segment_header.soc \
            else self.prev_segment_header
        pic_enc.output_status = "processing"
        sorter = ReferenceListSorter(sh, self.prev_segment_header.open_gop)
        deps = sorter.prepare(pic_enc.pic_data.poc, pic_enc.pic_data.tid,
                              pic_enc.pic_data.is_intra_pic(),
                              self.pic_encoders,
                              pic_enc.pic_data.ref_pic_lists,
                              sh.leading_pictures)
        buffer_flag = 1 if pic_enc.buffer_flag else 0
        if self.pipeline is not None:
            # GOP across slots: each in-flight picture owns a slot for its
            # lookahead and motion search (on a mesh spanning processes,
            # one of this process's slots)
            mesh = mesh_for(self.device)
            slot = None if mesh is None else \
                mesh.local_slots[self.doc % len(mesh.local_slots)]
            job = self.pipeline.submit(pic_enc, deps, sh, self.segment_qp,
                                       buffer_flag, self.settings, slot)
            self._encode_jobs.append((pic_enc, deps, job))
        elif self.multihost_gop:
            # pictures split over the processes by DOC; the owner's NAL
            # bytes and reconstruction go to every other process
            from ..parallel import multihost
            mesh = mesh_for(self.device)
            if mesh is not None and mesh.multiprocess:
                # only the owner codes the picture: a collective of the
                # sharded lookahead would wait for the other processes
                raise RuntimeError("multihost_gop codes a picture in one "
                                   "process; install no mesh spanning "
                                   "processes for it")
            owner = self.doc % multihost.process_count()
            nal_bytes = multihost.encode_or_receive(self, pic_enc, sh,
                                                    owner)
            pic_enc.output_status = "finished"
            self._on_picture_encoded(pic_enc, deps, nal_bytes)
        else:
            nal_bytes = pic_enc.encode(sh, self.segment_qp, buffer_flag,
                                       self.settings)
            pic_enc.output_status = "finished"
            self._on_picture_encoded(pic_enc, deps, nal_bytes)
        if pic_enc.pic_data.soc == self.segment_header.soc:
            self.doc_bitstream_order.append(pic_enc.pic_data.doc)
        self.doc += 1

    def _harvest_encode_jobs(self):
        """Collect the threaded picture encodes in submission (DOC) order
        (ref: thread_encoder.cc:61-97 WaitOne/WaitForPicture)."""
        jobs, self._encode_jobs = self._encode_jobs, []
        nals = EncodePipeline.harvest([job for _, _, job in jobs])
        for (pic_enc, deps, _), nal_bytes in zip(jobs, nals):
            pic_enc.output_status = "finished"
            self._on_picture_encoded(pic_enc, deps, nal_bytes)

    def _on_picture_encoded(self, pic_enc, inter_deps, nal_bytes):
        """(ref: encoder.cc:328-376)"""
        pic_enc.output_status = "has_not_been_output"
        pd = pic_enc.pic_data
        rpl = pd.ref_pic_lists
        l0, l1 = [], []
        if rpl is not None and not pd.is_intra_pic():
            l0 = [rpl.get_ref_poc(0, i)
                  for i in range(rpl.get_num_ref_pics(0))]
            l1 = [rpl.get_ref_poc(1, i)
                  for i in range(rpl.get_num_ref_pics(1))]
        nal = EncodedNal(
            nal_bytes, 1 if pic_enc.buffer_flag else 0, int(pd.nal_type),
            pd.poc, pd.doc, pd.soc, pd.tid,
            qp=pd.pic_qp.get_qp_raw(0) if pd.pic_qp else 0,
            user_data=pic_enc.user_data, sse=pic_enc.rec_sse,
            psnr=list(pic_enc.rec_psnr), l0=l0, l1=l1)
        self.pending_out_nals[pd.doc] = nal
        last_poc = pd.poc
        for dep in sorted(inter_deps, key=lambda p: p.pic_data.poc):
            is_prev_sub_gop_pic = dep.pic_data.tid == 0 and \
                dep.pic_data.poc < pd.poc
            if last_poc == dep.pic_data.poc or is_prev_sub_gop_pic:
                continue
            dep.ref_count -= 1
            last_poc = dep.pic_data.poc
        if pd.tid == 0:
            for prev in self.pic_encoders:
                if prev.pic_data.tid == 0 and \
                        prev.pic_data.poc < pd.poc and prev.ref_count > 0:
                    prev.ref_count -= 1

    def _prepare_output_nals(self):
        """(ref: encoder.cc:378-403)"""
        while self.doc_bitstream_order:
            next_doc = self.doc_bitstream_order[0]
            nal = self.pending_out_nals.get(next_doc)
            if nal is None:
                return
            self.doc_bitstream_order.pop(0)
            if nal.nal_unit_type == int(k.NalUnitType.INTRA_ACCESS_PICTURE):
                sh_prefix = b""
                if self.settings.encapsulation_mode != 0:
                    sh_prefix = bytes([k.ENCAPSULATION_CODE, 1])
                sh_bytes = sh_prefix + \
                    seg.write_segment_header(self.segment_header,
                                                    self.framerate)
                self.api_output_nals.append(EncodedNal(
                    sh_bytes, 0, int(k.NalUnitType.SEGMENT_HEADER), 0, 0,
                    self.segment_header.soc, 0))
            self.api_output_nals.append(nal)
            del self.pending_out_nals[next_doc]
            # reference only outputs one buffered nal per api call
            break

    def _get_new_picture_encoder(self):
        """(ref: encoder.cc:564-600)"""
        sh = self.segment_header
        if len(self.pic_encoders) < self.pic_buffering_num:
            pic = PictureEncoder(sh.chroma_format, sh.internal_width,
                                 sh.internal_height, sh.internal_bitdepth,
                                 sh.crop_width, sh.crop_height,
                                 device=self.device)
            self.pic_encoders.append(pic)
            return pic
        for pic_enc in self.pic_encoders:
            if pic_enc.output_status != "has_been_output" or \
                    pic_enc.ref_count > 0:
                continue
            return pic_enc
        raise RuntimeError("no available picture encoder")

    def reconstruct_next_picture(self):
        """Returns (poc, rec bytes) of next picture in output order."""
        for pic in self.pic_encoders:
            if pic.pic_data.poc == self.last_rec_poc + 1 and \
                    pic.output_status == "has_not_been_output":
                pic.output_status = "has_been_output"
                self.last_rec_poc += 1
                return pic.pic_data.poc, pic.rec_pic.to_bytes()
        return None, None


def encode_stream(yuv_bytes, width, height, frames, qp=32, bitdepth=8,
                  settings=None, sub_gop_length=0, num_ref_pics=None,
                  chroma_format=k.ChromaFormat.YUV420, checksum_mode=0,
                  low_delay=False, speed_mode=1, tune=0,
                  max_keypic_distance=640, closed_gop=0, device=None):
    """Convenience one-shot encoder on ``device`` (None: the card);
    returns list of NAL byte strings."""
    enc = Encoder(bitdepth, device=device)
    settings = settings or EncoderSettings()
    if settings.default_num_ref_pics < 0:
        settings.initialize_speed(speed_mode)
    if tune:
        settings.tune(tune)
    if num_ref_pics is not None:
        settings.default_num_ref_pics = num_ref_pics
    enc.set_resolution(width, height)
    enc.set_chroma_format(chroma_format)
    enc.set_deblock(1)
    enc.set_checksum_mode(checksum_mode)
    enc.set_qp(qp)
    enc.set_low_delay(low_delay)
    enc.input_bitdepth = bitdepth
    enc.set_encoder_settings(settings)
    if num_ref_pics is not None:
        enc.set_num_ref_pics(num_ref_pics)
    # sub_gop_length 0 = auto (ref: xvc_enc_lib/xvcenc.cc:346-351)
    if sub_gop_length == 0:
        sub_gop_length = 16 if enc.segment_header.num_ref_pics > 0 else 1
    enc.set_sub_gop_length(sub_gop_length)
    # segment / closed-gop length (ref: xvc_enc_lib/xvcenc.cc:269-290)
    if max_keypic_distance == 0:
        seg_len = ((1 << 62) // sub_gop_length) * sub_gop_length
    else:
        seg_len = (max_keypic_distance // sub_gop_length) * sub_gop_length
    enc.set_segment_length(seg_len)
    if closed_gop > 0:
        enc.set_closed_gop_interval(seg_len * closed_gop)
    else:
        enc.set_closed_gop_interval(
            ((1 << 62) // sub_gop_length) * sub_gop_length)
    frame_size = width * height * 3 // 2 * (1 if bitdepth <= 8 else 2)
    if chroma_format == k.ChromaFormat.YUV444:
        frame_size = width * height * 3 * (1 if bitdepth <= 8 else 2)
    nals = []
    for f in range(frames):
        out = enc.encode(yuv_bytes[f * frame_size:(f + 1) * frame_size])
        nals.extend(n.bytes for n in out)
    for n in enc.flush_all():
        nals.append(n.bytes)
    return nals
