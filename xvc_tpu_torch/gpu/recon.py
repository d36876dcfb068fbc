"""Replay reconstruction of a picture the flat path refuses.

Port of ``xvc_tpu/tpu/recon.py`` (``JaxReconstructor``) for the pictures
``flat_recon.ineligible_reason`` names: LIC (local illumination
compensation) on, chroma 4:2:2 or 4:4:4, or a restricted intra toolset;
and for every picture of the Python parse (above 14 bit, or under
``XVC_PIC_NATIVE=0``).  The picture's CU tree is there: the native parse
rebuilt it (``native/pic.py`` ``_replay_tree``), or the Python parse
read it and ``tree_records.build`` made its record table.  Then, in
this order:

  1. the device half of the flat path (``FlatReconstructor``, whose
     subclass this is): one upload, ITX of every coded block and MC of
     every inter leaf from the record table (``itx.itx_picture``,
     ``mc.mc_picture``: one launch each, doing the work of the JAX
     package's ``dsp.make_dequant_itx`` and ``dsp.make_mc_kernel``
     groups), and combine.  ``mc_picture`` predicts LIC leaves without
     LIC; step 3 rewrites each of them before any later leaf reads it;
  2. the intra scans, where the JAX rules allow them
     (``_can_scan_intra``, ``_can_scan_chroma``).  The JAX package's
     rule that sends luma to its host tail when intra covers less than a
     quarter of the picture is a cost rule of its device link and is not
     copied: it changes no sample;
  3. the sequential tail on the host, when it has blocks: the planes and
     the residual come down in one download; the leaves are walked in
     decode order replaying the availability marks (the reference's
     ClearMarkCuInPic / MarkUsedInPic protocol, ref:
     cu_decoder.cc:47-100), and every intra block the scans did not take
     and every LIC block is predicted on the host (``codec/cu_decoder.py``
     ``CuDecoder``), its residual added and clipped; the planes go back
     up in one upload.

Deblock, the frame-store write and the download follow as on the flat
path (``codec/picture_decoder.py``).
"""
import numpy as np
import torch

from .. import constants as k
from ..codec import inter_mc
from ..codec.cu_decoder import CuDecoder
from ..profiling import span
from . import dsp
from . import flat_recon
from .records import C_LIC, C_PRED, C_TREE

# the number of blocks the sequential host tail reconstructed for the last
# picture this module reconstructed (one per leaf and component; each
# Reconstructor counts its own in ``tail_blocks`` and sets this when its
# picture is done, so the workers of a threaded decode do not mix counts)
LAST_TAIL_BLOCKS = -1


class Reconstructor(flat_recon.FlatReconstructor):
    STAGE = "recon"

    def __init__(self, pic_decoder, segment, device):
        super().__init__(pic_decoder, segment, device)
        self.dec = CuDecoder(self.rec, self.pd, self.restr)

    def run(self):
        """As ``FlatReconstructor.run``: the visible device planes
        {comp: (H, W) int16} when the picture is deblocked, else None
        once the picture is stored and the host planes filled."""
        global LAST_TAIL_BLOCKS
        pd = self.pd
        scan_luma = self._can_scan_intra()
        scan_chroma = scan_luma and self._can_scan_chroma()
        with span("recon.build"):
            leaves = flat_recon.decode_order_leaves(pd._parse_records)
            lmeta, cmeta = self._build_intra_meta(leaves, scan_chroma) \
                if scan_luma else (None, None)
        self._device_half(leaves, lmeta, cmeta)
        self._scans()
        planes_dev = self._visible()
        self.tail_blocks = 0
        if self._tail_needed(leaves, scan_luma, scan_chroma):
            planes_dev = self._sequential_tail(planes_dev, scan_luma,
                                               scan_chroma)
        LAST_TAIL_BLOCKS = self.tail_blocks
        if pd.deblock:
            return planes_dev
        flat_recon.store_and_download(self.rec, planes_dev, self.device,
                                      self.STAGE)
        return None

    # ------------------------------------------------------------------
    def _can_scan_intra(self):
        """The luma scan covers the default (unrestricted) 67-mode
        toolset; LIC pictures keep the host tail (LIC blocks interleave
        with intra in decode order)."""
        r = self.restr
        return (not self.pd.lic_active and
                not r.disable_ext2_intra_67_modes and
                flat_recon._intra_restrictions_default(r))

    def _can_scan_chroma(self):
        """The chroma scan covers the 4:2:0 default toolset
        (planar/DC/angular/DM/LM); other chroma formats keep the host
        tail (their LM downsample filters differ)."""
        return (self.pd.chroma_format == k.ChromaFormat.YUV420 and
                not self.restr.disable_intra_chroma_predictor and
                not self.restr.disable_ext2_intra_chroma_from_luma)

    def _tail_needed(self, leaves, scan_luma, scan_chroma):
        """Whether any leaf has a block for the host tail: an LIC leaf,
        or an intra leaf with a component the scans did not take."""
        if ((leaves[:, C_PRED] == 1) & (leaves[:, C_LIC] != 0)).any():
            return True
        for tree in (0, 1):
            comps = self.pd.get_components(tree)
            if (comps and (not scan_luma and 0 in comps or
                           not scan_chroma and comps[-1] != 0) and
                    ((leaves[:, C_TREE] == tree) &
                     (leaves[:, C_PRED] == 0)).any()):
                return True
        return False

    # ------------------------------------------------------------------
    def _sequential_tail(self, planes_dev, skip_luma, skip_chroma):
        """Download the planes and the residual (one download), run the
        host tail over the CU tree, upload the planes (one upload)."""
        rec = self.rec
        comps = sorted(planes_dev)
        resi_dev = self._visible((self.rpad_l, self.rpad_c))
        with span("recon.download"):
            flat, offs = dsp.gather_flat(
                [planes_dev[c].to(torch.int32) for c in comps] +
                [resi_dev[c] for c in comps])
        host = [flat[off:off + int(np.prod(shape))].reshape(shape)
                for off, shape in offs]
        resi = {}
        for i, comp in enumerate(comps):
            rec.plane_view(comp)[:] = host[i]
            resi[comp] = host[len(comps) + i]
        with span("recon.sequential"):
            self._for_each_leaf(lambda cu: self._sequential_leaf(
                cu, resi, skip_luma, skip_chroma))
        with span("recon.reupload"):
            batch = dsp.DevBatch()
            handles = [batch.add(rec.plane_view(c).astype(np.int16))
                       for c in comps]
            batch.upload(self.device)
        return {c: batch.get(h) for c, h in zip(comps, handles)}

    def _for_each_leaf(self, visitor):
        """Decode-order leaf walk with incremental availability marking
        (ref: cu_decoder.cc:86-100): per CTU the primary tree, then the
        secondary.  The walk starts from a clear table (the Python
        parse's table holds every leaf).  In a picture of CTU tile rows each CTU's lookups are
        cut at its tile's top, as they were in its parse
        (xvc_tpu/tpu/recon.py ``_for_each_leaf``)."""
        pic = self.pd
        trees = [k.CuTree.PRIMARY]
        if pic.has_secondary_cu_tree():
            trees.append(k.CuTree.SECONDARY)
        for tree in trees:
            pic.cu_table[tree] = [None] * len(pic.cu_table[tree])
        tiled = pic.tile_rows > 1
        for rsaddr in range(pic.get_number_of_ctus()):
            if tiled:
                pic.tile_ctx_top_y = pic.tile_top_y_of_row(
                    rsaddr // pic.ctu_num_x)
            for tree in trees:
                self._visit(pic.get_ctu(tree, rsaddr), visitor)
        if tiled:
            pic.tile_ctx_top_y = 0

    def _visit(self, cu, visitor):
        if cu.split != k.SplitType.NONE:
            for sub in cu.sub_cus:
                if sub is not None:
                    self._visit(sub, visitor)
        else:
            self.pd.mark_used_in_pic(cu)
            visitor(cu)

    def _sequential_leaf(self, cu, resi, skip_luma, skip_chroma):
        if not (cu.is_intra() or (cu.is_inter() and cu.use_lic)):
            return
        dec = self.dec
        dec.intra.invalidate_lm_cache()
        max_pel = (1 << self.bitdepth) - 1
        for comp in self.pd.get_components(cu.cu_tree):
            if skip_luma and comp == 0:
                continue  # luma handled by the device intra scan
            if skip_chroma and comp != 0 and cu.is_intra():
                continue  # chroma handled by the device chroma scan
            self.tail_blocks += 1
            cx, cy = cu.pos(comp)
            w, h = cu.size(comp)
            if cu.is_intra():
                pred = dec.predict_intra(cu, comp)
            else:
                pred = inter_mc.motion_compensation(dec.inter, cu, comp)
            if cu.cbf[comp]:
                pred = np.clip(pred + resi[comp][cy:cy + h, cx:cx + w],
                               0, max_pel)
            self.rec.plane_view(comp)[cy:cy + h, cx:cx + w] = pred
