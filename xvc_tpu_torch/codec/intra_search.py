"""Intra mode search: SATD pre-pass + full RD reconstruction.

Behavioral equivalent of the reference intra search
(ref: src/xvc_enc_lib/intra_search.cc).  Copy of
``xvc_tpu/codec/intra_search.py`` with its three device hooks on the
encoder's torch device:

- the transform-RD prepass's candidates (``txrd_cands``, from
  ``gpu/txrd_prepass.py``) replace the SATD pre-pass where they cover
  the CU;
- the whole-picture lookahead's cost maps (``lookahead``, from
  ``gpu/lookahead.py``: ``tpu_intra_lookahead``) rank the modes instead
  of the per-CU pre-pass where they cover the CU;
- otherwise the per-CU pre-pass's all-mode SATD runs on the device
  (``device_prepass_satd``: on the card one packed upload, one
  ``intra_satd.cu`` launch and one download) wherever the JAX package's
  device pre-pass may
  (``XVC_INTRA_PREPASS=jax``: square CUs of 4 to 32, 67 modes, the
  default intra toolset), and in the native library
  (``xvcn_intra_prepass_satd``, the JAX package's host route) for every
  other CU.  Both give the host metric's values, so the stream does not
  depend on the route.  In a picture of CTU tile rows the JAX package's
  two routes read different reference rows (its device pre-pass takes no
  tile cut); the device call here reads the rows of the route the JAX
  package would take (``_device_prepass_satd``).
"""
import threading

import numpy as np
import torch

from .. import constants as k
from .. import native
from ..engine import use_jax_intra_prepass
from ..gpu import intra_satd
from ..gpu.flat_recon import _intra_restrictions_default
from ..ops import intra_pred as ip
from ..profiling import span
from ..syntax.writer import SyntaxWriter
from . import intra_modes
from .transform_encoder import (TxSearchFlags, load_comp_state,
                                save_comp_state)

_COST_MAX = (1 << 62)

_NUM_INTRA_FAST_MODES_EXT = (
    (0, 0, 0, 0, 0, 0, 0, 0),
    (0, 0, 0, 0, 0, 0, 0, 0),
    (0, 0, 3, 3, 3, 3, 2, 2),
    (0, 0, 3, 3, 3, 3, 3, 2),
    (0, 0, 3, 3, 3, 3, 3, 2),
    (0, 0, 3, 3, 3, 3, 3, 2),
    (0, 0, 2, 3, 3, 3, 3, 2),
    (0, 0, 2, 2, 2, 2, 2, 3),
)
_NUM_INTRA_FAST_MODES_NO_EXT = (0, 3, 8, 8, 3, 3, 3)


# Each thread's staging buffers of the per-CU call on the card, by
# (device, n): pinned host and device int32 blocks packed as
# intra_satd.pack_block packs them, the pinned [67] result and the event
# its download records.  A call reuses them only after waiting for its
# own download, which follows its upload on the stream.
_STAGING = threading.local()


def _staging(device, n):
    bufs = getattr(_STAGING, "bufs", None)
    if bufs is None:
        bufs = _STAGING.bufs = {}
    key = (str(device), n)
    got = bufs.get(key)
    if got is None:
        size = intra_satd.packed_size(n)
        got = (torch.empty(size, dtype=torch.int32, pin_memory=True),
               torch.empty(size, dtype=torch.int32, device=device),
               torch.empty(intra_satd.num_modes(1), dtype=torch.int32,
                           pin_memory=True),
               torch.cuda.Event())
        bufs[key] = got
    return got


def device_prepass_satd(orig, top, left, bitdepth, device):
    """All 67 modes' SATD of one n x n block on ``device``: the block
    (orig [n, n]) and its reference lines (top [2n+1], left [2n]) go up
    packed, the [67] int32 costs come down.  On the card that is one
    upload, one ``intra_satd`` launch and one download, waited for on an
    event; on the CPU the same packed block through
    ``intra_satd.intra_satd_plain``."""
    n = orig.shape[0]
    dev = torch.device(device)
    with span("encode.intra_prepass"):
        if dev.type != "cuda":
            packed = np.empty(intra_satd.packed_size(n), np.int32)
            intra_satd.pack_block(orig, top, left, packed)
            return intra_satd.intra_satd(
                *intra_satd.block_views(torch.from_numpy(packed).to(dev), n),
                n, bitdepth, 1).numpy()[0]
        host, buf, result, done = _staging(dev, n)
        intra_satd.pack_block(orig, top, left, host.numpy())
        buf.copy_(host, non_blocking=True)
        costs = intra_satd.intra_satd(*intra_satd.block_views(buf, n), n,
                                      bitdepth, 1)
        result.copy_(costs[0], non_blocking=True)
        done.record(torch.cuda.current_stream(dev))
        done.synchronize()
        return result.numpy().copy()


class IntraSearch:
    def __init__(self, bitdepth, pic_data, orig_pic, settings, cu_writer,
                 device):
        self.device = device
        self.bitdepth = bitdepth
        self.pic = pic_data
        self.orig_pic = orig_pic
        self.settings = settings
        self.cu_writer = cu_writer
        self._best_state = {}
        # per-picture open-loop device cost maps ({n: [bh,bw,67]}), set
        # by PictureEncoder when tpu_intra_lookahead is enabled
        self.lookahead = None
        # per-picture device transform-RD candidate maps
        # ({n: [bh,bw,K]}, gpu/txrd_prepass.py), set by PictureEncoder
        # when tpu_txrd_prepass is enabled
        self.txrd_cands = None

    def compress_intra_luma(self, cu, qp, bitstream_writer, encoder, rec_pic,
                            helpers):
        """(ref: intra_search.cc:43-90)"""
        helpers.begin_ref_scope(cu)
        try:
            return self._compress_intra_luma(cu, qp, bitstream_writer,
                                             encoder, rec_pic, helpers)
        finally:
            helpers.end_ref_scope()

    def _compress_intra_luma(self, cu, qp, bitstream_writer, encoder,
                             rec_pic, helpers):
        comp = 0
        modes_cost = self._determine_slow_intra_modes(
            cu, qp, bitstream_writer, encoder, rec_pic, helpers)

        best_mode = -1
        best_cost = _COST_MAX
        best_dist = _COST_MAX
        best_is_applied = False
        best_uses_tx_select = False
        for intra_mode in modes_cost:
            cu.intra_mode_luma = intra_mode
            best_is_applied = False
            rdo_writer = SyntaxWriter.rdo_clone(bitstream_writer, 0)
            ssd = self.predict_and_transform(cu, comp, qp, rdo_writer,
                                             encoder, rec_pic, helpers)
            self.cu_writer.write_component(cu, comp, rdo_writer)
            bits = rdo_writer.get_num_written_bits()
            cost = ssd + int(bits * qp.get_lambda() + 0.5)
            bias_normal_tx = (cost == best_cost and best_uses_tx_select and
                              cu.tx_select_idx < 0)
            if cost < best_cost or bias_normal_tx:
                best_cost = cost
                best_dist = ssd
                best_mode = intra_mode
                best_uses_tx_select = cu.tx_select_idx >= 0
                best_is_applied = True
                self._best_state[0] = save_comp_state(cu, rec_pic, 0)
        cu.intra_mode_luma = best_mode
        if not best_is_applied:
            load_comp_state(cu, rec_pic, 0, self._best_state[0])
        return best_dist

    def compress_intra_chroma(self, cu, qp, bitstream_writer, encoder,
                              rec_pic, helpers):
        """(ref: intra_search.cc:92-158)"""
        helpers.begin_ref_scope(cu)
        try:
            return self._compress_intra_chroma(cu, qp, bitstream_writer,
                                               encoder, rec_pic, helpers)
        finally:
            helpers.end_ref_scope()

    def _compress_intra_chroma(self, cu, qp, bitstream_writer, encoder,
                               rec_pic, helpers):
        restr = self.pic.restrictions
        luma_cu = cu if cu.cu_tree == k.CuTree.PRIMARY else \
            self.pic.get_cu_at(k.CuTree.PRIMARY, cu.pos_x, cu.pos_y)
        luma_mode = luma_cu.intra_mode_luma
        chroma_modes = intra_modes.get_predictors_chroma(luma_mode, restr)
        if restr.disable_intra_chroma_predictor:
            cu.intra_mode_chroma = k.INTRA_CHROMA_DM
            d = self.predict_and_transform(cu, 1, qp, bitstream_writer,
                                           encoder, rec_pic, helpers)
            d += self.predict_and_transform(cu, 2, qp, bitstream_writer,
                                            encoder, rec_pic, helpers)
            return d

        best_cost = _COST_MAX
        best_dist = 0
        best_mode = None
        best_is_applied = False
        for chroma_mode in chroma_modes:
            if chroma_mode == 99:
                continue
            cu.intra_mode_chroma = chroma_mode
            best_is_applied = False
            rdo_writer = SyntaxWriter.rdo_clone(bitstream_writer, 0)
            dist = self.predict_and_transform(cu, 1, qp, rdo_writer,
                                              encoder, rec_pic, helpers)
            self.cu_writer.write_residual_data(cu, 1, rdo_writer)
            dist += self.predict_and_transform(cu, 2, qp, rdo_writer,
                                               encoder, rec_pic, helpers)
            self.cu_writer.write_residual_data(cu, 2, rdo_writer)
            self.cu_writer.write_intra_prediction(cu, 1, rdo_writer)
            self.cu_writer.write_intra_prediction(cu, 2, rdo_writer)
            bits = rdo_writer.get_num_written_bits()
            cost = dist + int(bits * qp.get_lambda() + 0.5)
            if cost < best_cost:
                best_cost = cost
                best_dist = dist
                best_mode = chroma_mode
                best_is_applied = True
                self._best_state[1] = save_comp_state(cu, rec_pic, 1)
                self._best_state[2] = save_comp_state(cu, rec_pic, 2)
        cu.intra_mode_chroma = best_mode
        if not best_is_applied:
            load_comp_state(cu, rec_pic, 1, self._best_state[1])
            load_comp_state(cu, rec_pic, 2, self._best_state[2])
        return best_dist

    def _device_prepass_satd(self, cu, rec_pic):
        """All-mode SATD for one CU on the device (closed-loop refs),
        bit-identical to the host metric (weight 1.0 for luma)."""
        comp = 0
        cx, cy = cu.pos(comp)
        w, h = cu.size(comp)
        restr = self.pic.restrictions
        plane = rec_pic.plane_view(comp)
        has_left = cx > 0
        # Under XVC_INTRA_PREPASS=jax no tile cut, as in the JAX package's
        # _jax_prepass_satd: the above row may cross a tile top, where sar
        # (cut by get_cu_at) is 0.  Else the JAX package's host route's
        # references (get_ref_samples), which are cut at the tile top.
        tile_top = 0 if use_jax_intra_prepass() else self.pic.tile_ctx_top_y
        has_above = cy > tile_top
        sbl = cu.get_cu_size_below_left(comp) if has_left else 0
        sar = cu.get_cu_size_above_right(comp) if has_above else 0
        top, left = ip.compute_ref_samples(
            w, h, plane, cx, cy, has_left, has_above,
            has_left and has_above, sbl, sar, self.bitdepth, restr)
        orig = self.orig_pic.plane_view(comp)[cy:cy + h, cx:cx + w]
        return device_prepass_satd(orig, top, left, self.bitdepth,
                                   self.device)

    def predict_and_transform(self, cu, comp, qp, writer, encoder, rec_pic,
                              helpers):
        """(ref: intra_search.cc:172-186)"""
        mode = cu.get_intra_mode(comp)
        pred = helpers.predict_intra_mode(cu, comp, mode, rec_pic)
        encoder.set_pred_buffer(comp, pred)
        tx_flags = TxSearchFlags.FULL_EVAL & ~TxSearchFlags.CBF_ZERO
        cost = encoder.compress_and_eval_transform(
            cu, comp, qp, writer, self.orig_pic, tx_flags, None,
            self.cu_writer, rec_pic)
        return cost[1]

    def _determine_slow_intra_modes(self, cu, qp, bitstream_writer, encoder,
                                    rec_pic, helpers):
        """(ref: intra_search.cc:188-303); returns ordered mode list."""
        restr = self.pic.restrictions
        comp = 0
        num_intra_modes = k.NBR_INTRA_MODES_EXT \
            if not restr.disable_ext2_intra_67_modes else k.NBR_INTRA_MODES
        two_passes = not restr.disable_ext2_intra_67_modes
        cx, cy = cu.pos(comp)
        w, h = cu.size(comp)
        orig_blk = self.orig_pic.plane_view(comp)[cy:cy + h, cx:cx + w]
        evaluated = [False] * k.NBR_INTRA_MODES_EXT
        mpm = intra_modes.get_predictor_luma(cu, restr)
        modes_cost = []

        # Device transform-RD prepass short-circuit (gpu/txrd_prepass.py):
        # the SATD pre-pass + mode-eval loop is replaced by the batched
        # device ranking; the first two MPMs are appended so the exact
        # RD still sees the neighbour modes.  Mirrors the native lookup
        # (xvcn_enc.inc enc_intra_cand_lookup) bit for bit.
        if (self.txrd_cands is not None and w == h and
                cu.cu_tree == k.CuTree.PRIMARY and
                w in self.txrd_cands and cx % w == 0 and cy % h == 0 and
                cy // h < self.txrd_cands[w].shape[0] and
                cx // w < self.txrd_cands[w].shape[1]):
            entry = self.txrd_cands[w][cy // h, cx // w]
            if (entry >= 0).all():
                out = [int(m) for m in entry]
                for i in range(min(mpm.num_neighbor_modes, 2)):
                    if mpm[i] not in out:
                        out.append(mpm[i])
                return out

        # RD-equivalent fast mode: rank candidates from the whole-frame
        # open-loop device cost maps (gpu/lookahead.py) instead of
        # evaluating modes per CU.  A different (conforming) bitstream
        # from the per-CU search's, the JAX package's own.
        if (self.lookahead is not None and w == h and w in self.lookahead
                and cx % w == 0 and cy % h == 0 and
                cy // h < self.lookahead[w].shape[0] and
                cx // w < self.lookahead[w].shape[1] and
                not restr.disable_ext2_intra_67_modes):
            costs = self.lookahead[w][cy // h, cx // w]
            width_log2 = w.bit_length() - 1
            height_log2 = h.bit_length() - 1
            num_slow = _NUM_INTRA_FAST_MODES_NO_EXT[min(width_log2, 6)]
            if self.settings.fast_intra_mode_eval_level == 2:
                num_slow = _NUM_INTRA_FAST_MODES_EXT[width_log2][height_log2]
            elif self.settings.fast_intra_mode_eval_level == 0:
                num_slow = 33
            order = np.argsort(costs, kind="stable")
            out = [int(m) for m in order[:num_slow]]
            for i in range(mpm.num_neighbor_modes):
                if mpm[i] not in out:
                    out.append(mpm[i])
            return out

        # Batched device pre-pass: all 67 mode SATDs in one device call
        # against the current (closed-loop) reference samples; identical
        # values to the per-mode host loop, so the bitstream is
        # byte-identical (ref: intra_search.cc:188-303).  The native
        # pre-pass serves every other CU: one call instead of a
        # predict+metric round trip per candidate mode.
        if (w == h and 4 <= w <= 32 and
                not restr.disable_ext2_intra_67_modes and
                _intra_restrictions_default(restr)):
            satd_all = self._device_prepass_satd(cu, rec_pic)
        else:
            top, left = helpers.get_ref_samples(cu, comp, rec_pic)
            satd_all = np.empty(num_intra_modes, dtype=np.int64)
            native.lib().xvcn_intra_prepass_satd(
                top.ctypes.data, left.ctypes.data, w, h,
                0 if restr.disable_ext2_intra_67_modes else 1,
                1 if restr.disable_intra_ref_sample_filter else 0,
                1 if restr.disable_intra_dc_post_filter else 0,
                1 if restr.disable_intra_ver_hor_post_filter else 0,
                1 if restr.disable_intra_planar else 0,
                1 if (w <= 16 and h <= 16) else 0,
                orig_blk.ctypes.data, orig_blk.strides[0] // 4,
                self.bitdepth, num_intra_modes, satd_all.ctypes.data)

        def eval_mode(intra_mode):
            dist = int(satd_all[intra_mode])
            rdo_writer = SyntaxWriter.rdo_clone(bitstream_writer, 0)
            rdo_writer.write_intra_mode(intra_mode, mpm)
            bits = rdo_writer.get_num_written_bits()
            return dist + bits * qp.lambda_sqrt

        for i in range(num_intra_modes):
            if two_passes and i > 1 and (i % 2) != 0:
                modes_cost.append((i, float("inf")))
                continue
            cost = eval_mode(i)
            modes_cost.append((i, cost))
            evaluated[i] = True
        modes_cost.sort(key=lambda p: p[1])

        width_log2 = w.bit_length() - 1
        height_log2 = h.bit_length() - 1
        num_modes_for_slow_rdo = _NUM_INTRA_FAST_MODES_NO_EXT[
            min(width_log2, 6)]
        if self.settings.fast_intra_mode_eval_level == 2:
            num_modes_for_slow_rdo = \
                _NUM_INTRA_FAST_MODES_EXT[width_log2][height_log2]
        elif self.settings.fast_intra_mode_eval_level == 0:
            num_modes_for_slow_rdo = 33

        if two_passes:
            modes_added = num_modes_for_slow_rdo
            for i in range(num_modes_for_slow_rdo):
                base_mode = modes_cost[i][0]
                if base_mode <= 2 or base_mode >= k.NBR_INTRA_MODES_EXT - 1:
                    continue
                for offset in (-1, 1):
                    intra_mode = base_mode + offset
                    if evaluated[intra_mode]:
                        continue
                    cost = eval_mode(intra_mode)
                    if modes_added < len(modes_cost):
                        modes_cost[modes_added] = (intra_mode, cost)
                    else:
                        modes_cost.append((intra_mode, cost))
                    modes_added += 1
                    evaluated[intra_mode] = True
            modes_cost[:modes_added] = sorted(modes_cost[:modes_added],
                                              key=lambda p: p[1])

        out = [m for m, _ in modes_cost[:num_modes_for_slow_rdo]]
        for i in range(mpm.num_neighbor_modes):
            if mpm[i] not in out:
                out.append(mpm[i])
        return out
