"""Shared intra block prediction for decoder reconstruction and encoder RDO.

(ref: src/xvc_common_lib/intra_prediction.cc — Predict/FillReferenceState)
"""
import numpy as np

from .. import constants as k
from ..ops import intra_pred as ip


class IntraReconstructor:
    """Predicts intra blocks against a given reconstructed picture."""

    def __init__(self, pic_data, bitdepth, restrictions):
        self.pic = pic_data
        self.bitdepth = bitdepth
        self.restr = restrictions
        self._lm_cache_key = None
        self._lm_cache = None
        self._ref_scope = None   # {comp: (top, left, ftop, fleft)}
        self._ref_scope_cu = None

    def begin_ref_scope(self, cu):
        """Cache reference samples per component while the encoder's
        mode loops evaluate one CU (the reference computes the ref
        state once per CU: FillReferenceState, then Predict per mode —
        ref: intra_prediction.h:46-53).  Only valid while no OTHER CU's
        reconstruction changes; the caller scopes it around one CU's
        mode search."""
        self._ref_scope = {}
        self._ref_scope_cu = cu

    def end_ref_scope(self):
        self._ref_scope = None
        self._ref_scope_cu = None

    def _refs(self, cu, comp, rec_pic):
        scope = self._ref_scope if self._ref_scope_cu is cu else None
        if scope is not None and comp in scope:
            return scope[comp]
        cx, cy = cu.pos(comp)
        width, height = cu.size(comp)
        plane = rec_pic.plane_view(comp)
        has_left = cx > 0
        # the tile top is a virtual picture top for intra availability
        # (tile extension; 0 outside tile coding)
        tile_top = self.pic.tile_ctx_top_y
        if comp != 0:
            tile_top >>= self.pic.chroma_shift_y
        has_above = cy > tile_top
        size_below_left = cu.get_cu_size_below_left(comp) if has_left else 0
        size_above_right = cu.get_cu_size_above_right(comp) if has_above \
            else 0
        top, left = ip.compute_ref_samples(
            width, height, plane, cx, cy, has_left, has_above,
            has_left and has_above, size_below_left, size_above_right,
            self.bitdepth, self.restr)
        entry = [top, left, None, None]
        if scope is not None:
            scope[comp] = entry
        return entry

    def get_ref_samples(self, cu, comp, rec_pic):
        """(top, left) reference samples for this CU (scope-cached)."""
        entry = self._refs(cu, comp, rec_pic)
        return entry[0], entry[1]

    def predict_intra_mode(self, cu, comp, mode, rec_pic):
        restr = self.restr
        if mode == k.INTRA_MODE_LM_CHROMA:
            return self._pred_lm_chroma(cu, comp, rec_pic)
        width, height = cu.size(comp)
        entry = self._refs(cu, comp, rec_pic)
        top, left = entry[0], entry[1]
        if restr.disable_intra_planar and mode == 0:
            mode = 1
        use_filt = False
        if comp == 0:
            use_filt = ip.use_filtered_ref_samples(cu.width, cu.height,
                                                   mode, restr)
        if use_filt:
            if entry[2] is None:
                entry[2], entry[3] = ip.filter_ref_samples(width, height,
                                                           top, left)
            ftop, fleft = entry[2], entry[3]
        else:
            ftop, fleft = top, left
        post_filter = comp == 0 and width <= 16 and height <= 16
        if mode == 0:
            return ip.pred_planar(width, height, ftop, fleft)
        if mode == 1:
            return ip.pred_dc(width, height, top, left, post_filter, restr)
        return ip.pred_angular(width, height, mode, ftop, fleft,
                               post_filter, self.bitdepth, restr)

    def invalidate_lm_cache(self):
        self._lm_cache_key = None
        self._lm_cache = None

    def _pred_lm_chroma(self, cu, comp, rec_pic):
        """(ref: intra_prediction.cc:560-585)"""
        cx, cy = cu.pos(comp)
        width, height = cu.size(comp)
        max_val = (1 << self.bitdepth) - 1
        key = (id(cu), cu.pos_x, cu.pos_y, cu.width, cu.height)
        if comp == 1 or self._lm_cache_key != key:
            self._lm_cache = self._rescale_luma(cu, comp, rec_pic)
            self._lm_cache_key = key
        luma_sub = self._lm_cache
        chroma_plane = rec_pic.plane_view(comp)
        has_above = cu.pos_y > self.pic.tile_ctx_top_y
        has_left = cu.pos_x > 0
        src_above = chroma_plane[cy - 1, cx:cx + width] if has_above else None
        src_left = chroma_plane[cy:cy + height, cx - 1] if has_left else None
        ref_above = luma_sub[0, 1:1 + width] if has_above else None
        ref_left = luma_sub[1:1 + height, 0] if has_left else None
        scale, offset, shift = ip.derive_lm_params(
            width, height, has_above, has_left,
            src_above, src_left, ref_above, ref_left, self.bitdepth)
        block = luma_sub[1:1 + height, 1:1 + width].astype(np.int64)
        pred = ((scale * block) >> shift) + offset
        return np.clip(pred, 0, max_val).astype(np.int32)

    def _rescale_luma(self, cu, comp, rec_pic):
        """(ref: intra_prediction.cc:873-954), vectorized."""
        luma_plane = rec_pic.plane_view(0)
        lx, ly = cu.pos_x, cu.pos_y
        width, height = cu.size(comp)
        has_above = ly > self.pic.tile_ctx_top_y
        has_left = lx > 0
        out = np.zeros((height + 1, width + 1), dtype=np.int32)
        cf = self.pic.chroma_format
        start_y = -1 if has_above else 0
        start_x = 0 if has_left else 1
        L = luma_plane.astype(np.int32, copy=False)
        ys = np.arange(start_y, height)
        xs = np.arange(start_x, width)

        if cf == k.ChromaFormat.YUV420:
            yy = ly + 2 * ys
            if has_left:
                s = (L[yy, lx - 3] + 2 * L[yy, lx - 2] + L[yy, lx - 1] +
                     L[yy + 1, lx - 3] + 2 * L[yy + 1, lx - 2] +
                     L[yy + 1, lx - 1])
                out[ys + 1, 0] = (s + 4) >> 3
            else:
                out[ys + 1, 1] = (L[yy, lx] + L[yy + 1, lx] + 1) >> 1
            xxl = lx + 2 * xs
            s = (L[np.ix_(yy, xxl - 1)] + 2 * L[np.ix_(yy, xxl)] +
                 L[np.ix_(yy, xxl + 1)] + L[np.ix_(yy + 1, xxl - 1)] +
                 2 * L[np.ix_(yy + 1, xxl)] + L[np.ix_(yy + 1, xxl + 1)])
            out[np.ix_(ys + 1, xs + 1)] = (s + 4) >> 3
        elif cf == k.ChromaFormat.YUV444:
            if has_above:
                out[0, 1:1 + width] = luma_plane[ly - 1, lx:lx + width]
            if has_left:
                out[1:1 + height, 0] = luma_plane[ly:ly + height, lx - 1]
            out[1:1 + height, 1:1 + width] = \
                luma_plane[ly:ly + height, lx:lx + width]
        else:  # 4:2:2
            yy = ly + ys
            if has_left:
                s = L[yy, lx - 3] + 2 * L[yy, lx - 2] + L[yy, lx - 1]
                out[ys + 1, 0] = (s + 2) >> 2
            else:
                out[ys + 1, 1] = (L[yy, lx] + L[yy, lx + 1] + 1) >> 1
            xxl = lx + 2 * xs
            s = (L[np.ix_(yy, xxl - 1)] + 2 * L[np.ix_(yy, xxl)] +
                 L[np.ix_(yy, xxl + 1)])
            out[np.ix_(ys + 1, xs + 1)] = (s + 2) >> 2
        return out
