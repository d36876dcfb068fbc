"""CABAC context families: layout, qp/pic-type initialization, selection.

Behavioral equivalent of the reference context system
(ref: src/xvc_common_lib/cabac.{h,cc}).  Contexts live in one flat uint8
array; a "context" is an integer index into it, which maps directly onto
the native C engine and keeps Python overhead minimal.
"""
import numpy as np

from .. import constants as k
from . import context_model as cm

_D = 154  # kDef placeholder used by the reference for undetermined values
_N = 0    # kNotUsed

# Family sizes (ref: cabac.h:36-85)
FAMILIES = [
    ("cu_cbf_luma", 1), ("cu_cbf_chroma", 1),
    ("cu_part_size", 4), ("cu_pred_mode", 1), ("cu_root_cbf", 1),
    ("cu_skip_flag", 3), ("cu_split_quad_flag", 5), ("cu_split_binary", 6),
    ("inter_dir", 5), ("inter_fullpel_mv", 3),
    ("inter_merge_flag", 1), ("inter_merge_idx", 1),
    ("inter_mvd", 2), ("inter_mvp_idx", 1), ("inter_ref_idx", 2),
    ("intra_pred_luma", 9), ("intra_pred_chroma", 2),
    ("affine_flag", 3), ("lic_flag", 1), ("delta_qp", 3),
    ("coeff_csbf_luma", 2), ("coeff_csbf_chroma", 2),
    ("coeff_sig_luma", 27), ("coeff_sig_chroma", 15),
    ("coeff_greater1_luma", 16), ("coeff_greater1_chroma", 8),
    ("coeff_greater2_luma", 4), ("coeff_greater2_chroma", 2),
    ("coeff_ext_csbf_luma", 2), ("coeff_ext_csbf_chroma", 2),
    ("coeff_ext_sig_luma", 54), ("coeff_ext_sig_chroma", 12),
    ("coeff_ext_greater1_luma", 16), ("coeff_ext_greater1_chroma", 6),
    ("coeff_last_pos_x_luma", 25), ("coeff_last_pos_x_chroma", 3),
    ("coeff_last_pos_y_luma", 25), ("coeff_last_pos_y_chroma", 3),
    ("transform_skip_flag", 2), ("transform_select_flag", 6),
    ("transform_select_idx", 4),
]

OFFSETS = {}
_off = 0
for _name, _size in FAMILIES:
    OFFSETS[_name] = _off
    _off += _size
NUM_CONTEXTS = _off

# Initialization values per pic type (rows: kBi=0, kUni=1, kIntra=2)
# (ref: cabac.cc:35-280)
INIT_VALUES = {
    "cu_split_quad_flag": [[107, 139, 126, 255, 0],
                           [107, 139, 126, 255, 0],
                           [139, 141, 157, 255, 0]],
    "cu_split_binary": [[107, 139, 126, 154, 154, 154],
                        [107, 139, 126, 154, 154, 154],
                        [139, 141, 157, 154, 154, 154]],
    "cu_skip_flag": [[197, 185, 201], [197, 185, 201], [_N, _N, _N]],
    "inter_merge_flag": [[154], [110], [_N]],
    "inter_merge_idx": [[137], [122], [_N]],
    "cu_part_size": [[154, 139, 154, 154],
                     [154, 139, 154, 154],
                     [184, _N, _N, _N]],
    "cu_pred_mode": [[134], [149], [_N]],
    "intra_pred_luma": [[183] + [_D] * 8, [154] + [_D] * 8, [184] + [_D] * 8],
    "intra_pred_chroma": [[152, 139], [152, 139], [63, 139]],
    "inter_dir": [[95, 79, 63, 31, 31], [95, 79, 63, 31, 31],
                  [_N, _N, _N, _N, _N]],
    "inter_fullpel_mv": [[197, 185, 201], [197, 185, 201], [_N, _N, _N]],
    "affine_flag": [[197, 185, 201], [197, 185, 201], [_N, _N, _N]],
    "lic_flag": [[154], [154], [_N]],
    "inter_mvd": [[169, 198], [140, 198], [_N, _N]],
    "inter_ref_idx": [[153, 153], [153, 153], [_N, _N]],
    "delta_qp": [[154, 154, 154], [154, 154, 154], [154, 154, 154]],
    "cu_cbf": [[111, 149], [111, 149], [141, 94]],
    "cu_root_cbf": [[79], [79], [_N]],
    "last_pos": [
        [125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111,
         79, 126, 111, 111, 79, _D, _D, _D, _D, _D, _D, 108, 123, 93],
        [125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94,
         111, 111, 95, 94, _D, _D, _D, _D, _D, _D, 108, 123, 108],
        [110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127,
         111, 79, 143, 127, 111, 79, _D, _D, _D, _D, _D, _D, 108, 123, 63]],
    "subblock_csbf": [[121, 140, 61, 154], [121, 140, 61, 154],
                      [91, 171, 134, 141]],
    "ext_subblock_csbf": [[122, 143, 91, 141], [61, 154, 78, 111],
                          [135, 155, 104, 139]],
    "coeff_sig": [
        [170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140, 136, 153,
         154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 170,
         153, 138, 138, 122, 121, 122, 121, 167, 151, 183, 140, 151, 183, 140],
        [155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140, 136, 153,
         154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 170,
         153, 123, 123, 107, 121, 107, 121, 167, 151, 183, 140, 151, 183, 140],
        [111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179, 153,
         125, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153, 125, 140,
         139, 182, 182, 152, 136, 152, 136, 153, 136, 139, 111, 136, 139,
         111]],
    "ext_coeff_sig": [
        [107, 139, 154, 140, 140, 141, 108, 154, 125, 155, 126, 127, 139, 155,
         155, 141, 156, 143, 107, 139, 154, 140, 140, 141, 108, 154, 125, 155,
         126, 127, 139, 155, 155, 141, 156, 143, 107, 139, 154, 140, 140, 141,
         108, 154, 125, 155, 126, 127, 139, 155, 155, 141, 156, 143, 137, 154,
         154, 155, 155, 156, 124, 185, 156, 171, 142, 158],
        [121, 167, 153, 139, 154, 140, 137, 168, 139, 154, 169, 155, 167, 169,
         169, 184, 199, 156, 121, 167, 153, 139, 154, 140, 137, 168, 139, 154,
         169, 155, 167, 169, 169, 184, 199, 156, 121, 167, 153, 139, 154, 140,
         137, 168, 139, 154, 169, 155, 167, 169, 169, 184, 199, 156, 136, 153,
         139, 154, 125, 140, 122, 154, 184, 185, 171, 157],
        [152, 139, 154, 154, 169, 155, 182, 154, 169, 184, 155, 141, 168, 214,
         199, 170, 170, 171, 152, 139, 154, 154, 169, 155, 182, 154, 169, 184,
         155, 141, 168, 214, 199, 170, 170, 171, 152, 139, 154, 154, 169, 155,
         182, 154, 169, 184, 155, 141, 168, 214, 199, 170, 170, 171, 167, 154,
         169, 140, 155, 141, 153, 171, 185, 156, 171, 172]],
    "coeff_greater1": [
        [154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121,
         136, 122, 169, 208, 166, 167, 154, 152, 167, 182],
        [154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121,
         136, 137, 169, 194, 166, 167, 154, 167, 137, 182],
        [140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139, 107,
         122, 152, 140, 179, 166, 182, 140, 227, 122, 197]],
    "ext_coeff_greater1": [
        [121, 135, 123, 124, 139, 125, 92, 124, 154, 125, 155, 138, 169, 155,
         170, 156, 166, 152, 140, 170, 171, 157],
        [165, 75, 152, 153, 139, 154, 121, 138, 139, 154, 140, 167, 183, 169,
         170, 156, 193, 181, 169, 170, 171, 172],
        [196, 105, 152, 153, 139, 154, 136, 138, 139, 169, 140, 196, 183, 169,
         170, 171, 195, 181, 169, 170, 156, 157]],
    "coeff_greater2": [[107, 167, 91, 107, 107, 167],
                       [107, 167, 91, 122, 107, 167],
                       [138, 153, 136, 167, 152, 152]],
    "inter_mvp_idx": [[168], [168], [_N]],
    "transform_skip_flag": [[139, 139], [139, 139], [139, 139]],
    "transform_select_flag": [[_D] * 6] * 3,
    "transform_select_idx": [[_D] * 4] * 3,
}

# intra mode -> predictor-context map (ref: cabac.cc:446-461)
_MODE_TO_CTX_EXT = np.array(
    [1, 1] + [2] * 33 + [3] * 32, dtype=np.int32)
_MODE_TO_CTX = np.array(
    [1, 1] + [2] * 17 + [3] * 16, dtype=np.int32)

_CTX_INDEX_MAP_4x4 = np.array(
    [0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8], dtype=np.int32)


def _size_to_log2(s):
    return s.bit_length() - 1


_RESET_CACHE = {}  # (qp, pic_type, alt_residual) -> initialized states


class CabacContexts:
    """Flat context-state array + selection logic."""

    def __init__(self, restrictions):
        self.restr = restrictions
        self.state = np.zeros(NUM_CONTEXTS, dtype=np.uint8)

    def reset_states(self, qp_raw_luma: int, pic_type: int):
        r = self.restr
        q = 32 if r.disable_cabac_init_per_qp else qp_raw_luma
        s = (int(k.PicturePredictionType.BI)
             if r.disable_cabac_init_per_pic_type else int(pic_type))
        # the init table is pure in (q, s, alt-residual flag); cache the
        # whole state vector (the per-context Python loop costs ~0.5 ms
        # per picture otherwise)
        key = (q, s, bool(r.disable_ext2_cabac_alt_residual_ctx))
        cached = _RESET_CACHE.get(key)
        if cached is not None:
            self.state[:] = cached
            return
        st = self.state

        def init(name, values, offset=None):
            base = OFFSETS[name] if offset is None else offset
            for i, v in enumerate(values):
                st[base + i] = cm.init_state(q, v)

        iv = INIT_VALUES
        init("cu_cbf_luma", iv["cu_cbf"][s][:1])
        init("cu_cbf_chroma", iv["cu_cbf"][s][1:])
        init("cu_part_size", iv["cu_part_size"][s])
        init("cu_pred_mode", iv["cu_pred_mode"][s])
        init("cu_root_cbf", iv["cu_root_cbf"][s])
        init("cu_skip_flag", iv["cu_skip_flag"][s])
        init("cu_split_quad_flag", iv["cu_split_quad_flag"][s])
        init("cu_split_binary", iv["cu_split_binary"][s])
        init("inter_dir", iv["inter_dir"][s])
        init("inter_fullpel_mv", iv["inter_fullpel_mv"][s])
        init("inter_merge_flag", iv["inter_merge_flag"][s])
        init("inter_merge_idx", iv["inter_merge_idx"][s])
        init("inter_mvd", iv["inter_mvd"][s])
        init("inter_mvp_idx", iv["inter_mvp_idx"][s])
        init("inter_ref_idx", iv["inter_ref_idx"][s])
        init("intra_pred_luma", iv["intra_pred_luma"][s])
        init("intra_pred_chroma", iv["intra_pred_chroma"][s])
        init("affine_flag", iv["affine_flag"][s])
        init("lic_flag", iv["lic_flag"][s])
        init("delta_qp", iv["delta_qp"][s])
        if not r.disable_ext2_cabac_alt_residual_ctx:
            init("coeff_ext_csbf_luma", iv["ext_subblock_csbf"][s][:2])
            init("coeff_ext_csbf_chroma", iv["ext_subblock_csbf"][s][2:])
            init("coeff_ext_sig_luma", iv["ext_coeff_sig"][s][:54])
            init("coeff_ext_sig_chroma", iv["ext_coeff_sig"][s][54:])
            init("coeff_ext_greater1_luma", iv["ext_coeff_greater1"][s][:16])
            init("coeff_ext_greater1_chroma", iv["ext_coeff_greater1"][s][16:])
        else:
            init("coeff_csbf_luma", iv["subblock_csbf"][s][:2])
            init("coeff_csbf_chroma", iv["subblock_csbf"][s][2:])
            init("coeff_sig_luma", iv["coeff_sig"][s][:27])
            init("coeff_sig_chroma", iv["coeff_sig"][s][27:])
            init("coeff_greater1_luma", iv["coeff_greater1"][s][:16])
            init("coeff_greater1_chroma", iv["coeff_greater1"][s][16:])
            init("coeff_greater2_luma", iv["coeff_greater2"][s][:4])
            init("coeff_greater2_chroma", iv["coeff_greater2"][s][4:])
        init("coeff_last_pos_x_luma", iv["last_pos"][s][:25])
        init("coeff_last_pos_x_chroma", iv["last_pos"][s][25:])
        init("coeff_last_pos_y_luma", iv["last_pos"][s][:25])
        init("coeff_last_pos_y_chroma", iv["last_pos"][s][25:])
        init("transform_skip_flag", iv["transform_skip_flag"][s])
        init("transform_select_flag", iv["transform_select_flag"][s])
        init("transform_select_idx", iv["transform_select_idx"][s])
        _RESET_CACHE[key] = st.copy()

    # ---- context selection (returns integer index into self.state) ----

    def get_affine_ctx(self, cu_left, cu_above):
        offset = 0
        if cu_left is not None and cu_left.use_affine:
            offset += 1
        if cu_above is not None and cu_above.use_affine:
            offset += 1
        return OFFSETS["affine_flag"] + offset

    def get_skip_flag_ctx(self, cu_left, cu_above):
        offset = 0
        if not self.restr.disable_cabac_skip_flag_ctx:
            if cu_left is not None and cu_left.skip_flag:
                offset += 1
            if cu_above is not None and cu_above.skip_flag:
                offset += 1
        return OFFSETS["cu_skip_flag"] + offset

    def get_split_binary_ctx(self, cu):
        left, above = cu.get_cu_left(), cu.get_cu_above()
        depth = (cu.depth << 1) + cu.binary_depth
        offset = 0
        if left is not None:
            offset += 1 if ((left.depth << 1) + left.binary_depth) > depth \
                else 0
        if above is not None:
            offset += 1 if ((above.depth << 1) + above.binary_depth) > depth \
                else 0
        return OFFSETS["cu_split_binary"] + offset

    def get_split_flag_ctx(self, cu, pic_max_depth):
        offset = 0
        left, above = cu.get_cu_left(), cu.get_cu_above()
        if not self.restr.disable_cabac_split_flag_ctx:
            if left is not None:
                offset += 1 if left.depth > cu.depth else 0
            if above is not None:
                offset += 1 if above.depth > cu.depth else 0
        if not self.restr.disable_ext_cabac_alt_split_flag_ctx:
            min_depth = pic_max_depth
            max_depth = 0
            for tmp in (left, above):
                if tmp is not None:
                    min_depth = min(min_depth, tmp.depth)
                    max_depth = max(max_depth, tmp.depth)
                else:
                    min_depth = 0
                    max_depth = pic_max_depth
            min_depth = max(0, min_depth - 1)
            max_depth = min(pic_max_depth, max_depth + 1)
            if cu.depth < min_depth:
                offset = 3
            elif cu.depth >= max_depth + 1:
                offset = 4
        return OFFSETS["cu_split_quad_flag"] + offset

    def get_intra_predictor_ctx(self, intra_mode):
        if self.restr.disable_ext2_intra_67_modes:
            return OFFSETS["intra_pred_luma"] + int(_MODE_TO_CTX[intra_mode])
        return OFFSETS["intra_pred_luma"] + int(_MODE_TO_CTX_EXT[intra_mode])

    def get_inter_dir_bi_ctx(self, cu):
        if self.restr.disable_cabac_inter_dir_ctx:
            return OFFSETS["inter_dir"]
        idx = min(cu.depth, 4)
        if not self.restr.disable_ext_cabac_alt_inter_dir_ctx:
            log2_size = (_size_to_log2(cu.width) +
                         _size_to_log2(cu.height) + 1) >> 1
            idx = min(max(7 - log2_size, 0), 3)
        return OFFSETS["inter_dir"] + idx

    def get_inter_fullpel_mv_ctx(self, cu_left, cu_above):
        offset = 0
        if cu_left is not None and cu_left.fullpel_mv:
            offset += 1
        if cu_above is not None and cu_above.fullpel_mv:
            offset += 1
        return OFFSETS["inter_fullpel_mv"] + offset

    def get_subblock_csbf_ctx(self, is_luma, sublock_csbf, posx, posy,
                              width, height):
        """Returns (ctx_idx, pattern_sig_ctx)."""
        right = 0
        below = 0
        if not self.restr.disable_ext2_cabac_alt_residual_ctx:
            base = OFFSETS["coeff_ext_csbf_luma"] if is_luma else \
                OFFSETS["coeff_ext_csbf_chroma"]
        else:
            base = OFFSETS["coeff_csbf_luma"] if is_luma else \
                OFFSETS["coeff_csbf_chroma"]
        if posx < width - 1:
            right = 1 if sublock_csbf[posy * width + posx + 1] else 0
        if posy < height - 1:
            below = 1 if sublock_csbf[(posy + 1) * width + posx] else 0
        pattern_sig_ctx = right + (below << 1)
        if self.restr.disable_cabac_subblock_csbf_ctx:
            return base, pattern_sig_ctx
        return base + (right | below), pattern_sig_ctx

    def get_coeff_sig_ctx(self, is_luma, pattern_sig_ctx, scan_order,
                          posx, posy, coeff, width_log2, height_log2):
        """coeff: 2-D numpy int array holding partially-decoded levels."""
        if not self.restr.disable_ext2_cabac_alt_residual_ctx:
            width = 1 << width_log2
            height = 1 << height_log2
            size = (width_log2 + height_log2) >> 1
            posxy = posx + posy
            if self.restr.disable_cabac_coeff_sig_ctx:
                return OFFSETS["coeff_ext_sig_luma"]
            offset = 0
            if posx < width - 1:
                offset += 1 if coeff[posy, posx + 1] else 0
                if posx < width - 2:
                    offset += 1 if coeff[posy, posx + 2] else 0
                if posy < height - 1:
                    offset += 1 if coeff[posy + 1, posx + 1] else 0
            if posy < height - 1:
                offset += 1 if coeff[posy + 1, posx] else 0
                if posy < height - 2:
                    offset += 1 if coeff[posy + 2, posx] else 0
            offset = min(offset, 5)
            start_offset = 6 if posxy < 2 else 0
            start_offset += 6 if (is_luma and posxy < 5) else 0
            if size > 2 and is_luma:
                start_offset += 18 << min(1, size - 3)
            base = OFFSETS["coeff_ext_sig_luma"] if is_luma else \
                OFFSETS["coeff_ext_sig_chroma"]
            return base + start_offset + offset
        else:
            base = OFFSETS["coeff_sig_luma"] if is_luma else \
                OFFSETS["coeff_sig_chroma"]
            if (posx == 0 and posy == 0) or \
                    self.restr.disable_cabac_coeff_sig_ctx:
                return base
            if width_log2 == 2 and height_log2 == 2:
                return base + int(_CTX_INDEX_MAP_4x4[4 * posy + posx])
            start_offset = 21 if is_luma else 12
            if width_log2 == 3 and height_log2 == 3:
                start_offset = 9 if scan_order == k.ScanOrder.DIAGONAL else 15
            pos_x_in_subset = posx & 3
            pos_y_in_subset = posy & 3
            if pattern_sig_ctx == 0:
                if pos_x_in_subset + pos_y_in_subset <= 2:
                    cnt = 2 if pos_x_in_subset + pos_y_in_subset == 0 else 1
                else:
                    cnt = 0
            elif pattern_sig_ctx == 1:
                cnt = (2 if pos_y_in_subset == 0 else 1) \
                    if pos_y_in_subset <= 1 else 0
            elif pattern_sig_ctx == 2:
                cnt = (2 if pos_x_in_subset == 0 else 1) \
                    if pos_x_in_subset <= 1 else 0
            else:
                cnt = 2
            comp_offset = 3 if (is_luma and
                                ((posx >> 2) + (posy >> 2)) > 0) else 0
            return base + start_offset + comp_offset + cnt

    def _ext_greater_ctx(self, is_luma, posx, posy, is_last_coeff,
                         coeff, width, height, threshold):
        posxy = posx + posy
        base_l = OFFSETS["coeff_ext_greater1_luma"]
        base_c = OFFSETS["coeff_ext_greater1_chroma"]
        if is_last_coeff:
            return base_l if is_luma else base_c
        offset = 0
        if posx < width - 1:
            offset += 1 if abs(int(coeff[posy, posx + 1])) > threshold else 0
            if posx < width - 2:
                offset += 1 if abs(int(coeff[posy, posx + 2])) > threshold \
                    else 0
            if posy < height - 1:
                offset += (1 if abs(int(coeff[posy + 1, posx + 1])) > threshold
                           else 0)
        if posy < height - 1:
            offset += 1 if abs(int(coeff[posy + 1, posx])) > threshold else 0
            if posy < height - 2:
                offset += 1 if abs(int(coeff[posy + 2, posx])) > threshold \
                    else 0
        offset = min(offset, 4) + 1
        if is_luma:
            start_offset = 10 if posxy < 3 else (5 if posxy < 10 else 0)
            return base_l + start_offset + offset
        return base_c + offset

    def get_coeff_greater1_ctx(self, is_luma, ctx_set, c1, posx, posy,
                               is_last_coeff, coeff, width, height):
        if not self.restr.disable_ext2_cabac_alt_residual_ctx:
            if self.restr.disable_cabac_coeff_greater1_ctx:
                return OFFSETS["coeff_ext_greater1_luma"] if is_luma else \
                    OFFSETS["coeff_ext_greater1_chroma"]
            return self._ext_greater_ctx(is_luma, posx, posy, is_last_coeff,
                                         coeff, width, height, 1)
        if self.restr.disable_cabac_coeff_greater1_ctx:
            return OFFSETS["coeff_greater1_luma"] if is_luma else \
                OFFSETS["coeff_greater1_chroma"]
        offset = 4 * ctx_set + c1
        return (OFFSETS["coeff_greater1_luma"] if is_luma else
                OFFSETS["coeff_greater1_chroma"]) + offset

    def get_coeff_greater2_ctx(self, is_luma, ctx_set, posx, posy,
                               is_last_coeff, coeff, width, height):
        if not self.restr.disable_ext2_cabac_alt_residual_ctx:
            if self.restr.disable_cabac_coeff_greater2_ctx:
                return OFFSETS["coeff_ext_greater1_luma"] if is_luma else \
                    OFFSETS["coeff_ext_greater1_chroma"]
            return self._ext_greater_ctx(is_luma, posx, posy, is_last_coeff,
                                         coeff, width, height, 2)
        if self.restr.disable_cabac_coeff_greater2_ctx:
            return OFFSETS["coeff_ext_greater1_luma"] if is_luma else \
                OFFSETS["coeff_ext_greater1_chroma"]
        return (OFFSETS["coeff_greater2_luma"] if is_luma else
                OFFSETS["coeff_greater2_chroma"]) + ctx_set

    def get_coeff_golomb_rice_k(self, posx, posy, width, height, coeff):
        offset = 0
        num = 0
        if posx < width - 1:
            c = int(coeff[posy, posx + 1])
            offset += abs(c)
            num += 1 if c else 0
            if posx < width - 2:
                c = int(coeff[posy, posx + 2])
                offset += abs(c)
                num += 1 if c else 0
            if posy < height - 1:
                c = int(coeff[posy + 1, posx + 1])
                offset += abs(c)
                num += 1 if c else 0
        if posy < height - 1:
            c = int(coeff[posy + 1, posx])
            offset += abs(c)
            num += 1 if c else 0
            if posy < height - 2:
                c = int(coeff[posy + 2, posx])
                offset += abs(c)
                num += 1 if c else 0
        threshold = 4 + offset - num
        for kk in range(10):
            if (1 << (kk + 3)) > threshold:
                return kk
        return 9

    def get_coeff_last_pos_ctx(self, is_luma, width, height, pos, is_pos_x):
        size = width if is_pos_x else height
        r = self.restr
        if is_luma:
            base = OFFSETS["coeff_last_pos_x_luma"] if is_pos_x else \
                OFFSETS["coeff_last_pos_y_luma"]
            if (r.disable_cabac_coeff_last_pos_ctx and
                    r.disable_ext_cabac_alt_last_pos_ctx):
                return base
            if not r.disable_ext_cabac_alt_last_pos_ctx:
                offset_map = (0, 0, 0, 3, 6, 10, 15, 21)
                size_log2 = _size_to_log2(size)
                offset = offset_map[size_log2]
                shift = (size_log2 + 1) >> 2
            else:
                size_bits = _size_to_log2(size) - 2
                offset = size_bits * 3 + ((size_bits + 1) >> 2)
                shift = (size_bits + 3) >> 2
            return base + offset + (pos >> shift)
        base = OFFSETS["coeff_last_pos_x_chroma"] if is_pos_x else \
            OFFSETS["coeff_last_pos_y_chroma"]
        if (r.disable_cabac_coeff_last_pos_ctx and
                r.disable_ext_cabac_alt_last_pos_ctx):
            return base
        if not r.disable_ext_cabac_alt_last_pos_ctx:
            shift = min(max(size >> 3, 0), 2)
        else:
            shift = _size_to_log2(size) - 2
        return base + (pos >> shift)
