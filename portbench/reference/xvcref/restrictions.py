"""Restriction flag system (normative "profile" flags carried in bitstream).

Behavioral equivalent of the reference restriction flags
(ref: src/xvc_common_lib/restrictions.h:42-247, restrictions.cc:340-470)
with bitstream order defined by the segment header
(ref: src/xvc_dec_lib/segment_header_reader.cc:100-238,
 src/xvc_enc_lib/segment_header_writer.cc:31-214).
"""
from dataclasses import dataclass, fields, replace

# Flag groups in bitstream signaling order.  Each group is preceded by a
# one-bit group-present flag.
INTRA_FLAGS = (
    "disable_intra_ref_padding",
    "disable_intra_ref_sample_filter",
    "disable_intra_dc_post_filter",
    "disable_intra_ver_hor_post_filter",
    "disable_intra_planar",
    "disable_intra_mpm_prediction",
    "disable_intra_chroma_predictor",
)
INTER_FLAGS = (
    "disable_inter_mvp",
    "disable_inter_scaling_mvp",
    "disable_inter_tmvp_mvp",
    "disable_inter_tmvp_merge",
    "disable_inter_tmvp_ref_list_derivation",
    "disable_inter_merge_candidates",
    "disable_inter_merge_mode",
    "disable_inter_merge_bipred",
    "disable_inter_skip_mode",
    "disable_inter_chroma_subpel",
    "disable_inter_mvd_greater_than_flags",
    "disable_inter_bipred",
)
TRANSFORM_FLAGS = (
    "disable_transform_adaptive_scan_order",
    "disable_transform_residual_greater_than_flags",
    "disable_transform_residual_greater2",
    "disable_transform_last_position",
    "disable_transform_root_cbf",
    "disable_transform_cbf",
    "disable_transform_subblock_csbf",
    "disable_transform_sign_hiding",
    "disable_transform_adaptive_exp_golomb",
)
CABAC_FLAGS = (
    "disable_cabac_ctx_update",
    "disable_cabac_split_flag_ctx",
    "disable_cabac_skip_flag_ctx",
    "disable_cabac_inter_dir_ctx",
    "disable_cabac_subblock_csbf_ctx",
    "disable_cabac_coeff_sig_ctx",
    "disable_cabac_coeff_greater1_ctx",
    "disable_cabac_coeff_greater2_ctx",
    "disable_cabac_coeff_last_pos_ctx",
    "disable_cabac_init_per_pic_type",
    "disable_cabac_init_per_qp",
)
DEBLOCK_FLAGS = (
    "disable_deblock_strong_filter",
    "disable_deblock_weak_filter",
    "disable_deblock_chroma_filter",
    "disable_deblock_boundary_strength_zero",
    "disable_deblock_boundary_strength_one",
    "disable_deblock_initial_sample_decision",
    "disable_deblock_weak_sample_decision",
    "disable_deblock_two_samples_weak_filter",
    "disable_deblock_depending_on_qp",
)
HIGH_LEVEL_FLAGS = (
    "disable_high_level_default_checksum_method",
)
EXT_FLAGS = (
    "disable_ext_sink",
    "disable_ext_implicit_last_ctu",
    "disable_ext_tmvp_full_resolution",
    "disable_ext_tmvp_exclude_intra_from_ref_list",
    "disable_ext_ref_list_l0_trim",
    "disable_ext_implicit_partition_type",
    "disable_ext_cabac_alt_split_flag_ctx",
    "disable_ext_cabac_alt_inter_dir_ctx",
    "disable_ext_cabac_alt_last_pos_ctx",
    "disable_ext_two_cu_trees",
    "disable_ext_transform_size_64",
    "disable_ext_intra_unrestricted_predictor",
    "disable_ext_deblock_subblock_size_4",
)
EXT2_FLAGS = (
    "disable_ext2_intra_67_modes",
    "disable_ext2_intra_6_predictors",
    "disable_ext2_intra_chroma_from_luma",
    "disable_ext2_inter_adaptive_fullpel_mv",
    "disable_ext2_inter_affine",
    "disable_ext2_inter_affine_merge",
    "disable_ext2_inter_affine_mvp",
    "disable_ext2_inter_bipred_l1_mvd_zero",
    "disable_ext2_inter_high_precision_mv",
    "disable_ext2_inter_local_illumination_comp",
    "disable_ext2_transform_skip",
    "disable_ext2_transform_high_precision",
    "disable_ext2_transform_select",
    "disable_ext2_transform_dst",
    "disable_ext2_cabac_alt_residual_ctx",
)

GROUPS = (INTRA_FLAGS, INTER_FLAGS, TRANSFORM_FLAGS, CABAC_FLAGS,
          DEBLOCK_FLAGS, HIGH_LEVEL_FLAGS, EXT_FLAGS, EXT2_FLAGS)

ALL_FLAGS = tuple(f for g in GROUPS for f in g)

_fields_src = "\n".join(f"    {name}: bool = False" for name in ALL_FLAGS)
exec(f"""
@dataclass
class Restrictions:
{_fields_src}

    def copy(self):
        return replace(self)
""")


def read_restrictions(bit_reader, major_version: int) -> "Restrictions":
    """Parse restriction flags from a segment header."""
    restr = Restrictions()
    n_groups = 8 if major_version > 1 else 7
    for gi in range(n_groups):
        group = GROUPS[gi]
        if bit_reader.read_bit():
            for name in group:
                if bit_reader.read_bit():
                    setattr(restr, name, True)
    if major_version <= 1:
        for name in EXT2_FLAGS:
            setattr(restr, name, True)
        restr.disable_ext2_transform_dst = False
    return restr


class RestrictedMode:
    """(ref: restrictions.h RestrictedMode)"""
    UNRESTRICTED = 0
    MODE_A = 1
    MODE_B = 2
    MODE_C = 3
    MODE_D = 4


_MODE_AB_FLAGS = (
    "disable_ext_implicit_last_ctu",
    "disable_ext_tmvp_full_resolution",
    "disable_ext_tmvp_exclude_intra_from_ref_list",
    "disable_ext_ref_list_l0_trim",
    "disable_ext_intra_unrestricted_predictor",
)

_MODE_A_FLAGS = (
    "disable_ext_sink",
    "disable_ext_implicit_partition_type",
    "disable_ext_cabac_alt_split_flag_ctx",
    "disable_ext_cabac_alt_inter_dir_ctx",
    "disable_ext_cabac_alt_last_pos_ctx",
    "disable_ext_two_cu_trees",
    "disable_ext_transform_size_64",
    "disable_ext_deblock_subblock_size_4",
    "disable_ext2_intra_67_modes",
    "disable_ext2_intra_6_predictors",
    "disable_ext2_intra_chroma_from_luma",
    "disable_ext2_inter_adaptive_fullpel_mv",
    "disable_ext2_inter_affine",
    "disable_ext2_inter_affine_merge",
    "disable_ext2_inter_high_precision_mv",
    "disable_ext2_inter_local_illumination_comp",
    "disable_ext2_transform_high_precision",
    "disable_ext2_transform_select",
    "disable_ext2_cabac_alt_residual_ctx",
)

# Mode C toggles (inverts) this list (ref: restrictions.cc:373-443)
_MODE_C_TOGGLE_FLAGS = (
    "disable_intra_ref_sample_filter",
    "disable_intra_dc_post_filter",
    "disable_intra_ver_hor_post_filter",
    "disable_inter_mvp",
    "disable_inter_scaling_mvp",
    "disable_inter_tmvp_mvp",
    "disable_inter_tmvp_ref_list_derivation",
    "disable_inter_merge_bipred",
    "disable_inter_skip_mode",
    "disable_inter_mvd_greater_than_flags",
    "disable_transform_adaptive_scan_order",
    "disable_transform_residual_greater2",
    "disable_transform_root_cbf",
    "disable_transform_subblock_csbf",
    "disable_transform_sign_hiding",
    "disable_transform_adaptive_exp_golomb",
    "disable_cabac_skip_flag_ctx",
    "disable_cabac_inter_dir_ctx",
    "disable_cabac_subblock_csbf_ctx",
    "disable_cabac_coeff_greater2_ctx",
    "disable_cabac_coeff_last_pos_ctx",
    "disable_cabac_init_per_pic_type",
    "disable_cabac_init_per_qp",
    "disable_deblock_strong_filter",
    "disable_deblock_boundary_strength_zero",
    "disable_deblock_boundary_strength_one",
    "disable_deblock_weak_sample_decision",
    "disable_deblock_two_samples_weak_filter",
    "disable_ext_sink",
    "disable_ext_implicit_last_ctu",
    "disable_ext_tmvp_full_resolution",
    "disable_ext_tmvp_exclude_intra_from_ref_list",
    "disable_ext_ref_list_l0_trim",
    "disable_ext_implicit_partition_type",
    "disable_ext_cabac_alt_split_flag_ctx",
    "disable_ext_cabac_alt_inter_dir_ctx",
    "disable_ext_cabac_alt_last_pos_ctx",
    "disable_ext_two_cu_trees",
    "disable_ext_intra_unrestricted_predictor",
    "disable_ext_deblock_subblock_size_4",
    "disable_ext2_intra_67_modes",
    "disable_ext2_intra_6_predictors",
    "disable_ext2_inter_adaptive_fullpel_mv",
    "disable_ext2_inter_affine",
    "disable_ext2_inter_affine_merge",
    "disable_ext2_inter_affine_mvp",
    "disable_ext2_inter_bipred_l1_mvd_zero",
    "disable_ext2_inter_high_precision_mv",
    "disable_ext2_inter_local_illumination_comp",
    "disable_ext2_transform_skip",
    "disable_ext2_transform_high_precision",
    "disable_ext2_transform_dst",
)

_MODE_D_FLAGS = _MODE_AB_FLAGS + (
    "disable_ext_sink",
    "disable_ext_two_cu_trees",
    "disable_ext2_intra_67_modes",
    "disable_ext2_intra_6_predictors",
    "disable_ext2_intra_chroma_from_luma",
    "disable_ext2_inter_adaptive_fullpel_mv",
    "disable_ext2_inter_affine",
    "disable_ext2_inter_affine_merge",
    "disable_ext2_inter_high_precision_mv",
    "disable_ext2_inter_local_illumination_comp",
    "disable_ext2_transform_high_precision",
    "disable_ext2_transform_select",
    "disable_ext2_cabac_alt_residual_ctx",
    "disable_intra_dc_post_filter",
    "disable_intra_ver_hor_post_filter",
    "disable_transform_sign_hiding",
    "disable_transform_adaptive_scan_order",
    "disable_ext2_transform_dst",
)

# Mode C requires every flag in this list set for baseline conformance
_BASELINE_FLAGS = _MODE_C_TOGGLE_FLAGS
