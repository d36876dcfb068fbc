"""Encoder tuning settings with speed-mode presets.

Behavioral equivalent of the reference settings
(ref: src/xvc_enc_lib/encoder_settings.{h,cc}).  Copy of
``xvc_tpu/codec/encoder_settings.py``.  The settings that need the
Python CU encoder (``tpu_intra_lookahead``, ``tile_rows >= 2``) route
the session there (``native/enc.usable_for``); the port rejects
``multihost_gop`` (``codec/encoder.py``); speed mode 3
(``SpeedMode.TPU``) runs the split DP and the transform-RD prepass on
the card.
"""
from dataclasses import dataclass


class SpeedMode:
    PLACEBO = 0
    SLOW = 1
    FAST = 2
    # xvc_tpu extension (not in the reference): FAST knobs + the device
    # bottom-up split DP (tpu/wavefront_rdo.py) pruning the CU
    # recursion from batched cost maps.  Conforming, reference-
    # decodable streams; bitstream differs from speed 2.
    TPU = 3


class TuneMode:
    DEFAULT = 0
    PSNR = 1


class RestrictedModeIds:
    UNRESTRICTED = 0
    MODE_A = 1
    MODE_B = 2
    MODE_C = 3
    MODE_D = 4


@dataclass
class EncoderSettings:
    # rdo behavior (compile-time in the reference)
    encoder_strict_rdo_bit_counting: bool = False
    encoder_count_actual_written_bits: bool = True
    rdo_quant: bool = True
    fast_cu_split_based_on_full_cu: bool = True
    fast_mode_selection_for_cached_cu: bool = True
    skip_mode_decision_for_identical_cu: bool = False
    fast_inter_transform_dist: bool = True
    fast_inter_root_cbf_zero_bits: bool = False
    inter_search_range_bi: int = 4

    # speed mode dependent
    inter_search_range_uni_max: int = 256
    inter_search_range_uni_min: int = 96
    bipred_refinement_iterations: int = -1
    always_evaluate_intra_in_inter: int = -1
    default_num_ref_pics: int = -1
    max_binary_split_depth: int = -1
    fast_transform_select_eval: int = -1
    fast_intra_mode_eval_level: int = -1
    fast_transform_size_64: int = -1
    fast_transform_select: int = -1
    fast_inter_local_illumination_comp: int = -1
    fast_inter_adaptive_fullpel_mv: int = -1

    # TPU lookahead speed feature (this framework only, not in the
    # reference): one whole-frame open-loop 67-mode SATD analysis on the
    # device replaces the per-CU closed-loop mode pre-pass ranking.
    # RD-equivalent fast mode: the bitstream differs from the reference
    # (mode candidate ordering comes from open-loop costs) but stays
    # conforming; enable via
    #   -explicit-encoder-settings "tpu_intra_lookahead 1"
    tpu_intra_lookahead: int = 0
    # batched bottom-up split RDO: force quad-split decisions from the
    # device lookahead maps via a vectorized DP (tpu/wavefront_rdo.py);
    # implies tpu_intra_lookahead for intra pictures
    tpu_split_dp: int = 0
    # device transform-RD intra mode prepass (tpu/txrd_prepass.py):
    # K > 0 keeps only the top-K transform-aware candidates per aligned
    # square block for the full RD search (native or Python), replacing
    # the per-CU SATD pre-pass + 67-mode eval loop.  Conforming fast
    # mode; open-loop ranking => different bitstream.  Enable via
    #   -explicit-encoder-settings "tpu_txrd_prepass 2"
    tpu_txrd_prepass: int = 0
    # CTU-tile-row extension (this framework only): >= 2 splits each
    # picture into that many CTU-row tiles with independent CABAC
    # contexts and prediction cut at tile tops, for in-picture parallel
    # decode/encode across chips.  The stream is rfe-flagged (baseline
    # decoders skip it).  Enable via
    #   -explicit-encoder-settings "tile_rows 4"
    tile_rows: int = 0

    # defaults used in all speed modes
    fast_merge_eval: int = 1
    fast_quad_split_based_on_binary_split: int = 1
    eval_prev_mv_search_result: int = 1
    fast_inter_pred_bits: int = 0
    rdo_quant_2x2: int = 1
    intra_qp_offset: int = 0
    smooth_lambda_scaling: int = 1
    adaptive_qp: int = 2
    aqp_strength: int = 13
    structural_ssd: int = 1
    structural_strength: int = 16
    encapsulation_mode: int = 0
    leading_pictures: int = 0
    source_padding: int = 1
    chroma_qp_offset_table: int = 1
    chroma_qp_offset_u: int = 0
    chroma_qp_offset_v: int = 0
    flat_lambda: int = 0
    lambda_scale_a: float = 1.0
    lambda_scale_b: float = 0.0
    restricted_mode: int = 0
    # free-form signaled restriction flag names, applied on top of
    # restricted_mode (e.g. ("disable_inter_tmvp_mvp",)); None = none
    explicit_restrictions: tuple = None
    # cross-host GOP pipelining: split pictures over jax processes by
    # DOC ownership (requires explicit_restrictions to include
    # multihost.GOP_PIPELINE_PROFILE; see xvc_tpu/parallel/multihost.py)
    multihost_gop: int = 0

    def initialize_speed(self, speed_mode):
        if speed_mode == SpeedMode.PLACEBO:
            self.inter_search_range_uni_max = 384
            self.inter_search_range_uni_min = 96
            self.bipred_refinement_iterations = 4
            self.always_evaluate_intra_in_inter = 1
            self.default_num_ref_pics = 3
            self.max_binary_split_depth = 3
            self.fast_transform_select_eval = 0
            self.fast_intra_mode_eval_level = 1
            self.fast_transform_size_64 = 0
            self.fast_transform_select = 0
            self.fast_inter_local_illumination_comp = 0
            self.fast_inter_adaptive_fullpel_mv = 0
        elif speed_mode == SpeedMode.SLOW:
            self.bipred_refinement_iterations = 1
            self.always_evaluate_intra_in_inter = 0
            self.default_num_ref_pics = 2
            self.max_binary_split_depth = 2
            self.fast_transform_select_eval = 1
            self.fast_intra_mode_eval_level = 1
            self.fast_transform_size_64 = 0
            self.fast_transform_select = 0
            self.fast_inter_local_illumination_comp = 0
            self.fast_inter_adaptive_fullpel_mv = 0
        elif speed_mode in (SpeedMode.FAST, SpeedMode.TPU):
            self.bipred_refinement_iterations = 1
            self.always_evaluate_intra_in_inter = 0
            self.default_num_ref_pics = 1
            self.max_binary_split_depth = 2
            self.fast_transform_select_eval = 1
            self.fast_intra_mode_eval_level = 2
            self.fast_transform_size_64 = 1
            self.fast_transform_select = 1
            self.fast_inter_local_illumination_comp = 1
            self.fast_inter_adaptive_fullpel_mv = 1
            if speed_mode == SpeedMode.TPU:
                self.tpu_split_dp = 1
                self.tpu_txrd_prepass = 1
        else:
            raise ValueError("bad speed mode")

    def initialize_restricted(self, mode):
        """(ref: encoder_settings.cc:75-121)"""
        self.restricted_mode = mode
        if mode == RestrictedModeIds.MODE_C:
            return
        self.inter_search_range_uni_max = 256
        self.inter_search_range_uni_min = 96
        self.bipred_refinement_iterations = 1
        self.always_evaluate_intra_in_inter = 0
        self.default_num_ref_pics = 2
        self.fast_transform_select_eval = 1
        self.fast_intra_mode_eval_level = 2
        self.fast_transform_size_64 = 0
        self.fast_transform_select = 0
        self.fast_inter_local_illumination_comp = 0
        self.fast_inter_adaptive_fullpel_mv = 0
        self.fast_merge_eval = 1
        self.fast_quad_split_based_on_binary_split = 2
        self.eval_prev_mv_search_result = 0
        self.fast_inter_pred_bits = 1
        self.rdo_quant_2x2 = 0
        self.smooth_lambda_scaling = 0
        self.adaptive_qp = 0
        self.structural_ssd = 0
        self.source_padding = 1
        if mode == RestrictedModeIds.MODE_A:
            self.max_binary_split_depth = 0
            self.fast_intra_mode_eval_level = 1
            self.fast_merge_eval = 0
            self.eval_prev_mv_search_result = 1
        elif mode == RestrictedModeIds.MODE_B:
            self.max_binary_split_depth = 2
            self.chroma_qp_offset_u = 1
            self.chroma_qp_offset_v = 1
        elif mode == RestrictedModeIds.MODE_D:
            self.max_binary_split_depth = 3

    def tune(self, tune_mode):
        if tune_mode == TuneMode.PSNR:
            self.adaptive_qp = 0
            self.structural_ssd = 0
            self.source_padding = 1
            self.chroma_qp_offset_table = 0

    def parse_explicit_settings(self, explicit_settings: str):
        """Space-separated name/value overrides
        (ref: encoder_settings.cc:140-214)."""
        tokens = explicit_settings.split()
        if len(tokens) % 2:
            raise ValueError("explicit settings must be name value pairs")
        for name, value in zip(tokens[::2], tokens[1::2]):
            if not hasattr(self, name):
                raise ValueError(f"unknown explicit setting: {name}")
            current = getattr(self, name)
            if isinstance(current, bool):
                setattr(self, name, bool(int(value)))
            elif isinstance(current, float):
                setattr(self, name, float(value))
            else:
                setattr(self, name, int(value))
