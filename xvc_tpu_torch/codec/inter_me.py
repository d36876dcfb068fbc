"""Inter encoder: motion estimation + mode RD search.

Behavioral equivalent of the reference inter search
(ref: src/xvc_enc_lib/inter_search.cc, inter_tz_search.cc,
 cu_encoder.cc:431-515).  Copy of ``xvc_tpu/codec/inter_me.py``: merge,
skip, uni- and bi-prediction, AMVP, affine ME and affine merge, LIC.  Its
block metrics and MC are the native library's (``ops/metrics.py``,
``inter_mc.py``); under ``XVC_ME=jax`` (``engine.use_device_me``) the TZ
search takes its fullpel SADs from ``gpu/me.DeviceSadTable``, filled on
the encoder's device (kernel ``me_sad`` on the card).  The affine
gradient search and ``_lround`` stay float64 Python, as in the
reference.
"""
import math

import numpy as np

from .. import constants as k
from .. import native
from ..engine import use_device_me
from ..gpu import me as device_me
from ..ops import metrics as met
from ..syntax.writer import SyntaxWriter
from . import inter_mc as mc
from . import inter_mv as mv_mod
from .transform_encoder import TxSearchFlags

_DIST_MAX = (1 << 62)
_COST_MAX = (1 << 62)
FAST_MERGE_NUM_CAND = 4
FAST_MERGE_COST_FACTOR = 1.25
FAST_TRANSFORM_SELECT_COST_FACTOR = 1.1

_SQUARE_XY_HALF = ((0, 0), (0, -1), (0, 1), (-1, 0), (1, 0), (-1, -1),
                   (1, -1), (-1, 1), (1, 1))
_SQUARE_XY_QPEL = ((0, 0), (0, -1), (0, 1), (-1, -1), (1, -1), (-1, 0),
                   (1, 0), (-1, 1), (1, 1))

_UP, _DOWN, _LEFT, _RIGHT = -3, 3, -1, 1


def save_inter_state(cu):
    return (cu.inter_dir, cu.skip_flag, cu.merge_flag, cu.merge_idx,
            cu.fullpel_mv, cu.use_affine, cu.use_lic,
            [list(cu.mv[0]), list(cu.mv[1])],
            [list(cu.mvd[0]), list(cu.mvd[1])],
            list(cu.ref_idx), list(cu.mvp_idx))


def load_inter_state(cu, st):
    (cu.inter_dir, cu.skip_flag, cu.merge_flag, cu.merge_idx, cu.fullpel_mv,
     cu.use_affine, cu.use_lic, mv, mvd, ref_idx, mvp_idx) = st
    cu.mv = [list(mv[0]), list(mv[1])]
    cu.mvd = [list(mvd[0]), list(mvd[1])]
    cu.ref_idx = list(ref_idx)
    cu.mvp_idx = list(mvp_idx)


def load_inter_state_list(cu, st, ref_list):
    cu.mv[ref_list] = list(st[7][ref_list])
    cu.ref_idx[ref_list] = st[9][ref_list]
    cu.mvd[ref_list] = list(st[8][ref_list])
    cu.mvp_idx[ref_list] = st[10][ref_list]


def get_mvp_bits(mvp_idx, num_mvp):
    if num_mvp == 1:
        return 0
    return 1


def get_num_exp_golomb_bits(mvd):
    length = 1
    mvd_unsigned = ((-mvd) << 1) + 1 if mvd <= 0 else (mvd << 1)
    while mvd_unsigned != 1:
        mvd_unsigned >>= 1
        length += 2
    return length


def get_mvd_bits(mvp, mv, mvd_down_shift):
    shift = mv_mod.MV_PRECISION_SHIFT - mv_mod.MVD_PRECISION_SHIFT + \
        mvd_down_shift
    mvd_x = (mv[0] - mvp[0]) >> shift
    mvd_y = (mv[1] - mvp[1]) >> shift
    return get_num_exp_golomb_bits(mvd_x) + get_num_exp_golomb_bits(mvd_y)


def get_mvd_bits3(mvp3, mv3, mvd_down_shift):
    return get_mvd_bits(mvp3[0], mv3[0], mvd_down_shift) + \
        get_mvd_bits(mvp3[1], mv3[1], mvd_down_shift)


def get_mvd_bits_fullpel(mvp, fullpel_x, fullpel_y, mvd_down_shift):
    up = mv_mod.MV_PRECISION_SHIFT
    shift = mv_mod.MV_PRECISION_SHIFT - mv_mod.MVD_PRECISION_SHIFT + \
        mvd_down_shift
    mvd_x = ((fullpel_x << up) - mvp[0]) >> shift
    mvd_y = ((fullpel_y << up) - mvp[1]) >> shift
    return get_num_exp_golomb_bits(mvd_x) + get_num_exp_golomb_bits(mvd_y)


class InterSearch(mc.InterPredictor):
    """Holds per-picture ME state (uni-pred memoization etc.)."""

    def __init__(self, cu_encoder):
        super().__init__(cu_encoder.pic, cu_encoder.rec_pic,
                         cu_encoder.rec_pic.bitdepth, cu_encoder.restr)
        self.enc = cu_encoder
        self.device = cu_encoder.device
        self.settings = cu_encoder.settings
        self.orig_pic = cu_encoder.orig_pic
        self.cu_metric = cu_encoder.cu_metric
        self.satd_metric = met.SampleMetric(self.bitdepth,
                                            met.MetricType.SATD)
        rpl = cu_encoder.pic.ref_pic_lists
        self.same_poc_in_l0_mapping = self._same_poc_mapping(rpl)
        n = k.MAX_NUM_REF_PICS
        self.unipred_best_mv = [[None] * n, [None] * n]
        self.unipred_best_mv_affine = [[None] * n, [None] * n]
        self.unipred_best_mvp_idx = [[0] * n, [0] * n]
        self.unipred_best_dist = [[0] * n, [0] * n]
        self.previous_fullpel = [[(0, 0)] * n, [(0, 0)] * n]

    @staticmethod
    def _same_poc_mapping(rpl):
        """(ref: reference_picture_lists.cc GetSamePocMappingFor(kL1))"""
        num_l1 = rpl.get_num_ref_pics(1)
        mapping = []
        for i in range(num_l1):
            poc = rpl.get_ref_poc(1, i)
            found = -1
            for j in range(rpl.get_num_ref_pics(0)):
                if rpl.get_ref_poc(0, j) == poc:
                    found = j
                    break
            mapping.append(found)
        while len(mapping) < k.MAX_NUM_REF_PICS:
            mapping.append(-1)
        return mapping

    # ---- metric selection (ref: inter_search.cc:1059-1080) ----
    def _fullpel_metric(self, cu):
        if cu.use_affine:
            return met.SampleMetric(self.bitdepth, met.MetricType.SATD)
        if cu.use_lic:
            t = met.MetricType.SAD_AC_ONLY_FAST if cu.height > 8 else \
                met.MetricType.SAD_AC_ONLY
            return met.SampleMetric(self.bitdepth, t)
        t = met.MetricType.SAD_FAST if cu.height > 8 else met.MetricType.SAD
        return met.SampleMetric(self.bitdepth, t)

    def _subpel_metric(self, cu):
        t = met.MetricType.SATD_AC_ONLY if cu.use_lic else \
            met.MetricType.SATD
        return met.SampleMetric(self.bitdepth, t)

    def _mvp_metric(self, cu):
        return met.SampleMetric(self.bitdepth, met.MetricType.SAD)

    def _orig_block(self, cu, comp):
        cx, cy = cu.pos(comp)
        w, h = cu.size(comp)
        return self.orig_pic.plane_view(comp)[cy:cy + h, cx:cx + w]

    # ---- motion compensation wrappers ----
    def mc_mv(self, cu, comp, ref_pic, mv, post_filter):
        return mc.motion_compensation_mv(self, cu, comp, ref_pic, mv,
                                         post_filter)

    def mc_mv3(self, cu, comp, ref_pic, mv3, post_filter):
        return mc.motion_compensation_mv3(self, cu, comp, ref_pic, mv3,
                                          post_filter)

    def motion_compensation_cu(self, cu, comp):
        return mc.motion_compensation(self, cu, comp)

    # ---- top-level per-mode compression ----
    def compress_inter(self, cu, qp, bitstream_writer, search_flags,
                       best_cu_cost, encoder, rec_pic):
        """(ref: inter_search.cc:73-99)"""
        first_pass = dict(search_flags)
        first_pass["affine"] = False
        best_cost = self.search_motion(cu, qp, bitstream_writer, first_pass)
        if search_flags.get("affine"):
            best_state = save_inter_state(cu)
            cost = self.search_motion(cu, qp, bitstream_writer, search_flags)
            if best_cost <= cost:
                load_inter_state(cu, best_state)
        if cu.fullpel_mv and cu.has_zero_mvd():
            return _DIST_MAX
        return self.compress_and_eval_cbf(cu, qp, bitstream_writer,
                                          best_cu_cost, encoder, rec_pic)

    def compress_inter_fast(self, cu, comp, qp, bitstream_writer, encoder,
                            rec_pic):
        if not cu.cbf[comp]:
            pred = self.motion_compensation_cu(cu, comp)
            cx, cy = cu.pos(comp)
            w, h = cu.size(comp)
            rec_pic.plane_view(comp)[cy:cy + h, cx:cx + w] = pred
            return self.cu_metric.compare(qp, comp, self._orig_block(cu, comp),
                                          pred)
        pred = self.motion_compensation_cu(cu, comp)
        encoder.set_pred_buffer(comp, pred)
        return encoder.transform_and_reconstruct(cu, comp, qp,
                                                 bitstream_writer,
                                                 self.orig_pic, rec_pic)

    def compress_merge_cand(self, cu, qp, bitstream_writer, merge_list,
                            merge_idx, force_skip, best_cu_cost, encoder,
                            rec_pic):
        """(ref: inter_search.cc:119-140)"""
        cu.skip_flag = bool(force_skip)
        cu.merge_idx = merge_idx
        mv_mod.apply_merge_cand(cu, merge_list[merge_idx])
        if not force_skip:
            dist = self.compress_and_eval_cbf(cu, qp, bitstream_writer,
                                              best_cu_cost, encoder, rec_pic)
        else:
            dist = self.compress_skip_only(cu, qp, bitstream_writer, encoder,
                                           rec_pic)
        if self.restr.disable_inter_skip_mode:
            cu.skip_flag = False
        return dist

    def compress_affine_merge(self, cu, qp, bitstream_writer, merge_cand,
                              force_skip, best_cu_cost, encoder, rec_pic):
        cu.skip_flag = bool(force_skip)
        cu.merge_idx = 0
        mv_mod.apply_affine_merge_cand(cu, merge_cand)
        if not force_skip:
            dist = self.compress_and_eval_cbf(cu, qp, bitstream_writer,
                                              best_cu_cost, encoder, rec_pic)
        else:
            dist = self.compress_skip_only(cu, qp, bitstream_writer, encoder,
                                           rec_pic)
        if self.restr.disable_inter_skip_mode:
            cu.skip_flag = False
        return dist

    def search_merge_candidates(self, cu, qp, bitstream_writer, merge_list,
                                encoder):
        """(ref: inter_search.cc:165-197); returns candidate lookup list."""
        max_merge_cand = k.NUM_INTER_MERGE_CANDIDATES
        metric = met.SampleMetric(self.bitdepth, met.MetricType.SATD)
        orig = self._orig_block(cu, 0)
        cand_cost = []
        for merge_idx in range(max_merge_cand):
            mv_mod.apply_merge_cand(cu, merge_list[merge_idx])
            pred = self.motion_compensation_cu(cu, 0)
            dist = metric.compare(qp, 0, orig, pred)
            bits = merge_idx + 1 - (0 if merge_idx < max_merge_cand - 1
                                    else 1)
            cost = dist + bits * qp.lambda_sqrt
            cand_cost.append((merge_idx, cost))
        cand_cost.sort(key=lambda p: p[1])
        num_merge_cand = FAST_MERGE_NUM_CAND
        out = [0] * max_merge_cand
        for merge_idx in range(FAST_MERGE_NUM_CAND, -1, -1):
            out[merge_idx] = cand_cost[merge_idx][0]
            if cand_cost[merge_idx][1] > \
                    cand_cost[0][1] * FAST_MERGE_COST_FACTOR:
                num_merge_cand = merge_idx
        return num_merge_cand, out

    def search_motion(self, cu, qp, bitstream_writer, search_flags):
        """(ref: inter_search.cc:199-259)"""
        comp = 0
        orig_luma = self._orig_block(cu, comp)
        cu.reset_prediction_state()
        cu.pred_mode = k.PredictionMode.INTER
        if search_flags.get("fullpel"):
            cu.fullpel_mv = True
        if search_flags.get("lic"):
            cu.use_lic = True
        if search_flags.get("affine"):
            cu.use_affine = True

        cu.inter_dir = k.InterDir.L0
        cost_l0, state_l0 = self.search_ref_idx(
            cu, qp, 0, bitstream_writer, orig_luma, _COST_MAX)
        if search_flags.get("unipred_only"):
            return cost_l0

        cu.inter_dir = k.InterDir.L1
        cost_l1, state_bi, state_l1_unique, cost_l1_unique = \
            self.search_ref_idx(cu, qp, 1, bitstream_writer, orig_luma,
                                _COST_MAX, want_unique=True)
        load_inter_state_list(cu, state_l0, 0)
        best_uni_dir = k.InterDir.L0 if cost_l0 <= cost_l1 else k.InterDir.L1
        cost_best_bi, state_bi = self.search_bi_iterative(
            cu, qp, bitstream_writer, best_uni_dir, state_bi)

        if cost_best_bi <= cost_l0 and cost_best_bi <= cost_l1_unique:
            best_cost = cost_best_bi
            load_inter_state(cu, state_bi)
        elif cost_l0 <= cost_l1_unique:
            best_cost = cost_l0
            load_inter_state(cu, state_l0)
        else:
            best_cost = cost_l1_unique
            load_inter_state(cu, state_l1_unique)
        return best_cost

    def search_bi_iterative(self, cu, qp, bitstream_writer, best_uni_dir,
                            state_bi):
        """(ref: inter_search.cc:392-433)"""
        comp = 0
        orig_luma = self._orig_block(cu, comp)
        cu.inter_dir = k.InterDir.BI
        search_list = 1 if best_uni_dir == k.InterDir.L0 else 0
        cost_best = _COST_MAX
        num_iterations = self.settings.bipred_refinement_iterations
        if cu.pic.force_bipred_l1_mvd_zero:
            num_iterations = 1
            search_list = 0
        for _ in range(num_iterations):
            cu.inter_dir = k.InterDir.L1 if search_list == 0 else \
                k.InterDir.L0
            other_pred = self.motion_compensation_cu(cu, comp)
            bipred_orig = (2 * orig_luma.astype(np.int64) -
                           other_pred).astype(np.int16).astype(np.int32)
            cu.inter_dir = k.InterDir.BI
            prev_best = cost_best
            cost_best, state_bi = self.search_ref_idx(
                cu, qp, search_list, bitstream_writer, bipred_orig,
                cost_best, best_state=state_bi)
            if cost_best == prev_best:
                break
            search_list = 1 - search_list
        return cost_best, state_bi

    def search_ref_idx(self, cu, qp, ref_list, bitstream_writer, orig_buffer,
                       initial_best_cost, want_unique=False, best_state=None):
        """(ref: inter_search.cc:456-578)"""
        is_affine = cu.use_affine
        rpl = cu.pic.ref_pic_lists
        num_ref_idx = rpl.get_num_ref_pics(ref_list)
        lam = int(math.floor(65536.0 * qp.lambda_sqrt))
        bipred = cu.inter_dir == k.InterDir.BI
        force_mvd_zero = cu.pic.force_bipred_l1_mvd_zero and ref_list == 1
        cost_best = initial_best_cost
        cost_best_unique = _COST_MAX
        state_unique = None
        if best_state is None:
            best_state = save_inter_state(cu)
        if not bipred:
            other_list = 1 - ref_list
            cu.mv[other_list] = [(0, 0)] * 4
            cu.ref_idx[other_list] = -1

        for ref_idx in range(num_ref_idx):
            unique_ref_pic = ref_list == 1 and \
                self.same_poc_in_l0_mapping[ref_idx] < 0
            cu.ref_idx[ref_list] = ref_idx
            if is_affine:
                mvp_list = mv_mod.get_mvp_list_affine(
                    self.restr, cu, ref_list, ref_idx,
                    k.NUM_INTER_MV_PREDICTORS)
            else:
                mvp_list = mv_mod.get_mvp_list(self.restr, cu, ref_list,
                                               ref_idx)
            mv_bootstrap = None
            ref_pic = rpl.get_ref_pic(ref_list, ref_idx)
            if bipred:
                mvp_idx = self.unipred_best_mvp_idx[ref_list][ref_idx]
                mv_bootstrap = self._get_best_unipred_mv(is_affine, ref_list,
                                                         ref_idx)
            else:
                mvp_idx, mvp_cost = self.eval_start_mvp(
                    cu, qp, mvp_list, ref_pic, is_affine)
                if force_mvd_zero:
                    if mvp_cost < cost_best:
                        cu.ref_idx[ref_list] = ref_idx
                        cu.mvp_idx[ref_list] = mvp_idx
                        if is_affine:
                            mv_mod.set_mv3(cu, mvp_list[mvp_idx], ref_list)
                            cu.mvd[ref_list] = [(0, 0), (0, 0)]
                        else:
                            cu.mv[ref_list] = [mvp_list[mvp_idx]] * 4
                            cu.mvd[ref_list][0] = (0, 0)
                        cost_best = mvp_cost
                        best_state = save_inter_state(cu)
                    if bipred or not unique_ref_pic:
                        continue
                if is_affine:
                    mv_normal = self.unipred_best_mv[ref_list][ref_idx] or \
                        (0, 0)
                    mv_bootstrap = mv_mod.derive_mv_affine(
                        cu, ref_pic, mv_normal, mv_normal)

            dist = 0
            if not bipred and not unique_ref_pic and ref_list == 1:
                l0_ref_idx = self.same_poc_in_l0_mapping[ref_idx]
                mv = self._get_best_unipred_mv(is_affine, 0, l0_ref_idx)
                dist = self.unipred_best_dist[0][l0_ref_idx]
            else:
                mv, dist = self.motion_estimation(
                    cu, qp, "full" if bipred else "tz", ref_list, ref_idx,
                    bipred, orig_buffer, mvp_list[mvp_idx], mv_bootstrap)
            mvp_idx = self.eval_final_mvp_idx(cu, mvp_list, mv, mvp_idx,
                                              is_affine)
            if not bipred or self.settings.bipred_refinement_iterations > 1:
                self._set_best_unipred_mv(is_affine, ref_list, ref_idx, mv)
                self.unipred_best_mvp_idx[ref_list][ref_idx] = mvp_idx
                self.unipred_best_dist[ref_list][ref_idx] = dist

            cu.mvp_idx[ref_list] = mvp_idx
            if is_affine:
                mv_mod.set_mv3(cu, mv, ref_list)
                self._set_mvd3(cu, ref_list, mvp_list[mvp_idx], mv)
            else:
                cu.mv[ref_list] = [mv] * 4
                self._set_mvd(cu, ref_list, mvp_list[mvp_idx], mv)
            bits = self.get_inter_pred_bits(cu, bitstream_writer)
            cost = dist + ((bits * lam) >> 16)
            if not force_mvd_zero and cost < cost_best:
                cost_best = cost
                best_state = save_inter_state(cu)
            if want_unique and unique_ref_pic and cost < cost_best_unique:
                cost_best_unique = cost
                state_unique = save_inter_state(cu)
        load_inter_state(cu, best_state)
        if want_unique:
            if state_unique is None:
                state_unique = save_inter_state(cu)
            return cost_best, best_state, state_unique, cost_best_unique
        return cost_best, best_state

    def _get_best_unipred_mv(self, is_affine, ref_list, ref_idx):
        if is_affine:
            return self.unipred_best_mv_affine[ref_list][ref_idx]
        return self.unipred_best_mv[ref_list][ref_idx]

    def _set_best_unipred_mv(self, is_affine, ref_list, ref_idx, mv):
        if is_affine:
            self.unipred_best_mv_affine[ref_list][ref_idx] = mv
        else:
            self.unipred_best_mv[ref_list][ref_idx] = mv

    @staticmethod
    def _set_mvd(cu, ref_list, mvp, mv):
        shift = mv_mod.MV_PRECISION_SHIFT - mv_mod.MVD_PRECISION_SHIFT
        mvd_x = _ashr(mv[0] - mvp[0], shift)
        mvd_y = _ashr(mv[1] - mvp[1], shift)
        if cu.fullpel_mv:
            mvd_x = _ashr(mvd_x, mv_mod.MVD_PRECISION_SHIFT)
            mvd_y = _ashr(mvd_y, mv_mod.MVD_PRECISION_SHIFT)
        cu.mvd[ref_list][0] = (mvd_x, mvd_y)

    @staticmethod
    def _set_mvd3(cu, ref_list, mvp3, mv3):
        shift = mv_mod.MV_PRECISION_SHIFT - mv_mod.MVD_PRECISION_SHIFT
        for i in range(2):
            mvd_x = _ashr(mv3[i][0] - mvp3[i][0], shift)
            mvd_y = _ashr(mv3[i][1] - mvp3[i][1], shift)
            if cu.fullpel_mv:
                mvd_x = _ashr(mvd_x, mv_mod.MVD_PRECISION_SHIFT)
                mvd_y = _ashr(mvd_y, mv_mod.MVD_PRECISION_SHIFT)
            cu.mvd[ref_list][i] = (mvd_x, mvd_y)

    def eval_start_mvp(self, cu, qp, mvp_list, ref_pic, is_affine):
        """(ref: inter_search.cc:966-997)"""
        metric = self._mvp_metric(cu)
        lam = int(math.floor(65536.0 * qp.lambda_sqrt))
        best_mvp_idx = 0
        best_cost = _COST_MAX
        orig = self._orig_block(cu, 0)
        for i in range(len(mvp_list)):
            if is_affine:
                pred = self.mc_mv3(cu, 0, ref_pic, mvp_list[i], True)
            else:
                mv = mv_mod.clip_mv(cu, ref_pic, mvp_list[i])
                pred = self.mc_mv(cu, 0, ref_pic, mv, True)
            dist = metric.compare(qp, 0, orig, pred)
            bits = get_mvp_bits(i, len(mvp_list))
            cost = dist + (int(bits * lam + 0.5) >> 16)
            if cost < best_cost:
                best_cost = cost
                best_mvp_idx = i
            if (not is_affine and self.restr.disable_inter_mvp) or \
                    (is_affine and self.restr.disable_ext2_inter_affine_mvp):
                break
        return best_mvp_idx, best_cost

    def eval_final_mvp_idx(self, cu, mvp_list, mv, mvp_idx_start, is_affine):
        """(ref: inter_search.cc:999-1020)"""
        if (not cu.use_affine and self.restr.disable_inter_mvp) or \
                (cu.use_affine and self.restr.disable_ext2_inter_affine_mvp):
            return 0
        mvd_precision = mv_mod.MVD_PRECISION_SHIFT if cu.fullpel_mv else 0
        best_mvp_idx = 0
        best_cost = _COST_MAX
        for i in range(len(mvp_list)):
            cost = get_mvp_bits(i, len(mvp_list))
            if is_affine:
                cost += get_mvd_bits3(mvp_list[i], mv, mvd_precision)
            else:
                cost += get_mvd_bits(mvp_list[i], mv, mvd_precision)
            if cost < best_cost or (cost == best_cost and
                                    i == mvp_idx_start):
                best_cost = cost
                best_mvp_idx = i
        return best_mvp_idx

    # ---- motion estimation ----
    def motion_estimation(self, cu, qp, search_method, ref_list, ref_idx,
                          bipred, orig_buffer, mvp, mv_bootstrap):
        if cu.use_affine:
            return self.motion_est_affine(cu, qp, ref_list, ref_idx, bipred,
                                          orig_buffer, mvp, mv_bootstrap)
        return self.motion_est_normal(cu, qp, search_method, ref_list,
                                      ref_idx, bipred, orig_buffer, mvp,
                                      mv_bootstrap)

    def motion_est_normal(self, cu, qp, search_method, ref_list, ref_idx,
                          bipred, orig_buffer, mvp, mv_bootstrap):
        """(ref: inter_search.cc:606-662)"""
        rpl = cu.pic.ref_pic_lists
        ref_pic = rpl.get_ref_pic(ref_list, ref_idx)
        ref_poc = rpl.get_ref_poc(ref_list, ref_idx)
        search_range = self.settings.inter_search_range_bi \
            if search_method == "full" else \
            self._search_range_unipred(ref_poc)
        center = mv_bootstrap if mv_bootstrap is not None else mvp
        clip_min, clip_max = self._determine_min_max_mv(cu, ref_pic, center,
                                                        search_range)
        fullpel_metric = self._fullpel_metric(cu)
        if search_method == "full":
            mv_fullpel = self._full_search(cu, qp, fullpel_metric, mvp,
                                           ref_pic, clip_min, clip_max,
                                           orig_buffer)
        else:
            mv_fullpel = self._tz_search(
                cu, qp, fullpel_metric, mvp, ref_pic, clip_min, clip_max,
                self.previous_fullpel[ref_list][ref_idx], search_range)
            self.previous_fullpel[ref_list][ref_idx] = mv_fullpel
        subpel_metric = self._subpel_metric(cu)
        if cu.fullpel_mv:
            mv_subpel = (mv_fullpel[0] * 16, mv_fullpel[1] * 16)
            dist = self._get_subpel_dist(cu, qp, ref_pic, subpel_metric,
                                         mv_subpel, orig_buffer)
        else:
            mv_subpel, dist = self._subpel_search(
                cu, qp, subpel_metric, ref_pic, mvp, mv_fullpel, orig_buffer)
        return mv_subpel, (dist >> 1) if bipred else dist

    def motion_est_affine(self, cu, qp, ref_list, ref_idx, bipred,
                          orig_buffer, mvp, mv_bootstrap):
        """(ref: inter_search.cc:664-749)"""
        comp = 0
        lam = int(math.floor(65536.0 * qp.lambda_sqrt))
        rpl = cu.pic.ref_pic_lists
        ref_pic = rpl.get_ref_pic(ref_list, ref_idx)
        force_mv_bootstrap = bipred
        bi_dist_shift = 1 if bipred else 0
        max_iterations = 5 if bipred else 7
        metric_mvp = self._mvp_metric(cu)
        metric = self._fullpel_metric(cu)

        best_mv = [tuple(m) for m in mvp]
        pred = self.mc_mv3(cu, comp, ref_pic, mvp, False)
        best_dist = metric_mvp.compare(qp, comp, orig_buffer, pred)
        mvp_bits = get_mvd_bits3(mvp, best_mv, 0)
        best_cost = (best_dist >> bi_dist_shift) + ((lam * mvp_bits) >> 16)

        if mv_bootstrap is not None and \
                [tuple(m) for m in mv_bootstrap] != best_mv:
            mv = mv_bootstrap
            pred2 = self.mc_mv3(cu, comp, ref_pic, mv, False)
            dist = metric_mvp.compare(qp, comp, orig_buffer, pred2)
            bits = get_mvd_bits3(mvp, mv, 0)
            cost = (dist >> bi_dist_shift) + ((lam * bits) >> 16)
            if cost < best_cost or force_mv_bootstrap:
                best_mv = [tuple(m) for m in mv]
                pred = pred2
        best_dist = metric.compare(qp, comp, orig_buffer, pred)
        mvp_bits = get_mvd_bits3(mvp, best_mv, 0)
        best_cost = (best_dist >> bi_dist_shift) + ((lam * mvp_bits) >> 16)

        mv = list(best_mv)
        for _ in range(max_iterations):
            err = (orig_buffer.astype(np.int64) -
                   pred).astype(np.int16).astype(np.int64)
            mvd = self._affine_gradient_search(cu.width, cu.height, pred, err)
            if mvd[0] == (0, 0) and mvd[1] == (0, 0):
                break
            mv0 = mv_mod.add_mvd(mv[0], mvd[0])
            mv1 = mv_mod.add_mvd(mv[1], mvd[1])
            mv = mv_mod.derive_mv_affine(cu, ref_pic, mv0, mv1)
            pred = self.mc_mv3(cu, comp, ref_pic, mv, False)
            dist = metric.compare(qp, comp, orig_buffer, pred)
            bits = get_mvd_bits3(mvp, mv, 0)
            cost = (dist >> bi_dist_shift) + ((lam * bits) >> 16)
            if cost < best_cost:
                best_cost = cost
                best_dist = dist
                best_mv = [tuple(m) for m in mv]
        return best_mv, best_dist >> bi_dist_shift

    @staticmethod
    def _affine_gradient_search(width, height, pred, err):
        """(ref: inter_search.cc:751-851)"""
        N_PARAMS = 4
        p = pred.astype(np.float64)
        dh = np.zeros((height, width))
        dv = np.zeros((height, width))
        a0 = p[0:-2, 0:-2]
        a1 = p[0:-2, 1:-1]
        a2 = p[0:-2, 2:]
        b0 = p[1:-1, 0:-2]
        b2 = p[1:-1, 2:]
        c0 = p[2:, 0:-2]
        c1 = p[2:, 1:-1]
        c2 = p[2:, 2:]
        dh[1:-1, 1:-1] = (-a0 + a2 - 2 * b0 + 2 * b2 - c0 + c2) / 8.0
        dv[1:-1, 1:-1] = (-a0 - 2 * a1 - a2 + c0 + 2 * c1 + c2) / 8.0
        dh[1:-1, 0] = dh[1:-1, 1]
        dh[1:-1, -1] = dh[1:-1, -2]
        dv[1:-1, 0] = dv[1:-1, 1]
        dv[1:-1, -1] = dv[1:-1, -2]
        dh[0, :] = dh[1, :]
        dh[-1, :] = dh[-2, :]
        dv[0, :] = dv[1, :]
        dv[-1, :] = dv[-2, :]

        yy, xx = np.mgrid[0:height, 0:width]
        c = np.stack([dh, xx * dh + yy * dv, dv, yy * dh - xx * dv])
        matrix = np.zeros((N_PARAMS, N_PARAMS + 1))
        for row in range(N_PARAMS):
            for col in range(N_PARAMS):
                matrix[row][col] = (c[row] * c[col]).sum()
            matrix[row][N_PARAMS] = (err * c[row]).sum()
        # row echelon solve mirroring reference pivoting
        for i in range(N_PARAMS - 1):
            best_index = i
            best_val = abs(matrix[i][i])
            for j in range(i + 1, N_PARAMS):
                if abs(matrix[j][i]) > best_val:
                    best_index = j
                    best_val = abs(matrix[j][i])
            if best_index != i:
                matrix[[i, best_index]] = matrix[[best_index, i]]
            for j in range(i + 1, N_PARAMS):
                for kk in range(i + 1, N_PARAMS + 1):
                    if matrix[i][i]:
                        matrix[j][kk] -= \
                            matrix[i][kk] * matrix[j][i] / matrix[i][i]
        params = [0.0] * N_PARAMS
        if matrix[N_PARAMS - 1][N_PARAMS - 1]:
            params[N_PARAMS - 1] = matrix[N_PARAMS - 1][N_PARAMS] / \
                matrix[N_PARAMS - 1][N_PARAMS - 1]
        for row in range(N_PARAMS - 2, -1, -1):
            ssum = 0.0
            for col in range(row + 1, N_PARAMS):
                ssum += matrix[row][col] * params[col]
            if matrix[row][row]:
                params[row] = (matrix[row][N_PARAMS] - ssum) / \
                    matrix[row][row]
        scale = 1 << mv_mod.MVD_PRECISION_SHIFT
        mvd0 = (_lround(scale * params[0]), _lround(scale * params[2]))
        mvd1 = (_lround(scale * (params[1] * width + params[0])),
                _lround(scale * (-params[3] * width + params[2])))
        return (mvd0, mvd1)

    def _search_range_unipred(self, ref_poc):
        mx = self.settings.inter_search_range_uni_max
        mn = self.settings.inter_search_range_uni_min
        delta_poc = self.pic.poc - ref_poc
        sub_gop = max(1, self.pic.sub_gop_length)
        rng = (mx * abs(delta_poc) + (sub_gop // 2)) // sub_gop
        return min(max(rng, mn), mx)

    def _determine_min_max_mv(self, cu, ref_pic, center, search_range):
        """(ref: inter_prediction.cc:801-817)"""
        if isinstance(center[0], tuple):
            center = center[0]
        center_clip = mv_mod.clip_mv(cu, ref_pic, center)
        r = search_range << mv_mod.MV_PRECISION_SHIFT
        smin = mv_mod.clip_mv(cu, ref_pic, (center_clip[0] - r,
                                            center_clip[1] - r))
        smax = mv_mod.clip_mv(cu, ref_pic, (center_clip[0] + r,
                                            center_clip[1] + r))
        return ((smin[0] >> 4, smin[1] >> 4), (smax[0] >> 4, smax[1] >> 4))

    # ---- fullpel searches ----
    def _dist_fullpel(self, cu, qp, metric, ref_pic, orig_buffer, mv_x, mv_y):
        cx, cy = cu.pos(0)
        plane = ref_pic.padded_plane(0)
        px, py = ref_pic.pad_x[0], ref_pic.pad_y[0]
        blk = plane[py + cy + mv_y:py + cy + mv_y + cu.height,
                    px + cx + mv_x:px + cx + mv_x + cu.width]
        return metric.compare(qp, 0, orig_buffer, blk)

    def _make_dist_fullpel(self, cu, qp, metric, ref_pic, orig_buffer):
        """Hoist the per-candidate pointer math out of the fullpel ME
        loop: the returned closure issues one native metric call per
        motion vector candidate (the hottest loop in the encoder)."""
        if not (orig_buffer.dtype == np.int32 and
                orig_buffer.strides[1] == 4 and
                qp.distortion_weight[0] == 1.0):
            def slow(mv_x, mv_y):
                return self._dist_fullpel(cu, qp, metric, ref_pic,
                                          orig_buffer, mv_x, mv_y)
            return slow
        fn = native.lib().xvcn_metric
        cx, cy = cu.pos(0)
        plane = ref_pic.padded_plane(0)
        stride = plane.shape[1]
        base = plane.ctypes.data + \
            4 * ((ref_pic.pad_y[0] + cy) * stride + ref_pic.pad_x[0] + cx)
        optr = orig_buffer.ctypes.data
        ostride = orig_buffer.strides[0] // 4
        w, h = cu.width, cu.height
        mt = metric.type
        bd = metric.bitdepth
        qraw = qp.get_qp_raw(0)
        strength = float(metric.structural_strength)

        def fast(mv_x, mv_y):
            return fn(mt, optr, ostride, base + 4 * (mv_y * stride + mv_x),
                      stride, w, h, bd, qraw, strength)
        return fast

    def _full_search(self, cu, qp, metric, mvp, ref_pic, mv_min, mv_max,
                     orig_buffer):
        """(ref: inter_search.cc:853-891)"""
        mvd_precision = mv_mod.MVD_PRECISION_SHIFT if cu.fullpel_mv else 0
        lam = int(math.floor(65536.0 * qp.lambda_sqrt))
        cost_best = _COST_MAX
        mv_best = (0, 0)
        dist_fullpel = self._make_dist_fullpel(cu, qp, metric, ref_pic,
                                               orig_buffer)
        for mv_y in range(mv_min[1], mv_max[1] + 1):
            for mv_x in range(mv_min[0], mv_max[0] + 1):
                dist = dist_fullpel(mv_x, mv_y)
                if dist >= cost_best:
                    continue
                bits = get_mvd_bits_fullpel(mvp, mv_x, mv_y, mvd_precision)
                cost = dist + ((lam * bits) >> 16)
                if cost < cost_best:
                    cost_best = cost
                    mv_best = (mv_x, mv_y)
        return mv_best

    def _tz_search(self, cu, qp, metric, mvp, ref_pic, mv_min, mv_max,
                   prev_search, search_range):
        """(ref: inter_tz_search.cc:84-171)"""
        DIAMOND_THRESHOLD = 3
        FULL_SEARCH_GRANULARITY = 5
        orig_buffer = self._orig_block(cu, 0)
        mvd_downshift = mv_mod.MVD_PRECISION_SHIFT if cu.fullpel_mv else 0
        lam = int(math.floor(65536.0 * qp.lambda_sqrt))
        st = {"best": (0, 0), "cost": _COST_MAX, "last_pos": 0,
              "last_range": 0}

        dist_fullpel = self._make_dist_fullpel(cu, qp, metric, ref_pic,
                                               orig_buffer)

        def check_cost_best(mv_x, mv_y):
            dist = dist_fullpel(mv_x, mv_y)
            if dist >= st["cost"]:
                return False
            bits = get_mvd_bits_fullpel(mvp, mv_x, mv_y, mvd_downshift)
            cost = dist + ((lam * bits) >> 16)
            if cost < st["cost"]:
                st["cost"] = cost
                st["best"] = (mv_x, mv_y)
                return True
            return False

        def inside(mv_x, mv_y, dirs):
            for d in dirs:
                if d == _UP and not mv_y >= mv_min[1]:
                    return False
                if d == _DOWN and not mv_y <= mv_max[1]:
                    return False
                if d == _LEFT and not mv_x >= mv_min[0]:
                    return False
                if d == _RIGHT and not mv_x <= mv_max[0]:
                    return False
            return True

        def check_cost(mv_x, mv_y, rng, dirs):
            if not inside(mv_x, mv_y, dirs):
                return False
            if not check_cost_best(mv_x, mv_y):
                return False
            st["last_pos"] = sum(dirs)
            st["last_range"] = rng
            return True

        def diamond_search(base, rng):
            bx, by = base
            mod = False
            if rng == 1:
                mod |= check_cost(bx, by - rng, rng, (_UP,))
                mod |= check_cost(bx - rng, by, rng, (_LEFT,))
                mod |= check_cost(bx + rng, by, rng, (_RIGHT,))
                mod |= check_cost(bx, by + rng, rng, (_DOWN,))
            elif rng <= 8:
                r2 = rng >> 1
                mod |= check_cost(bx, by - rng, rng, (_UP,))
                mod |= check_cost(bx - r2, by - r2, r2, (_UP, _LEFT))
                mod |= check_cost(bx + r2, by - r2, r2, (_UP, _RIGHT))
                mod |= check_cost(bx - rng, by, rng, (_LEFT,))
                mod |= check_cost(bx + rng, by, rng, (_RIGHT,))
                mod |= check_cost(bx - r2, by + r2, r2, (_DOWN, _LEFT))
                mod |= check_cost(bx + r2, by + r2, r2, (_DOWN, _RIGHT))
                mod |= check_cost(bx, by + rng, rng, (_DOWN,))
            else:
                mod |= check_cost(bx, by - rng, rng, (_UP,))
                mod |= check_cost(bx - rng, by, rng, (_LEFT,))
                mod |= check_cost(bx + rng, by, rng, (_RIGHT,))
                mod |= check_cost(bx, by + rng, rng, (_DOWN,))
                for i in range(1, 4):
                    r14 = i * (rng >> 2)
                    r34 = rng - r14
                    mod |= check_cost(bx - r14, by - r34, rng, (_UP, _LEFT))
                    mod |= check_cost(bx + r14, by - r34, rng, (_UP, _RIGHT))
                    mod |= check_cost(bx - r14, by + r34, rng,
                                      (_DOWN, _LEFT))
                    mod |= check_cost(bx + r14, by + r34, rng,
                                      (_DOWN, _RIGHT))
            return mod

        def neighbor_point_search():
            r = 1
            bx, by = st["best"]
            lp = st["last_pos"]
            if lp == _UP + _LEFT:
                check_cost(bx - r, by, r, (_LEFT,))
                check_cost(bx, by - r, r, (_UP,))
            elif lp == _UP:
                check_cost(bx - r, by - r, r, (_UP, _LEFT))
                check_cost(bx + r, by - r, r, (_UP, _RIGHT))
            elif lp == _UP + _RIGHT:
                check_cost(bx, by - r, r, (_UP,))
                check_cost(bx + r, by, r, (_RIGHT,))
            elif lp == _LEFT:
                check_cost(bx - r, by + r, r, (_DOWN, _LEFT))
                check_cost(bx - r, by - r, r, (_UP, _LEFT))
            elif lp == _RIGHT:
                check_cost(bx + r, by - r, r, (_UP, _RIGHT))
                check_cost(bx + r, by + r, r, (_DOWN, _RIGHT))
            elif lp == _DOWN + _LEFT:
                check_cost(bx - r, by, r, (_LEFT,))
                check_cost(bx, by + r, r, (_DOWN,))
            elif lp == _DOWN:
                check_cost(bx - r, by + r, r, (_DOWN, _LEFT))
                check_cost(bx + r, by + r, r, (_DOWN, _RIGHT))
            elif lp == _DOWN + _RIGHT:
                check_cost(bx + r, by, r, (_RIGHT,))
                check_cost(bx, by + r, r, (_DOWN,))

        # XVC_ME=jax: the fullpel SAD sweeps run as batched device
        # dispatches; the TZ decision logic replays on the host against
        # the returned SAD table (byte-identical bitstreams)
        sad_table = None
        if use_device_me():
            if metric.type in (met.MetricType.SAD, met.MetricType.SAD_FAST):
                sad_table = device_me.DeviceSadTable(
                    self, cu, metric, ref_pic, orig_buffer, self.device)

                def dist_fullpel(mv_x, mv_y):  # noqa: F811
                    return sad_table.dist(qp, mv_x, mv_y)

        fullsearch_min, fullsearch_max = mv_min, mv_max
        mvp_clip = mv_mod.clip_mv(cu, ref_pic, mvp)
        check_cost_best(mvp_clip[0] >> 4, mvp_clip[1] >> 4)
        change_min_max = False
        if st["best"] != (0, 0):
            change_min_max = check_cost_best(0, 0)
        st["last_range"] = 0

        if cu.depth != 0 and self.settings.eval_prev_mv_search_result:
            prev_clip = mv_mod.clip_mv(cu, ref_pic,
                                       (prev_search[0] * 16,
                                        prev_search[1] * 16))
            change_min_max |= check_cost_best(prev_clip[0] >> 4,
                                              prev_clip[1] >> 4)
            if change_min_max:
                best_subpel = (st["best"][0] * 16, st["best"][1] * 16)
                fullsearch_min, fullsearch_max = self._determine_min_max_mv(
                    cu, ref_pic, best_subpel, search_range)

        mv_base = st["best"]
        if sad_table is not None:
            sad_table.prefetch(qp, device_me.tz_initial_candidates(
                mv_base, search_range))
        rounds_with_no_match = 0
        rng = 1
        while rng <= search_range:
            changed = diamond_search(mv_base, rng)
            if changed:
                rounds_with_no_match = 0
            else:
                rounds_with_no_match += 1
                if rounds_with_no_match >= DIAMOND_THRESHOLD:
                    break
            rng *= 2
        if st["last_range"] == 1:
            st["last_range"] = 0
            neighbor_point_search()

        if st["last_range"] > FULL_SEARCH_GRANULARITY:
            st["last_range"] = FULL_SEARCH_GRANULARITY
            step = FULL_SEARCH_GRANULARITY
            if sad_table is not None:
                grid = [(x, y)
                        for y in range(fullsearch_min[1],
                                       fullsearch_max[1] + 1, step)
                        for x in range(fullsearch_min[0],
                                       fullsearch_max[0] + 1, step)]
                sad_table.prefetch(qp, grid)
            for y in range(fullsearch_min[1], fullsearch_max[1] + 1, step):
                for x in range(fullsearch_min[0], fullsearch_max[0] + 1,
                               step):
                    check_cost_best(x, y)

        while st["last_range"] > 0:
            mv_start = st["best"]
            if sad_table is not None:
                sad_table.prefetch(qp, device_me.tz_initial_candidates(
                    mv_start, search_range))
            st["last_range"] = 0
            rng = 1
            while rng <= search_range:
                diamond_search(mv_start, rng)
                rng *= 2
            if st["last_range"] == 1:
                st["last_range"] = 0
                neighbor_point_search()
        return st["best"]

    def _get_subpel_dist(self, cu, qp, ref_pic, metric, mv, orig_buffer):
        pred = self.mc_mv(cu, 0, ref_pic, mv, False)
        return metric.compare(qp, 0, orig_buffer, pred)

    def _subpel_search(self, cu, qp, metric, ref_pic, mvp, mv_fullpel,
                       orig_buffer):
        """(ref: inter_search.cc:893-949)"""
        lam = int(math.floor(65536.0 * qp.lambda_sqrt))
        best_cost = _COST_MAX
        best_dist = _COST_MAX
        best_mv = (mv_fullpel[0] * 16, mv_fullpel[1] * 16)
        mv_base = best_mv
        for dx, dy in _SQUARE_XY_HALF:
            mv = (mv_base[0] + dx * 8, mv_base[1] + dy * 8)
            dist = self._get_subpel_dist(cu, qp, ref_pic, metric, mv,
                                         orig_buffer)
            if dist >= best_cost:
                continue
            bits = get_mvd_bits(mvp, mv, 0)
            cost = dist + ((lam * bits) >> 16)
            if cost < best_cost:
                best_cost = cost
                best_dist = dist
                best_mv = mv
        mv_base = best_mv
        for dx, dy in _SQUARE_XY_QPEL[1:]:
            mv = (mv_base[0] + dx * 4, mv_base[1] + dy * 4)
            dist = self._get_subpel_dist(cu, qp, ref_pic, metric, mv,
                                         orig_buffer)
            if dist >= best_cost:
                continue
            bits = get_mvd_bits(mvp, mv, 0)
            cost = dist + ((lam * bits) >> 16)
            if cost < best_cost:
                best_cost = cost
                best_dist = dist
                best_mv = mv
        return best_mv, best_dist

    # ---- residual coding eval ----
    def compress_and_eval_cbf(self, cu, qp, bitstream_writer, best_cu_cost,
                              encoder, rec_pic):
        """(ref: inter_search.cc:261-365)"""
        restr = self.restr
        cu_writer = self.enc.cu_writer

        def get_zero_cost(dist):
            w = SyntaxWriter.rdo_clone(bitstream_writer, 0)
            w.write_root_cbf(False)
            bits_zero = w.get_num_written_bits()
            return dist + int(bits_zero * qp.get_lambda() + 0.5)

        max_components = self.pic.max_num_components
        best_cost = [None] * 3
        comp_dist_zero = [0] * 3
        sum_dist_resi = 0
        sum_dist_final = 0
        sum_dist_zero = 0
        tx_rd_flags = TxSearchFlags.FULL_EVAL
        nbr_tx_passes = 1
        if self.settings.fast_transform_select_eval:
            tx_rd_flags &= ~TxSearchFlags.TRANSFORM_SELECT
            nbr_tx_passes = 2

        for tx_pass in range(nbr_tx_passes):
            modified = False
            for comp in range(max_components):
                if tx_pass == 0:
                    pred = self.motion_compensation_cu(cu, comp)
                    encoder.set_pred_buffer(comp, pred)
                prev = None if tx_pass == 0 else best_cost[comp][0]
                zero_holder = []
                tx_cost = encoder.compress_and_eval_transform(
                    cu, comp, qp, bitstream_writer, self.orig_pic,
                    tx_rd_flags, prev, cu_writer, rec_pic,
                    out_dist_zero=zero_holder)
                if zero_holder:
                    comp_dist_zero[comp] = zero_holder[0]
                if tx_pass == 0:
                    sum_dist_resi += tx_cost[2]
                    sum_dist_final += tx_cost[1]
                    sum_dist_zero += comp_dist_zero[comp]
                    best_cost[comp] = tx_cost
                elif tx_cost[0] < best_cost[comp][0]:
                    sum_dist_resi -= best_cost[comp][2]
                    sum_dist_resi += tx_cost[2]
                    sum_dist_final -= best_cost[comp][1]
                    sum_dist_final += tx_cost[1]
                    best_cost[comp] = tx_cost
                    modified = True
            has_any_cbf = any(cu.cbf[:max_components])
            cu.root_cbf = has_any_cbf or restr.disable_transform_root_cbf
            cu.skip_flag = cu.merge_flag and not has_any_cbf

            if (tx_pass == 0 or modified) and \
                    not restr.disable_transform_root_cbf:
                bits_non_zero = encoder.get_cu_bits_residual(
                    cu, bitstream_writer, cu_writer)
                cost_non_zero = sum_dist_resi + \
                    int(bits_non_zero * qp.get_lambda() + 0.5)
                cost_zero = get_zero_cost(sum_dist_zero)
                if cost_zero < cost_non_zero:
                    sum_dist_resi = sum_dist_zero
                    sum_dist_final = sum_dist_zero
                    cu.root_cbf = False
                    for comp in range(max_components):
                        best_cost[comp] = (best_cost[comp][0],
                                           comp_dist_zero[comp],
                                           comp_dist_zero[comp])
                        encoder._clear_cbf(cu, comp, restr)
                        cx, cy = cu.pos(comp)
                        w, h = cu.size(comp)
                        rec_pic.plane_view(comp)[cy:cy + h, cx:cx + w] = \
                            encoder.get_pred_buffer(comp)
                    has_any_cbf = any(cu.cbf[:max_components])
                    cu.skip_flag = cu.merge_flag and not has_any_cbf

            if self.settings.fast_transform_select_eval:
                if not cu.cbf[0]:
                    break
                bits_full = encoder.get_cu_bits_full(cu, bitstream_writer,
                                                     cu_writer)
                cost_full = sum_dist_resi + \
                    int(bits_full * qp.get_lambda() + 0.5)
                if cost_full > best_cu_cost * \
                        FAST_TRANSFORM_SELECT_COST_FACTOR:
                    break
                tx_rd_flags = TxSearchFlags.TRANSFORM_SELECT
        return sum_dist_final

    def compress_skip_only(self, cu, qp, bitstream_writer, encoder, rec_pic):
        """(ref: inter_search.cc:367-390)"""
        restr = self.restr
        if not restr.disable_inter_skip_mode:
            cu.skip_flag = True
        if not restr.disable_transform_root_cbf:
            cu.root_cbf = False
        sum_dist = 0
        for comp in range(self.pic.max_num_components):
            pred = self.motion_compensation_cu(cu, comp)
            cx, cy = cu.pos(comp)
            w, h = cu.size(comp)
            rec_pic.plane_view(comp)[cy:cy + h, cx:cx + w] = pred
            encoder._clear_cbf(cu, comp, restr)
            sum_dist += self.cu_metric.compare(
                qp, comp, self._orig_block(cu, comp), pred)
        return sum_dist

    def get_inter_pred_bits(self, cu, bitstream_writer):
        """(ref: inter_search.cc:1082-1137)"""
        if self.settings.fast_inter_pred_bits:
            rpl = cu.pic.ref_pic_lists
            pic_pred_type = cu.pic.get_prediction_type()
            if cu.inter_dir != k.InterDir.BI:
                ref_list = 0 if cu.inter_dir == k.InterDir.L0 else 1
                num_ref_idx = rpl.get_num_ref_pics(ref_list)
                bits = 1 if pic_pred_type == k.PicturePredictionType.UNI \
                    else 3
                bits += 0 if num_ref_idx <= 1 else cu.ref_idx[ref_list] + 1
                bits -= 1 if (num_ref_idx > 1 and
                              cu.ref_idx[ref_list] == num_ref_idx - 1) else 0
                bits += get_mvp_bits(cu.mvp_idx[ref_list],
                                     k.NUM_INTER_MV_PREDICTORS)
                if cu.use_affine:
                    for i in range(2):
                        bits += get_num_exp_golomb_bits(cu.mvd[ref_list][i][0])
                        bits += get_num_exp_golomb_bits(cu.mvd[ref_list][i][1])
                else:
                    bits += get_num_exp_golomb_bits(cu.mvd[ref_list][0][0])
                    bits += get_num_exp_golomb_bits(cu.mvd[ref_list][0][1])
                return bits
            bits = 5
            for ref_list in range(2):
                num_ref_idx = rpl.get_num_ref_pics(ref_list)
                bits += 0 if num_ref_idx <= 1 else cu.ref_idx[ref_list] + 1
                bits -= 1 if (num_ref_idx > 1 and
                              cu.ref_idx[ref_list] == num_ref_idx - 1) else 0
                bits += get_mvp_bits(cu.mvp_idx[ref_list],
                                     k.NUM_INTER_MV_PREDICTORS)
                if cu.get_force_mvd_zero(ref_list):
                    continue
                if cu.use_affine:
                    for i in range(2):
                        bits += get_num_exp_golomb_bits(cu.mvd[ref_list][i][0])
                        bits += get_num_exp_golomb_bits(cu.mvd[ref_list][i][1])
                else:
                    bits += get_num_exp_golomb_bits(cu.mvd[ref_list][0][0])
                    bits += get_num_exp_golomb_bits(cu.mvd[ref_list][0][1])
            return bits
        rdo_writer = SyntaxWriter.rdo_clone(bitstream_writer, 0)
        self.enc.cu_writer.write_inter_prediction(cu, 0, rdo_writer)
        return rdo_writer.get_num_written_bits()


def _ashr(v, shift):
    """Arithmetic shift right matching C >> on negative ints."""
    return v >> shift


def _lround(v):
    """C lround: round half away from zero."""
    return int(math.floor(v + 0.5)) if v >= 0 else -int(math.floor(-v + 0.5))


def compress_inter_pic(enc, best_cu_holder, qp, rdo_depth, cache_result,
                       writer):
    """(ref: cu_encoder.cc:431-515)"""
    from .cu_encoder import load_cu_state, save_cu_state
    restr = enc.restr
    search = enc.inter_search
    rec_pic = enc.rec_pic
    best_cu = best_cu_holder[0]
    comps = enc.pic.get_components(best_cu.cu_tree)
    cu = enc.pic.create_cu(best_cu.cu_tree, best_cu.depth, best_cu.pos_x,
                           best_cu.pos_y, best_cu.width, best_cu.height)
    cu.qp = qp

    fast_skip_inter = (enc.settings.fast_mode_selection_for_cached_cu and
                       (cache_result.any_intra or cache_result.any_skip) and
                       not restr.disable_inter_merge_mode)
    fast_skip_intra = (enc.settings.fast_mode_selection_for_cached_cu and
                       cache_result.any_inter)
    best = {"cost": _COST_MAX, "dist": 0, "state": None}

    def save_if_best(cost_dist):
        nonlocal cu, best_cu
        cost, dist = cost_dist
        if cost < best["cost"]:
            best["cost"] = cost
            best["dist"] = dist
            best["state"] = save_cu_state(cu, rec_pic, comps)
            best_cu, cu = cu, best_cu

    if cu.can_affine_merge() and \
            not restr.disable_ext2_inter_affine_merge and \
            not restr.disable_inter_merge_mode and \
            not restr.disable_ext2_inter_affine:
        cost = _compress_affine_merge(enc, cu, qp, writer, best["cost"])
        save_if_best(cost)

    if not restr.disable_inter_merge_mode:
        fast_merge_skip = enc.settings.fast_merge_eval and \
            cache_result.any_skip
        cost = _compress_merge(enc, cu, qp, writer, best["cost"],
                               fast_merge_skip)
        save_if_best(cost)

    if not fast_skip_inter:
        cost = _compress_inter_mode(enc, cu, qp, writer, "me", best["cost"])
        save_if_best(cost)

    if not fast_skip_inter and enc.pic.lic_active and \
            not restr.disable_ext2_inter_local_illumination_comp:
        cost = _compress_inter_mode(enc, cu, qp, writer, "lic", best["cost"])
        save_if_best(cost)

    if not restr.disable_ext2_inter_adaptive_fullpel_mv:
        cost = _compress_inter_mode(enc, cu, qp, writer, "fullpel",
                                    best["cost"])
        save_if_best(cost)

    if enc.pic.lic_active and \
            not restr.disable_ext2_inter_local_illumination_comp and \
            not restr.disable_ext2_inter_adaptive_fullpel_mv:
        cost = _compress_inter_mode(enc, cu, qp, writer, "lic_fullpel",
                                    best["cost"])
        save_if_best(cost)

    best_has_cbf = any(best_cu.cbf[:enc.pic.max_num_components])
    if (not fast_skip_intra and best_has_cbf) or \
            enc.settings.always_evaluate_intra_in_inter:
        cost = enc.compress_intra(cu, qp, writer)
        save_if_best(cost)

    load_cu_state(best_cu, rec_pic, best["state"], comps)
    best_cu_holder[0] = best_cu
    return best["dist"]


def _compress_inter_mode(enc, cu, qp, writer, rd_mode, best_cu_cost):
    """(ref: cu_encoder.cc:542-577)"""
    restr = enc.restr
    search = enc.inter_search
    flags = {}
    if cu.pic.get_prediction_type() == k.PicturePredictionType.UNI:
        flags["unipred_only"] = True
    if rd_mode == "me":
        if cu.can_use_affine() and not restr.disable_ext2_inter_affine:
            flags["affine"] = True
    elif rd_mode == "fullpel":
        flags["fullpel"] = True
    elif rd_mode == "lic":
        flags["lic"] = True
    elif rd_mode == "lic_fullpel":
        flags["fullpel"] = True
        flags["lic"] = True
    dist = search.compress_inter(cu, qp, writer, flags, best_cu_cost, enc,
                                 enc.rec_pic)
    if dist >= _DIST_MAX:
        return (_COST_MAX, dist)
    return enc.get_cu_cost_without_split(cu, qp, writer, dist)


def _compress_merge(enc, cu, qp, writer, best_cu_cost, fast_merge_skip):
    """(ref: cu_encoder.cc:579-642)"""
    from .transform_encoder import load_comp_state, save_comp_state
    restr = enc.restr
    search = enc.inter_search
    rec_pic = enc.rec_pic
    num_merge_cand = 1 if restr.disable_inter_merge_candidates else \
        k.NUM_INTER_MERGE_CANDIDATES
    cu.reset_prediction_state()
    cu.pred_mode = k.PredictionMode.INTER
    cu.merge_flag = True

    merge_list = mv_mod.get_merge_candidates(restr, cu)
    if enc.settings.fast_merge_eval and not fast_merge_skip and \
            num_merge_cand > 1:
        num_merge_cand, cand_lookup = search.search_merge_candidates(
            cu, qp, writer, merge_list, enc)
    else:
        cand_lookup = list(range(num_merge_cand))

    comps = enc.pic.get_components(cu.cu_tree)
    best_cost = (_COST_MAX, 0)
    best_merge_idx = -1
    best_state = None
    skip_evaluated = [False] * k.NUM_INTER_MERGE_CANDIDATES
    skip_eval_init = 1 if fast_merge_skip else 0
    for skip_eval_idx in range(skip_eval_init, 2):
        force_skip = skip_eval_idx != 0
        for i in range(num_merge_cand):
            merge_idx = cand_lookup[i]
            if skip_evaluated[merge_idx]:
                continue
            dist = search.compress_merge_cand(
                cu, qp, writer, merge_list, merge_idx, force_skip,
                best_cu_cost, enc, rec_pic)
            cost = enc.get_cu_cost_without_split(cu, qp, writer, dist)
            has_any_cbf = any(cu.cbf[:enc.pic.max_num_components])
            if not has_any_cbf:
                skip_evaluated[merge_idx] = True
            if cost[0] < best_cost[0]:
                best_cu_cost = min(cost[0], best_cu_cost)
                best_cost = cost
                best_merge_idx = merge_idx
                best_state = {c: save_comp_state(cu, rec_pic, c)
                              for c in comps}
                best_state["inter"] = save_inter_state(cu)
                best_state["root_cbf"] = cu.root_cbf
                if not has_any_cbf and not force_skip:
                    # Encoder optimization, assume skip is always best;
                    # only ends this round, the forced-skip round still
                    # evaluates candidates that produced coefficients
                    # (ref: cu_encoder.cc:657-669).
                    break
    cu.merge_idx = best_merge_idx
    mv_mod.apply_merge_cand(cu, merge_list[best_merge_idx])
    for c in comps:
        load_comp_state(cu, rec_pic, c, best_state[c])
    load_inter_state(cu, best_state["inter"])
    cu.root_cbf = best_state["root_cbf"]
    cu.merge_idx = best_merge_idx
    cu.merge_flag = True
    has_any_cbf = any(cu.cbf[:enc.pic.max_num_components])
    cu.skip_flag = not has_any_cbf and not restr.disable_inter_skip_mode
    return best_cost


def _compress_affine_merge(enc, cu, qp, writer, best_cu_cost):
    """(ref: cu_encoder.cc:644-673)"""
    from .transform_encoder import load_comp_state, save_comp_state
    search = enc.inter_search
    rec_pic = enc.rec_pic
    cu.reset_prediction_state()
    cu.pred_mode = k.PredictionMode.INTER
    cu.merge_flag = True
    cu.use_affine = True
    cu.merge_idx = 0
    comps = enc.pic.get_components(cu.cu_tree)
    merge_cand = mv_mod.get_affine_merge_cand(cu)
    dist = search.compress_affine_merge(cu, qp, writer, merge_cand, False,
                                        best_cu_cost, enc, rec_pic)
    best_cost = enc.get_cu_cost_without_split(cu, qp, writer, dist)
    has_any_cbf = any(cu.cbf[:enc.pic.max_num_components])
    if has_any_cbf:
        best_state = {c: save_comp_state(cu, rec_pic, c) for c in comps}
        best_state["inter"] = save_inter_state(cu)
        best_state["root_cbf"] = cu.root_cbf
        dist_skip = search.compress_affine_merge(cu, qp, writer, merge_cand,
                                                 True, best_cu_cost, enc,
                                                 rec_pic)
        cost = enc.get_cu_cost_without_split(cu, qp, writer, dist_skip)
        if cost[0] < best_cost[0]:
            return cost
        cu.skip_flag = False
        for c in comps:
            load_comp_state(cu, rec_pic, c, best_state[c])
        load_inter_state(cu, best_state["inter"])
        cu.root_cbf = best_state["root_cbf"]
    return best_cost
