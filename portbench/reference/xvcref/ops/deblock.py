"""In-loop deblocking filter.

Behavioral equivalent of the reference deblocking filter
(ref: src/xvc_common_lib/deblocking_filter.cc): CTU-ordered, vertical
edges then horizontal edges on a 4-pel (ext) or 8-pel grid, HEVC-style
strong/weak luma filtering, chroma only at boundary strength 2.
"""
import numpy as np

from .. import constants as k

TC_TABLE = (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1,
            1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6,
            7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24)
BETA_TABLE = (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7, 8, 9,
              10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30,
              32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60,
              62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88)

SUBBLOCK_SIZE = 8
SUBBLOCK_SIZE_EXT = 4
FILTER_GROUP_SIZE = 4
CHROMA_FILTER_RESOLUTION = 8


class DeblockingFilter:
    def __init__(self, pic_data, rec_pic, beta_offset, tc_offset,
                 restrictions):
        self.pic = pic_data
        self.rec = rec_pic
        self.beta_offset = beta_offset
        self.tc_offset = tc_offset
        self.restr = restrictions

    def deblock_picture(self):
        r = self.restr
        has_secondary = self.pic.has_secondary_cu_tree()
        num_ctus = self.pic.get_number_of_ctus()
        subblock_size = SUBBLOCK_SIZE if \
            r.disable_ext_deblock_subblock_size_4 else SUBBLOCK_SIZE_EXT
        for direction in (0, 1):  # 0 = vertical edges, 1 = horizontal
            for rsaddr in range(num_ctus):
                self._deblock_ctu(rsaddr, k.CuTree.PRIMARY, direction,
                                  subblock_size)
                if has_secondary:
                    self._deblock_ctu(rsaddr, k.CuTree.SECONDARY, direction,
                                      SUBBLOCK_SIZE)

    def _deblock_ctu(self, rsaddr, cu_tree, direction, subblock_size):
        r = self.restr
        ctu = self.pic.get_ctu(k.CuTree.PRIMARY, rsaddr)
        ctu_x, ctu_y = ctu.pos_x, ctu.pos_y
        csx = self.rec.shift_x[1]
        csy = self.rec.shift_y[1]
        deblock_luma = cu_tree == k.CuTree.PRIMARY
        deblock_chroma = (self.pic.max_num_components > 1 and
                          (not self.pic.has_secondary_cu_tree() or
                           cu_tree == k.CuTree.SECONDARY) and
                          not r.disable_deblock_chroma_filter)
        for dy in range(0, k.MAX_BLOCK_SIZE, subblock_size):
            for dx in range(0, k.MAX_BLOCK_SIZE, subblock_size):
                x = ctu_x + dx
                y = ctu_y + dy
                if x >= self.pic.width or y >= self.pic.height:
                    continue
                cu_q = self.pic.get_cu_at(cu_tree, x, y)
                if cu_q is None:
                    continue
                if direction == 0:
                    cu_p = self.pic.get_cu_at(cu_tree, x - 1, y) \
                        if x > 0 else None
                else:
                    cu_p = self.pic.get_cu_at(cu_tree, x, y - 1) \
                        if y > 0 else None
                if cu_p is None or (cu_p.pos_x == cu_q.pos_x and
                                    cu_p.pos_y == cu_q.pos_y):
                    continue
                bs = self._get_boundary_strength(cu_p, cu_q, x, y, direction)
                if not bs:
                    continue
                qp = (cu_p.qp.get_qp_raw(0) + cu_q.qp.get_qp_raw(0) + 1) >> 1
                if r.disable_deblock_depending_on_qp:
                    qp = 32
                if deblock_luma:
                    self._filter_edge_luma(x, y, direction, subblock_size,
                                           bs, qp)
                if deblock_chroma and bs == 2:
                    chroma_qp = (cu_p.qp.get_qp_raw(1) +
                                 cu_q.qp.get_qp_raw(1) + 1) >> 1
                    if r.disable_deblock_depending_on_qp:
                        chroma_qp = 31
                    cx = x >> csx
                    cy = y >> csy
                    if direction == 0 and \
                            (cx & (CHROMA_FILTER_RESOLUTION - 1)) == 0:
                        self._filter_edge_chroma(cx, cy, csx, csy, direction,
                                                 subblock_size, chroma_qp)
                    elif direction == 1 and \
                            (cy & (CHROMA_FILTER_RESOLUTION - 1)) == 0:
                        self._filter_edge_chroma(cx, cy, csx, csy, direction,
                                                 subblock_size, chroma_qp)

    def _get_boundary_strength(self, cu_p, cu_q, pos_x, pos_y, direction):
        """(ref: deblocking_filter.cc:154-241)"""
        r = self.restr
        one_step = 16  # MotionVector::kScale
        bs = 1 if r.disable_deblock_boundary_strength_zero else 0
        if direction == 0:
            corner_p = 1 if (pos_y - cu_p.pos_y) < (cu_p.height >> 1) else 3
            corner_q = 0 if (pos_y - cu_q.pos_y) < (cu_q.height >> 1) else 2
        else:
            corner_p = 2 if (pos_x - cu_p.pos_x) < (cu_p.width >> 1) else 3
            corner_q = 0 if (pos_x - cu_q.pos_x) < (cu_q.width >> 1) else 1

        if cu_p.is_intra() or cu_q.is_intra():
            bs = 2
        elif cu_p.cbf[0] or cu_q.cbf[0]:
            bs = 1
        elif self.pic.get_prediction_type() == k.PicturePredictionType.BI:
            ref_p0 = cu_p.get_ref_poc(0)
            ref_p1 = cu_p.get_ref_poc(1)
            ref_q0 = cu_q.get_ref_poc(0)
            ref_q1 = cu_q.get_ref_poc(1)
            if (ref_p0 == ref_q0 and ref_p1 == ref_q1) or \
                    (ref_p0 == ref_q1 and ref_p1 == ref_q0):
                mv_p0 = cu_p.mv[0][corner_p]
                mv_p1 = cu_p.mv[1][corner_p]
                mv_q0 = cu_q.mv[0][corner_q]
                mv_q1 = cu_q.mv[1][corner_q]

                def cond1():
                    return (abs(mv_p0[0] - mv_q0[0]) >= one_step or
                            abs(mv_p0[1] - mv_q0[1]) >= one_step or
                            abs(mv_p1[0] - mv_q1[0]) >= one_step or
                            abs(mv_p1[1] - mv_q1[1]) >= one_step)

                def cond2():
                    return (abs(mv_p0[0] - mv_q1[0]) >= one_step or
                            abs(mv_p0[1] - mv_q1[1]) >= one_step or
                            abs(mv_p1[0] - mv_q0[0]) >= one_step or
                            abs(mv_p1[1] - mv_q0[1]) >= one_step)

                if ref_p0 != ref_p1:
                    if ref_p0 == ref_q0:
                        if cond1():
                            bs = 1
                    else:
                        if cond2():
                            bs = 1
                else:
                    if cond1() and cond2():
                        bs = 1
            else:
                bs = 1
        else:
            if cu_p.ref_idx[0] != cu_q.ref_idx[0]:
                bs = 1
            else:
                mv_p0 = cu_p.mv[0][corner_p]
                mv_q0 = cu_q.mv[0][corner_q]
                if abs(mv_p0[0] - mv_q0[0]) >= one_step or \
                        abs(mv_p0[1] - mv_q0[1]) >= one_step:
                    bs = 1
        if bs == 1 and r.disable_deblock_boundary_strength_one:
            bs = 2
        return bs

    def _filter_edge_luma(self, x, y, direction, subblock_size, bs, qp):
        r = self.restr
        plane = self.rec.padded_plane(0)
        px, py = self.rec.pad_x[0], self.rec.pad_y[0]
        bitdepth_shift = self.pic.bitdepth - 8

        def sample(i, j):
            # i = along edge, j = across edge (negative = p side)
            if direction == 0:
                return plane[py + y + i, px + x + j]
            return plane[py + y + j, px + x + i]

        def set_sample(i, j, v):
            if direction == 0:
                plane[py + y + i, px + x + j] = v
            else:
                plane[py + y + j, px + x + i] = v

        nbr_groups = subblock_size // FILTER_GROUP_SIZE
        for group_idx in range(nbr_groups):
            index_beta = min(max(qp + self.beta_offset, 0),
                             len(BETA_TABLE) - 1)
            beta = BETA_TABLE[index_beta] << bitdepth_shift
            g = group_idx * FILTER_GROUP_SIZE

            def dp(i):
                return abs(sample(i, -3) - 2 * sample(i, -2) + sample(i, -1))

            def dq(i):
                return abs(sample(i, 0) - 2 * sample(i, 1) + sample(i, 2))

            dp0, dq0 = dp(g), dq(g)
            dp3, dq3 = dp(g + 3), dq(g + 3)
            d0 = dp0 + dq0
            d3 = dp3 + dq3
            d = d0 + d3
            if d >= beta and not r.disable_deblock_initial_sample_decision:
                continue
            index_tc = min(max(qp + self.tc_offset + 2 * (bs - 1), 0),
                           len(TC_TABLE) - 1)
            tc = TC_TABLE[index_tc] << bitdepth_shift

            strong = (d0 << 1) < (beta >> 2) and (d3 << 1) < (beta >> 2)
            strong = strong and self._check_strong(sample, g, beta, tc)
            strong = strong and self._check_strong(sample, g + 3, beta, tc)
            if strong and not r.disable_deblock_strong_filter:
                self._filter_luma_strong(sample, set_sample, g, 2 * tc)
            else:
                if r.disable_deblock_weak_filter:
                    continue
                side_threshold = (beta + (beta >> 1)) >> 3
                filter_p1 = (dp0 + dp3) < side_threshold
                filter_q1 = (dq0 + dq3) < side_threshold
                self._filter_luma_weak(sample, set_sample, g, tc,
                                       filter_p1, filter_q1)

    @staticmethod
    def _check_strong(sample, i, beta, tc):
        p3, p0 = sample(i, -4), sample(i, -1)
        q0, q3 = sample(i, 0), sample(i, 3)
        test2 = (abs(p3 - p0) + abs(q0 - q3)) < (beta >> 3)
        test3 = abs(p0 - q0) < ((tc * 5 + 1) >> 1)
        return test2 and test3

    def _filter_luma_weak(self, sample, set_sample, g, tc,
                          filter_p1, filter_q1):
        r = self.restr
        sample_max = (1 << self.pic.bitdepth) - 1
        threshold = tc * 10
        half_tc = tc >> 1
        for i in range(g, g + FILTER_GROUP_SIZE):
            p1, p0 = sample(i, -2), sample(i, -1)
            q0, q1 = sample(i, 0), sample(i, 1)
            delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
            if abs(delta) >= threshold and \
                    not r.disable_deblock_weak_sample_decision:
                continue
            delta = min(max(delta, -tc), tc)
            set_sample(i, -1, min(max(p0 + delta, 0), sample_max))
            set_sample(i, 0, min(max(q0 - delta, 0), sample_max))
            if not r.disable_deblock_two_samples_weak_filter:
                if filter_p1:
                    p2 = sample(i, -3)
                    delta_p1 = min(max(
                        (((p2 + p0 + 1) >> 1) - p1 + delta) >> 1,
                        -half_tc), half_tc)
                    set_sample(i, -2, min(max(p1 + delta_p1, 0), sample_max))
                if filter_q1:
                    q2 = sample(i, 2)
                    delta_q1 = min(max(
                        (((q2 + q0 + 1) >> 1) - q1 - delta) >> 1,
                        -half_tc), half_tc)
                    set_sample(i, 1, min(max(q1 + delta_q1, 0), sample_max))

    @staticmethod
    def _filter_luma_strong(sample, set_sample, g, tc2):
        for i in range(g, g + FILTER_GROUP_SIZE):
            p3, p2, p1, p0 = (sample(i, -4), sample(i, -3), sample(i, -2),
                              sample(i, -1))
            q0, q1, q2, q3 = (sample(i, 0), sample(i, 1), sample(i, 2),
                              sample(i, 3))
            np2 = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3
            np1 = (p2 + p1 + p0 + q0 + 2) >> 2
            np0 = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3
            nq0 = (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3
            nq1 = (p0 + q0 + q1 + q2 + 2) >> 2
            nq2 = (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3
            set_sample(i, -3, p2 + min(max(np2 - p2, -tc2), tc2))
            set_sample(i, -2, p1 + min(max(np1 - p1, -tc2), tc2))
            set_sample(i, -1, p0 + min(max(np0 - p0, -tc2), tc2))
            set_sample(i, 0, q0 + min(max(nq0 - q0, -tc2), tc2))
            set_sample(i, 1, q1 + min(max(nq1 - q1, -tc2), tc2))
            set_sample(i, 2, q2 + min(max(nq2 - q2, -tc2), tc2))

    def _filter_edge_chroma(self, x, y, scale_x, scale_y, direction,
                            subblock_size, qp):
        bitdepth_shift = self.pic.bitdepth - 8
        index_tc = min(max(qp + self.tc_offset + 2, 0), len(TC_TABLE) - 1)
        tc = TC_TABLE[index_tc] << bitdepth_shift
        scaled_subblock_size = subblock_size >> scale_y if direction == 0 \
            else subblock_size >> scale_x
        sample_max = (1 << self.pic.bitdepth) - 1
        for c in (1, 2):
            plane = self.rec.padded_plane(c)
            px, py = self.rec.pad_x[c], self.rec.pad_y[c]

            def sample(i, j):
                if direction == 0:
                    return plane[py + y + i, px + x + j]
                return plane[py + y + j, px + x + i]

            def set_sample(i, j, v):
                if direction == 0:
                    plane[py + y + i, px + x + j] = v
                else:
                    plane[py + y + j, px + x + i] = v

            for i in range(scaled_subblock_size):
                p1, p0 = sample(i, -2), sample(i, -1)
                q0, q1 = sample(i, 0), sample(i, 1)
                delta = min(max((((q0 - p0) * 4) + p1 - q1 + 4) >> 3,
                                -tc), tc)
                set_sample(i, -1, min(max(p0 + delta, 0), sample_max))
                set_sample(i, 0, min(max(q0 - delta, 0), sample_max))
