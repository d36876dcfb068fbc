"""Quantization with rate-distortion optimization + sign-bit hiding.

Behavioral equivalent of the reference RDO quantizer
(ref: src/xvc_enc_lib/rdo_quant.cc).  Copy of ``xvc_tpu/codec/
rdo_quant.py`` with its native RDO route: the fast quantizer and its sign
hiding in numpy, the full RDO quantization (context-accurate fractional
bit costs against the writer's CABAC states) in one call of the native
library (the JAX module's Python twin of it is not copied).
"""
import numpy as np

from .. import constants as k
from .. import native
from .. import scan as scan_mod
from ..cabac.contexts import OFFSETS
from ..native.engines import quant_rdo_native
from ..ops import quant as q

LAMBDA_PRECISION = 16


class RdoQuant:
    def __init__(self, bitdepth, encoder_settings):
        self.bitdepth = bitdepth
        self.settings = encoder_settings

    def quant_fast(self, cu, comp, qp, pic_type, src, out):
        """(ref: rdo_quant.cc:156-201). src/out are (h, w) int arrays."""
        height, width = src.shape
        wl2, hl2 = width.bit_length() - 1, height.bit_length() - 1
        size_rounding_bias = ((wl2 + hl2) % 2) != 0
        transform_shift = q.get_transform_shift(width, height, self.bitdepth)
        shift = q.QUANT_SHIFT + qp.get_qp_per(comp) + transform_shift + \
            (7 if size_rounding_bias else 0)
        scale = qp.get_fwd_scale(comp) * (181 if size_rounding_bias else 1)
        offset = (171 if pic_type == k.PicturePredictionType.INTRA
                  else 85) << (shift - 9)
        s = src.astype(np.int64)
        sign = np.where(s < 0, -1, 1)
        abs_coeff = np.abs(s)
        level = (abs_coeff * scale + offset) >> shift
        out[:, :] = np.clip(level * sign, k.INT16_MIN, k.INT16_MAX)
        delta = ((abs_coeff * scale) - (level << shift)) >> (shift - 8)
        delta = delta.astype(np.int16).astype(np.int64)  # Coeff cast
        num_non_zero = int(np.count_nonzero(level))
        restr = cu.pic.restrictions
        if not restr.disable_transform_sign_hiding and \
                num_non_zero > 1 and width >= 4 and height >= 4:
            num_non_zero = self._sign_hide_fast(cu, comp, width, height,
                                                src, delta, out)
        return num_non_zero

    def _sign_hide_fast(self, cu, comp, width, height, src, delta, out):
        """(ref: rdo_quant.cc:448-573)"""
        restr = cu.pic.restrictions
        subblock_shift = k.SUBBLOCK_SHIFT
        subblock_size = 1 << (2 * subblock_shift)
        intra_mode = cu.get_intra_mode(comp) if cu.is_intra() else 0
        scan_order = scan_mod.determine_scan_order(cu, comp == 0, intra_mode,
                                                   restr)
        scan_table = scan_mod.SCAN_COEFF_4X4[scan_order]
        sw = width >> subblock_shift
        sh = height >> subblock_shift
        sub_scan = scan_mod.derive_subblock_scan(scan_order, sw, sh)
        num_non_zero = int(np.count_nonzero(out))
        last_subblock = -1
        mask = (1 << subblock_shift) - 1
        for si in range(sw * sh - 1, -1, -1):
            sscan = sub_scan[si]
            sy = sscan // sw
            sx = sscan - sy * sw
            px, py = sx << subblock_shift, sy << subblock_shift

            def coords(idx):
                so = scan_table[idx]
                return py + (so >> subblock_shift), px + (so & mask)

            first_nz, last_nz = subblock_size, -1
            abs_sum = 0
            for ci in range(subblock_size):
                yy, xx = coords(ci)
                c = int(out[yy, xx])
                if c:
                    first_nz = min(first_nz, ci)
                    last_nz = max(last_nz, ci)
                    abs_sum += c
            if last_nz >= 0 and last_subblock == -1:
                last_subblock = 1
            if last_nz - first_nz > k.SIGN_HIDING_THRESHOLD:
                yy, xx = coords(first_nz)
                sign = 0 if int(out[yy, xx]) > 0 else 1
                if sign != (abs_sum & 1):
                    min_cost = 32767
                    min_change = 0
                    min_index = -1
                    start = last_nz if last_subblock == 1 else \
                        subblock_size - 1
                    for ci in range(start, -1, -1):
                        yy, xx = coords(ci)
                        if int(out[yy, xx]) != 0:
                            if int(delta[yy, xx]) > 0:
                                curr_cost = -int(delta[yy, xx])
                                curr_change = 1
                            else:
                                if ci == first_nz and \
                                        abs(int(out[yy, xx])) == 1:
                                    curr_cost = 32767
                                    curr_change = 0
                                else:
                                    curr_cost = int(delta[yy, xx])
                                    curr_change = -1
                        else:
                            if ci < first_nz:
                                this_sign = 0 if int(src[yy, xx]) >= 0 else 1
                                if this_sign != sign:
                                    curr_cost = 32767
                                    curr_change = 0
                                else:
                                    curr_cost = -int(delta[yy, xx])
                                    curr_change = 1
                            else:
                                curr_cost = -int(delta[yy, xx])
                                curr_change = 1
                        if curr_cost < min_cost:
                            min_cost = curr_cost
                            min_change = curr_change
                            min_index = ci
                    yy, xx = coords(min_index)
                    if int(out[yy, xx]) in (k.INT16_MIN, k.INT16_MAX):
                        min_change = -1
                    if not int(out[yy, xx]):
                        num_non_zero += 1
                    if int(src[yy, xx]) >= 0:
                        out[yy, xx] += min_change
                    else:
                        out[yy, xx] -= min_change
                    if not int(out[yy, xx]):
                        num_non_zero -= 1
            if last_subblock == 1:
                last_subblock = 0
        return num_non_zero

    # ---- full RDO quantization ----

    def quant_rdo(self, cu, comp, qp, pic_type, writer, src, out):
        w, h = cu.size(comp)
        if w == 2 or h == 2:
            if not self.settings.rdo_quant_2x2:
                return self.quant_fast(cu, comp, qp, pic_type, src, out)
            subblock_shift = 1
        else:
            subblock_shift = k.SUBBLOCK_SHIFT
        return self._quant_rdo_native(cu, comp, qp, writer, src, out,
                                      subblock_shift)

    def _quant_rdo_native(self, cu, comp, qp, writer, src, out,
                          subblock_shift):
        restr = cu.pic.restrictions
        height, width = src.shape
        is_luma = comp == 0
        intra_mode = cu.get_intra_mode(comp) if cu.is_intra() else 0
        scan_order = scan_mod.determine_scan_order(cu, is_luma, intra_mode,
                                                   restr)
        if not is_luma:
            cbf_idx = OFFSETS["cu_cbf_chroma"]
        elif cu.is_intra():
            cbf_idx = OFFSETS["cu_cbf_luma"]
        else:
            cbf_idx = OFFSETS["cu_root_cbf"]
        lam = qp.get_lambda_scaled(comp)
        lambda_fp = int(lam * (1 << LAMBDA_PRECISION) + 0.5)
        inv_scale = qp.get_inv_scale(comp)
        subblock_size = 1 << (2 * subblock_shift)
        rd_factor = int(float(inv_scale) * float(inv_scale) / lam /
                        subblock_size / (1 << (2 * (self.bitdepth - 8))) +
                        0.5) if lam > 0 else 0
        if src.dtype != np.int32 or not src.flags["C_CONTIGUOUS"]:
            src = np.ascontiguousarray(src, dtype=np.int32)
        assert out.dtype == np.int32 and out.flags["C_CONTIGUOUS"]
        return quant_rdo_native(
            writer.ctx.state, native.restr_bits(restr), width, height,
            subblock_shift, is_luma, scan_order, self.bitdepth,
            qp.get_qp_per(comp), qp.get_fwd_scale(comp), inv_scale,
            lambda_fp, cbf_idx, rd_factor, src, out)
