"""Native picture encode driver (all picture types).

One call to ``xvcn_encode_picture_intra`` (``csrc/xvcn_enc.inc`` +
``csrc/xvcn_enc_inter.inc``; the symbol name is historical: it handles
intra AND inter pictures) runs the whole CTU RDO loop (intra mode
search, motion estimation, merge RD, transform RD, CABAC bit counting
and the final entropy write) in C++ and returns the CABAC payload bytes.
Cross-picture TMVP state rides the same per-4x4 motion-field export as
the native parse.  The device stages hand it their results as two packed
int8 buffers: the split DP's force maps (``gpu/wavefront_rdo.py``) and
the transform-RD prepass's intra candidates (``gpu/txrd_prepass.py``).

Copy of ``xvc_tpu/native/enc.py``.  ``usable_for`` is the JAX package's
routing rule: the sessions it keeps off the native encoder are coded by
the Python CU encoder (``codec/cu_encoder.py``).
"""
import ctypes as c
import os

import numpy as np

from ..engine import use_device_me, use_jax_intra_prepass
from . import lib
from .pic import (XvcnRefPic as _XvcnRefPic, _fam_arrays, _restr_vec,
                  _tx_tables, mvfield_shape)


class XvcnEncSettings(c.Structure):
    _fields_ = [
        ("rdo_quant", c.c_int32),
        ("rdo_quant_2x2", c.c_int32),
        ("structural_ssd", c.c_int32),
        ("structural_strength", c.c_double),
        ("fast_transform_select_eval", c.c_int32),
        ("fast_intra_mode_eval_level", c.c_int32),
        ("fast_cu_split_based_on_full_cu", c.c_int32),
        ("fast_quad_split_based_on_binary_split", c.c_int32),
        ("adaptive_qp", c.c_int32),
        ("aqp_strength", c.c_int32),
        ("eval_prev_mv_search_result", c.c_int32),
        ("fast_merge_eval", c.c_int32),
        ("fast_inter_transform_dist", c.c_int32),
        ("inter_search_range_bi", c.c_int32),
        ("inter_search_range_uni_max", c.c_int32),
        ("inter_search_range_uni_min", c.c_int32),
        ("bipred_refinement_iterations", c.c_int32),
        ("always_evaluate_intra_in_inter", c.c_int32),
        ("fast_mode_selection_for_cached_cu", c.c_int32),
        ("fast_inter_pred_bits", c.c_int32),
        ("skip_mode_decision_for_identical_cu", c.c_int32),
    ]


class XvcnEncPicParams(c.Structure):
    _fields_ = [
        ("ctx_state", c.c_int64),
        ("fam41", c.c_int64),
        ("fam18", c.c_int64),
        ("restr", c.c_int64),
        ("tx_blob", c.c_int64),
        ("tx_offsets", c.c_int64),
        ("orig_plane", c.c_int64 * 3),
        ("orig_stride", c.c_int64 * 3),
        ("rec_plane", c.c_int64 * 3),
        ("rec_stride", c.c_int64 * 3),
        ("out_buf", c.c_int64),
        ("out_cap", c.c_int64),
        ("pic_lambda", c.c_double),
        ("width", c.c_int32),
        ("height", c.c_int32),
        ("bitdepth", c.c_int32),
        ("chroma_fmt", c.c_int32),
        ("pic_qp", c.c_int32),
        ("pred_type", c.c_int32),
        ("max_binary_split_depth", c.c_int32),
        ("chroma_qp_offset_table", c.c_int32),
        ("chroma_qp_offset_u", c.c_int32),
        ("chroma_qp_offset_v", c.c_int32),
        ("deblock", c.c_int32),
        ("beta_offset", c.c_int32),
        ("tc_offset", c.c_int32),
        ("poc", c.c_int32),
        ("num_ctx", c.c_int32),
        ("lic_active", c.c_int32),
        ("tmvp_valid", c.c_int32),
        ("tmvp_ref_list", c.c_int32),
        ("tmvp_ref_idx", c.c_int32),
        ("force_l1_mvd_zero", c.c_int32),
        ("sub_gop_length", c.c_int32),
        ("num_ref", c.c_int32 * 2),
        ("highest_layer", c.c_int32),
        ("refs", (_XvcnRefPic * 5) * 2),
        ("out_mvfield", c.c_int64),
        ("out_mf_stride", c.c_int32),
        ("pad4_", c.c_int32),
        ("settings", XvcnEncSettings),
        ("out_len", c.c_int64),
        ("start_frac_bits", c.c_int64),
        ("status", c.c_int32),
        ("pad2_", c.c_int32),
        ("profile", c.c_int32),
        ("pad5_", c.c_int32),
        ("me_ns", c.c_int64),
        ("intra_search_ns", c.c_int64),
        ("txrd_ns", c.c_int64),
        ("write_ns", c.c_int64),
        ("deblock_ns", c.c_int64),
        ("split_force", c.c_int64),
        ("intra_cands", c.c_int64),
        ("intra_cands_k", c.c_int32),
        ("pad6_", c.c_int32),
    ]


def usable_for(settings):
    """Whether the native encoder codes a session's pictures, as in the
    JAX package (``xvc_tpu/native/enc.py`` ``usable_for``).  The Python CU
    encoder takes the device lookahead's mode-candidate reordering
    (``tpu_intra_lookahead``), the per-CU device SATD pre-pass
    (``XVC_INTRA_PREPASS=jax``, the JAX package's switch under its own
    name), device motion estimation (``XVC_ME=jax``,
    ``engine.use_device_me``), CTU tile rows (``tile_rows >= 2``: the
    native encoder writes one substream a picture) and
    ``XVC_ENC_NATIVE=0``."""
    if os.environ.get("XVC_ENC_NATIVE", "1") == "0":
        return False
    if settings.tile_rows >= 2:
        return False
    if use_jax_intra_prepass():
        return False
    if use_device_me():
        return False
    return not settings.tpu_intra_lookahead


def _surface_base(pic, comp):
    """Visible-origin pointer into the picture's int16 surface."""
    buf = pic.rec16(comp)
    off = (pic.pad_y[comp] * buf.shape[1] + pic.pad_x[comp]) * 2
    return buf.ctypes.data + off, buf.shape[1], buf


def encode_picture(pic_encoder, segment, settings, base_qp,
                   split_force=None, intra_cands=None, intra_cands_k=0):
    """Returns the CABAC payload bytes for one picture; the
    reconstruction is written into pic_encoder.rec_pic in place.
    split_force: optional packed int8 force-map buffer from
    gpu/wavefront_rdo.pack_force_maps (device split DP).
    intra_cands: optional packed int8 candidate buffer from
    gpu/txrd_prepass.pack_intra_cands (device transform-RD prepass)."""
    pd = pic_encoder.pic_data
    rec = pic_encoder.rec_pic
    orig = pic_encoder.orig_pic
    restr = segment.restrictions
    fam41, fam18 = _fam_arrays()
    tx_blob, tx_offsets = _tx_tables()
    restr_vec = _restr_vec(restr)

    from ..cabac.contexts import NUM_CONTEXTS, CabacContexts
    ctx = CabacContexts(restr)
    ctx.reset_states(base_qp.get_qp_raw(0), pd.get_prediction_type())

    p = XvcnEncPicParams()
    p.ctx_state = ctx.state.ctypes.data
    p.fam41 = fam41.ctypes.data
    p.fam18 = fam18.ctypes.data
    p.restr = restr_vec.ctypes.data
    p.tx_blob = tx_blob.ctypes.data
    p.tx_offsets = tx_offsets.ctypes.data
    rec.begin_native16()  # recon goes to the int16 surface
    for comp in range(3):
        obuf = orig.padded_plane(comp)
        p.orig_plane[comp] = obuf.ctypes.data + 4 * (
            orig.pad_y[comp] * obuf.shape[1] + orig.pad_x[comp])
        p.orig_stride[comp] = obuf.shape[1]
        rb, rstride, _rbuf = _surface_base(rec, comp)
        p.rec_plane[comp] = rb
        p.rec_stride[comp] = rstride
    out = np.zeros(max(1 << 16, pd.width * pd.height * 4), dtype=np.uint8)
    p.out_buf = out.ctypes.data
    p.out_cap = out.size
    p.pic_lambda = base_qp.get_lambda()
    p.width = pd.width
    p.height = pd.height
    p.bitdepth = pd.bitdepth
    p.chroma_fmt = int(pd.chroma_format)
    p.pic_qp = base_qp.get_qp_raw(0)
    p.pred_type = int(pd.get_prediction_type())
    p.max_binary_split_depth = segment.max_binary_split_depth
    p.chroma_qp_offset_table = settings.chroma_qp_offset_table
    p.chroma_qp_offset_u = settings.chroma_qp_offset_u
    p.chroma_qp_offset_v = settings.chroma_qp_offset_v
    p.deblock = 1 if pd.deblock else 0
    p.beta_offset = pd.beta_offset
    p.tc_offset = pd.tc_offset
    p.poc = pd.poc
    p.num_ctx = NUM_CONTEXTS
    p.lic_active = 1 if pd.lic_active else 0
    p.tmvp_valid = 1 if pd.tmvp_valid else 0
    p.tmvp_ref_list = pd.tmvp_ref_list
    p.tmvp_ref_idx = pd.tmvp_ref_idx
    p.force_l1_mvd_zero = 1 if pd.force_bipred_l1_mvd_zero else 0
    p.sub_gop_length = pd.sub_gop_length
    p.highest_layer = 1 if pd.highest_layer else 0
    rows, cols = mvfield_shape(pd.width, pd.height)
    mvfield = np.zeros(rows * cols * 8, dtype=np.int32)
    p.out_mvfield = mvfield.ctypes.data
    p.out_mf_stride = cols
    s = p.settings
    s.rdo_quant = 1 if settings.rdo_quant else 0
    s.rdo_quant_2x2 = settings.rdo_quant_2x2
    s.structural_ssd = settings.structural_ssd
    s.structural_strength = float(settings.structural_strength)
    s.fast_transform_select_eval = settings.fast_transform_select_eval
    s.fast_intra_mode_eval_level = settings.fast_intra_mode_eval_level
    s.fast_cu_split_based_on_full_cu = \
        1 if settings.fast_cu_split_based_on_full_cu else 0
    s.fast_quad_split_based_on_binary_split = \
        settings.fast_quad_split_based_on_binary_split
    s.adaptive_qp = settings.adaptive_qp
    s.aqp_strength = settings.aqp_strength
    s.eval_prev_mv_search_result = settings.eval_prev_mv_search_result
    s.fast_merge_eval = settings.fast_merge_eval
    s.fast_inter_transform_dist = \
        1 if settings.fast_inter_transform_dist else 0
    s.inter_search_range_bi = settings.inter_search_range_bi
    s.inter_search_range_uni_max = settings.inter_search_range_uni_max
    s.inter_search_range_uni_min = settings.inter_search_range_uni_min
    s.bipred_refinement_iterations = settings.bipred_refinement_iterations
    s.always_evaluate_intra_in_inter = \
        settings.always_evaluate_intra_in_inter
    s.fast_mode_selection_for_cached_cu = \
        1 if settings.fast_mode_selection_for_cached_cu else 0
    s.fast_inter_pred_bits = settings.fast_inter_pred_bits
    s.skip_mode_decision_for_identical_cu = \
        1 if settings.skip_mode_decision_for_identical_cu else 0

    if split_force is not None:
        p.split_force = split_force.ctypes.data
    if intra_cands is not None:
        p.intra_cands = intra_cands.ctypes.data
        p.intra_cands_k = intra_cands_k
    keep_alive = [ctx.state, fam41, fam18, tx_blob, tx_offsets, restr_vec,
                  out, mvfield, split_force, intra_cands] + \
                 [orig.planes[i] for i in range(3)] + \
                 [rec.rec16(i) for i in range(3)]
    rpl = pd.ref_pic_lists
    for lst in range(2):
        n = min(rpl.get_num_ref_pics(lst), 5)
        p.num_ref[lst] = n
        for i in range(n):
            entry = rpl.entries[lst][i]
            rp = p.refs[lst][i]
            rp.poc = entry.poc
            rp.pic_type = int(entry.pic_data.get_prediction_type())
            rp.width = entry.rec_pic.width[0]
            rp.height = entry.rec_pic.height[0]
            for comp in range(3):
                # int16 reference surface (ME fullpel SAD and MC both
                # read it; the one-pass convert for Python-path pics
                # amortizes over the many re-reads per CU)
                sh = entry.rec_pic.shadow16(comp)
                off16 = 2 * (entry.rec_pic.pad_y[comp] * sh.shape[1] +
                             entry.rec_pic.pad_x[comp])
                rp.plane16[comp] = sh.ctypes.data + off16
                rp.plane[comp] = rp.plane16[comp]  # presence flag only
                rp.stride[comp] = sh.shape[1]
                keep_alive.append(sh)
            mf = getattr(entry.pic_data, "_xvcn_mvfield", None)
            if mf is not None and entry.rec_pic.width[0] == pd.width and \
                    entry.rec_pic.height[0] == pd.height:
                rp.mvfield = mf.ctypes.data
                rp.mf_stride = getattr(entry.pic_data, "_xvcn_mf_stride", 0)
                keep_alive.append(mf)
            else:
                rp.mvfield = 0
                rp.mf_stride = 0
    from ..profiling import add_span_time, enabled as _prof_enabled
    p.profile = 1 if _prof_enabled() else 0
    status = lib().xvcn_encode_picture_intra(c.byref(p))
    if p.profile:
        # me/intra_search overlap txrd: txrd is a nested sub-span of
        # both search stages (same convention as decode.native.recon.*);
        # the "encode.native" total span lives in picture_encoder.py
        add_span_time("encode.native.me", p.me_ns / 1e9)
        add_span_time("encode.native.intra_search", p.intra_search_ns / 1e9)
        add_span_time("encode.native.txrd", p.txrd_ns / 1e9)
        add_span_time("encode.native.write", p.write_ns / 1e9)
        add_span_time("encode.native.deblock", p.deblock_ns / 1e9)
    del keep_alive
    if status != 0:
        raise RuntimeError("native encode failed (status %d)" % status)
    pd._xvcn_mvfield = mvfield
    pd._xvcn_mf_stride = cols
    return out[:p.out_len].tobytes()
