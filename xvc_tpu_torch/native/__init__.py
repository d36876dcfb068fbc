"""Native host runtime: g++ build + ctypes binding of ``csrc/xvcn.cpp``.

The C++ library holds the sequential part of decoding: the CABAC parse
and the MV derivation of a whole picture (``xvcn_parse_picture``,
``csrc/xvcn_pic.inc``), which emit the flat record table the device path
reconstructs from, and the block predictors of the replay path's host
tail (``xvcn_intra_*``, ``xvcn_mc_unipred``).  It also holds the
encoder's CTU rate-distortion search and entropy write of a whole
picture (``xvcn_encode_picture_intra``, ``csrc/xvcn_enc.inc`` and
``csrc/xvcn_enc_inter.inc``; ``native/enc.py``), which consumes the
device stages' force maps and intra candidates, and the block-level
helpers of the Python CU encoder (``native/engines.py``: the CABAC
writer, residual coding and counting, RDO quantization; the metric,
forward transform, fused reconstruction and intra SATD prepass its
search calls).  It is compiled with g++
the first time it is needed, into ``build/xvc_tpu_torch/`` at the root
of the checkout (never next to the sources), and cached there under a
hash of the sources.

``csrc/`` is a copy of ``xvc_tpu/native/xvcn.cpp``, ``xvcn_pic.inc``,
``xvcn_enc.inc`` and ``xvcn_enc_inter.inc``.  A build failure raises:
there is no Python parse or pure-Python block coder to fall back to.
"""
import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_SOURCES = ("xvcn.cpp", "xvcn_pic.inc", "xvcn_enc.inc",
            "xvcn_enc_inter.inc")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_ROOT, "build", "xvc_tpu_torch")

# Context family order; must match enum FamIdx in xvcn.cpp.
FAMILY_ORDER = [
    "coeff_csbf_luma", "coeff_csbf_chroma",
    "coeff_sig_luma", "coeff_sig_chroma",
    "coeff_greater1_luma", "coeff_greater1_chroma",
    "coeff_greater2_luma", "coeff_greater2_chroma",
    "coeff_ext_csbf_luma", "coeff_ext_csbf_chroma",
    "coeff_ext_sig_luma", "coeff_ext_sig_chroma",
    "coeff_ext_greater1_luma", "coeff_ext_greater1_chroma",
    "coeff_last_pos_x_luma", "coeff_last_pos_x_chroma",
    "coeff_last_pos_y_luma", "coeff_last_pos_y_chroma",
]


# Restriction-flag bit order of the residual coder; must match enum
# RestrBit in xvcn.cpp.
RESTR_FLAG_ORDER = [
    "disable_ext2_cabac_alt_residual_ctx",
    "disable_cabac_coeff_sig_ctx",
    "disable_cabac_coeff_greater1_ctx",
    "disable_cabac_coeff_greater2_ctx",
    "disable_cabac_coeff_last_pos_ctx",
    "disable_cabac_subblock_csbf_ctx",
    "disable_ext_cabac_alt_last_pos_ctx",
    "disable_transform_cbf",
    "disable_transform_subblock_csbf",
    "disable_transform_last_position",
    "disable_transform_residual_greater_than_flags",
    "disable_transform_residual_greater2",
    "disable_transform_sign_hiding",
    "disable_transform_adaptive_exp_golomb",
]


def restr_bits(restr) -> int:
    """The residual coder's restriction mask (cached on ``restr``)."""
    bits = getattr(restr, "_xvcn_mask", None)
    if bits is None:
        bits = 0
        for i, name in enumerate(RESTR_FLAG_ORDER):
            if getattr(restr, name):
                bits |= 1 << i
        try:
            restr._xvcn_mask = bits
        except AttributeError:
            pass
    return bits


def family_offsets() -> np.ndarray:
    from ..cabac.contexts import OFFSETS
    return np.array([OFFSETS[f] for f in FAMILY_ORDER], dtype=np.int32)


def build() -> str:
    """Compile the library if the one for the current sources is
    missing; return its path."""
    h = hashlib.sha256()
    for name in _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    so_path = os.path.join(BUILD_DIR, "xvcn_%s.so" % h.hexdigest()[:16])
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.tmp%d" % (so_path, os.getpid())
    base = ["g++", "-std=c++14", "-O3", "-fPIC", "-shared",
            "-fvisibility=hidden"]
    # -march=native lets the compiler vectorize the parse's table loops
    # for the machine the library is built on; drop it if the toolchain
    # refuses it
    for extra in (["-march=native"], []):
        res = subprocess.run(
            base + extra + [os.path.join(_CSRC, "xvcn.cpp"), "-o", tmp],
            capture_output=True, text=True)
        if res.returncode == 0:
            break
    else:
        raise RuntimeError("g++ failed to build the native library:\n%s"
                           % res.stderr[-2000:])
    os.replace(tmp, so_path)
    return so_path


def _bind_block_coder(handle):
    """The exports the Python CU encoder calls (native/engines.py and
    its search)."""
    c = ctypes
    p = c.c_void_p
    handle.xvcn_enc_create.restype = c.c_void_p
    handle.xvcn_enc_create.argtypes = [c.c_int, c.c_int, c.c_int64]
    handle.xvcn_enc_destroy.argtypes = [p]
    handle.xvcn_enc_get_frac_bits.restype = c.c_uint64
    handle.xvcn_enc_get_frac_bits.argtypes = [p]
    handle.xvcn_enc_set_frac_bits.argtypes = [p, c.c_uint64]
    handle.xvcn_enc_get_out_len.restype = c.c_int64
    handle.xvcn_enc_get_out_len.argtypes = [p]
    handle.xvcn_enc_copy_out.argtypes = [p, p]
    handle.xvcn_enc_encode_bin.argtypes = [p, p, c.c_int, c.c_int]
    handle.xvcn_enc_encode_bypass.argtypes = [p, c.c_int]
    handle.xvcn_enc_encode_bypass_bins.argtypes = [p, c.c_uint32, c.c_int]
    handle.xvcn_enc_encode_bin_trm.argtypes = [p, c.c_int]
    handle.xvcn_enc_finish.argtypes = [p]
    handle.xvcn_write_coefficients.restype = c.c_int
    handle.xvcn_write_coefficients.argtypes = [
        p, p, p, c.c_uint64, c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,
        p, c.c_int]
    handle.xvcn_quant_rdo.restype = c.c_int
    handle.xvcn_quant_rdo.argtypes = [
        p, p, c.c_uint64, c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,
        c.c_int, c.c_int, c.c_int, c.c_int64, c.c_int64, c.c_int,
        c.c_int64, p, p, c.c_int]
    handle.xvcn_metric.restype = c.c_int64
    handle.xvcn_metric.argtypes = [
        c.c_int, p, c.c_int64, p, c.c_int64, c.c_int, c.c_int, c.c_int,
        c.c_int, c.c_double]
    handle.xvcn_fwd_transform.argtypes = [
        p, c.c_int, c.c_int, p, p, c.c_int, c.c_int, c.c_int, p]
    handle.xvcn_intra_prepass_satd.argtypes = [
        p, p, c.c_int, c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,
        c.c_int, c.c_int, p, c.c_int64, c.c_int, c.c_int, p]
    handle.xvcn_recon_dist.restype = c.c_int64
    handle.xvcn_recon_dist.argtypes = [
        p, c.c_int, c.c_int,               # levels, h, w
        c.c_int, c.c_int, c.c_int,         # dq scale/shift, kind
        p, p,                              # m1, m2
        c.c_int, c.c_int, c.c_int,         # shift1/2, zo
        c.c_int, c.c_int, c.c_int,         # skip sh/sc, dc sh
        p, c.c_int64,                      # pred, stride
        p, c.c_int64,                      # orig, stride
        p, c.c_int64,                      # rec, stride
        p, c.c_int, c.c_int, c.c_int,      # resi, bd, metric, qp
        c.c_double]
    for name in ("xvcn_enc_destroy", "xvcn_enc_set_frac_bits",
                 "xvcn_enc_copy_out", "xvcn_enc_encode_bin",
                 "xvcn_enc_encode_bypass", "xvcn_enc_encode_bypass_bins",
                 "xvcn_enc_encode_bin_trm", "xvcn_enc_finish",
                 "xvcn_fwd_transform", "xvcn_intra_prepass_satd"):
        getattr(handle, name).restype = None



def _bind_parse_reader(handle):
    """The arithmetic decoder and residual reader of the Python parse
    (``native/engines.NativeEntropyDecoder``)."""
    c = ctypes
    p = c.c_void_p
    handle.xvcn_dec_create.restype = c.c_void_p
    handle.xvcn_dec_create.argtypes = [c.c_char_p, c.c_int64, c.c_int64,
                                       c.c_int]
    handle.xvcn_dec_destroy.argtypes = [p]
    handle.xvcn_dec_destroy.restype = None
    handle.xvcn_dec_get_pos.restype = c.c_int64
    handle.xvcn_dec_get_pos.argtypes = [p]
    handle.xvcn_dec_get_error.restype = c.c_int
    handle.xvcn_dec_get_error.argtypes = [p]
    handle.xvcn_dec_decode_bin.restype = c.c_int
    handle.xvcn_dec_decode_bin.argtypes = [p, p, c.c_int]
    handle.xvcn_dec_decode_bypass.restype = c.c_int
    handle.xvcn_dec_decode_bypass.argtypes = [p]
    handle.xvcn_dec_decode_bypass_bins.restype = c.c_uint32
    handle.xvcn_dec_decode_bypass_bins.argtypes = [p, c.c_int]
    handle.xvcn_dec_decode_bin_trm.restype = c.c_int
    handle.xvcn_dec_decode_bin_trm.argtypes = [p]
    handle.xvcn_dec_finish.argtypes = [p]
    handle.xvcn_dec_finish.restype = None
    handle.xvcn_read_coefficients.restype = c.c_int
    handle.xvcn_read_coefficients.argtypes = [
        p, p, p, c.c_uint64, c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,
        p, c.c_int]

_lock = threading.Lock()
_lib = None


def lib():
    """The loaded native library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            c = ctypes
            handle = c.CDLL(build())
            handle.xvcn_parse_picture.restype = c.c_int
            handle.xvcn_parse_picture.argtypes = [
                c.c_void_p, c.c_void_p, c.c_int64,
                c.POINTER(c.c_int64), c.POINTER(c.c_int32)]
            handle.xvcn_export_parse.restype = None
            handle.xvcn_export_parse.argtypes = [c.c_void_p, c.c_int32,
                                                 c.c_void_p]
            # the host tail of the replay path (ops/intra_pred.py,
            # codec/inter_mc.py)
            handle.xvcn_intra_filter_ref.argtypes = [
                c.c_void_p, c.c_void_p, c.c_int, c.c_int, c.c_void_p,
                c.c_void_p]
            handle.xvcn_intra_pred_dc.argtypes = [
                c.c_void_p, c.c_void_p, c.c_int, c.c_int, c.c_int,
                c.c_void_p]
            handle.xvcn_intra_pred_planar.argtypes = [
                c.c_void_p, c.c_void_p, c.c_int, c.c_int, c.c_void_p]
            handle.xvcn_intra_pred_angular.argtypes = [
                c.c_void_p, c.c_void_p, c.c_int, c.c_int, c.c_int, c.c_int,
                c.c_int, c.c_int, c.c_int, c.c_void_p]
            handle.xvcn_mc_unipred.argtypes = [
                c.c_int, c.c_void_p, c.c_int64, c.c_int, c.c_int, c.c_int,
                c.c_int, c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,
                c.c_void_p, c.c_int64]
            # the encoder (native/enc.py)
            handle.xvcn_encode_picture_intra.restype = c.c_int
            handle.xvcn_encode_picture_intra.argtypes = [c.c_void_p]
            _bind_block_coder(handle)
            _bind_parse_reader(handle)
            for name in ("xvcn_intra_filter_ref", "xvcn_intra_pred_dc",
                         "xvcn_intra_pred_planar", "xvcn_intra_pred_angular",
                         "xvcn_mc_unipred"):
                getattr(handle, name).restype = None
            _lib = handle
    return _lib
