"""Native host runtime: g++ build + ctypes binding of ``csrc/xvcn.cpp``.

The C++ library holds the sequential part of decoding: the CABAC parse
and the MV derivation of a whole picture (``xvcn_parse_picture``,
``csrc/xvcn_pic.inc``), which emit the flat record table the device path
reconstructs from, and the block predictors of the replay path's host
tail (``xvcn_intra_*``, ``xvcn_mc_unipred``).  It also holds the
encoder's CTU rate-distortion search and entropy write of a whole
picture (``xvcn_encode_picture_intra``, ``csrc/xvcn_enc.inc`` and
``csrc/xvcn_enc_inter.inc``; ``native/enc.py``), which consumes the
device stages' force maps and intra candidates.  It is compiled with g++
the first time it is needed, into ``build/xvc_tpu_torch/`` at the root
of the checkout (never next to the sources), and cached there under a
hash of the sources.

``csrc/`` is a copy of ``xvc_tpu/native/xvcn.cpp``, ``xvcn_pic.inc``,
``xvcn_enc.inc`` and ``xvcn_enc_inter.inc``.  A build failure raises:
there is no Python parse or CU encoder to fall back to.
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
            for name in ("xvcn_intra_filter_ref", "xvcn_intra_pred_dc",
                         "xvcn_intra_pred_planar", "xvcn_intra_pred_angular",
                         "xvcn_mc_unipred"):
                getattr(handle, name).restype = None
            _lib = handle
    return _lib
