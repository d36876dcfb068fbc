"""Build the CUDA kernels with nvcc and bind them with ctypes.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``), one nvcc per
source and all of them at once, and linked into one shared library with
a plain C interface, under ``build/xvc_tpu_torch/`` at the root of the
checkout, the first time a kernel is needed.  The library name carries a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  Each C entry point
enqueues its kernel on the stream it is given and returns
``cudaGetLastError()``; ``check`` turns a nonzero code into an error.
``xvc_host_alloc`` / ``xvc_host_free`` hand out and take back mapped
pinned host memory (the motion search's sweep staging, ``gpu/me.py``).
"""
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_ROOT, "build", "xvc_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_PP = ctypes.POINTER(ctypes.c_void_p)
# C entry points: name -> argument types (pointers and the stream as
# c_void_p, so ctypes never cuts a 64-bit address to an int)
SIGNATURES = {
    "xvc_mc_scatter": [_P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _P, _I, _I,
                       _P, _I, _I, _I, _P, _I, _P],
    "xvc_itx_scatter": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _P, _P, _P, _P, _I, _P, _I, _I, _I, _P],
    "xvc_itx_picture": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    "xvc_mc_picture": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P],
    "xvc_deblock_edges": [_P, _P, _P, _P, _P],
    "xvc_deblock_luma": [_P, _I, _I, _I, _P, _I, _P, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _P],
    "xvc_deblock_chroma": [_P, _P, _I, _I, _I, _P, _I, _P, _I, _I, _I, _I,
                           _P],
    "xvc_satd": [_P, _P, _L, _I, _I, _I, _P, _P],
    "xvc_intra_satd": [_P, _P, _P, _L, _I, _I, _I, _P, _P],
    "xvc_txrd": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                 _F, _F, _F, _F, _F, _F, _P, _P],
    "xvc_intra_luma_scan": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
    "xvc_intra_chroma_scan": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                              _P],
    "xvc_resample_picture": [_P, _I, _I, _P],
    "xvc_me_sad": [_P, _I, _I, _I, _L, _I, _I, _P, _I, _I, _I, _I, _I, _P,
                   _P],
    "xvc_host_alloc": [_L, _PP, _PP],
    "xvc_host_free": [_P],
}

_lock = threading.Lock()
_lib = None
BUILD_LOG = ""


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are compiled "
                           "at first use and need the CUDA toolkit")
    return path


def sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def build():
    """Compile the kernels if the library for the current sources is
    missing; return its path.  nvcc's output (with ``-Xptxas -v``, the
    registers and shared memory of every kernel) is kept in
    ``BUILD_LOG``."""
    global BUILD_LOG
    srcs = sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs + glob.glob(os.path.join(_CSRC, "*.cuh")):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode())
            h.update(f.read())
    so_path = os.path.join(BUILD_DIR,
                           "libxvc_tpu_torch_%s.so" % h.hexdigest()[:16])
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = "%s.tmp%d" % (so_path, os.getpid())
    objs = ["%s.%s.o" % (tag, os.path.basename(src)) for src in srcs]
    procs = [subprocess.Popen([nvcc] + NVCC_FLAGS + ["-c", "-o", obj, src],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(srcs, objs)]
    outs = [proc.communicate()[0] for proc in procs]
    BUILD_LOG = "".join(outs)
    failed = [src for src, proc in zip(srcs, procs) if proc.returncode != 0]
    tmp = tag + ".so"
    if not failed:
        res = subprocess.run([nvcc, "-shared", "-o", tmp] + objs,
                             capture_output=True, text=True)
        BUILD_LOG += res.stdout + res.stderr
        if res.returncode != 0:
            failed = ["link"]
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("nvcc failed on %s:\n%s" % (", ".join(failed),
                                                       BUILD_LOG))
    os.replace(tmp, so_path)
    return so_path


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def stream_of(t):
    """PyTorch's current stream on the tensor's device, as a pointer."""
    import torch
    if t.device.index != torch.cuda.current_device():
        raise ValueError("tensor on %s but the current CUDA device is %d"
                         % (t.device, torch.cuda.current_device()))
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def check(rc, name):
    if rc != 0:
        raise RuntimeError("%s: kernel launch failed with CUDA error %d"
                           % (name, rc))
