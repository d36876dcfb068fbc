"""Python facades over the native CABAC engine, residual coder and RDO
quantizer of the Python CU encoder, and the native arithmetic decoder of
the Python parse.

Copy of ``xvc_tpu/native/engines.py``.  The parse reads through
``NativeEntropyDecoder`` (``syntax/reader.py``).  On the encode side the real
bitstream is written by ``NativeEntropyEncoder``; the counting-mode
encoders of the RD search stay in Python (``cabac/entropy_encoder.py``:
their per-element work is light and they are cloned constantly), but
their residual-block bit counting goes through the native writer
(``count_write_coefficients``), and the RDO quantizer is native
(``quant_rdo_native``).
"""
import threading

import numpy as np

from . import family_offsets, lib

# the context family offsets the C calls read through a raw address: built
# once, under the lock, and never replaced, so that no thread's array is
# freed while another thread's C call reads it
_OFFSETS_ARR = None
_OFFSETS_LOCK = threading.Lock()


def _offsets_ptr():
    arr = _OFFSETS_ARR
    if arr is None:
        arr = _build_offsets()
    return arr.ctypes.data


def _build_offsets():
    global _OFFSETS_ARR
    with _OFFSETS_LOCK:
        if _OFFSETS_ARR is None:
            _OFFSETS_ARR = family_offsets()
        return _OFFSETS_ARR


class NativeEntropyDecoder:
    """The CABAC reader of a picture's (or tile's) payload for the Python
    parse (``syntax/reader.py``), over xvcn: the mirror of
    ``cabac/entropy_decoder.EntropyDecoder``."""

    __slots__ = ("bit_reader", "state", "ctx_update", "_buf", "_h", "_sp",
                 "_lib")

    def __init__(self, bit_reader, ctx_state, ctx_update=True):
        self.bit_reader = bit_reader
        self.state = ctx_state
        self.ctx_update = ctx_update
        self._buf = bit_reader.buf
        self._h = None
        self._sp = ctx_state.ctypes.data
        self._lib = lib()

    def start(self):
        assert self.bit_reader.bit_mask == 0x80
        self._h = self._lib.xvcn_dec_create(self._buf, len(self._buf),
                                            self.bit_reader.pos,
                                            1 if self.ctx_update else 0)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.xvcn_dec_destroy(self._h)
            self._h = None

    def decode_bin(self, ctx):
        return self._lib.xvcn_dec_decode_bin(self._h, self._sp, ctx)

    def decode_bypass(self):
        return self._lib.xvcn_dec_decode_bypass(self._h)

    def decode_bypass_bins(self, num_bins):
        return self._lib.xvcn_dec_decode_bypass_bins(self._h, num_bins)

    def decode_bin_trm(self):
        return self._lib.xvcn_dec_decode_bin_trm(self._h)

    def finish(self):
        self._lib.xvcn_dec_finish(self._h)
        if self._lib.xvcn_dec_get_error(self._h):
            raise ValueError("corrupt bitstream")
        # the BitReader goes on after the CABAC payload
        self.bit_reader.pos = self._lib.xvcn_dec_get_pos(self._h)
        self.bit_reader.bit_mask = 0x80

    def read_coefficients_native(self, restr_mask, width, height,
                                 subblock_shift, is_luma, scan_order, dst):
        n = self._lib.xvcn_read_coefficients(
            self._h, self._sp, _offsets_ptr(), restr_mask, width, height,
            subblock_shift, 1 if is_luma else 0, scan_order,
            dst.ctypes.data, dst.shape[1])
        if self._lib.xvcn_dec_get_error(self._h):
            raise ValueError("corrupt bitstream")
        return n


class NativeEntropyEncoder:
    """The CABAC writer of a picture's (or tile's) payload, over xvcn."""

    __slots__ = ("bit_writer", "state", "ctx_update", "_h", "_sp", "_lib")

    def __init__(self, bit_writer, ctx_state, ctx_update=True):
        assert bit_writer is not None
        self.bit_writer = bit_writer
        self.state = ctx_state
        self.ctx_update = ctx_update
        self._sp = ctx_state.ctypes.data
        self._lib = lib()
        self._h = self._lib.xvcn_enc_create(1 if ctx_update else 0, 0,
                                            1 << 16)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.xvcn_enc_destroy(self._h)
            self._h = None

    def get_num_written_bits(self):
        return self._lib.xvcn_enc_get_frac_bits(self._h) >> 15

    def get_fractional_bits(self):
        return self._lib.xvcn_enc_get_frac_bits(self._h) & 32767

    @property
    def frac_bits(self):
        return self._lib.xvcn_enc_get_frac_bits(self._h)

    def reset_bit_counting(self):
        self._lib.xvcn_enc_set_frac_bits(
            self._h, self._lib.xvcn_enc_get_frac_bits(self._h) & 32767)

    def encode_bin(self, binval, ctx):
        self._lib.xvcn_enc_encode_bin(self._h, self._sp, binval, ctx)

    def encode_bypass(self, binval):
        self._lib.xvcn_enc_encode_bypass(self._h, binval)

    def encode_bypass_bins(self, binvals, num_bins):
        self._lib.xvcn_enc_encode_bypass_bins(self._h, binvals & 0xFFFFFFFF,
                                              num_bins)

    def encode_bin_trm(self, binval):
        self._lib.xvcn_enc_encode_bin_trm(self._h, binval)

    def finish(self):
        self._lib.xvcn_enc_finish(self._h)
        n = self._lib.xvcn_enc_get_out_len(self._h)
        out = np.empty(n, dtype=np.uint8)
        self._lib.xvcn_enc_copy_out(self._h, out.ctypes.data)
        self.bit_writer.write_bytes(out.tobytes())

    def write_coefficients_native(self, restr_mask, width, height,
                                  subblock_shift, is_luma, scan_order, src):
        return self._lib.xvcn_write_coefficients(
            self._h, self._sp, _offsets_ptr(), restr_mask, width, height,
            subblock_shift, 1 if is_luma else 0, scan_order, src.ctypes.data,
            src.shape[1])


def count_write_coefficients(py_enc, restr_mask, width, height,
                             subblock_shift, is_luma, scan_order, src):
    """Residual bit counting for a Python counting-mode EntropyEncoder:
    run the native writer in counting mode against the shared context
    array, then fold the fractional bits back into the Python engine."""
    native = lib()
    h = native.xvcn_enc_create(1 if py_enc.ctx_update else 0, 1, 0)
    try:
        native.xvcn_enc_set_frac_bits(h, py_enc.frac_bits)
        n = native.xvcn_write_coefficients(
            h, py_enc.state.ctypes.data, _offsets_ptr(), restr_mask, width,
            height, subblock_shift, 1 if is_luma else 0, scan_order,
            src.ctypes.data, src.shape[1])
        py_enc.frac_bits = native.xvcn_enc_get_frac_bits(h)
        return n
    finally:
        native.xvcn_enc_destroy(h)


def quant_rdo_native(ctx_state, restr_mask, width, height, subblock_shift,
                     is_luma, scan_order, bitdepth, qp_per, fwd_scale,
                     inv_scale, lambda_fp, cbf_ctx_idx, rd_factor, src, out):
    return lib().xvcn_quant_rdo(
        ctx_state.ctypes.data, _offsets_ptr(), restr_mask, width, height,
        subblock_shift, 1 if is_luma else 0, scan_order, bitdepth, qp_per,
        fwd_scale, inv_scale, lambda_fp, cbf_ctx_idx, rd_factor,
        src.ctypes.data, out.ctypes.data, out.shape[1])
