"""Fractional-bit counting of the CABAC encoder (RDO counting mode).

Behavioral equivalent of the reference arithmetic encoder's bit counting
(ref: src/xvc_enc_lib/entropy_encoder.cc): the encoder only accumulates
fractional bits, and its contexts still adapt, exactly like the
reference RdoSyntaxWriter.  Copy of the counting mode of
``xvc_tpu/cabac/entropy_encoder.py`` (``bit_writer=None``); the real
bitstream is written by the native engine
(``native/engines.NativeEntropyEncoder``).
"""
from .context_model import (ENTROPY_BITS, ENTROPY_BYPASS_BITS,
                            NEXT_STATE_LPS, NEXT_STATE_MPS)

_ENTROPY_BITS_TRM0 = int(ENTROPY_BITS[126])
_ENTROPY_BITS_TRM1 = int(ENTROPY_BITS[127])


class EntropyEncoder:
    __slots__ = ("state", "ctx_update", "frac_bits")

    def __init__(self, ctx_state, ctx_update=True, written_bits=0,
                 fractional_bits=0):
        self.state = ctx_state
        self.ctx_update = ctx_update
        self.frac_bits = (written_bits << 15) | (fractional_bits & 32767)

    def get_num_written_bits(self):
        return self.frac_bits >> 15

    def get_fractional_bits(self):
        return self.frac_bits & 32767

    def reset_bit_counting(self):
        self.frac_bits &= 32767

    def encode_bin(self, binval, ctx):
        state = int(self.state[ctx])
        self.frac_bits += int(ENTROPY_BITS[state ^ binval])
        if self.ctx_update:
            self.state[ctx] = NEXT_STATE_LPS[state] \
                if binval != (state & 1) else NEXT_STATE_MPS[state]

    def encode_bypass(self, binval):
        self.frac_bits += ENTROPY_BYPASS_BITS

    def encode_bypass_bins(self, binvals, num_bins):
        self.frac_bits += ENTROPY_BYPASS_BITS * num_bins

    def encode_bin_trm(self, binval):
        self.frac_bits += _ENTROPY_BITS_TRM1 if binval else _ENTROPY_BITS_TRM0
