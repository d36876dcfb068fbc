"""Binary arithmetic decoder (HEVC-style, 9-bit range).

Behavioral equivalent of the reference arithmetic decoder
(ref: src/xvc_dec_lib/entropy_decoder.cc:28-158).  Operates on a flat
context-state array; ctx arguments are integer indices.  The native C
engine (native/cabac.c) implements the same loop for speed; this is the
reference Python implementation used for validation.
"""
from .context_model import (NEXT_STATE_LPS, NEXT_STATE_MPS, RANGE_TABLE,
                            RENORM_TABLE)


class EntropyDecoder:
    __slots__ = ("bit_reader", "range", "value", "bits_needed",
                 "state", "ctx_update")

    def __init__(self, bit_reader, ctx_state, ctx_update=True):
        self.bit_reader = bit_reader
        self.state = ctx_state
        self.ctx_update = ctx_update
        self.range = 510
        self.bits_needed = -24
        self.value = 0

    def start(self):
        self.range = 510
        self.bits_needed = -8
        self.value = (self.bit_reader.read_byte() << 8) | \
            self.bit_reader.read_byte()

    def decode_bin(self, ctx: int) -> int:
        state = int(self.state[ctx])
        mps = state & 1
        lps = int(RANGE_TABLE[state >> 1][(self.range >> 6) & 3])
        self.range -= lps
        scaled_range = self.range << 7
        if self.value < scaled_range:
            binval = mps
            if self.ctx_update:
                self.state[ctx] = NEXT_STATE_MPS[state]
            if scaled_range >= (256 << 7):
                return binval
            num_bits = 1
        else:
            binval = 1 - mps
            self.value -= scaled_range
            self.range = lps
            if self.ctx_update:
                self.state[ctx] = NEXT_STATE_LPS[state]
            num_bits = int(RENORM_TABLE[lps >> 3])
        self.value <<= num_bits
        self.range <<= num_bits
        self.bits_needed += num_bits
        if self.bits_needed >= 0:
            self.value |= self.bit_reader.read_byte() << self.bits_needed
            self.bits_needed -= 8
        return binval

    def decode_bypass(self) -> int:
        self.value += self.value
        self.bits_needed += 1
        if self.bits_needed >= 0:
            self.bits_needed = -8
            self.value += self.bit_reader.read_byte()
        scaled_range = self.range << 7
        if self.value >= scaled_range:
            self.value -= scaled_range
            return 1
        return 0

    def decode_bypass_bins(self, num_bins: int) -> int:
        bins = 0
        while num_bins > 8:
            self.value = (self.value << 8) + \
                (self.bit_reader.read_byte() << (8 + self.bits_needed))
            scaled_range = self.range << 15
            for _ in range(8):
                bins += bins
                scaled_range >>= 1
                if self.value >= scaled_range:
                    bins += 1
                    self.value -= scaled_range
            num_bins -= 8
        self.bits_needed += num_bins
        self.value <<= num_bins
        if self.bits_needed >= 0:
            self.value += self.bit_reader.read_byte() << self.bits_needed
            self.bits_needed -= 8
        scaled_range = self.range << (num_bins + 7)
        for _ in range(num_bins):
            bins += bins
            scaled_range >>= 1
            if self.value >= scaled_range:
                bins += 1
                self.value -= scaled_range
        return bins

    def decode_bin_trm(self) -> int:
        self.range -= 2
        scaled_range = self.range << 7
        if self.value >= scaled_range:
            self.bit_reader.rewind(-self.bits_needed)
            return 1
        if scaled_range < (256 << 7):
            self.range = scaled_range >> 6
            self.value <<= 1
            self.bits_needed += 1
            if self.bits_needed == 0:
                self.bits_needed = -8
                self.value += self.bit_reader.read_byte()
        return 0

    def finish(self):
        self.bit_reader.read_bits(1)
        self.bit_reader.skip_bits()
