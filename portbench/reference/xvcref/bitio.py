"""MSB-first bit reader / writer for xvc high-level syntax.

Behavioral equivalents of the reference bit I/O
(ref: src/xvc_dec_lib/bit_reader.cc, src/xvc_enc_lib/bit_writer.cc).
The CABAC hot path has its own native engine; these classes only carry
headers and byte-aligned payloads, so Python speed is fine here.
"""


class BitReader:
    __slots__ = ("buf", "pos", "bit_mask", "length")

    def __init__(self, data: bytes):
        self.buf = data
        self.length = len(data)
        self.pos = 0
        self.bit_mask = 0x80

    def get_position(self) -> int:
        assert self.bit_mask == 0x80
        return self.pos

    def read_bit(self) -> int:
        val = self.buf[self.pos] & self.bit_mask if self.pos < self.length else 0
        self.bit_mask >>= 1
        if not self.bit_mask:
            self.bit_mask = 0x80
            if self.pos < self.length:
                self.pos += 1
        return 1 if val else 0

    def read_bits(self, n: int) -> int:
        bits = 0
        for i in range(n - 1, -1, -1):
            bits |= self.read_bit() << i
        return bits

    def skip_bits(self):
        """Byte align."""
        if self.bit_mask != 0x80:
            self.bit_mask = 0x80
            if self.pos < self.length:
                self.pos += 1

    def read_byte(self) -> int:
        if self.pos >= self.length:
            raise ValueError("corrupt bitstream")
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def read_bytes(self, n: int) -> bytes:
        take = min(n, self.length - self.pos)
        out = self.buf[self.pos:self.pos + take]
        self.pos += take
        return out

    def rewind(self, num_bits: int):
        for _ in range(num_bits):
            self.bit_mask <<= 1
            if self.bit_mask == 0x100:
                self.bit_mask = 0x1
                self.pos -= 1
