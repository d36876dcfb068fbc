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


class BitWriter:
    __slots__ = ("buf", "shift")

    def __init__(self):
        self.buf = bytearray()
        self.shift = 0  # number of bits already used in last byte

    def write_bit(self, bit: int):
        if self.shift:
            self.buf[-1] |= (bit & 1) << (8 - self.shift - 1)
            self.shift = (self.shift + 1) % 8
        else:
            self.buf.append((bit & 1) << 7)
            self.shift = 1

    def write_bits(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self.write_bit((value >> i) & 1)

    def write_byte(self, b: int):
        assert self.shift == 0
        self.buf.append(b & 0xFF)

    def write_bytes(self, data: bytes):
        assert self.shift == 0
        self.buf.extend(data)

    def pad_zero_bits(self):
        """Byte align with zero bits."""
        self.shift = 0

    def get_bytes(self) -> bytes:
        return bytes(self.buf)
