"""File-level NAL framing: 4-byte little-endian length-prefixed NAL units.

(ref: app/xvc_enc_app/encoder_app.cc:493-517 writes each NAL with a 4-byte
little-endian size prefix; xvc_dec_app reads the same format.)
"""
import struct


def split_nal_units(data: bytes):
    """Yield NAL unit byte strings from a length-prefixed stream."""
    pos = 0
    n = len(data)
    while pos + 4 <= n:
        (size,) = struct.unpack_from("<I", data, pos)
        pos += 4
        if size == 0 or pos + size > n:
            break
        yield data[pos:pos + size]
        pos += size
