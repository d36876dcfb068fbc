"""Per-picture checksum (MD5 / CRC16-CCITT) for conformance verification.

Behavioral equivalent of the reference checksum
(ref: src/xvc_common_lib/checksum.{h,cc}).
"""
import hashlib

import numpy as np

from .. import constants as k


def hash_picture(rec_pic, method, mode):
    if method == k.ChecksumMethod.MD5:
        return _md5(rec_pic, mode)
    return _crc(rec_pic, mode)


def _plane_bytes(rec_pic, comp):
    """One strided cast pass; the result supports the buffer protocol so
    hashlib can consume it without a further bytes copy."""
    view = rec_pic.plane_view(comp)
    dtype = np.uint8 if rec_pic.bitdepth == 8 else np.dtype("<u2")
    buf = np.empty(view.shape, dtype)
    np.copyto(buf, view, casting="unsafe")
    return buf


def _md5(rec_pic, mode):
    num_comps = k.num_components(rec_pic.chroma_format)
    out = bytearray()
    md5 = hashlib.md5()
    for c in range(num_comps):
        if mode == k.ChecksumMode.MAX_ROBUST:
            md5 = hashlib.md5()
        md5.update(_plane_bytes(rec_pic, c))
        if mode == k.ChecksumMode.MAX_ROBUST:
            out.extend(md5.digest())
    if mode == k.ChecksumMode.MIN_OVERHEAD:
        out.extend(md5.digest())
    return bytes(out)


def _crc(rec_pic, mode):
    num_comps = k.num_components(rec_pic.chroma_format)
    out = bytearray()
    crc = 0xFFFF
    for c in range(num_comps):
        if mode == k.ChecksumMode.MAX_ROBUST:
            crc = 0xFFFF
        view = rec_pic.plane_view(c)
        flat = np.ascontiguousarray(view).astype(np.int64).ravel()
        nbits = 16 if rec_pic.bitdepth > 8 else 8
        for v in flat:
            v = int(v)
            for bit in range(8):
                crc_msb = (crc >> 15) & 1
                bit_val = (v >> (7 - bit)) & 1
                crc = (((crc << 1) + bit_val) & 0xFFFF) ^ (crc_msb * 0x1021)
            if nbits == 16:
                for bit in range(8):
                    crc_msb = (crc >> 15) & 1
                    bit_val = (v >> (15 - bit)) & 1
                    crc = (((crc << 1) + bit_val) & 0xFFFF) ^ \
                        (crc_msb * 0x1021)
        if mode == k.ChecksumMode.MAX_ROBUST:
            for _ in range(16):
                crc_msb = (crc >> 15) & 1
                crc = ((crc << 1) & 0xFFFF) ^ (crc_msb * 0x1021)
            out.append((crc >> 8) & 0xFF)
            out.append(crc & 0xFF)
    if mode == k.ChecksumMode.MIN_OVERHEAD:
        for _ in range(16):
            crc_msb = (crc >> 15) & 1
            crc = ((crc << 1) & 0xFFFF) ^ (crc_msb * 0x1021)
        out.append((crc >> 8) & 0xFF)
        out.append(crc & 0xFF)
    return bytes(out)
