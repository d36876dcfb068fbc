"""Padded planar YUV picture store.

Behavioral equivalent of the reference frame store
(ref: src/xvc_common_lib/yuv_pic.{h,cc}): each plane is padded by
(kMaxBlockSize + 16) samples on every side (scaled for chroma) so motion
compensation can read out of frame, with edge-replication PadBorder().
Planes are numpy int32 internally for exact arithmetic.
"""
import numpy as np

from .. import constants as k

PAD = k.MAX_BLOCK_SIZE + 16


class YuvPicture:
    def __init__(self, chroma_format, width, height, bitdepth,
                 padding=True, crop_width=0, crop_height=0):
        self.chroma_format = chroma_format
        self.bitdepth = bitdepth
        self.crop_width = crop_width
        self.crop_height = crop_height
        sx = k.chroma_shift_x(chroma_format)
        sy = k.chroma_shift_y(chroma_format)
        self.shift_x = [0, sx, sx]
        self.shift_y = [0, sy, sy]
        self.width = [width, width >> sx, width >> sx]
        self.height = [height, height >> sy, height >> sy]
        self.pad = [(PAD, PAD >> sx), (PAD, PAD >> sy)]
        self.pad_x = [PAD >> self.shift_x[c] if padding else 0
                      for c in range(3)]
        self.pad_y = [PAD >> self.shift_y[c] if padding else 0
                      for c in range(3)]
        self._plane_shapes = [
            (self.height[c] + 2 * self.pad_y[c],
             self.width[c] + 2 * self.pad_x[c]) for c in range(3)]
        # int32 planes are allocated lazily: a native16 decode session
        # only ever touches the int16 surfaces, so eagerly zeroing three
        # int32 planes per fresh picture buffer (~33 MB at 1080p) was
        # pure page-fault overhead in the decode loop
        self._planes = None

    @property
    def planes(self):
        if self._planes is None:
            self._planes = [np.zeros(self._plane_shapes[c], dtype=np.int32)
                            for c in range(3)]
        return self._planes

    def _s16_slots(self):
        cache = getattr(self, "_shadow16", None)
        if cache is None:
            cache = self._shadow16 = [None, None, None]
        return cache

    def rec16(self, comp):
        """int16 surface buffer (padded plane geometry), allocated
        lazily and kept across picture reuses.  Under native decode
        this IS the authoritative reconstruction surface (the
        reference's Sample type, yuv_pic.h); the int32 planes are
        materialized from it on demand for Python consumers."""
        cache = self._s16_slots()
        if cache[comp] is None or \
                cache[comp].shape != self._plane_shapes[comp]:
            # zero-initialized so the padding area's history mirrors the
            # int32 planes exactly: never-padded (non-reference) pictures
            # expose deterministic zero borders to the output resampler,
            # matching the Python twin and the reference decoder
            cache[comp] = np.zeros(self._plane_shapes[comp], np.int16)
        return cache[comp]

    def begin_native16(self):
        """Mark the int16 surface authoritative (about to be written by
        the native decoder); int32 planes become stale."""
        for c in range(3):
            self.rec16(c)
        self._native16 = True
        self._stale32 = [True, True, True]

    def invalidate_shadow16(self):
        """Buffer recycled for new content: drop surface authority and
        any cached int16 mirror (buffers are kept for reuse)."""
        self._native16 = False
        self._stale32 = [False, False, False]
        self._s16_valid = [False, False, False]

    def _materialize(self, comp):
        if getattr(self, "_native16", False) and \
                getattr(self, "_stale32", None) and self._stale32[comp]:
            np.copyto(self.planes[comp], self._shadow16[comp],
                      casting="unsafe")
            self._stale32[comp] = False

    def shadow16(self, comp):
        """int16 view of the padded plane for native MC reads (samples
        always fit: internal bitdepth <= 14).  Under native16 decode the
        surface is returned directly; otherwise a cached conversion of
        the int32 plane (valid once the picture is reconstructed and
        padded; invalidate_shadow16() resets it on buffer reuse)."""
        cache = self._s16_slots()
        if getattr(self, "_native16", False):
            return cache[comp]
        valid = getattr(self, "_s16_valid", None)
        if valid is None:
            valid = self._s16_valid = [False, False, False]
        if cache[comp] is None or not valid[comp] or \
                cache[comp].shape != self.planes[comp].shape:
            plane = self.planes[comp]
            buf = cache[comp]
            if buf is None or buf.shape != plane.shape:
                buf = cache[comp] = np.empty(plane.shape, np.int16)
            np.copyto(buf, plane, casting="unsafe")
            valid[comp] = True
        return cache[comp]

    def plane_view(self, comp):
        """(height, width) view of the visible plane area."""
        self._materialize(comp)
        px, py = self.pad_x[comp], self.pad_y[comp]
        return self.planes[comp][py:py + self.height[comp],
                                 px:px + self.width[comp]]

    def padded_plane(self, comp):
        self._materialize(comp)
        return self.planes[comp]

    def get_display_width(self, comp):
        w = self.width[0] - self.crop_width
        return w >> self.shift_x[comp] if comp else w

    def get_display_height(self, comp):
        h = self.height[0] - self.crop_height
        return h >> self.shift_y[comp] if comp else h

    def pad_border(self):
        """Edge-replicate into the padding area (ref: yuv_pic.cc:118-150).
        Pads whichever surface is authoritative (the int16 native
        surface or the int32 planes)."""
        if self.width[0] == 0:
            return
        native16 = getattr(self, "_native16", False)
        for c in range(3):
            px, py = self.pad_x[c], self.pad_y[c]
            buf = self._shadow16[c] if native16 else self.planes[c]
            h, w = self.height[c], self.width[c]
            buf[:py, px:px + w] = buf[py, px:px + w]
            buf[py + h:, px:px + w] = buf[py + h - 1, px:px + w]
            buf[:, :px] = buf[:, px:px + 1]
            buf[:, px + w:] = buf[:, px + w - 1:px + w]
            if native16:
                self._stale32[c] = True

    def to_bytes(self, out_bitdepth=None, dither=False):
        """Serialize visible (display) area to packed planar bytes.

        Mirrors Resampler::CopyToBytesWithShift for same-size output
        (ref: resample.cc:304-338).
        """
        out_bitdepth = out_bitdepth or self.bitdepth
        chunks = []
        num_comps = k.num_components(self.chroma_format)
        for c in range(num_comps):
            view = self.plane_view(c)[:self.get_display_height(c),
                                      :self.get_display_width(c)]
            if out_bitdepth == self.bitdepth:
                data = view
            elif out_bitdepth > self.bitdepth:
                data = view << (out_bitdepth - self.bitdepth)
            else:
                downshift = self.bitdepth - out_bitdepth
                if dither:
                    # error-feedback dithering (row-serial)
                    data = _downshift_dither(view, downshift, out_bitdepth)
                else:
                    add = 1 << (downshift - 1)
                    maxv = (1 << out_bitdepth) - 1
                    data = np.minimum((view + add) >> downshift, maxv)
            dtype = np.uint8 if out_bitdepth <= 8 else np.uint16
            chunks.append(np.ascontiguousarray(data).astype(dtype).tobytes())
        return b"".join(chunks)


def _downshift_dither(view, downshift, out_bitdepth):
    h, w = view.shape
    out = np.zeros((h, w), dtype=np.int32)
    maxv = (1 << out_bitdepth) - 1
    mask = (1 << downshift) - 1
    err = 0
    for y in range(h):
        for x in range(w):
            v = int(view[y, x]) + err
            s = min(v >> downshift, maxv)
            err = v - (s << downshift) if s < maxv else (v & mask)
            out[y, x] = s
    return out
