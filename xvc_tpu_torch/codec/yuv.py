"""Padded planar YUV picture store.

Behavioral equivalent of the reference frame store
(ref: src/xvc_common_lib/yuv_pic.{h,cc}): each plane is padded by
(kMaxBlockSize + 16) samples on every side (scaled for chroma) so motion
compensation can read out of frame, with edge-replication PadBorder().
Planes are numpy int32 internally for exact arithmetic.  Copy of
``xvc_tpu/codec/yuv.py``.  For the decoder the host planes are only the
download target of the device path (checksum, output, alternative
reconstruction).  The native encoder writes its reconstruction to an
int16 surface of the padded plane geometry (``begin_native16``,
``rec16``) and reads its references' from the same surfaces
(``shadow16``); the int32 planes are filled from that surface when a
host reader asks for them.  The motion search keeps a copy of a
reference picture's padded luma on each device (``device_luma``,
``gpu/me.reference_luma``); a recycled buffer (``PictureEncoder.
init_pic``) and a new border (``pad_border``) drop it
(``drop_device_luma``).
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
        self.planes = [np.zeros(self._plane_shapes[c], dtype=np.int32)
                       for c in range(3)]
        # the motion search's copies of the padded luma, one a device
        # (generation, {device: tensor}), valid while
        # ``luma_generation`` is the one they were taken at
        self.device_luma = None
        self.luma_generation = 0

    def drop_device_luma(self):
        """The planes get new content: the device copy of the luma is
        stale.  Takes no lock (``gpu/me.reference_luma`` compares the
        generation under its own)."""
        self.luma_generation += 1
        self.device_luma = None

    # ---- the native encoder's int16 surfaces ----
    def _s16_slots(self):
        cache = getattr(self, "_shadow16", None)
        if cache is None:
            cache = self._shadow16 = [None, None, None]
        return cache

    def rec16(self, comp):
        """int16 surface buffer (padded plane geometry), allocated
        lazily and kept across picture reuses; zero-initialised, as the
        int32 planes are."""
        cache = self._s16_slots()
        if cache[comp] is None or \
                cache[comp].shape != self._plane_shapes[comp]:
            cache[comp] = np.zeros(self._plane_shapes[comp], np.int16)
        return cache[comp]

    def begin_native16(self):
        """Mark the int16 surface authoritative (about to be written by
        the native encoder); the int32 planes become stale."""
        for c in range(3):
            self.rec16(c)
        self._native16 = True
        self._stale32 = [True, True, True]

    def invalidate_shadow16(self):
        """Buffer recycled for new content: drop surface authority."""
        self._native16 = False
        self._stale32 = [False, False, False]

    def _materialize(self, comp):
        if getattr(self, "_native16", False) and self._stale32[comp]:
            np.copyto(self.planes[comp], self._shadow16[comp],
                      casting="unsafe")
            self._stale32[comp] = False

    def shadow16(self, comp):
        """int16 surface of a reference picture for the native encoder's
        reads: its reconstruction surface, which every picture the port
        encodes is written to (``begin_native16``)."""
        if not getattr(self, "_native16", False):
            raise RuntimeError("the picture has no reconstruction surface "
                               "(not encoded by the native encoder)")
        return self._shadow16[comp]

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
        Pads whichever surface is authoritative (the int16 surface or
        the int32 planes)."""
        if self.width[0] == 0:
            return
        self.drop_device_luma()
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

    def to_bytes(self):
        """The visible (display) area as packed planar bytes at the
        picture's own bit depth (ref: resample.cc:304-338, same-size
        output): the encoder's reconstruction output."""
        dtype = np.uint8 if self.bitdepth <= 8 else np.uint16
        chunks = []
        for c in range(k.num_components(self.chroma_format)):
            view = self.plane_view(c)[:self.get_display_height(c),
                                      :self.get_display_width(c)]
            chunks.append(np.ascontiguousarray(view).astype(dtype).tobytes())
        return b"".join(chunks)
