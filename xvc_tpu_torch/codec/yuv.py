"""Padded planar YUV picture store.

Behavioral equivalent of the reference frame store
(ref: src/xvc_common_lib/yuv_pic.{h,cc}): each plane is padded by
(kMaxBlockSize + 16) samples on every side (scaled for chroma) so motion
compensation can read out of frame, with edge-replication PadBorder().
Planes are numpy int32 internally for exact arithmetic.  Copy of
``xvc_tpu/codec/yuv.py`` without the int16 surfaces of the native host
decoder: here the host planes are only the download target of the device
path (checksum, output, alternative reconstruction).
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

    def plane_view(self, comp):
        """(height, width) view of the visible plane area."""
        px, py = self.pad_x[comp], self.pad_y[comp]
        return self.planes[comp][py:py + self.height[comp],
                                 px:px + self.width[comp]]

    def padded_plane(self, comp):
        return self.planes[comp]

    def get_display_width(self, comp):
        w = self.width[0] - self.crop_width
        return w >> self.shift_x[comp] if comp else w

    def get_display_height(self, comp):
        h = self.height[0] - self.crop_height
        return h >> self.shift_y[comp] if comp else h

    def pad_border(self):
        """Edge-replicate into the padding area (ref: yuv_pic.cc:118-150)."""
        if self.width[0] == 0:
            return
        for c in range(3):
            px, py = self.pad_x[c], self.pad_y[c]
            buf = self.planes[c]
            h, w = self.height[c], self.width[c]
            buf[:py, px:px + w] = buf[py, px:px + w]
            buf[py + h:, px:px + w] = buf[py + h - 1, px:px + w]
            buf[:, :px] = buf[:, px:px + 1]
            buf[:, px + w:] = buf[:, px + w - 1:px + w]
