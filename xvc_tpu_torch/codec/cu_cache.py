"""Cache of per-CU mode features across equivalent split orders.

Behavioral equivalent of the reference CU cache
(ref: src/xvc_enc_lib/cu_cache.{h,cc}); like the reference default
(kNumCuPerEntry = 0) only feature flags are stored.  Copy of
``xvc_tpu/codec/cu_cache.py``.
"""
from .. import constants as k

_NUM_PARTITIONS = 5
_F_VALID, _F_ANY_INTRA, _F_ANY_INTER, _F_ANY_SKIP = 1, 2, 4, 8


class CacheResult:
    __slots__ = ("cu", "cacheable", "any_intra", "any_inter", "any_skip")

    def __init__(self, cu, cacheable, any_intra, any_inter, any_skip):
        self.cu = cu
        self.cacheable = cacheable
        self.any_intra = any_intra
        self.any_inter = any_inter
        self.any_skip = any_skip


class CuCache:
    def __init__(self, pic_data):
        self.pic = pic_data
        depths = k.CTU_SIZE_LOG2 + 1
        self.features = [
            [[[0] * _NUM_PARTITIONS for _ in range(k.QUAD_SPLIT)]
             for _ in range(depths)]
            for _ in range(k.MAX_NUM_CU_TREES)]

    def invalidate(self, cu_tree, cu_depth):
        tree = int(cu_tree)

        def clear(depth):
            for quad in range(k.QUAD_SPLIT):
                for part in range(_NUM_PARTITIONS):
                    self.features[tree][depth][quad][part] = 0

        if cu_depth == 0:
            clear(0)
        clear(cu_depth + 1)

    def _find(self, cu):
        width, height = cu.width, cu.height
        if width == height:
            partition = 0
        elif width == (height << 1):
            partition = 1 if (cu.pos_y & ((height << 1) - 1)) == 0 else 2
        elif (width << 1) == height:
            partition = 3 if (cu.pos_x & ((width << 1) - 1)) == 0 else 4
        else:
            return None
        quad_size = max(width, height)
        quad_depth = k.CTU_SIZE_LOG2 - (quad_size.bit_length() - 1)
        parent_quad_size = quad_size << 1
        quad_pos = ((0 if (cu.pos_y & (parent_quad_size - 1)) < quad_size
                     else 2) +
                    (0 if (cu.pos_x & (parent_quad_size - 1)) < quad_size
                     else 1))
        return (int(cu.cu_tree), quad_depth, quad_pos, partition)

    def lookup(self, cu):
        key = self._find(cu)
        if key is None:
            return CacheResult(None, False, False, False, False)
        f = self.features[key[0]][key[1]][key[2]][key[3]]
        any_intra = any_inter = any_skip = False
        if f & _F_VALID:
            any_intra = bool(f & _F_ANY_INTRA)
            any_inter = bool(f & _F_ANY_INTER)
            any_skip = bool(f & _F_ANY_SKIP)
        return CacheResult(None, True, any_intra, any_inter, any_skip)

    def store(self, cu):
        key = self._find(cu)
        if key is None:
            return False
        f = self.features[key[0]][key[1]][key[2]][key[3]]
        f |= _F_VALID
        if cu.is_intra():
            f |= _F_ANY_INTRA
        if cu.is_inter():
            f |= _F_ANY_INTER
        if cu.skip_flag:
            f |= _F_ANY_SKIP
        self.features[key[0]][key[1]][key[2]][key[3]] = f
        return False
