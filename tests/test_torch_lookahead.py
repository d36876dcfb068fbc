"""The lookahead slice as a whole: ``frame_intra_lookahead`` of the port
(xvc_tpu_torch.gpu.lookahead) on the CPU device against the JAX
package's, on real frames: the first luma frame of ai352x288_in.yuv
(8 bit, CIF) and of ai64x48b10_in.yuv (10 bit).  Every size's cost map
must equal the JAX package's bit for bit (tolerance 0, int32).
"""
import numpy as np
import pytest

from xvc_tpu.restrictions import Restrictions as JaxRestrictions
from xvc_tpu.tpu import lookahead as jla
from xvc_tpu_torch.gpu import lookahead as tla
from xvc_tpu_torch.restrictions import Restrictions

from .util import data_path

_CACHE = {}


def _luma(name, w, h, bd):
    dtype = np.uint8 if bd == 8 else np.dtype("<u2")
    return np.fromfile(data_path(name), dtype, count=w * h).reshape(h, w)


def _maps(name, w, h, bd, mode_step):
    key = (name, mode_step)
    if key not in _CACHE:
        frame = _luma(name, w, h, bd)
        stats = {}
        _CACHE[key] = (
            jla.frame_intra_lookahead(frame, bd, JaxRestrictions(),
                                      mode_step=mode_step),
            tla.frame_intra_lookahead(frame, bd, Restrictions(),
                                      mode_step=mode_step, device="cpu",
                                      stats=stats),
            stats)
    return _CACHE[key]


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("name,w,h,bd", [("ai352x288_in.yuv", 352, 288, 8),
                                         ("ai64x48b10_in.yuv", 64, 48, 10)])
def test_lookahead_maps_match_jax(name, w, h, bd, n):
    want, got, stats = _maps(name, w, h, bd, 1)
    assert sorted(got) == sorted(want) == [4, 8, 16, 32]
    assert got[n].dtype == np.int32
    assert got[n].shape == (h // n, w // n, 67) == want[n].shape
    np.testing.assert_array_equal(got[n], want[n])
    assert stats[n]["blocks"] == (h // n) * (w // n)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_lookahead_mode_step_matches_jax(n):
    want, got, _ = _maps("ai64x48b10_in.yuv", 64, 48, 10, 4)
    assert got[n].shape == (48 // n, 64 // n, 19)
    np.testing.assert_array_equal(got[n], want[n])


def test_lookahead_leaves_out_sizes_larger_than_the_picture():
    frame = np.random.RandomState(0).randint(0, 256, (20, 24))
    want = jla.frame_intra_lookahead(frame, 8, JaxRestrictions())
    got = tla.frame_intra_lookahead(frame, 8, Restrictions(), device="cpu")
    assert sorted(got) == sorted(want) == [4, 8, 16]
    for n in got:  # partial blocks get no entry: 20 // 16 == 1 row
        np.testing.assert_array_equal(got[n], want[n])


def test_lookahead_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="is_available"):
        tla.frame_intra_lookahead(np.zeros((8, 8), np.int32), 8,
                                  Restrictions())
