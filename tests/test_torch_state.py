"""``xvc_tpu_torch.state.from_reference`` and the port's own tables.

The JAX package's constant tensors (angular weight tensors, Hadamard
matrices, ITX basis matrices, MC filter taps) and a frame store's padded
planes go through ``from_reference`` as numpy arrays and come out with
the dtype and layout the port's functions take; and every table the port
builds by itself equals the reference's, value for value.
"""
import numpy as np
import pytest
import torch

from xvc_tpu import constants as k
from xvc_tpu.codec import inter_mc as jmc
from xvc_tpu.codec.yuv import YuvPicture
from xvc_tpu.tpu import dsp as jdsp
from xvc_tpu.tpu import flat_recon as jfr
from xvc_tpu.tpu import intra_batch as jib
from xvc_tpu.tpu import satd as jsatd
from xvc_tpu_torch.codec.yuv import YuvPicture as TorchYuvPicture
from xvc_tpu_torch.gpu import dsp as tdsp
from xvc_tpu_torch.gpu import flat_recon as tfr
from xvc_tpu_torch.gpu import intra_batch as tib
from xvc_tpu_torch.gpu import satd as tsatd
from xvc_tpu_torch.state import from_reference

_MATRIX_KEYS = [(1, 1, 8, 8, True), (2, 5, 16, 4, True), (3, 4, 32, 32, True),
                (1, 1, 64, 64, False), (5, 1, 4, 8, False)]


def _reference_arrays():
    arrays = {}
    for n in (4, 8, 16, 32):
        arrays["angular/%d" % n] = jib.angular_weight_tensor(n)
    for n in (4, 8):
        arrays["hadamard/%d" % n] = jsatd._hadamard_f32(n)
    for key in _MATRIX_KEYS:
        m1, m2, _, _ = jdsp._matrices(*key)
        arrays["itx/%d_%d_%d_%d_%d/v" % key] = m1
        arrays["itx/%d_%d_%d_%d_%d/h" % key] = m2
    for name in ("LUMA_FILTER", "LUMA_FILTER_HIGH_PREC", "CHROMA_FILTER",
                 "CHROMA_FILTER_HIGH_PREC"):
        arrays["mc_taps/" + name] = getattr(jmc, name)
    pic = YuvPicture(k.ChromaFormat.YUV420, 64, 48, 10, True)
    rng = np.random.RandomState(2)
    for comp in range(3):
        pic.planes[comp][:] = rng.randint(0, 1024, pic.planes[comp].shape)
        base = pic.padded_plane(comp)
        th, tw = jfr._padded_shape(pic, comp)
        arrays["plane/%d" % comp] = np.pad(
            base, ((0, th - base.shape[0]), (0, tw - base.shape[1])),
            mode="edge")
    return arrays


def test_from_reference_gives_the_ports_dtypes_and_layouts():
    arrays = _reference_arrays()
    out = from_reference(arrays, "cpu")
    assert sorted(out) == sorted(arrays)
    want = {"angular": torch.float32, "hadamard": torch.int32,
            "itx": torch.int32, "mc_taps": torch.int32,
            "plane": torch.int16}
    for key, t in out.items():
        assert t.dtype == want[key.split("/")[0]], key
        assert t.is_contiguous() and t.device.type == "cpu"
        assert tuple(t.shape) == np.asarray(arrays[key]).shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(arrays[key]))
    # the planes have the port's frame-store geometry
    tpic = TorchYuvPicture(k.ChromaFormat.YUV420, 64, 48, 10, True)
    for comp in range(3):
        assert tuple(out["plane/%d" % comp].shape) == \
            tfr._padded_shape(tpic, comp)


def test_the_ports_own_tables_equal_the_reference():
    ref = from_reference(_reference_arrays(), "cpu")
    for n in (4, 8, 16, 32):
        np.testing.assert_array_equal(tib.angular_weight_tensor(n),
                                      ref["angular/%d" % n].numpy())
    for n in (4, 8):
        eye = torch.eye(n, dtype=torch.int32)
        assert torch.equal(tsatd._hadamard_last(eye), ref["hadamard/%d" % n])
    for key in _MATRIX_KEYS:
        m1, m2, s1, s2 = tdsp._matrices(*key)
        assert (s1, s2) == tuple(jdsp._matrices(*key)[2:])
        assert m1.dtype == np.int32 and m2.dtype == np.int32
        np.testing.assert_array_equal(
            m1, ref["itx/%d_%d_%d_%d_%d/v" % key].numpy())
        np.testing.assert_array_equal(
            m2, ref["itx/%d_%d_%d_%d_%d/h" % key].numpy())
    for luma in (True, False):
        for hp in (True, False):
            name = ("LUMA" if luma else "CHROMA") + "_FILTER" + \
                ("_HIGH_PREC" if hp else "")
            np.testing.assert_array_equal(tdsp._filter_table(luma, hp),
                                          ref["mc_taps/" + name].numpy())


def test_reference_state_drives_the_ports_functions():
    """SATD by the reference's Hadamard matrix equals the port's
    butterfly, and the reference's planes feed the port's MC core."""
    ref = from_reference(_reference_arrays(), "cpu")
    rng = np.random.RandomState(5)
    diff = torch.from_numpy(rng.randint(-1023, 1024, (11, 8, 8))
                            .astype(np.int32))
    h = ref["hadamard/8"].to(torch.int64)
    m = h @ diff.to(torch.int64) @ h
    want = ((m.abs().sum(dim=(-1, -2)) + 2) >> 2) >> 2
    assert torch.equal(tsatd.satd_square(diff, 10).to(torch.int64), want)
    planes = torch.stack([ref["plane/0"]])
    core = tdsp._mc_core_builder(8, 8, True, 10, True, False)
    z = torch.zeros(3, dtype=torch.int32)
    out = core(planes, z, z + 40, z + 50, z, z)
    assert tuple(out.shape) == (3, 8, 8)
    assert torch.equal(out[0].to(torch.int32),
                       planes[0, 43:51, 53:61].to(torch.int32))


@pytest.mark.parametrize("key,arr", [
    ("nothing/1", np.zeros((2, 2))),
    ("plane/0", np.zeros((2, 2, 2), np.int32)),
    ("plane/0", np.full((2, 2), 40000, np.int32)),
    ("hadamard/2", np.array([[0.5, 1.0], [1.0, -1.0]], np.float32)),
])
def test_from_reference_refuses(key, arr):
    with pytest.raises((KeyError, ValueError)):
        from_reference({key: arr}, "cpu")
