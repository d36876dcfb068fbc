"""Intra luma and chroma scans of the PyTorch port (xvc_tpu_torch) against
the JAX package's lax.scan versions on the CPU backend: bit-exact
(tolerance 0).

- real inputs: the canvases, residuals and scan metadata of every
  picture of ai64x48 and sp_fast, captured while the port decodes them,
  go through tpu/intra_scan.make_intra_scan / make_intra_chroma_scan and
  through gpu/intra_scan.intra_scan / intra_chroma_scan;
- synthetic inputs on a small canvas with blocks at its far corner, so
  that every window start (reference strips, 64x64 windows, LM luma
  window) is clamped as lax.dynamic_slice clamps it;
  (the goldens carry no LM block, so LM is held here and below);
- derive_lm's Python int32 arithmetic against the device derivation;
- the numpy-made families of xvc_tpu_torch/gpu/scan_cases.py, which the card
  tests put through the CUDA kernels: every block shape over all 67
  modes (chroma: plus LM with each has_l / has_a pair) at 8 and 10 bit
  with an inactive row in the middle, clamped windows, LM sums that
  wrap int32, and CTUs tiled in z-order with holes, as the codec lays
  them out, also with the leaves of two CTUs taken in turn.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xvc_tpu.tpu import intra_scan as jscan
from xvc_tpu_torch.codec.decoder import decode_stream
from xvc_tpu_torch.gpu import flat_recon
from xvc_tpu_torch.gpu import intra_scan as scan

from xvc_tpu_torch.gpu import scan_cases as cases
from .util import read_data


def _capture(name):
    """Decode ``name`` with the port on the CPU; record the inputs of
    every scan call (copies, before the scan writes the canvas)."""
    calls = []
    orig_l, orig_c = scan.intra_scan, scan.intra_chroma_scan

    def rec_l(plane, resi, meta, bd):
        calls.append(("luma", plane.clone(), resi.clone(), np.array(meta),
                      bd, None))
        return orig_l(plane, resi, meta, bd)

    def rec_c(planes, resi, luma, meta, bd):
        calls.append(("chroma", planes.clone(), resi.clone(),
                      np.array(meta), bd, luma.clone()))
        return orig_c(planes, resi, luma, meta, bd)

    mp = pytest.MonkeyPatch()
    mp.setattr(flat_recon.intra_scan, "intra_scan", rec_l)
    mp.setattr(flat_recon.intra_scan, "intra_chroma_scan", rec_c)
    try:
        pics = decode_stream(read_data(name + ".xvc"), device="cpu")
    finally:
        mp.undo()
    assert pics and all(p.conforming for p in pics)
    return calls


def _check(kind, plane, resi, meta, bd, luma):
    """``meta`` is a numpy array; the port takes it as a tensor."""
    tmeta = torch.from_numpy(meta)
    if kind == "luma":
        ph, pw = plane.shape
        want = jscan.make_intra_scan(ph, pw, bd)(
            jnp.asarray(plane.numpy()), jnp.asarray(resi.numpy()),
            jnp.asarray(meta))
        got = scan.intra_scan(plane.clone(), resi, tmeta, bd)
    else:
        _, ph, pw = plane.shape
        lh, lw = luma.shape
        want = jscan.make_intra_chroma_scan(ph, pw, lh, lw, bd)(
            jnp.asarray(plane.numpy()), jnp.asarray(resi.numpy()),
            jnp.asarray(luma.numpy()), jnp.asarray(meta))
        got = scan.intra_chroma_scan(plane.clone(), resi, luma, tmeta, bd)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["ai64x48", "sp_fast"])
def test_scans_match_jax_on_real_metadata(name):
    calls = _capture(name)
    kinds = {c[0] for c in calls}
    assert kinds == {"luma", "chroma"}
    for kind, plane, resi, meta, bd, luma in calls:
        _check(kind, plane, resi, meta, bd, luma)


def _synthetic_meta(rng, n, ncols, lay, w_choices, corner):
    """Random leaves; half of them at the canvas corner ``corner``."""
    meta = np.zeros((n, ncols), np.int32)
    for i in range(n):
        w, h = (int(rng.choice(w_choices)), int(rng.choice(w_choices)))
        if i % 2:
            px, py = corner - w, corner - h
        else:
            px, py = rng.randint(0, 40), rng.randint(0, 40)
        mode = int(rng.randint(0, 67))
        has_l, has_a = int(px > 0), int(py > 0)
        row = {"px": px, "py": py, "w": w, "h": h, "mode": mode,
               "has_l": has_l, "has_a": has_a, "has_al": has_l & has_a,
               "sbl": int(rng.choice([0, 4, 16, 64])),
               "sar": int(rng.choice([0, 4, 16, 64])), "active": 1,
               "plane": i % 2, "is_lm": int(rng.rand() < 0.3)}
        for key, col in lay.items():
            meta[i, col] = row[key]
    meta[-1, lay["active"]] = 0  # an inactive padding row
    return meta


def test_luma_scan_clamped_windows_match_jax():
    rng = np.random.RandomState(5)
    lay = dict(px=jscan.M_PX, py=jscan.M_PY, w=jscan.M_W, h=jscan.M_H,
               mode=jscan.M_MODE, has_l=jscan.M_HAS_L, has_a=jscan.M_HAS_A,
               has_al=jscan.M_HAS_AL, sbl=jscan.M_SBL, sar=jscan.M_SAR,
               active=jscan.M_ACTIVE)
    for bd in (8, 10):
        meta = _synthetic_meta(rng, 24, jscan.META_COLS, lay,
                               (4, 8, 16, 32, 64), 120)
        plane = torch.from_numpy(
            rng.randint(0, 1 << bd, (128, 136)).astype(np.int16))
        resi = torch.from_numpy(
            rng.randint(-60, 60, (128, 136)).astype(np.int32))
        _check("luma", plane, resi, meta, bd, None)


def test_chroma_scan_clamped_windows_match_jax():
    rng = np.random.RandomState(6)
    lay = dict(plane=jscan.C_PLANE, px=jscan.C_PX, py=jscan.C_PY,
               w=jscan.C_W, h=jscan.C_H, mode=jscan.C_MODE,
               is_lm=jscan.C_IS_LM, has_l=jscan.C_HAS_L, has_a=jscan.C_HAS_A,
               has_al=jscan.C_HAS_AL, sbl=jscan.C_SBL, sar=jscan.C_SAR,
               active=jscan.C_ACTIVE)
    for bd in (8, 10):
        meta = _synthetic_meta(rng, 24, jscan.CMETA_COLS, lay,
                               (2, 4, 8, 16, 32), 128)
        planes = torch.from_numpy(
            rng.randint(0, 1 << bd, (2, 136, 144)).astype(np.int16))
        resi = torch.from_numpy(
            rng.randint(-60, 60, (2, 136, 144)).astype(np.int32))
        luma = torch.from_numpy(
            rng.randint(0, 1 << bd, (136, 144)).astype(np.int16))
        _check("chroma", planes, resi, meta, bd, luma)


@pytest.mark.parametrize("bd", [8, 10])
def test_derive_lm_int32_semantics(bd):
    """Degenerate, no-neighbour and ordinary sums give the JAX results
    (via a one-row LM chroma scan, where the JAX scan derives them)."""
    rng = np.random.RandomState(bd)
    for trial in range(6):
        w = h = 8
        meta = np.zeros((1, jscan.CMETA_COLS), np.int32)
        has_l, has_a = (trial % 3 != 0), (trial % 2 == 0)
        meta[0, [jscan.C_PX, jscan.C_PY, jscan.C_W, jscan.C_H,
                 jscan.C_IS_LM, jscan.C_HAS_L, jscan.C_HAS_A,
                 jscan.C_ACTIVE]] = [8, 8, w, h, 1, has_l, has_a, 1]
        flat = trial >= 4  # flat luma: degenerate variance
        lum = np.full((96, 96), 300 % (1 << bd), np.int16) if flat else \
            rng.randint(0, 1 << bd, (96, 96)).astype(np.int16)
        planes = torch.from_numpy(
            rng.randint(0, 1 << bd, (2, 136, 136)).astype(np.int16))
        resi = torch.zeros((2, 136, 136), dtype=torch.int32)
        _check("chroma", planes, resi, meta, bd, torch.from_numpy(lum))


def _check_case(case):
    T = lambda a: None if a is None else torch.from_numpy(a.copy())
    _check(case["kind"], T(case["plane"]), T(case["resi"]), case["meta"],
           case["bd"], T(case["luma"]))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("h", cases.LUMA_DIMS)
@pytest.mark.parametrize("w", cases.LUMA_DIMS)
def test_luma_scan_every_shape_and_mode(w, h, bd):
    _check_case(cases.shape_case("luma", w, h, bd))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("h", cases.CHROMA_DIMS)
@pytest.mark.parametrize("w", cases.CHROMA_DIMS)
def test_chroma_scan_every_shape_mode_and_lm(w, h, bd):
    _check_case(cases.shape_case("chroma", w, h, bd))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("kind", ["luma", "chroma"])
def test_scan_corner_cases(kind, bd):
    _check_case(cases.corner_case(kind, bd))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("kind", ["luma", "chroma"])
def test_scan_tiled_ctus(kind, bd):
    _check_case(cases.tiled_case(kind, bd))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("kind", ["luma", "chroma"])
def test_scan_tiled_ctus_interleaved(kind, bd):
    _check_case(cases.tiled_case(kind, bd, interleave=True))


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_lm_sums_that_wrap_int32(bd):
    case = cases.lm_wrap_case(bd)
    _check_case(case)
    # the case is what it claims: the exact sum of squares of one
    # block's luma neighbours does not fit int32
    assert int(case["luma"].astype(np.int64).max()) ** 2 * 16 > 2 ** 31


def test_wrappers_take_metadata_as_tensor_or_array():
    """As an int32 tensor of the layout's width, the one form: an array,
    another width or type, or a canvas below the windows is refused."""
    case = cases.corner_case("luma", 8)
    T = lambda a: torch.from_numpy(a.copy())
    meta = T(case["meta"])
    a = scan.intra_scan(T(case["plane"]), T(case["resi"]), meta, 8)
    b = scan.intra_scan_plain(T(case["plane"]), T(case["resi"]), meta, 8)
    assert torch.equal(a, b) and not torch.equal(a, T(case["plane"]))
    with pytest.raises(TypeError):
        scan.intra_scan(T(case["plane"]), T(case["resi"]), case["meta"], 8)
    with pytest.raises(ValueError):
        scan.intra_scan(T(case["plane"]), T(case["resi"]),
                        meta[:, :5].contiguous(), 8)
    with pytest.raises(ValueError):
        scan.intra_scan(T(case["plane"]), T(case["resi"]),
                        meta.to(torch.int64), 8)
    with pytest.raises(ValueError):
        scan.intra_scan(T(case["plane"])[:100], T(case["resi"])[:100],
                        meta, 8)
