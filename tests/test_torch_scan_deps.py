"""The dependency model of the intra scans (xvc_tpu_torch/gpu/scan_deps.py)
and the schedule it allows, against the JAX package on the CPU backend.

- real metadata (every scan call of ai64x48 and sp_fast, and picture 0
  of the 720p LD stream, captured while the port decodes them on the
  CPU) lies inside the contract; picture 0's longest paths and widest
  levels are pinned;
- running the plain versions one row at a time in another order the
  graph allows (level by level, reversed within a level) gives the JAX
  scans' result bit for bit (tolerance 0), on the golden metadata and the
  tiled family (also with two CTUs' leaves in turn); on picture 0 of the 720p stream, the rows of its first
  two CTU rows against the plain version in decode order;
- the synthetic families whose leaves overlap or read later rows are
  found out of contract.
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
from xvc_tpu_torch.gpu import scan_deps
from .util import read_data


class _Stop(Exception):
    pass


def _capture_calls(name):
    """The inputs of every scan call of a CPU decode of ``name``."""
    calls = []
    orig_l, orig_c = scan.intra_scan, scan.intra_chroma_scan

    def rec_l(plane, resi, meta, bd):
        calls.append(("luma", plane.clone(), resi.clone(), meta.numpy().copy(),
                      bd, None))
        return orig_l(plane, resi, meta, bd)

    def rec_c(planes, resi, luma, meta, bd):
        calls.append(("chroma", planes.clone(), resi.clone(),
                      meta.numpy().copy(), bd, luma.clone()))
        return orig_c(planes, resi, luma, meta, bd)

    mp = pytest.MonkeyPatch()
    mp.setattr(flat_recon.intra_scan, "intra_scan", rec_l)
    mp.setattr(flat_recon.intra_scan, "intra_chroma_scan", rec_c)
    try:
        decode_stream(read_data(name + ".xvc"), device="cpu")
    finally:
        mp.undo()
    return calls


_HD = {}


def _hd720_picture0():
    """Picture 0 of the 720p LD stream, decoded on the CPU up to its luma
    scan: the scan metadata of both scans (from ``_build_intra_meta``),
    the luma canvas and residual, and the chroma canvas shape."""
    if not _HD:
        orig_b = flat_recon.FlatReconstructor._build_intra_meta

        def rec_b(self, leaves):
            _HD["meta"] = orig_b(self, leaves)
            _HD["chroma_shape"] = (2,) + flat_recon._pad_canvas_dims(
                self.rec.height[1], self.rec.width[1])
            return _HD["meta"]

        def rec_l(plane, resi, meta, bd):
            _HD["luma"] = (plane.clone(), resi.clone(), bd)
            raise _Stop

        mp = pytest.MonkeyPatch()
        mp.setattr(flat_recon.FlatReconstructor, "_build_intra_meta", rec_b)
        mp.setattr(flat_recon.intra_scan, "intra_scan", rec_l)
        try:
            decode_stream(read_data("bench/hd720_ld.xvc"), device="cpu")
        except _Stop:
            pass
        finally:
            mp.undo()
    return _HD


def _schedules(kind, meta, shape):
    s = scan_deps.analyse(kind, meta, shape)
    return (s,) if kind == "luma" else s


# ---------------------------------------------------------------------------
# Real metadata lies inside the contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ai64x48", "sp_fast"])
def test_golden_metadata_is_in_contract(name):
    calls = _capture_calls(name)
    assert {c[0] for c in calls} == {"luma", "chroma"}
    for kind, plane, _, meta, _, _ in calls:
        for s in _schedules(kind, meta, tuple(plane.shape)):
            assert s.in_contract, s.breach
            assert s.longest <= len(s.rows)


def test_hd720_picture0_longest_paths():
    """724 of 5,234 luma rows, 144 of 960 rows per chroma plane; at most
    19 / 12 rows on one level."""
    hd = _hd720_picture0()
    lmeta, cmeta = hd["meta"]
    plane = hd["luma"][0]
    s = scan_deps.analyse("luma", lmeta, tuple(plane.shape))
    assert s.in_contract and len(s.rows) == 5234
    assert (s.longest, s.widest) == (724, 19)
    assert max(len(d) for d in s.deps) == 15
    for c in scan_deps.analyse("chroma", cmeta, hd["chroma_shape"]):
        assert c.in_contract and len(c.rows) == 960
        assert (c.longest, c.widest) == (144, 12)


# ---------------------------------------------------------------------------
# Another order the graph allows gives the same planes
# ---------------------------------------------------------------------------

def _graph_order(s):
    """Level by level, reversed within a level: the row indices."""
    order = []
    for lev in range(s.longest):
        order += list(s.rows[s.level == lev][::-1])
    assert sorted(order) == sorted(s.rows)
    return order


def _run_rows(kind, plane, resi, luma, meta, bd, order):
    """The plain version one row at a time, in ``order``."""
    out = plane.clone()
    for n in order:
        row = torch.from_numpy(meta[n:n + 1].copy())
        if kind == "luma":
            scan.intra_scan_plain(out, resi, row, bd)
        else:
            scan.intra_chroma_scan_plain(out, resi, luma, row, bd)
    return out


def _jax(kind, plane, resi, luma, meta, bd):
    if kind == "luma":
        fn = jscan.make_intra_scan(*plane.shape, bd)
        return np.asarray(fn(jnp.asarray(plane.numpy()),
                             jnp.asarray(resi.numpy()), jnp.asarray(meta)))
    fn = jscan.make_intra_chroma_scan(*plane.shape[1:], *luma.shape, bd)
    return np.asarray(fn(jnp.asarray(plane.numpy()), jnp.asarray(resi.numpy()),
                         jnp.asarray(luma.numpy()), jnp.asarray(meta)))


def _is_topological(s, order):
    pos = {int(n): k for k, n in enumerate(order)}
    return sorted(pos) == sorted(s.rows.tolist()) and all(
        pos[int(j)] < pos[int(n)] for n, deps in zip(s.rows, s.deps)
        for j in deps)


def _check_graph_order(kind, plane, resi, luma, meta, bd, how):
    """Level by level (reversed within a level), or the kernel's
    wavefront ticket order where it applies."""
    order = []
    for s in _schedules(kind, meta, tuple(plane.shape)):
        assert s.in_contract, s.breach
        plane_order = _graph_order(s)
        if how == "wavefront":
            plane_order = scan_deps.wavefront_order(kind, meta, plane.shape,
                                                    s)
            if plane_order is None:
                plane_order = s.rows
        assert _is_topological(s, plane_order)
        order += list(plane_order)
    got = _run_rows(kind, plane, resi, luma, meta, bd, order)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax(kind, plane, resi, luma, meta, bd))


@pytest.mark.parametrize("how", ["levels", "wavefront"])
@pytest.mark.parametrize("name", ["ai64x48", "sp_fast"])
def test_graph_order_matches_jax_on_golden_metadata(name, how):
    for kind, plane, resi, meta, bd, luma in _capture_calls(name):
        _check_graph_order(kind, plane, resi, luma, meta, bd, how)


@pytest.mark.parametrize("how", ["levels", "wavefront"])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("kind", ["luma", "chroma"])
def test_graph_order_matches_jax_on_tiled_case(kind, bd, how):
    case = cases.tiled_case(kind, bd)
    T = lambda a: None if a is None else torch.from_numpy(a.copy())
    for s in _schedules(kind, case["meta"], case["plane"].shape):
        assert scan_deps.wavefront_order(kind, case["meta"],
                                         case["plane"].shape, s) is not None
    _check_graph_order(kind, T(case["plane"]), T(case["resi"]),
                       T(case["luma"]), case["meta"], bd, how)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("kind", ["luma", "chroma"])
def test_graph_order_matches_jax_on_interleaved_tiled_case(kind, bd):
    """Level by level on the table whose tickets go in decode order."""
    case = cases.tiled_case(kind, bd, interleave=True)
    T = lambda a: None if a is None else torch.from_numpy(a.copy())
    _check_graph_order(kind, T(case["plane"]), T(case["resi"]),
                       T(case["luma"]), case["meta"], bd, "levels")


def test_hd720_picture0_wavefront_tickets():
    """The kernel's wavefront ticket order applies to picture 0's luma
    and both chroma planes, is a topological order, and lets the
    kernel's 16 warps that take tickets in it finish in 1,005 (luma) /
    164 (chroma) steps against the longest paths of 724 / 144 (32 warps:
    858 / 160); in decode order they need 3,435 / 795 (32: 3,279 /
    619)."""
    hd = _hd720_picture0()
    lmeta, cmeta = hd["meta"]
    shape = tuple(hd["luma"][0].shape)
    s = scan_deps.analyse("luma", lmeta, shape)
    order = scan_deps.wavefront_order("luma", lmeta, shape, s)
    assert order is not None and _is_topological(s, order)
    assert [scan_deps.ticket_steps(s, o, w) for w in (16, 32)
            for o in (order, s.rows)] == [1005, 3435, 858, 3279]
    for c in scan_deps.analyse("chroma", cmeta, hd["chroma_shape"]):
        order = scan_deps.wavefront_order("chroma", cmeta,
                                          hd["chroma_shape"], c)
        assert order is not None and _is_topological(c, order)
        assert [scan_deps.ticket_steps(c, o, w) for w in (16, 32)
                for o in (order, c.rows)] == [164, 795, 160, 619]
    # with as many warps as rows, any topological order reaches the
    # longest path
    assert scan_deps.ticket_steps(s, s.rows, len(s.rows)) == 724


def test_graph_order_on_hd720_picture0_first_ctu_rows():
    """The rows of the first two CTU rows (py < 128), which depend on no
    other row, in graph order against decode order."""
    hd = _hd720_picture0()
    lmeta = hd["meta"][0]
    plane, resi, bd = hd["luma"]
    s = scan_deps.analyse("luma", lmeta, tuple(plane.shape))
    top = lmeta[s.rows, scan.M_PY] < 128
    sub = set(s.rows[top].tolist())
    assert 400 < len(sub) < len(s.rows)
    for k in np.flatnonzero(top):
        assert set(s.deps[k].tolist()) <= sub
    order = []
    for lev in range(s.longest):
        order += [n for n in s.rows[s.level == lev][::-1] if n in sub]
    got = _run_rows("luma", plane, resi, None, lmeta, bd, order)
    sel = np.zeros_like(lmeta)
    sel[:len(sub)] = lmeta[sorted(sub)]
    want = scan.intra_scan_plain(plane.clone(), resi, torch.from_numpy(sel),
                                 bd)
    assert not torch.equal(want, plane)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# Breaches of the contract are found
# ---------------------------------------------------------------------------

_OUT_OF_CONTRACT = (
    [("shape", kind, w, h) for kind, dims in (("luma", cases.LUMA_DIMS),
                                              ("chroma", cases.CHROMA_DIMS))
     for w in dims for h in dims]
    + [("corner", kind, 0, 0) for kind in ("luma", "chroma")]
    + [("lm_wrap", "chroma", 0, 0)])


def _family(family, kind, w, h, bd=8):
    if family == "shape":
        return cases.shape_case(kind, w, h, bd)
    if family == "corner":
        return cases.corner_case(kind, bd)
    return cases.lm_wrap_case(bd)


@pytest.mark.parametrize("family,kind,w,h", _OUT_OF_CONTRACT)
def test_overlapping_families_are_out_of_contract(family, kind, w, h):
    case = _family(family, kind, w, h)
    scheds = _schedules(kind, case["meta"], case["plane"].shape)
    assert all(not s.in_contract for s in scheds)
    assert all(s.breach in ("two writers", "reads a later row")
               for s in scheds)
    assert all(s.deps is None and s.longest is None for s in scheds)


def test_a_row_that_reads_a_later_row_is_found():
    """Two leaves side by side in reverse decode order: the first reads
    the second's column; swapping them brings the table into contract."""
    meta = np.zeros((2, scan.META_COLS), np.int32)
    meta[0] = [8, 0, 8, 8, 0, 1, 0, 0, 0, 0, 1]   # right leaf, reads left
    meta[1] = [0, 0, 8, 8, 0, 0, 0, 0, 0, 0, 1]   # left leaf
    s = scan_deps.analyse("luma", meta, (256, 264))
    assert (s.in_contract, s.breach) == (False, "reads a later row")
    s = scan_deps.analyse("luma", meta[::-1].copy(), (256, 264))
    assert s.in_contract and s.longest == 2 and s.widest == 1
    assert [d.tolist() for d in s.deps] == [[], [0]]
    meta[1, :4] = [4, 0, 8, 8]                      # overlaps the first
    s = scan_deps.analyse("luma", meta, (256, 264))
    assert (s.in_contract, s.breach) == (False, "two writers")
