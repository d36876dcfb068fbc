"""The PyTorch port's CUDA kernels and device decode on an NVIDIA card.

These tests carry the ``cuda`` marker and skip without a CUDA device (a
fixture decides); on the card they run with
``python -m pytest --noconftest tests/test_torch_cuda.py``.  They import no
JAX (the machine with the card has none): each kernel is held against
its plain PyTorch version on the same CUDA inputs, bit-exact, the
device decode (both paths: the flat one and the replay one of
gpu/recon.py) against every golden and the recorded host decodes
(tests/data/bench/<stream>_dec.sha256 of the six bench streams and the
small CTU-tile-row streams, tests/data/c4*_ra64x48_dec.sha256), damaged
streams against the same session on the CPU device (no sticky CUDA
error), the lookahead on the card against the same call on the CPU
device, the resampler's kernel against its plain version, output
conversion against the goldens, threaded decodes against sequential
ones, the motion search's SAD sweep against its plain version, the
encoders (speed 3 on the native encoder, the lookahead and the device
motion estimation on the Python CU encoder) against the CPU device, and
threaded encodes on both encoders against sequential ones on the card.
"""
import hashlib

import numpy as np
import pytest
import torch

from xvc_tpu_torch import kernels
from xvc_tpu_torch.codec import picture_decoder
from xvc_tpu_torch.codec.decoder import decode_stream
from xvc_tpu_torch.gpu import (deblock, flat_recon, itx, lookahead, mc,
                               resample, satd)
from xvc_tpu_torch.gpu import intra_scan as scan
from xvc_tpu_torch.ops import deblock as dbk
from xvc_tpu_torch.restrictions import Restrictions

from xvc_tpu_torch.gpu import deblock_cases as dcases
from xvc_tpu_torch.gpu import flat_cases
from xvc_tpu_torch.gpu import scan_cases as cases
from xvc_tpu_torch.gpu import scan_deps
from .util import data_path, read_data

pytestmark = pytest.mark.cuda

_BIG = 1 << 20


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _to(dev, *arrays):
    return [torch.from_numpy(np.array(a)).to(dev) for a in arrays]


def _device_ops_per_call(fn, iters=4):
    """The device operations (kernels and copies) of each of ``iters``
    calls of fn (which waits for its own result) under torch.profiler:
    each call in a range of its own, after two calls in the same window
    that are not counted (the first events of a window can be lost).  A
    device event counts for the call whose range holds the CUDA runtime
    call that issued it (by correlation id), or its own start where there
    is none."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2 + iters):
            with record_function("device_ops.call"):
                fn()
                torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    ranges = sorted((ev.start_ns(), ev.end_ns()) for ev in events
                    if ev.name() == "device_ops.call" and
                    not str(ev.device_type()).endswith("CUDA"))[2:]
    assert len(ranges) == iters
    counts = [0] * iters
    # the CUDA runtime calls on the host, by the correlation id their
    # device operations carry
    issued = {ev.correlation_id(): ev.start_ns() for ev in events
              if not str(ev.device_type()).endswith("CUDA") and
              ev.name().startswith("cuda")}
    for ev in events:
        if str(ev.device_type()).endswith("CUDA") and \
                not getattr(ev, "is_user_annotation", bool)() and \
                ev.name() != "device_ops.call":
            t = issued.get(ev.correlation_id(), ev.start_ns())
            for j, (a, b) in enumerate(ranges):
                if a <= t <= b:
                    counts[j] += 1
    return counts


def _device_ops_seen(fn, windows=3):
    """``_device_ops_per_call`` of the first of up to ``windows`` profiler
    windows that saw any device event: late in a long process a window
    can lose every one, which measures nothing."""
    for _ in range(windows):
        counts = _device_ops_per_call(fn)
        if any(counts):
            break
    return counts


def _positions(B, bw, bh, nx):
    ty, tx = np.divmod(np.arange(B), nx)
    return ty * bh, tx * bw


@pytest.mark.parametrize("luma,wb,hb,bd,short", [
    (True, 16, 16, 8, False), (True, 64, 8, 10, True),
    (True, 8, 8, 8, True), (False, 8, 8, 8, True),
    (False, 32, 32, 10, False), (False, 16, 64, 8, True)])
def test_mc_kernel_matches_plain(cuda, luma, wb, hb, bd, short):
    rng = np.random.RandomState(wb + hb + bd)
    nplanes, taps, nph = (1, 8, 16) if luma else (2, 4, 32)
    B, S, Hp, Wp = 512, 4, 256, 384
    cy, cx = _positions(B, wb, hb, 16)
    H, W = int(cy.max()) + hb, 16 * wb
    params = np.stack([
        rng.randint(-1, S + 1, B),
        rng.randint(-8, Hp - hb - taps + 9, B),
        rng.randint(-8, Wp - wb - taps + 9, B),
        rng.randint(0, nph, B) * (rng.rand(B) > 0.25),
        rng.randint(0, nph, B) * (rng.rand(B) > 0.25),
        rng.randint(0, 2 * nplanes, B), cy, cx,
        rng.randint(2, wb + 1, B), rng.randint(2, hb + 1, B)]).astype(
            np.int32)
    params[:, -B // 8:] = _BIG
    planes = rng.randint(0, 1 << bd, (S, Hp, Wp)).astype(np.int16)
    outs = []
    for fn in (mc.mc_scatter, mc.mc_scatter_plain):
        pred, mask = _to(cuda, np.zeros((2 * nplanes, H, W), np.int16),
                         np.zeros((nplanes, H, W), np.int16))
        fn(pred, mask, *_to(cuda, planes, params), wb, hb, luma, bd, True,
           short)
        outs.append((pred.cpu().numpy(), mask.cpu().numpy()))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("w,h,bd,variant", [
    (8, 8, 8, None), (64, 64, 10, None), (32, 4, 8, None), (2, 2, 8, None),
    (4, 4, 8, "dst4"), (16, 16, 8, "dc"), (8, 4, 10, "skip"),
    (16, 32, 10, "gen")])
def test_itx_kernel_matches_plain(cuda, w, h, bd, variant):
    rng = np.random.RandomState(w * h + bd)
    B, nplanes = 256, 2
    cy, cx = _positions(B, w, h, 16)
    H, W = int(cy.max()) + h, 16 * w
    coeff = rng.randint(-32768, 32768, (B, h, w)).astype(np.int16)
    coeff[rng.rand(B, h, w) < 0.6] = 0
    scale = rng.randint(1, 1 << 22, B).astype(np.int32)
    rows = [rng.randint(0, nplanes, B), cy, cx]
    if variant is None:
        rows += [rng.randint(0, 5, B), rng.randint(0, 5, B)]
    params = np.stack(rows).astype(np.int32)
    params[:3, -B // 8:] = _BIG
    outs = []
    for plain in (False, True):
        resi, *a = _to(cuda, np.zeros((nplanes, H, W), np.int32), coeff,
                       scale, params)
        if plain:
            itx.itx_scatter_plain(resi, *a, w, h, bd, True, variant, 1, 5)
        elif variant is None:
            itx.itx_scatter_gen(resi, *a, w, h, bd, True)
        else:
            itx.itx_scatter(resi, *a, w, h, bd, 1, 5, variant, True)
        outs.append(resi.cpu().numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("flags", [(False,) * 5,
                                   (True, False, False, True, True),
                                   (False, True, False, False, False),
                                   (False, False, True, False, False)])
def test_deblock_kernel_matches_plain(cuda, flags):
    """Both directions on a 1280x720 plane as it lies (no transpose)."""
    rng = np.random.RandomState(sum(flags))
    H, W = 720, 1280
    for direction in (0, 1):
        L, lines = (W, H) if direction == 0 else (H, W)
        blocks = rng.randint(0, 256, (H // 8, W // 8))
        plane = (np.repeat(np.repeat(blocks, 8, 0), 8, 1) // 12 + 100 +
                 rng.randint(-2, 3, (H, W))).astype(np.int16)
        xs = np.arange(4, L, 4).astype(np.int32)
        qp = rng.randint(16, 52, (len(xs), lines // 4))
        beta = np.asarray(dbk.BETA_TABLE, np.int32)[np.clip(qp, 0, 51)]
        tc = np.asarray(dbk.TC_TABLE, np.int32)[np.clip(qp + 2, 0, 53)]
        mask = (rng.rand(len(xs), lines // 4) < 0.8).astype(np.int32)
        outs = []
        for fn in (deblock.luma_pass, deblock.luma_pass_plain):
            pl, *a = _to(cuda, plane, xs, mask, tc, beta)
            fn(pl, *a, 8, flags, direction)
            outs.append(pl.cpu().numpy())
        assert (outs[0] != plane).any()
        np.testing.assert_array_equal(outs[0], outs[1])


LUMA_FLAGS = [(False,) * 5, (True, False, False, False, False),
              (False, True, False, False, False),
              (False, False, True, False, False),
              (False, False, False, True, True)]


@pytest.mark.parametrize("size", [(48, 96), (200, 328)])
@pytest.mark.parametrize("direction", [0, 1])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("kind", dcases.LUMA_KINDS)
def test_deblock_luma_kernel_edge_lists(cuda, kind, bd, direction, size):
    """Every position, a pruned list, a clamped last strip and a height
    that is no multiple of 4, under each restriction flag."""
    for n, flags in enumerate(LUMA_FLAGS):
        case = dcases.luma_case(kind, bd, direction, seed=n, size=size)
        outs = []
        kernels.reset_launches()
        for fn in (deblock.luma_pass, deblock.luma_pass_plain):
            pl, *a = _to(cuda, *case)
            fn(pl, *a, bd, flags, direction)
            outs.append(pl.cpu().numpy())
        assert kernels.LAUNCHES["deblock_luma"] == 1
        assert n or (outs[0] != case[0]).any()
        np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("direction", [0, 1])
@pytest.mark.parametrize("bd", [8, 10])
def test_deblock_chroma_kernel_matches_plain(cuda, bd, direction):
    for size in ((24, 48), (360, 640)):
        case = dcases.chroma_case(bd, direction, size=size)
        outs = []
        kernels.reset_launches()
        for fn in (deblock.chroma_pass, deblock.chroma_pass_plain):
            pl, *a = _to(cuda, *case)
            fn(pl, *a, bd, direction)
            outs.append(pl.cpu().numpy())
        assert kernels.LAUNCHES["deblock_chroma"] == 1
        assert (outs[0] != case[0]).any()
        np.testing.assert_array_equal(outs[0], outs[1])


def _tiled_edge_params(dev, size, sbs, pred_type, restr_flags, bd,
                       do_chroma=True):
    """attrs of a tiled picture on ``dev`` and what edge_params and its
    plain version make of them."""
    pic = dcases.tiled_picture(sum(size) + sbs, *size, pred_type)
    attrs, n = dbk.DeblockingFilter(pic, None, 0, 0, None).build_cu_attrs(0)
    lay = deblock.EdgeLayout(*size, sbs, 1, 1, True, do_chroma)
    args = (n, lay, 1, -2, bd, pred_type == 0, restr_flags)
    a, = _to(dev, attrs)
    return lay, deblock.edge_params(a, *args), \
        deblock.edge_params_plain(a, *args)


@pytest.mark.parametrize("restr_flags", [
    (False, False, False), (True, False, False), (False, True, False),
    (False, False, True)])
@pytest.mark.parametrize("pred_type", [0, 1, 2])
@pytest.mark.parametrize("sbs", [4, 8])
@pytest.mark.parametrize("size", dcases.EDGE_SIZES + ((1280, 720),))
def test_deblock_edges_kernel_matches_plain(cuda, size, sbs, pred_type,
                                            restr_flags):
    for bd in (8, 10):
        kernels.reset_launches()
        lay, got, want = _tiled_edge_params(cuda, size, sbs, pred_type,
                                            restr_flags, bd)
        assert kernels.LAUNCHES["deblock_edges"] == 1
        assert lay.total > 0 and got[1].shape == (lay.total,)
        for g, w in zip(got, want):
            assert g.device.type == "cuda"
            np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


@pytest.mark.parametrize("sbs", [4, 8])
@pytest.mark.parametrize("size", [(64, 48), (328, 200), (1280, 720)])
def test_deblock_filters_from_packed_entries(cuda, size, sbs):
    """luma_filter and chroma_filter on the entries edge_params derived,
    against the plain versions fed the unpacked tensors."""
    W, H = size
    rng = np.random.RandomState(W + sbs)
    lay, (_, params), _ = _tiled_edge_params(cuda, size, sbs, 0,
                                             (False,) * 3, 8)
    luma = dcases.blocky_plane(rng, H, W, 8)
    chroma = [dcases.blocky_plane(rng, H // 2, W // 2, 8) for _ in range(2)]
    got_l, want_l = _to(cuda, luma, luma)
    got_c, want_c = _to(cuda, *chroma), _to(cuda, *chroma)
    kernels.reset_launches()
    for d in (0, 1):
        deblock.luma_filter(got_l, params, lay, d, 8, (False,) * 5)
        deblock.chroma_filter(got_c, params, lay, d, 8)
        xs, mask, tc, beta = deblock.luma_tensors(params, lay, d)
        G = (H, W)[d] // 4
        deblock.luma_pass_plain(
            want_l, xs, mask[:, :G], tc[:, :G], beta[:, :G], 8, (False,) * 5,
            d)
        edges, apply, ctc = deblock.chroma_tensors(params, lay, d)
        N = (H // 2, W // 2)[d]
        for plane in want_c:
            deblock.chroma_pass_plain(plane, edges, apply[:, :N],
                                      ctc[:, :N], 8, d)
    assert kernels.LAUNCHES["deblock_luma"] == 2
    assert kernels.LAUNCHES["deblock_chroma"] == 2
    assert (got_l.cpu().numpy() != luma).any()
    assert (got_c[0].cpu().numpy() != chroma[0]).any()
    np.testing.assert_array_equal(got_l.cpu().numpy(), want_l.cpu().numpy())
    for g, w in zip(got_c, want_c):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


def test_deblock_on_card_is_kernels_only_and_never_waits_for_the_host(cuda):
    """With every plain version and numpy derivation made to raise, and
    any synchronising call inside deblock_picture an error, the decode
    still runs and equals its golden."""
    def refuse(*args, **kwargs):
        raise AssertionError("plain deblock code ran on the card's path")

    orig = picture_decoder.deblock_picture

    def no_sync(filt, planes, device):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return orig(filt, planes, device)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    mp = pytest.MonkeyPatch()
    for name in ("edge_params_plain", "luma_pass_plain", "chroma_pass_plain",
                 "compute_edge_metadata", "luma_edge_tensors",
                 "chroma_edge_tensors", "paint_cu_map_plain", "luma_tensors",
                 "chroma_tensors"):
        mp.setattr(deblock, name, refuse)
    mp.setattr(picture_decoder, "deblock_picture", no_sync)
    kernels.reset_launches()
    try:
        pics = decode_stream(read_data("sp_fast.xvc"), device=cuda)
    finally:
        mp.undo()
    assert len(pics) == 6 and all(p.conforming for p in pics)
    assert b"".join(p.bytes for p in pics) == read_data("sp_fast_dec.yuv")
    for name in ("deblock_edges", "deblock_luma", "deblock_chroma"):
        assert kernels.LAUNCHES[name] > 0


def test_deblock_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    case = dcases.luma_case("regular", 8, 0)
    plane, xs, mask, tc, beta = _to(cuda, *case)
    with pytest.raises(ValueError):
        deblock.luma_pass(plane, xs.cpu(), mask, tc, beta, 8, (False,) * 5)
    with pytest.raises(ValueError):
        deblock.luma_pass(plane.to(torch.int32), xs, mask, tc, beta, 8,
                          (False,) * 5)
    with pytest.raises(ValueError):
        deblock.luma_pass(plane, xs, mask, tc, beta, 8, (False,) * 5, 1)
    with pytest.raises(RuntimeError):
        deblock.luma_pass(plane, xs, mask, tc, beta, 16, (False,) * 5)


# every golden with a _dec.yuv and its picture count (the JAX package's
# host decode gives the same counts)
GOLDENS = {"ai16x16": 2, "ai352x288": 2, "ai44x36": 2, "ai64x48": 3,
           "ai64x48b10": 2, "ai64x48q27": 2, "ai64x48q37": 2, "b12": 2,
           "cf_c422": 2, "cf_c444": 2, "cf_mono": 2, "cg48x32": 6,
           "enc_encap": 3, "ld64x48": 8, "ra128x96": 17, "ra64x48": 10,
           "ra64x48b10": 9, "ra96x64pl": 9, "radbg": 10, "res16x24": 2,
           "res20x36": 2, "res24x16": 2, "res44x20": 2, "rm1_64x48": 3,
           "rm2_64x48": 3, "rm3_64x48": 3, "rm4_64x48": 3,
           "scal16to24": 17, "sp_cksum0": 6, "sp_fast": 6,
           "sp_leadpics": 6, "sp_placebo": 6, "sp_tunepsnr": 6}


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_every_golden_decodes_on_card(cuda, name):
    """Both device paths: the flat one and the replay one (gpu/recon.py:
    LIC, 4:2:2 / 4:4:4, restricted toolsets), ITX, MC and deblock on the
    card."""
    kernels.reset_launches()
    pics = decode_stream(read_data(name + ".xvc"), device=cuda)
    assert len(pics) == GOLDENS[name] and all(p.conforming for p in pics)
    assert b"".join(p.bytes for p in pics) == read_data(name + "_dec.yuv")
    assert kernels.LAUNCHES["itx_picture"] == len(pics)
    # radbg is coded with deblocking off
    assert (kernels.LAUNCHES["deblock_luma"] > 0) == (name != "radbg")


@pytest.mark.parametrize("name", ["c422_ra64x48", "c444_ra64x48"])
def test_chroma_inter_streams_decode_on_card(cuda, name):
    with open(data_path(name + "_dec.sha256")) as f:
        want = [line.split()[0] for line in f if line.strip()]
    kernels.reset_launches()
    pics = decode_stream(read_data(name + ".xvc"), device=cuda)
    assert len(pics) == len(want) == 5 and all(p.conforming for p in pics)
    assert [hashlib.sha256(p.bytes).hexdigest() for p in pics] == want
    assert kernels.LAUNCHES["mc_picture"] == 4


@pytest.mark.parametrize("name,count", [("ai64x48", 3), ("ai64x48b10", 2),
                                        ("sp_fast", 6)])
def test_decode_matches_golden_on_card(cuda, name, count):
    kernels.reset_launches()
    pics = decode_stream(read_data(name + ".xvc"), device=cuda)
    assert len(pics) == count and all(p.conforming for p in pics)
    assert b"".join(p.bytes for p in pics) == read_data(name + "_dec.yuv")
    for kernel in ("itx_picture", "deblock_edges", "deblock_luma",
                   "deblock_chroma", "intra_luma", "intra_chroma"):
        assert kernels.LAUNCHES[kernel] > 0
    assert kernels.LAUNCHES["itx"] == kernels.LAUNCHES["mc"] == 0


def test_720p_decode_matches_host_on_card(cuda):
    with open(data_path("bench/hd720_ld_dec.sha256")) as f:
        want = [line.split()[0] for line in f if line.strip()]
    kernels.reset_launches()
    pics = decode_stream(read_data("bench/hd720_ld.xvc"), device=cuda)
    assert len(pics) == len(want) == 8
    assert all(p.conforming for p in pics)
    assert [hashlib.sha256(p.bytes).hexdigest() for p in pics] == want
    assert all(kernels.LAUNCHES[name] > 0
               for name in ("deblock_edges", "deblock_luma",
                            "deblock_chroma", "intra_luma", "intra_chroma"))
    # one ITX launch a picture, one MC launch an inter picture, and
    # neither group kernel
    assert kernels.LAUNCHES["itx_picture"] == 8
    assert kernels.LAUNCHES["mc_picture"] == 7
    assert kernels.LAUNCHES["itx"] == kernels.LAUNCHES["mc"] == 0


@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("bd", [8, 10, 14])
def test_satd_kernel_matches_plain(cuda, n, bd):
    rng = np.random.RandomState(n + bd)
    lim = 2 ** bd - 1
    # a batch that fills no whole warp, tile or 1024-block group
    diff = rng.randint(-lim, lim + 1, (1031, 3, n, n)).astype(np.int32)
    diff[0, 0], diff[0, 1] = lim, -lim
    d, = _to(cuda, diff)
    kernels.reset_launches()
    got = satd.satd_square(d, bd)
    assert kernels.LAUNCHES["satd"] == 1
    assert got.dtype == torch.int32 and tuple(got.shape) == (1031, 3)
    want = satd.satd_plain(d, bd)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    np.testing.assert_array_equal(
        got.cpu().numpy(), satd.satd_plain(torch.from_numpy(diff), bd))
    if n == 8:
        np.testing.assert_array_equal(
            satd.satd8(d[:, 0].contiguous(), bd).cpu().numpy(),
            want[:, 0].cpu().numpy())


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_satd_pred_kernel_matches_plain(cuda, n):
    rng = np.random.RandomState(n)
    orig = rng.randint(0, 1024, (77, n, n)).astype(np.int32)
    preds = rng.randint(0, 1024, (77, 67, n, n)).astype(np.int32)
    o, p = _to(cuda, orig, preds)
    got = satd.satd_pred(o, p, 10)
    want = satd.satd_plain(torch.from_numpy(orig[:, None] - preds), 10)
    assert tuple(got.shape) == (77, 67)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_satd_pred_kernel_at_the_per_cu_shape(cuda, n, bd):
    """One CU's 67 predictions (B = 1), the shape the Python CU encoder's
    per-CU pre-pass gave the kernel, with the full-range extremes; and
    the whole per-CU call, which now launches intra_satd instead (one
    launch, no satd), against the CPU device."""
    from xvc_tpu_torch.codec.intra_search import device_prepass_satd
    rng = np.random.RandomState(10 * n + bd)
    top_bit = 1 << bd
    orig = rng.randint(0, top_bit, (1, n, n)).astype(np.int32)
    preds = rng.randint(0, top_bit, (1, 67, n, n)).astype(np.int32)
    orig[0, 0, 0], preds[0, 0, 0, 0] = top_bit - 1, 0
    o, p = _to(cuda, orig, preds)
    kernels.reset_launches()
    got = satd.satd_pred(o, p, bd)
    assert kernels.LAUNCHES["satd"] == 1
    want = satd.satd_plain(torch.from_numpy(orig[:, None] - preds), bd)
    assert tuple(got.shape) == (1, 67)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    top = rng.randint(0, top_bit, 2 * n + 1).astype(np.int32)
    left = rng.randint(0, top_bit, 2 * n).astype(np.int32)
    kernels.reset_launches()
    card = device_prepass_satd(orig[0], top, left, bd, cuda)
    assert kernels.LAUNCHES["intra_satd"] == 1
    assert kernels.LAUNCHES["satd"] == 0
    np.testing.assert_array_equal(
        card, device_prepass_satd(orig[0], top, left, bd, "cpu"))


@pytest.mark.parametrize("route", ["lookahead", "prepass"])
def test_python_cu_encode_on_card_matches_cpu(cuda, route, monkeypatch):
    """A 64x64 all-intra picture through the Python CU encoder on the
    card, with tpu_intra_lookahead (the lookahead's four intra_satd
    launches rank the modes) or under XVC_INTRA_PREPASS=jax (one
    intra_satd launch per CU the per-CU pre-pass evaluates; no satd
    launch on either route): the CPU device's NALs and
    reconstruction, the deblock kernels launched, and its decode on the
    card equal to the reconstruction."""
    from xvc_tpu_torch import api
    from xvc_tpu_torch.nal import write_nal_units
    from .encode_clips import txrd_clip
    w = h = 64
    yuv = txrd_clip(w, h, 1)
    settings = "tpu_intra_lookahead 1"
    if route == "prepass":
        monkeypatch.setenv("XVC_INTRA_PREPASS", "jax")
        settings = ""

    def enc(dev):
        ses = api.EncoderSession(api.EncoderParameters(
            width=w, height=h, qp=32, speed_mode=2, num_ref_pics=0,
            sub_gop_length=1, checksum_mode=1,
            explicit_encoder_settings=settings), device=dev)
        return ses.encode(yuv) + ses.flush(), ses.rec_pictures

    want, want_rec = enc("cpu")
    kernels.reset_launches()
    got, rec = enc(cuda)
    assert got == want and rec == want_rec
    if route == "lookahead":
        assert kernels.LAUNCHES["intra_satd"] == 4
    else:
        assert kernels.LAUNCHES["intra_satd"] > 16
    assert kernels.LAUNCHES["satd"] == 0
    for name in ("deblock_edges", "deblock_luma", "deblock_chroma"):
        assert kernels.LAUNCHES[name] > 0, name
    pics = decode_stream(write_nal_units(got), device=cuda)
    assert len(pics) == 1 and pics[0].conforming and pics[0].bytes == rec[0]


@pytest.mark.parametrize("bd", [8, 10, 12, 14])
@pytest.mark.parametrize("mode_step", [1, 4, 8])
@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
def test_intra_satd_kernel_matches_plain(cuda, n, mode_step, bd):
    """The all-mode intra SATD kernel against its plain version on the
    card, 77 blocks (random and sorted lines, the extremes), bit for
    bit, one launch."""
    from xvc_tpu_torch.gpu import intra_satd
    t = _to(cuda, *intra_satd.synthetic_inputs(
        np.random.RandomState(100 * n + 10 * mode_step + bd), 77, n, bd))
    kernels.reset_launches()
    got = intra_satd.intra_satd(*t, n, bd, mode_step)
    assert kernels.LAUNCHES["intra_satd"] == 1
    want = intra_satd.intra_satd_plain(*t, n, bd, mode_step)
    assert tuple(got.shape) == (77, intra_satd.num_modes(mode_step))
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_intra_satd_kernel_at_the_per_cu_shape(cuda, n, bd):
    """B = 1, as the per-CU pre-pass launches it: a sorted block and a
    random one, each alone, against the plain version."""
    from xvc_tpu_torch.gpu import intra_satd
    orig, top, left = intra_satd.synthetic_inputs(
        np.random.RandomState(7 * n + bd), 2, n, bd)
    for b in (0, 1):
        t = _to(cuda, orig[b:b + 1], top[b:b + 1], left[b:b + 1])
        np.testing.assert_array_equal(
            intra_satd.intra_satd(*t, n, bd).cpu().numpy(),
            intra_satd.intra_satd_plain(*t, n, bd, 1).cpu().numpy())


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_per_cu_call_is_one_launch_between_two_copies(cuda, n):
    """One device_prepass_satd call on the card: one intra_satd launch,
    no satd launch, and 3 device operations (the upload, the kernel, the
    download) in each call's range of a torch.profiler window; the CPU
    device's costs."""
    from xvc_tpu_torch.codec.intra_search import device_prepass_satd
    from xvc_tpu_torch.gpu import intra_satd
    orig, top, left = intra_satd.synthetic_inputs(
        np.random.RandomState(n), 1, n, 10)
    args = (orig[0], top[0], left[0], 10)
    want = device_prepass_satd(*args, "cpu")
    device_prepass_satd(*args, cuda)  # first-use costs
    torch.cuda.synchronize()
    kernels.reset_launches()
    got = device_prepass_satd(*args, cuda)
    assert kernels.LAUNCHES["intra_satd"] == 1
    assert kernels.LAUNCHES["satd"] == 0
    np.testing.assert_array_equal(got, want)
    assert _device_ops_per_call(
        lambda: device_prepass_satd(*args, cuda)) == [3] * 4


def test_make_intra_satd_fn_on_card_never_predicts(cuda, monkeypatch):
    """make_intra_satd_fn on the card goes to the kernel alone: with the
    batched predictor made to raise, every size and mode step still
    returns the CPU device's costs."""
    from xvc_tpu_torch.gpu import analysis, intra_batch, intra_satd
    cases = []
    for n, step in ((4, 1), (8, 1), (16, 4), (32, 1), (64, 8)):
        a = intra_satd.synthetic_inputs(np.random.RandomState(n), 9, n, 8)
        cases.append((n, step, a, analysis.make_intra_satd_fn(n, 8, step)(
            *_to("cpu", *a)).numpy()))

    def refuse(*args, **kwargs):
        raise AssertionError("predict_all_modes reached on the card")

    monkeypatch.setattr(intra_batch, "predict_all_modes", refuse)
    for n, step, a, want in cases:
        got = analysis.make_intra_satd_fn(n, 8, step)(*_to(cuda, *a))
        np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("mode_step", [1, 4])
def test_lookahead_on_card_matches_cpu(cuda, mode_step):
    frame = np.fromfile(data_path("ai352x288_in.yuv"), np.uint8,
                        count=352 * 288).reshape(288, 352)
    want = lookahead.frame_intra_lookahead(frame, 8, Restrictions(),
                                           mode_step=mode_step, device="cpu")
    kernels.reset_launches()
    got = lookahead.frame_intra_lookahead(frame, 8, Restrictions(),
                                          mode_step=mode_step, device=cuda)
    assert kernels.LAUNCHES["intra_satd"] == 4
    assert kernels.LAUNCHES["satd"] == 0
    assert sorted(got) == [4, 8, 16, 32]
    for n in got:
        np.testing.assert_array_equal(got[n], want[n])


def _scan_status(kind, meta, shape, status):
    """The kernel's status against the dependency model: parallel inside
    the contract, ordered outside it, every active row of a plane run,
    wavefront tickets where the model gives that order.  Returns the
    schedule of each plane: "wavefront", "parallel" (tickets in decode
    order) or "ordered"."""
    scheds = scan_deps.analyse(kind, meta, shape)
    scheds = (scheds,) if kind == "luma" else scheds
    status = status.cpu().numpy()
    assert status.shape == (len(scheds), scan.STATUS_WORDS)
    for s, (sched, rows, flags, warps, wave) in zip(scheds, status):
        assert sched == (scan.PARALLEL if s.in_contract else scan.ORDERED)
        assert (flags == 0) == s.in_contract
        assert rows == len(s.rows) and warps == 16
        assert wave == (s.in_contract and scan_deps.wavefront_order(
            kind, meta, shape, s) is not None)
    return ["ordered" if st[0] == scan.ORDERED else
            "wavefront" if st[4] else "parallel" for st in status]


def _scan_kernel(kind, plane, resi, luma, meta, bd):
    """One launch of the kernel on a copy of ``plane``."""
    if kind == "luma":
        return scan.intra_scan(plane.clone(), resi, meta, bd)
    return scan.intra_chroma_scan(plane.clone(), resi, luma, meta, bd)


def _scan_plain(kind, plane, resi, luma, meta, bd):
    if kind == "luma":
        return scan.intra_scan_plain(plane.clone(), resi, meta, bd)
    return scan.intra_chroma_scan_plain(plane.clone(), resi, luma, meta, bd)


def _scan_both(dev, case):
    """The case through the kernel and through the plain version, on the
    card; asserts bit-exact, one launch and the schedule the dependency
    model gives.  Returns the schedules taken."""
    plane, resi, meta = _to(dev, case["plane"], case["resi"], case["meta"])
    luma = None if case["luma"] is None else _to(dev, case["luma"])[0]
    name = "intra_" + case["kind"]
    kernels.reset_launches()
    got = _scan_kernel(case["kind"], plane, resi, luma, meta, case["bd"])
    assert kernels.LAUNCHES[name] == 1
    want = _scan_plain(case["kind"], plane, resi, luma, meta, case["bd"])
    torch.cuda.synchronize()
    assert not torch.equal(got, plane)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    return _scan_status(case["kind"], case["meta"], case["plane"].shape,
                        scan.last_status(name))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("h", cases.LUMA_DIMS)
@pytest.mark.parametrize("w", cases.LUMA_DIMS)
def test_intra_luma_kernel_every_shape_and_mode(cuda, w, h, bd):
    assert _scan_both(cuda, cases.shape_case("luma", w, h, bd)) == \
        ["ordered"]


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("h", cases.CHROMA_DIMS)
@pytest.mark.parametrize("w", cases.CHROMA_DIMS)
def test_intra_chroma_kernel_every_shape_mode_and_lm(cuda, w, h, bd):
    assert _scan_both(cuda, cases.shape_case("chroma", w, h, bd)) == \
        ["ordered"] * 2


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("kind", ["luma", "chroma"])
def test_intra_scan_kernels_corner_cases(cuda, kind, bd):
    took = _scan_both(cuda, cases.corner_case(kind, bd))
    assert took == ["ordered"] * (1 if kind == "luma" else 2)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("kind", ["luma", "chroma"])
def test_intra_scan_kernels_tiled_ctus_run_parallel(cuda, kind, bd):
    took = _scan_both(cuda, cases.tiled_case(kind, bd))
    assert took == ["wavefront"] * (1 if kind == "luma" else 2)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("kind", ["luma", "chroma"])
def test_intra_scan_kernels_interleaved_tiles_take_decode_order(cuda, kind,
                                                               bd):
    """Inside the contract, but two CTUs' rows in turn: parallel, with the
    tickets in decode order."""
    took = _scan_both(cuda, cases.tiled_case(kind, bd, interleave=True))
    assert took == ["parallel"] * (1 if kind == "luma" else 2)


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_intra_chroma_kernel_lm_sums_that_wrap(cuda, bd):
    assert _scan_both(cuda, cases.lm_wrap_case(bd)) == ["ordered"] * 2


class _Stop(Exception):
    pass


_HD = {}


def _hd720_picture0(dev):
    """What the luma and chroma scans of picture 0 of the 720p LD stream
    are given in a decode on the card (copies, before they write): kind
    -> (plane, resi, luma, meta, bd)."""
    if not _HD:
        orig_l = scan.intra_scan

        def rec_l(plane, resi, meta, bd):
            _HD["luma"] = (plane.clone(), resi.clone(), None, meta.clone(),
                           bd)
            return orig_l(plane, resi, meta, bd)

        def rec_c(planes, resi, luma, meta, bd):
            _HD["chroma"] = (planes.clone(), resi.clone(), luma.clone(),
                             meta.clone(), bd)
            raise _Stop

        mp = pytest.MonkeyPatch()
        mp.setattr(flat_recon.intra_scan, "intra_scan", rec_l)
        mp.setattr(flat_recon.intra_scan, "intra_chroma_scan", rec_c)
        try:
            decode_stream(read_data("bench/hd720_ld.xvc"), device=dev)
        except _Stop:
            pass
        finally:
            mp.undo()
    return _HD


@pytest.mark.parametrize("kind", ["luma", "chroma"])
def test_intra_scan_kernels_on_hd720_picture0_run_parallel(cuda, kind):
    plane, resi, luma, meta, bd = _hd720_picture0(cuda)[kind]
    got = _scan_kernel(kind, plane, resi, luma, meta, bd)
    want = _scan_plain(kind, plane, resi, luma, meta, bd)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and not torch.equal(got, plane)
    took = _scan_status(kind, meta.cpu().numpy(), tuple(plane.shape),
                        scan.last_status("intra_" + kind))
    assert took == ["wavefront"] * (1 if kind == "luma" else 2)


@pytest.mark.parametrize("inputs", ["hd720 picture 0", "interleaved"])
@pytest.mark.parametrize("kind", ["luma", "chroma"])
def test_intra_scan_kernels_repeat_identically(cuda, kind, inputs):
    """20 launches back to back, each on a fresh copy of the canvas, give
    identical planes (a race between the warps would show as a
    difference), equal to the plain version: on picture 0's inputs
    (wavefront tickets) and on the interleaved tiled case (tickets in
    decode order)."""
    if inputs == "interleaved":
        case = cases.tiled_case(kind, 10, interleave=True)
        plane, resi, meta = _to(cuda, case["plane"], case["resi"],
                                case["meta"])
        luma = None if case["luma"] is None else _to(cuda, case["luma"])[0]
        bd = case["bd"]
    else:
        plane, resi, luma, meta, bd = _hd720_picture0(cuda)[kind]
    want = _scan_plain(kind, plane, resi, luma, meta, bd)
    outs = [_scan_kernel(kind, plane, resi, luma, meta, bd)
            for _ in range(20)]
    status = scan.last_status("intra_" + kind).clone()
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)
    assert not torch.equal(want, plane)
    assert (status[:, 0] == scan.PARALLEL).all()
    assert (status[:, 4] == (inputs != "interleaved")).all()


def test_intra_scan_wrappers_never_wait_for_the_card(cuda):
    """The wrappers read nothing back: they run under
    set_sync_debug_mode("error")."""
    inputs = _hd720_picture0(cuda)
    kernels.reset_launches()
    outs = {}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for kind in ("luma", "chroma"):
            outs[kind] = _scan_kernel(kind, *inputs[kind])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["intra_luma"] == 1
    assert kernels.LAUNCHES["intra_chroma"] == 1
    for kind in ("luma", "chroma"):
        assert torch.equal(outs[kind], _scan_plain(kind, *inputs[kind]))


@pytest.mark.parametrize("name", ["ai64x48", "ai64x48b10", "sp_fast"])
def test_intra_scan_kernels_on_captured_inputs(cuda, name):
    """Every scan call of a decode on the card: the kernel's output
    against the plain version on copies of the same inputs, and the
    schedule it took against the dependency model (never ordered: the
    codec's tables lie inside the contract)."""
    seen = []
    orig_l, orig_c = scan.intra_scan, scan.intra_chroma_scan

    def took(kind, plane, meta):
        return _scan_status(kind, meta.cpu().numpy(), tuple(plane.shape),
                            scan.last_status("intra_" + kind))

    def rec_l(plane, resi, meta, bd):
        want = scan.intra_scan_plain(plane.clone(), resi, meta, bd)
        got = orig_l(plane, resi, meta, bd)
        seen.append(("luma", torch.equal(got, want),
                     took("luma", plane, meta)))
        return got

    def rec_c(planes, resi, luma, meta, bd):
        want = scan.intra_chroma_scan_plain(planes.clone(), resi, luma, meta,
                                            bd)
        got = orig_c(planes, resi, luma, meta, bd)
        seen.append(("chroma", torch.equal(got, want),
                     took("chroma", planes, meta)))
        return got

    mp = pytest.MonkeyPatch()
    mp.setattr(flat_recon.intra_scan, "intra_scan", rec_l)
    mp.setattr(flat_recon.intra_scan, "intra_chroma_scan", rec_c)
    try:
        pics = decode_stream(read_data(name + ".xvc"), device=cuda)
    finally:
        mp.undo()
    assert pics and all(p.conforming for p in pics)
    assert {kind for kind, _, _ in seen} == {"luma", "chroma"}
    assert all(ok for _, ok, _ in seen)
    assert all("ordered" not in names for _, _, names in seen)


def test_decode_on_card_never_takes_the_plain_scans(cuda):
    """The plain versions and their host tables are off the card's decode
    path: with each of them made to raise, the decode still runs."""
    def refuse(*args, **kwargs):
        raise AssertionError("plain scan code ran on the card's path")

    mp = pytest.MonkeyPatch()
    for name in ("intra_scan_plain", "intra_chroma_scan_plain", "_leaf_refs",
                 "derive_lm"):
        mp.setattr(scan, name, refuse)
    kernels.reset_launches()
    try:
        pics = decode_stream(read_data("sp_fast.xvc"), device=cuda)
    finally:
        mp.undo()
    assert len(pics) == 6 and all(p.conforming for p in pics)
    assert b"".join(p.bytes for p in pics) == read_data("sp_fast_dec.yuv")
    assert kernels.LAUNCHES["intra_luma"] > 0
    assert kernels.LAUNCHES["intra_chroma"] > 0


def test_intra_scan_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    case = cases.corner_case("luma", 8)
    plane, resi, meta = _to(cuda, case["plane"], case["resi"], case["meta"])
    with pytest.raises(ValueError):
        scan.intra_scan(plane, resi.cpu(), meta, 8)
    with pytest.raises(ValueError):
        scan.intra_scan(plane, resi, meta.to(torch.int64), 8)
    with pytest.raises(ValueError):
        scan.intra_scan(plane.t(), resi.t(), meta, 8)
    with pytest.raises(RuntimeError):
        scan.intra_scan(plane, resi, meta, 15)


# ---------------------------------------------------------------------------
# The picture kernels: ITX and MC of a whole picture from its records
# ---------------------------------------------------------------------------

# (stream under tests/data, decode-order index): pictures of the flat
# path, then of the replay path (LIC, 4:2:2 and 4:4:4 intra and inter, a
# restricted toolset)
REAL_PICTURES = [("bench/hd720_ld", 0), ("bench/hd720_ld", 3),
                 ("bench/cif_ai", 0), ("bench/fhd1080_ra", 3),
                 ("bench/qhd1440_ra10", 1), ("bench/uhd2160_ra10", 1),
                 ("bench/hd720_lic", 1), ("bench/hd720_lic", 3),
                 ("cf_c422", 0), ("cf_c444", 0), ("c422_ra64x48", 1),
                 ("c422_ra64x48", 3), ("c444_ra64x48", 1),
                 ("c444_ra64x48", 3), ("rm1_64x48", 2), ("ra64x48", 3)]
SYNTHETIC = {"420": dict(seed=2), "mono": dict(seed=8, mono=True),
             "dual tree 10 bit": dict(seed=8, dual=True, bitdepth=10),
             "no dst, low precision": dict(seed=8, no_dst=True,
                                           hp_tx=False),
             "10 bit, low-precision MVs, no chroma sub-pel": dict(
                 seed=8, bitdepth=10, hp_mv=False, chroma_subpel=False,
                 nrefs=(3, 1))}
_REAL = {}


def _real_picture(name, n):
    if (name, n) not in _REAL:
        _REAL[name, n] = flat_cases.parse_pictures(
            read_data(name + ".xvc"), {n})[n]
    return _REAL[name, n]


def _picture_kernel_both(dev, pic, kind, records=None):
    """(kernel planes, plain planes) of itx_picture ("itx") or mc_picture
    ("mc") on the picture's records, or on ``records``."""
    outs = []
    for kernel in (True, False):
        if kind == "itx":
            a = flat_cases.itx_args(pic, dev, records)
            (itx.itx_picture if kernel else itx.itx_picture_plain)(*a)
            planes = a[:2]
        else:
            a = flat_cases.mc_args(pic, dev, 11, records)
            (mc.mc_picture if kernel else mc.mc_picture_plain)(*a)
            planes = a[:4]
        torch.cuda.synchronize()
        outs.append([t.cpu().numpy() for t in planes if t is not None])
    return outs


def _picture_kernels_both(dev, pic, records=None):
    """(kernel planes, plain planes) of itx_picture then mc_picture."""
    itx_got, itx_want = _picture_kernel_both(dev, pic, "itx", records)
    mc_got, mc_want = _picture_kernel_both(dev, pic, "mc", records)
    return itx_got + mc_got, itx_want + mc_want


def _assert_planes(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name,n", REAL_PICTURES)
def test_picture_kernels_match_plain_on_real_records(cuda, name, n):
    pic = _real_picture(name, n)
    kernels.reset_launches()
    got, want = _picture_kernels_both(cuda, pic)
    _assert_planes(got, want)
    # one launch each (an intra picture's MC items all exit)
    assert kernels.LAUNCHES["itx_picture"] == kernels.LAUNCHES[
        "mc_picture"] == 1
    assert np.any(got[0])
    assert np.any(got[2]) == pic["inter"]


@pytest.mark.parametrize("case", sorted(SYNTHETIC))
def test_picture_kernels_match_plain_on_synthetic_records(cuda, case):
    pic = flat_cases.synthetic_picture(**SYNTHETIC[case])
    got, want = _picture_kernels_both(cuda, pic)
    _assert_planes(got, want)
    nitx = 1 if pic["mono"] else 2
    assert all(np.any(g) for g in got[:nitx])
    assert all(np.any(g) == pic["inter"] for g in got[nitx:])


@pytest.mark.parametrize("source", ["synthetic", "hd720_ld picture 3"])
def test_picture_kernels_drop_damaged_rows_without_a_fault(cuda, source):
    """Rows that break every guard (origins outside the plane, sides that
    are no power of two or too large, coefficients past the arena, a qp
    outside the table, reference indices outside 0..4 or past their list)
    write nothing, and the card reports no fault."""
    pic = flat_cases.synthetic_picture(5) if source == "synthetic" else \
        _real_picture("bench/hd720_ld", 3)
    for kind in ("itx", "mc"):
        bad = flat_cases.damaged_rows(pic, kind)
        clean, _ = _picture_kernel_both(cuda, pic, kind)
        got, want = _picture_kernel_both(
            cuda, pic, kind, np.concatenate([pic["records"], bad]))
        _assert_planes(got, want)
        _assert_planes(got, clean)
        only, _ = _picture_kernel_both(cuda, pic, kind, bad)
        assert not any(np.any(g) for g in only), kind
    torch.cuda.synchronize()


def test_picture_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    pic = flat_cases.synthetic_picture(2)
    a = list(flat_cases.itx_args(pic, cuda))
    with pytest.raises(ValueError):
        itx.itx_picture(a[0], a[1], a[2].cpu(), *a[3:])
    with pytest.raises(ValueError):
        itx.itx_picture(a[0], a[1], a[2][:, :70].contiguous(), *a[3:])
    b = list(flat_cases.mc_args(pic, cuda, 0))
    with pytest.raises(ValueError):
        mc.mc_picture(*b[:5], b[5].cpu(), *b[6:])
    with pytest.raises(ValueError):
        small = b[6][:, :64, :64].contiguous()
        mc.mc_picture(*b[:6], small, b[7], b[8])
    # rows that are no multiple of 8 samples: no 16-byte staging
    with pytest.raises(ValueError):
        mc.mc_picture(*b[:6], b[6][:, :, :-4].contiguous(), b[7], b[8])
    pred, mask = b[0], b[1]
    params = torch.zeros((10, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        mc.mc_scatter(pred, mask, b[6][:, :, :-4].contiguous(), params, 8, 8,
                      True, 8, True, False)


@pytest.mark.parametrize("name,count,inter", [
    ("cif_ai", 16, 0), ("hd720_ld", 8, 7), ("hd720_lic", 8, 7),
    ("fhd1080_ra", 8, 7), ("qhd1440_ra10", 5, 4), ("uhd2160_ra10", 3, 2)])
def test_bench_stream_decodes_on_card(cuda, name, count, inter):
    with open(data_path("bench/%s_dec.sha256" % name)) as f:
        want = [line.split()[0] for line in f if line.strip()]
    kernels.reset_launches()
    pics = decode_stream(read_data("bench/%s.xvc" % name), device=cuda)
    assert len(pics) == len(want) == count
    assert all(p.conforming for p in pics)
    assert [hashlib.sha256(p.bytes).hexdigest() for p in pics] == want
    assert kernels.LAUNCHES["itx_picture"] == count
    assert kernels.LAUNCHES["mc_picture"] == inter
    assert kernels.LAUNCHES["itx"] == kernels.LAUNCHES["mc"] == 0


@pytest.mark.parametrize("name,path", [("tiles64x256", "flat"),
                                       ("tiles64x128_lic", "replay")])
def test_tiles_stream_decodes_on_card(cuda, name, path, monkeypatch):
    """The small CTU-tile-row streams of tests/encode_clips.py
    TILE_STREAMS (64x256 in 4 tiles; 64x128 in 2 tiles with LIC on, whose
    inter pictures the replay path takes) on the card, sequential and
    with 2 picture threads: their hash lists (the JAX package's decodes),
    every picture conforming, the picture kernels and the deblock kernels
    launched (and the scans on the flat path), the group kernels not."""
    monkeypatch.setenv("XVC_THREADS_NO_CLAMP", "1")
    with open(data_path("bench/%s_dec.sha256" % name)) as f:
        want = [line.split()[0] for line in f if line.strip()]
    paths = []
    real = flat_recon.eligible

    def eligible(pd, restr):
        paths.append("flat" if real(pd, restr) else "replay")
        return paths[-1] == "flat"

    monkeypatch.setattr(picture_decoder.flat_recon, "eligible", eligible)
    data = read_data("bench/%s.xvc" % name)
    kernels.reset_launches()
    pics = decode_stream(data, device=cuda)
    launches = dict(kernels.LAUNCHES)
    assert len(pics) == len(want) == 3
    assert all(p.conforming for p in pics)
    assert [hashlib.sha256(p.bytes).hexdigest() for p in pics] == want
    assert launches["itx_picture"] == 3 and launches["mc_picture"] == 2
    assert launches["itx"] == launches["mc"] == 0
    for kernel in ("deblock_edges", "deblock_luma", "deblock_chroma",
                   "intra_luma", "intra_chroma"):
        assert launches[kernel] > 0, kernel
    if path == "flat":
        assert paths == ["flat"] * 3
    else:
        assert paths == ["flat", "replay", "replay"]
    threaded = decode_stream(data, device=cuda, num_threads=2)
    assert [p.bytes for p in threaded] == [p.bytes for p in pics]


@pytest.mark.parametrize("name", ["sp_fast", "ld64x48", "cf_c444"])
def test_decode_on_card_never_takes_the_plain_picture_code(cuda, name):
    """The plain versions and their job derivations are off the card's
    decode paths (the flat one, sp_fast; the replay one, ld64x48 with
    LIC, cf_c444): with each of them made to raise, the decode still
    runs."""
    def refuse(*args, **kwargs):
        raise AssertionError("plain ITX / MC code ran on the card's path")

    mp = pytest.MonkeyPatch()
    for module, names in ((itx, ("itx_picture_plain", "itx_jobs",
                                 "itx_scatter_plain")),
                          (mc, ("mc_picture_plain", "mc_jobs",
                                "mc_scatter_plain"))):
        for fn in names:
            mp.setattr(module, fn, refuse)
    try:
        pics = decode_stream(read_data(name + ".xvc"), device=cuda)
    finally:
        mp.undo()
    assert b"".join(p.bytes for p in pics) == read_data(name + "_dec.yuv")


def _damaged(nals, idx, mode, seed):
    """The damage of tests/test_torch_fuzz.py (which imports the JAX
    package, absent on the card's machine)."""
    import random
    rng = random.Random(seed)
    out = list(nals)
    b = bytearray(nals[idx])
    if mode == "truncate":
        b = b[:max(1, len(b) // 2)]
    elif mode == "corrupt":
        for _ in range(8):
            b[rng.randrange(len(b))] ^= rng.randrange(1, 256)
    else:
        b = bytearray(rng.randbytes(len(b)))
    out[idx] = bytes(b)
    return out


def _session_result(session, nals):
    flags = []
    for nal in nals:
        session.decode_nal(nal)
        while (pic := session.get_picture()) is not None:
            flags.append((pic.conforming, pic.bytes))
    session.flush()
    while (pic := session.get_picture()) is not None:
        flags.append((pic.conforming, pic.bytes))
    return flags, session.check_conformance()[1]


@pytest.mark.parametrize("mode", ["truncate", "corrupt", "garbage"])
@pytest.mark.parametrize("stream", ["ai64x48", "ai64x48b10", "sp_fast",
                                    "ld64x48", "cf_c422"])
def test_damaged_nals_on_card(cuda, stream, mode):
    """The damage of tests/test_torch_fuzz.py on the card: the session on
    the card gives the CPU device's pictures, bytes, conformance flags
    and corrupt count, and the card reports no fault."""
    from xvc_tpu_torch.api import DecoderSession
    from xvc_tpu_torch.nal import split_nal_units
    nals = list(split_nal_units(read_data(stream + ".xvc")))
    for idx in sorted({0, 1, 2, len(nals) // 2, len(nals) - 1}):
        for seed in (0, 1):
            bad = _damaged(nals, idx, mode, seed)
            got = _session_result(DecoderSession(device=cuda), bad)
            torch.cuda.synchronize()
            assert got == _session_result(DecoderSession(device="cpu"), bad)
    pics = decode_stream(read_data(stream + ".xvc"), device=cuda)
    assert all(p.conforming for p in pics)


# ---- the encoder's transform-RD prepass (kernels/csrc/txrd.cu) ----------

@pytest.mark.parametrize("keep", [1, 2, 3, 8])
@pytest.mark.parametrize("bd,qp,intra", [(8, 32, True), (8, 22, False),
                                         (10, 37, True)])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_txrd_kernel_matches_plain(cuda, n, bd, qp, intra, keep):
    """txrd (screen to kept modes) against txrd_plain on the same CUDA
    inputs (synthetic_inputs: SATD ties across the 8th and 9th place,
    cost ties, full-scale residuals), 67 or 19 modes, and against the
    CPU's plain version."""
    from xvc_tpu_torch.gpu import txrd_prepass as tx
    from xvc_tpu_torch.ops.quant import Qp
    rng = np.random.RandomState(n * 100 + qp + keep)
    step = 1 + keep % 3
    blocks = 1031 if n < 32 else 263
    orig, preds, satd = _to(cuda, *tx.synthetic_inputs(
        rng, blocks, n, bd, 2 + -(-65 // step)))
    p = tx.rank_params(n, bd, Qp(qp, 1, bd, 0.57 * 2 ** ((qp - 12) / 3)),
                       intra)
    kernels.reset_launches()
    got = tx.txrd(orig, preds, satd, n, bd, keep, step, p)
    want = tx.txrd_plain(orig, preds, satd, n, bd, keep, step, p)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["txrd"] == 1
    assert tuple(got.shape) == (blocks, keep) and got.dtype == torch.int32
    assert torch.equal(got, want)
    # the CPU's plain version gives the same
    assert torch.equal(got.cpu(), tx.txrd(
        orig.cpu(), preds.cpu(), satd.cpu(), n, bd, keep, step, p))


@pytest.mark.parametrize("bd", [12, 14, 16])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_txrd_kernel_matches_plain_at_high_bit_depths(cuda, n, bd):
    """Where the row pass's sums pass 2^24 (n >= 8 above 11 to 13 bit)
    the kernel shifts in float32, below in integers; both against
    txrd_plain."""
    from xvc_tpu_torch.gpu import txrd_prepass as tx
    from xvc_tpu_torch.ops.quant import Qp
    orig, preds, satd = _to(cuda, *tx.synthetic_inputs(
        np.random.RandomState(n + bd), 263, n, bd))
    p = tx.rank_params(n, bd, Qp(37, 1, bd, 0.57 * 2 ** (25 / 3)), False)
    got = tx.txrd(orig, preds, satd, n, bd, 2, 1, p)
    want = tx.txrd_plain(orig, preds, satd, n, bd, 2, 1, p)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_txrd_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    from xvc_tpu_torch.gpu import txrd_prepass as tx
    from xvc_tpu_torch.ops.quant import Qp
    orig, preds, satd = _to(cuda, *tx.synthetic_inputs(
        np.random.RandomState(1), 4, 32, 8))
    p = tx.rank_params(32, 8, Qp(32, 1, 8, 57.0), True)
    with pytest.raises(ValueError, match="2\\^31"):
        tx.txrd(orig, preds, satd, 32, 19, 1, 1, p)  # sums could pass 2^31
    o4, p4, s4 = _to(cuda, *tx.synthetic_inputs(
        np.random.RandomState(2), 4, 4, 8))
    with pytest.raises(ValueError, match="2\\^24"):
        tx.txrd(o4, p4, s4, 4, 17, 1, 1, p)    # n = 4: sums pass 2^24
    with pytest.raises(ValueError, match="fewer than 8"):
        tx.txrd(orig, preds[:, :7], satd[:, :7], 32, 8, 1, 1, p)
    with pytest.raises(ValueError, match="several devices"):
        tx.txrd(orig, preds, satd.cpu(), 32, 8, 1, 1, p)


def _hd720_s3_luma():
    from .encode_clips import make_hd720_s3
    return np.frombuffer(make_hd720_s3(), np.uint8,
                         count=1280 * 720).reshape(720, 1280)


@pytest.mark.parametrize("intra", [True, False])
def test_txrd_prepass_on_card_matches_cpu_and_repeats(cuda, intra):
    """frame_txrd_prepass of picture 0 of hd720_s3 on the card: the
    maps of the CPU device (plain versions) and the same maps over 5
    repeated calls; the txrd kernel holds its plain version on the real
    inputs of every size."""
    from xvc_tpu_torch.gpu import txrd_prepass as tx
    from xvc_tpu_torch.ops.quant import Qp
    luma = _hd720_s3_luma()
    qp = Qp(32, 1, 8, 0.57 * 2 ** (20 / 3))
    want = tx.frame_txrd_prepass(luma, 8, qp, intra, keep=1, device="cpu")
    fn = tx.txrd
    differ = []

    def spy(orig, preds, satd, n, bitdepth, keep, screen_step, params):
        out = fn(orig, preds, satd, n, bitdepth, keep, screen_step, params)
        plain = tx.txrd_plain(orig, preds, satd, n, bitdepth, keep,
                              screen_step, params)
        differ.append(int((out != plain).any(1).sum()))
        return out

    tx.txrd = spy
    try:
        for _ in range(5):
            kernels.reset_launches()
            got = tx.frame_txrd_prepass(luma, 8, qp, intra, keep=1,
                                        device=cuda)
            assert kernels.LAUNCHES["txrd"] == 4
            assert kernels.LAUNCHES["satd"] == 4
            assert kernels.LAUNCHES["intra_satd"] == 0
            for n in want:
                np.testing.assert_array_equal(got[n], want[n])
    finally:
        tx.txrd = fn
    assert differ == [0] * 20


def test_txrd_prepass_on_card_runs_no_sort_and_no_float64(cuda):
    """One prepass call of picture 0 of hd720_s3 on the card: no
    aten::sort and no operation on a float64 tensor (so no float64
    matmul): prediction, SATD and txrd only."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from xvc_tpu_torch.gpu import txrd_prepass as tx
    from xvc_tpu_torch.ops.quant import Qp
    luma = _hd720_s3_luma()
    qp = Qp(32, 1, 8, 0.57 * 2 ** (20 / 3))
    seen = []

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            flat = list(args) + list((kwargs or {}).values())
            seen.append((str(func), {a.dtype for a in flat
                                     if isinstance(a, torch.Tensor)}))
            return func(*args, **(kwargs or {}))

    tx.frame_txrd_prepass(luma, 8, qp, True, keep=2, device=cuda)
    with Log():
        tx.frame_txrd_prepass(luma, 8, qp, True, keep=2, device=cuda)
    assert seen and not [op for op, _ in seen if "sort" in op]
    assert not [op for op, dt in seen if torch.float64 in dt]


def test_speed3_encode_on_card_matches_cpu(cuda):
    """A speed-3 encode (split DP + prepass) of the 192x192 clip of
    tests/test_wavefront_rdo.py on the card: the CPU device's bytes, with
    the card's kernels launched, and its decode on the card conforming."""
    from xvc_tpu_torch.codec.encoder import encode_stream
    from xvc_tpu_torch.codec.encoder_settings import EncoderSettings
    from xvc_tpu_torch.nal import write_nal_units
    from .encode_clips import wavefront_clip

    def enc(dev):
        s = EncoderSettings()
        s.initialize_speed(3)
        return write_nal_units(encode_stream(
            wavefront_clip(), 192, 192, 2, qp=32, settings=s,
            sub_gop_length=2, num_ref_pics=1, checksum_mode=1, device=dev))

    want = enc("cpu")
    kernels.reset_launches()
    got = enc(cuda)
    assert kernels.LAUNCHES["txrd"] > 0 and kernels.LAUNCHES["satd"] > 0
    assert kernels.LAUNCHES["intra_satd"] > 0  # the split DP's lookahead
    assert got == want
    pics = decode_stream(got, device=cuda)
    assert len(pics) == 2 and all(p.conforming for p in pics)


def test_split_dp_on_card_matches_cpu(cuda):
    from xvc_tpu_torch.gpu import wavefront_rdo as wf
    luma = _hd720_s3_luma().astype(np.int32)
    ref = np.roll(luma, 3, axis=1)
    maps = lookahead.frame_intra_lookahead(luma, 8, Restrictions(),
                                           sizes=(16, 32), mode_step=4,
                                           device=cuda)
    maps.update(lookahead.frame_intra_lookahead(
        luma, 8, Restrictions(), sizes=(64,), mode_step=8, device=cuda))
    for dev in ("cpu", cuda):
        sad = wf.frame_zero_mv_sad(luma, [ref], 8, sizes=(16, 32, 64),
                                   device=dev)
        if dev == "cpu":
            want_sad = sad
            want = wf.split_dp_from_lookahead(maps, 11.3, sad, device=dev)
        else:
            for n in want_sad:
                np.testing.assert_array_equal(sad[n], want_sad[n])
            got = wf.split_dp_from_lookahead(maps, 11.3, sad, device=dev)
            for n in want:
                np.testing.assert_array_equal(got[n], want[n])


# ---- the resampler (kernels/csrc/resample.cu), output conversion and
# picture threads on the card ------------------------------------------------

RESAMPLE_CASES = list(resample.DEVICE_CASES) + [
    c for bd in (8, 10, 14) for c in resample.class_cases(bd)]


@pytest.mark.parametrize("case", RESAMPLE_CASES,
                         ids=["%dx%d_%d-%dx%d_%d" % c for c in RESAMPLE_CASES])
def test_resample_kernel_matches_plain(cuda, case):
    src_bd, dst_w, dst_h, dst_bd = case[2:]
    for full_scale in (False, True):
        window = torch.from_numpy(resample.synthetic_window(
            case, sum(case), full_scale)).to(cuda)
        kernels.reset_launches()
        got = resample.resample_window(window, src_bd, dst_w, dst_h, dst_bd)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["resample"] == 1
        want = resample.resample_plain(window, src_bd, dst_w, dst_h, dst_bd)
        assert torch.equal(got, want)


@pytest.mark.parametrize("src,dst", [((1920, 1080), (1280, 720)),
                                     ((960, 540), (640, 360)),
                                     ((1280, 720), (1920, 1080)),
                                     ((640, 360), (960, 540))])
def test_resample_kernel_matches_plain_at_full_width(cuda, src, dst):
    case = src + (8,) + dst + (8,)
    window = torch.from_numpy(resample.synthetic_window(case, 3)).to(cuda)
    got = resample.resample_window(window, 8, dst[0], dst[1], 8)
    assert torch.equal(got, resample.resample_plain(window, 8, dst[0],
                                                    dst[1], 8))


def test_resample_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    """The host-window entry takes int32 windows (copied to int16 for the
    kernel); the kernel's own planes take int16 windows with an even row
    stride and uint8, int16 or int32 outputs with contiguous rows."""
    window = torch.zeros((40, 40), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        resample.resample_window(window.to(torch.int16), 8, 16, 16, 8)
    with pytest.raises(ValueError):
        resample.resample_window(window[:, ::2], 8, 16, 16, 8)
    with pytest.raises(ValueError):   # a vertical shift below 0
        resample.resample_window(window, 8, 16, 16, 24)
    win16 = torch.zeros((40, 42), dtype=torch.int16, device=cuda)[:, :40]

    def run(win, out):
        resample.run_planes([resample.PlaneJob(0, 8, 8, 24, 24, 16, 16,
                                               out)], [(win, 0, 0)], 8, 8)

    out = torch.empty((16, 16), dtype=torch.uint8, device=cuda)
    run(win16, out)   # taken
    for bad_win, bad_out in (
            (win16.to(torch.int32), out),                     # int32 window
            (torch.zeros((40, 41), dtype=torch.int16,
                         device=cuda)[:, :40], out),          # odd stride
            (win16, out.float()),                             # float output
            (win16, torch.empty((16, 32), dtype=torch.uint8,
                                device=cuda)[:, ::2])):       # strided rows
        with pytest.raises(ValueError):
            run(bad_win, bad_out)


PICTURE_CASES = [(1920, 1080, 1280, 720), (1280, 720, 1920, 1080),
                 (96, 64, 64, 48), (48, 32, 72, 48)]


def _stored_picture(dev, seed, width, height, bd, padded=True):
    """A 4:2:0 picture with random samples in its frame-store slot on
    ``dev`` (edge-replicated, as the decoder stores it); its host border
    padded, or random (a buffer that kept an older border)."""
    from xvc_tpu_torch import constants as k
    from xvc_tpu_torch.codec.yuv import YuvPicture
    rng = np.random.RandomState(seed)
    pic = YuvPicture(k.ChromaFormat.YUV420, width, height, bd, True, 8, 4)
    for c in range(3):
        plane = pic.padded_plane(c)
        plane[:] = rng.randint(0, 1 << bd, plane.shape)
    if padded:
        pic.pad_border()
    flat_recon.frame_store_put(pic, flat_recon.device_pad_planes(
        pic, {c: torch.from_numpy(pic.plane_view(c).astype(np.int16)).to(
            dev) for c in range(3)}), dev)
    return pic


@pytest.mark.parametrize("padded", [True, False], ids=["padded", "ring"])
@pytest.mark.parametrize("case", PICTURE_CASES,
                         ids=["%dx%d-%dx%d" % c for c in PICTURE_CASES])
def test_resample_picture_from_the_store_matches_the_cpu(cuda, case,
                                                         padded):
    """Whole pictures from the frame store: the three planes of a 4:2:0
    picture in one launch into the packed output bytes, at 8 and 10 bit,
    equal to the same call on the CPU device (``resample_plain`` on the
    same windows); and the alternative reconstruction in one launch, its
    store slot and host planes equal to the CPU's."""
    from xvc_tpu_torch.codec.yuv import YuvPicture
    from xvc_tpu_torch.ops import resample as ors
    sw, sh, dw, dh = case
    for bd in (8, 10):
        pics = {d: _stored_picture(d, sum(case) + bd, sw, sh, bd, padded)
                for d in (cuda, torch.device("cpu"))}
        planes, off = [], 0
        for c in range(3):
            w, h = (dw, dh) if c == 0 else (dw // 2, dh // 2)
            planes.append((c, off, w, h))
            off += w * h
        kernels.reset_launches()
        got = {d: resample.resample_to_buffer(p, planes, bd, bd, off, d,
                                              padded)
               for d, p in pics.items()}
        assert kernels.LAUNCHES["resample"] == 1
        assert np.array_equal(*got.values())
        alts = {d: YuvPicture(1, dw, dh, bd, True) for d in pics}
        slots = {d: ors.resample_pic(alts[d], p, d, padded)
                 for d, p in pics.items()}
        assert kernels.LAUNCHES["resample"] == 2
        for c in range(3):
            assert np.array_equal(alts[cuda].padded_plane(c),
                                  alts[torch.device("cpu")].padded_plane(c))
        stored = [flat_recon.get_store(alts[d], d).stacks()[0][slots[d]]
                  for d in pics]
        assert torch.equal(stored[0].cpu(), stored[1])


OUTPUT_GOLDENS = [
    ("ai64x48", "ai64x48_out_down32x24.yuv", dict(output_width=32,
                                                  output_height=24)),
    ("ai64x48", "ai64x48_out_up128x96.yuv", dict(output_width=128,
                                                 output_height=96)),
    ("ai64x48", "ai64x48_out_down44x36.yuv", dict(output_width=44,
                                                  output_height=36)),
    ("ai64x48", "ai64x48_out_chroma444.yuv", dict(output_chroma_format=3)),
    ("ai64x48", "ai64x48_out_argb.yuv", dict(output_chroma_format=4)),
    ("ai64x48b10", "ai64x48b10_out_dither8.yuv", dict(output_bitdepth=8,
                                                      dither=1))]


def _session_pictures(session, data):
    from xvc_tpu_torch.nal import split_nal_units
    for nal in split_nal_units(data):
        session.decode_nal(nal)
    session.flush()
    pics = []
    while (pic := session.get_picture()) is not None:
        pics.append(pic)
    return pics


@pytest.mark.parametrize("stream,golden,kw", OUTPUT_GOLDENS,
                         ids=[g[1][:-4] for g in OUTPUT_GOLDENS])
def test_output_conversion_on_card_equals_the_golden(cuda, stream, golden,
                                                     kw):
    from xvc_tpu_torch.api import DecoderParameters, DecoderSession
    kernels.reset_launches()
    pics = _session_pictures(DecoderSession(DecoderParameters(**kw),
                                            device=cuda),
                             read_data(stream + ".xvc"))
    assert all(p.conforming for p in pics)
    assert b"".join(p.bytes for p in pics) == read_data(golden)
    # the sinc resizes run on the card, one launch a resized picture;
    # 4:4:4 and ARGB chroma is the bilinear 2x upsample of the host
    assert kernels.LAUNCHES["resample"] == \
        (len(pics) if "output_width" in kw else 0)


@pytest.mark.parametrize("threads", [2, 4])
@pytest.mark.parametrize("name", ["ra64x48", "ld64x48", "scal16to24",
                                  "splice96x64to64x48"])
def test_threaded_decode_on_card_equals_sequential(cuda, monkeypatch, name,
                                                   threads):
    from xvc_tpu_torch.parallel import pipeline
    monkeypatch.setenv("XVC_THREADS_NO_CLAMP", "1")
    monkeypatch.setattr(pipeline, "WAIT_SECONDS", 120.0)
    data = read_data(name + ".xvc")
    seq = decode_stream(data, device=cuda)
    thr = decode_stream(data, device=cuda, num_threads=threads)
    cpu = decode_stream(data, device="cpu")
    for pics in (thr, cpu):
        assert [(p.poc, p.conforming, p.bytes) for p in pics] == \
            [(p.poc, p.conforming, p.bytes) for p in seq]


def _me_case(seed, w, h, bd, n, corners=False):
    """A padded 1280x720 luma plane (880 x 1440), a block and n offsets
    from a box origin: inside one 192 x 192 window (its corners first),
    or, with ``corners``, from the plane's origin to its four corners."""
    rng = np.random.RandomState(seed)
    plane = rng.randint(0, 1 << bd, (880, 1440)).astype(np.int32)
    orig = rng.randint(0, 1 << bd, (h, w)).astype(np.int32)
    orig[::3] = 0
    if corners:
        oy, ox, side_y, side_x = 0, 0, 880, 1440
    else:
        oy, ox, side_y, side_x = 300, 517, 192, 192
    plane[oy:oy + h, ox:ox + w] = (1 << bd) - 1
    ys = rng.randint(0, side_y - h + 1, n)
    xs = rng.randint(0, side_x - w + 1, n)
    for j, (y, x) in enumerate([(0, 0), (0, side_x - w), (side_y - h, 0),
                                (side_y - h, side_x - w)][:n]):
        ys[j], xs[j] = y, x
    return plane, oy, ox, orig, np.stack([ys, xs]).astype(np.int32)


@pytest.mark.parametrize("bd", [8, 16])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("w,h,n,corners", [
    (4, 4, 1, False), (8, 16, 44, False), (16, 16, 86, False),
    (32, 8, 754, False), (64, 64, 86, False), (16, 64, 44, False),
    (16, 16, 4, True), (64, 32, 86, True)])
def test_me_sad_kernel_matches_plain(cuda, w, h, n, corners, fast, bd):
    """The motion search's SAD sweep against its plain version on the
    card, bit for bit, one launch and one device operation: the plane
    resident on the card, the block and offsets read from mapped staging,
    the SADs written to mapped memory; a warp a candidate up to 256
    samples, a CTA a candidate above; int16 at 8 bit, int32 at 16; the
    720p plane's four corners."""
    from xvc_tpu_torch.gpu import me
    plane, oy, ox, orig, cands = _me_case(w * 7 + h + n, w, h, bd, n,
                                          corners)
    res = torch.from_numpy(plane).to(me.packed_dtype(bd)).to(cuda)
    want = me.sad_sweep_plain(res, oy, ox, *_to(cuda, orig, cands), fast,
                              bd).cpu().numpy()
    np.testing.assert_array_equal(
        want, me.sad_sweep_plain(torch.from_numpy(plane), oy, ox,
                                 *_to("cpu", orig, cands), fast,
                                 bd).numpy())
    kernels.reset_launches()
    got = me.sad_sweep(res, oy, ox, orig, cands, fast, bd)
    assert kernels.LAUNCHES["me_sad"] == 1
    np.testing.assert_array_equal(got, want)
    assert _device_ops_seen(
        lambda: me.sad_sweep(res, oy, ox, orig, cands, fast, bd)) == [1] * 4


def test_me_prefetch_call_is_one_launch_between_two_copies(cuda):
    """One DeviceSadTable prefetch on the card: the reference's padded
    luma uploaded once (equal to the host plane), then each sweep one
    me_sad launch and one device operation, with no copy on either side
    of it now (the name is kept from the packed call, which had one
    upload and one download); the CPU device's cache."""
    from xvc_tpu_torch.codec.yuv import YuvPicture
    from xvc_tpu_torch.gpu import me
    from xvc_tpu_torch.ops import metrics as met

    class Cu:
        width, height = 16, 16

        @staticmethod
        def pos(comp):
            return 600, 300

    class Qp:
        distortion_weight = [1.0, 1.0, 1.0]

    plane, _, _, orig, _ = _me_case(5, 16, 16, 10, 1)
    pic = YuvPicture(1, 1280, 720, 10)
    pic.planes[0][:] = plane
    metric = met.SampleMetric(10, met.MetricType.SAD_FAST)
    mvs = me.tz_initial_candidates((3, -2), 64)
    tabs = {dev: me.DeviceSadTable(None, Cu(), metric, pic, orig, dev)
            for dev in ("cpu", cuda)}
    me.reset_stats()
    kernels.reset_launches()
    for tab in tabs.values():
        tab.prefetch(Qp(), mvs)
    assert tabs[cuda].cache == tabs["cpu"].cache
    assert len(tabs[cuda].cache) == len(set(mvs))
    assert kernels.LAUNCHES["me_sad"] == 1
    assert me.STATS["reference_uploads"] == 2  # one a device
    assert set(pic.device_luma[1]) == {torch.device("cpu"), cuda}
    np.testing.assert_array_equal(
        pic.device_luma[1][cuda].cpu().numpy(), pic.padded_plane(0))
    assert pic.device_luma[1][cuda].device.type == "cuda"

    def call():
        tab = me.DeviceSadTable(None, Cu(), metric, pic, orig, cuda)
        tab.prefetch(Qp(), mvs)

    assert _device_ops_seen(call) == [1] * 4
    assert me.STATS["reference_uploads"] == 2


def test_python_cu_inter_encode_on_card_matches_cpu(cuda, monkeypatch):
    """ra64x48's first three pictures through the Python CU encoder's
    inter half under XVC_ME=jax on the card: the CPU device's NALs and
    reconstruction, as many me_sad launches as device sweeps (some), and
    its decode on the card, three conforming pictures, equal to the
    reconstruction (of this GOP the session keeps the first two, as the
    JAX package's does)."""
    from xvc_tpu_torch import api
    from xvc_tpu_torch.gpu import me
    from xvc_tpu_torch.nal import write_nal_units
    monkeypatch.setenv("XVC_ME", "jax")
    w, h, f = 64, 48, 3
    yuv = read_data("ra64x48_in.yuv")[:f * w * h * 3 // 2]

    def enc(dev):
        ses = api.EncoderSession(api.EncoderParameters(
            width=w, height=h, qp=32, num_ref_pics=2, sub_gop_length=2,
            checksum_mode=1), device=dev)
        fs = w * h * 3 // 2
        nals = []
        for i in range(f):
            nals += ses.encode(yuv[i * fs:(i + 1) * fs])
        return nals + ses.flush(), ses.rec_pictures

    want, want_rec = enc("cpu")
    me.reset_stats()
    kernels.reset_launches()
    got, rec = enc(cuda)
    assert got == want and rec == want_rec
    assert kernels.LAUNCHES["me_sad"] == me.STATS["device_calls"] > 0
    pics = decode_stream(write_nal_units(got), device=cuda)
    assert len(pics) == f and all(p.conforming for p in pics)
    assert rec and [p.bytes for p in pics][:len(rec)] == rec


# picture-threaded encoding on the card ----------------------------------

def _session_encode_on(dev, params, yuv, frames, fs):
    """NALs, reconstructions and launch counts of an EncoderSession on
    ``dev`` (the counts set to 0 just before, read just after)."""
    from xvc_tpu_torch import api
    ses = api.EncoderSession(params, device=dev)
    kernels.reset_launches()
    nals = []
    for i in range(frames):
        nals += ses.encode(yuv[i * fs:(i + 1) * fs])
    nals += ses.flush()
    torch.cuda.synchronize()
    return nals, ses.rec_pictures, dict(kernels.LAUNCHES), ses


def test_threaded_speed3_encode_on_card_equals_sequential(cuda,
                                                          monkeypatch):
    """Five pictures of the 192x192 clip of tests/test_wavefront_rdo.py at
    speed 3, random access with sub-GOP 4, with 4 picture threads on the
    card: the sequential encode's NALs, reconstructions and kernel
    launches, decoded on the card to the reconstruction."""
    from xvc_tpu_torch import api
    from xvc_tpu_torch.nal import write_nal_units
    from xvc_tpu_torch.parallel import pipeline
    from .encode_clips import wavefront_clip
    monkeypatch.setenv("XVC_THREADS_NO_CLAMP", "1")
    monkeypatch.setattr(pipeline, "WAIT_SECONDS", 120.0)
    f = 5
    yuv = wavefront_clip(f=f)

    def params(threads):
        return api.EncoderParameters(
            width=192, height=192, qp=32, speed_mode=3, sub_gop_length=4,
            checksum_mode=1, threads=threads)

    want, want_rec, want_n, _ = _session_encode_on(cuda, params(0), yuv, f,
                                                   192 * 192 * 3 // 2)
    got, rec, n, ses = _session_encode_on(cuda, params(4), yuv, f,
                                          192 * 192 * 3 // 2)
    assert ses._enc.pipeline is not None
    assert got == want and rec == want_rec and len(rec) == f
    assert n == want_n and n["txrd"] > 0 and n["intra_satd"] > 0
    pics = decode_stream(write_nal_units(got), device=cuda)
    assert len(pics) == f and all(p.conforming for p in pics)
    assert [p.bytes for p in pics] == rec


def test_threaded_python_cu_inter_encode_on_card_equals_sequential(
        cuda, monkeypatch):
    """ra64x48_me4 (tests/encode_clips.py PYTHON_CU_INTER_MORE: pictures 1
    and 3 are coded at once) under XVC_ME=jax with 4 picture threads on
    the card: the sequential encode's NALs, reconstructions, prefetch
    counts and me_sad launches (summed over the workers, equal to the
    device sweeps), and the JAX package's recorded stream."""
    import json
    from xvc_tpu_torch import api
    from xvc_tpu_torch.gpu import me
    from xvc_tpu_torch.nal import write_nal_units
    from xvc_tpu_torch.parallel import pipeline
    from . import encode_clips as clips
    monkeypatch.setenv("XVC_THREADS_NO_CLAMP", "1")
    monkeypatch.setattr(pipeline, "WAIT_SECONDS", 120.0)
    name = "ra64x48_me4"
    clip = clips.PYTHON_CU_INTER_MORE[name]
    for var, val in clip["env"].items():
        monkeypatch.setenv(var, val)
    yuv = clips.python_cu_inter_input(name, data_path(""))
    fs = clips.frame_bytes(clip)
    runs = []
    for threads in (0, 4):
        me.reset_stats()
        runs.append(_session_encode_on(
            cuda, clips.python_cu_inter_params(api, name, threads), yuv,
            clip["pictures"], fs) + (dict(me.STATS),))
    (want, want_rec, want_n, _, want_me), (got, rec, n, ses, stats) = runs
    assert ses._enc.pipeline is not None
    assert got == want and rec == want_rec
    assert n == want_n and stats == want_me
    assert n["me_sad"] == stats["device_calls"] > 0
    with open(data_path("bench/python_cu_inter_more.json")) as f:
        ref = json.load(f)[name]
    data = write_nal_units(got)
    assert hashlib.sha256(data).hexdigest() == ref["sha256"]
    pics = decode_stream(data, device=cuda)
    assert len(pics) == clip["pictures"] and all(p.conforming for p in pics)


# ---------------------------------------------------------------------------
# Bit depth 15 (-k b15): the picture kernels, the deblock kernels and the
# scans against their plain versions, and the 15-bit streams through the
# Python parse and the replay path
# ---------------------------------------------------------------------------

B15_STREAMS = ["ra64x48b15", "tiles64x128b15", "bench/hd720_b15"]


@pytest.mark.parametrize("kind", ["levels 1-199", "full int16 levels"])
@pytest.mark.parametrize("seed", [3, 4])
def test_b15_picture_kernels_match_plain(cuda, seed, kind):
    """itx_picture (DC-only blocks, 32x32 transform skip, the 64-bit
    dequant product) and mc_picture (uni, bi, full-pel and sub-pel) at 15
    bit."""
    pic = flat_cases.b15_picture(seed) if kind == "levels 1-199" else \
        flat_cases.synthetic_picture(seed, bitdepth=15)
    outs = []
    for itx_fn, mc_fn in ((itx.itx_picture, mc.mc_picture),
                          (itx.itx_picture_plain, mc.mc_picture_plain)):
        kernels.reset_launches()
        a = flat_cases.itx_args(pic, cuda)
        itx_fn(*a)
        b = flat_cases.mc_args(pic, cuda, seed)
        mc_fn(*b)
        torch.cuda.synchronize()
        outs.append([t.cpu().numpy() for t in a[:2] + b[:4]
                     if t is not None])
        if itx_fn is itx.itx_picture:
            assert kernels.LAUNCHES["itx_picture"] == 1
            assert kernels.LAUNCHES["mc_picture"] == 1
    for g, w in zip(*outs):
        np.testing.assert_array_equal(g, w)
    assert outs[0][0].any() and outs[0][2].any()


@pytest.mark.parametrize("direction", [0, 1])
@pytest.mark.parametrize("kind", dcases.LUMA_KINDS)
def test_b15_deblock_kernels_match_plain(cuda, kind, direction):
    case = dcases.luma_case(kind, 15, direction, size=(200, 328))
    outs = []
    for fn in (deblock.luma_pass, deblock.luma_pass_plain):
        pl, *a = _to(cuda, *case)
        fn(pl, *a, 15, LUMA_FLAGS[0], direction)
        outs.append(pl.cpu().numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    case = dcases.chroma_case(15, direction, size=(360, 640))
    outs = []
    for fn in (deblock.chroma_pass, deblock.chroma_pass_plain):
        pl, *a = _to(cuda, *case)
        fn(pl, *a, 15, direction)
        outs.append(pl.cpu().numpy())
    assert (outs[0] != case[0]).any()
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("kind", ["luma", "chroma"])
def test_b15_scan_kernels_match_plain(cuda, kind):
    dims = cases.LUMA_DIMS if kind == "luma" else cases.CHROMA_DIMS
    for w in dims:
        for h in dims:
            _scan_both(cuda, cases.shape_case(kind, w, h, 15))
    _scan_both(cuda, cases.corner_case(kind, 15))
    _scan_both(cuda, cases.tiled_case(kind, 15))


@pytest.mark.parametrize("name", B15_STREAMS)
def test_b15_streams_decode_on_card(cuda, name):
    with open(data_path(name + "_dec.sha256")) as f:
        want = [line.split()[0] for line in f if line.strip()]
    kernels.reset_launches()
    pics = decode_stream(read_data(name + ".xvc"), device=cuda)
    assert all(p.conforming for p in pics)
    assert [hashlib.sha256(p.bytes).hexdigest() for p in pics] == want
    assert kernels.LAUNCHES["itx_picture"] == len(pics)
    assert kernels.LAUNCHES["mc_picture"] > 0
    assert kernels.LAUNCHES["intra_luma"] > 0
    assert kernels.LAUNCHES["intra_chroma"] > 0
    assert kernels.LAUNCHES["itx"] == kernels.LAUNCHES["mc"] == 0


def test_b15_python_parse_of_hd720_ld_equals_the_native_route(cuda,
                                                              monkeypatch):
    data = read_data("bench/hd720_ld.xvc")
    native = decode_stream(data, device=cuda, max_pics=2)
    monkeypatch.setenv("XVC_PIC_NATIVE", "0")
    python = decode_stream(data, device=cuda, max_pics=2)
    assert all(p.conforming for p in python)
    assert [p.bytes for p in python] == [p.bytes for p in native]


def _mesh_of(slots):
    from xvc_tpu_torch import engine
    from xvc_tpu_torch.parallel import mesh as mesh_mod
    mesh = mesh_mod.make_mesh(slots)
    engine.set_mesh(mesh)
    return mesh


def test_mesh_lookahead_on_two_slots_equals_unsharded(cuda):
    """The 720p-wide lookahead over two slots of the card (one stream
    each): the unsharded maps, one ``intra_satd`` launch a slot a size."""
    from xvc_tpu_torch import engine
    rng = np.random.RandomState(11)
    frame = rng.randint(0, 256, size=(96, 1280)).astype(np.int32)
    ref = lookahead.frame_intra_lookahead(frame, 8, Restrictions(),
                                          device=cuda)
    mesh = _mesh_of([cuda, cuda])
    assert mesh.slots[0].stream is not mesh.slots[1].stream
    kernels.reset_launches()
    try:
        got = lookahead.frame_intra_lookahead(frame, 8, Restrictions(),
                                              device=cuda)
    finally:
        engine.set_mesh(None)
    assert kernels.LAUNCHES["intra_satd"] == 2 * len(ref)
    for n in ref:
        np.testing.assert_array_equal(got[n], ref[n])


@pytest.mark.parametrize("threads", [0, 4])
def test_mesh_pinned_decode_on_two_slots_equals_unmeshed(cuda, monkeypatch,
                                                         threads):
    """hd720_ld decoded with a mesh of two slots of the card, each picture
    pinned (all to one slot sequentially; pairs rotating with 4 picture
    threads, whose references then move between the slots' stores): its
    hash list."""
    from xvc_tpu_torch import engine
    from xvc_tpu_torch import profiling
    monkeypatch.setenv("XVC_THREADS_NO_CLAMP", "1")
    with open(data_path("bench/hd720_ld_dec.sha256")) as f:
        want = [line.split()[0] for line in f if line.strip()]
    _mesh_of([cuda, cuda])
    moves = profiling.counted("xfer.move")
    try:
        pics = decode_stream(read_data("bench/hd720_ld.xvc"), device=cuda,
                             num_threads=threads)
    finally:
        engine.set_mesh(None)
    assert [hashlib.sha256(p.bytes).hexdigest() for p in pics] == want
    assert all(p.conforming for p in pics)
    assert (profiling.counted("xfer.move") > moves) == (threads > 0)


def test_mesh_sharded_replay_dispatch_on_two_slots(cuda, monkeypatch):
    """ld64x48 (LIC: the replay path) decoded on the card, each replay
    picture's device half run unsharded and then over two slots with no
    pin: equal canvases, and the golden."""
    from xvc_tpu_torch import engine
    from xvc_tpu_torch.gpu import recon
    orig = recon.Reconstructor._device_half
    checked = []

    def twice(self, leaves, lmeta, cmeta):
        orig(self, leaves, lmeta, cmeta)
        ref = [None if t is None else t.clone() for t in
               (self.plane_l, self.rpad_l, self.plane_c, self.rpad_c)]
        _mesh_of([cuda, cuda])
        try:
            orig(self, leaves, lmeta, cmeta)
        finally:
            engine.set_mesh(None)
        for r, g in zip(ref, (self.plane_l, self.rpad_l, self.plane_c,
                              self.rpad_c)):
            assert (r is None and g is None) or torch.equal(r, g)
        checked.append(self.pd.poc)

    monkeypatch.setattr(recon.Reconstructor, "_device_half", twice)
    pics = decode_stream(read_data("ld64x48.xvc"), device=cuda)
    assert checked
    assert b"".join(p.bytes for p in pics) == read_data("ld64x48_dec.yuv")


def test_session_spans_and_copy_counters_on_the_card(cuda):
    """hd720_ld through ``api.DecoderSession`` on the card with the span
    table enabled, under torch.profiler (after a warm decode): its hash
    list; one ``device.wait`` a download; the counted copies each way
    equal to the trace's copy events; the downloaded bytes those of the
    visible int16 planes a picture (and, for a picture with a host tail,
    its int32 planes and residuals)."""
    from torch.profiler import ProfilerActivity, profile
    from xvc_tpu_torch import api, profiling
    from xvc_tpu_torch.nal import split_nal_units
    data = read_data("bench/hd720_ld.xvc")
    with open(data_path("bench/hd720_ld_dec.sha256")) as f:
        want = [line.split()[0] for line in f if line.strip()]

    def decode():
        ses = api.DecoderSession(device=cuda)
        out = []
        for nal in split_nal_units(data):
            ses.decode_nal(nal)
            while (pic := ses.get_picture()) is not None:
                out.append(pic)
        ses.flush()
        while (pic := ses.get_picture()) is not None:
            out.append(pic)
        return out

    decode()
    torch.cuda.synchronize()
    profiling.reset()
    profiling.enable(True)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pics = decode()
            torch.cuda.synchronize()
        rep = profiling.report()
    finally:
        profiling.enable(False)
        profiling.reset()
    assert [hashlib.sha256(p.bytes).hexdigest() for p in pics] == want
    copies = {"DtoH": 0, "HtoD": 0}
    for ev in prof.profiler.kineto_results.events():
        for kind in copies:
            copies[kind] += ev.name().startswith("Memcpy " + kind)
    assert copies["DtoH"] == rep["xfer.dtoh"]["calls"]
    assert copies["HtoD"] == rep["xfer.htod"]["calls"]
    assert rep["device.wait"]["calls"] == rep["xfer.dtoh"]["calls"]
    assert rep["session.output_wait"]["calls"] == len(pics)
    assert rep["decode.session"]["calls"] >= len(pics)
    samples = 1280 * 720 * 3 // 2
    tails = rep.get("recon.download", {"calls": 0})["calls"]
    assert rep["xfer.dtoh.bytes"]["calls"] == \
        len(pics) * samples * 2 + tails * 2 * samples * 4
