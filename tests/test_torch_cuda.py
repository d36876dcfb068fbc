"""The PyTorch port's CUDA kernels and device decode on an NVIDIA card.

These tests carry the ``cuda`` marker and skip without a CUDA device (a
fixture decides); on the card they run with
``python -m pytest --noconftest tests/test_torch_cuda.py``.  They import no
JAX (the machine with the card has none): each kernel is held against
its plain PyTorch version on the same CUDA inputs, bit-exact, and the
device decode against the goldens and the host native decode.
"""
import numpy as np
import pytest
import torch

from xvc_tpu_torch import kernels
from xvc_tpu_torch.codec.decoder import decode_stream
from xvc_tpu_torch.gpu import deblock, itx, mc

from .util import read_data

pytestmark = pytest.mark.cuda

_BIG = 1 << 20


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _to(dev, *arrays):
    return [torch.from_numpy(np.array(a)).to(dev) for a in arrays]


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
    from xvc_tpu.ops import deblock as dbk
    rng = np.random.RandomState(sum(flags))
    for H, W in ((720, 1280), (1280, 720)):
        blocks = rng.randint(0, 256, (H // 8, W // 8))
        plane = (np.repeat(np.repeat(blocks, 8, 0), 8, 1) // 12 + 100 +
                 rng.randint(-2, 3, (H, W))).astype(np.int16)
        xs = np.arange(4, W, 4).astype(np.int32)
        qp = rng.randint(16, 52, (len(xs), H // 4))
        beta = np.asarray(dbk.BETA_TABLE, np.int32)[np.clip(qp, 0, 51)]
        tc = np.asarray(dbk.TC_TABLE, np.int32)[np.clip(qp + 2, 0, 53)]
        mask = (rng.rand(len(xs), H // 4) < 0.8).astype(np.int32)
        outs = []
        for fn in (deblock.luma_pass, deblock.luma_pass_plain):
            pl, *a = _to(cuda, plane, xs, mask, tc, beta)
            fn(pl, *a, 8, flags)
            outs.append(pl.cpu().numpy())
        assert (outs[0] != plane).any()
        np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("name,count", [("ai64x48", 3), ("ai64x48b10", 2),
                                        ("sp_fast", 6)])
def test_decode_matches_golden_on_card(cuda, name, count):
    kernels.reset_launches()
    pics = decode_stream(read_data(name + ".xvc"), device=cuda)
    assert len(pics) == count and all(p.conforming for p in pics)
    assert b"".join(p.bytes for p in pics) == read_data(name + "_dec.yuv")
    assert kernels.LAUNCHES["itx"] > 0 and kernels.LAUNCHES["deblock_luma"] > 0


def test_720p_decode_matches_host_on_card(cuda):
    from xvc_tpu.codec.decoder import Decoder
    from xvc_tpu.nal import split_nal_units
    data = read_data("bench/hd720_ld.xvc")
    dec = Decoder()
    host = []
    for nal in split_nal_units(data):
        dec.decode_nal(nal)
        while (pic := dec.get_decoded_picture()) is not None:
            host.append(pic)
    dec.flush()
    while (pic := dec.get_decoded_picture()) is not None:
        host.append(pic)
    kernels.reset_launches()
    pics = decode_stream(data, device=cuda)
    assert len(pics) == len(host) == 8
    assert all(p.conforming for p in pics)
    assert [p.bytes for p in pics] == [p.bytes for p in host]
    assert all(n > 0 for n in kernels.LAUNCHES.values())
