"""Bit depth 15 through the port on the CPU, tolerance 0.

A picture above 14 bit takes the Python parse and the replay path.  The
oracle is the stream's own checksums and the JAX package: its encoder's
reconstructions (the hash lists ``*b15*_dec.sha256``, recipe
``tests/encode_clips.py`` ``make_b15_stream``) and its default (host)
decode, which is held equal on every picture it decodes conforming.  That
decode raises on a DC-only block of the DCT-2 family above 14 bit, where
the shift of the DC-only inverse goes negative (ROADMAP queue 3 F5), and
reports the picture non-conforming; the encoder's native reconstruction
gives such a block a residual of 0, which the checksums record and the
port computes.

- ``ra64x48b15`` (bi-prediction, full-pel and sub-pel MC, DC-only
  blocks, transform skip, LM) and ``tiles64x128b15`` (2 CTU tile rows)
  decode to their hash lists, every picture conforming, on both
  arithmetic decoders, and ra64x48b15 with every intra block on the
  replay path's host tail; equal to the JAX package's host decode where it
  conforms, and everywhere once F5's block is given the encoder's
  residual; its ``XVC_DSP=jax`` decode equals its default decode;
- a segment header patched to 16 bit raises ``NotImplementedError``
  naming ROADMAP item 6;
- the plain versions of the picture kernels at 15 bit against the JAX
  package's host functions on seeded inputs: ``itx_picture_plain`` per
  block (DC-only blocks, 32x32 transform skip, DST-4, every family),
  the MC core of ``mc_picture_plain`` against the native MC of the JAX
  package's host path in every fractional case (full-pel bi-prediction
  included), ``make_add_avg``, ``mc_picture_plain`` against the JAX
  package's job path, both deblock passes, and the LM model of the
  chroma scan against ``derive_lm_params``.
"""
import ctypes
import hashlib
import types

import numpy as np
import pytest
import torch

from xvc_tpu import native as jnative
from xvc_tpu.codec import inter_mc as jmc
from xvc_tpu.ops import intra_pred as jip
from xvc_tpu.ops import quant as jq
from xvc_tpu.ops import transform as jtx
from xvc_tpu.restrictions import Restrictions as JaxRestrictions
from xvc_tpu_torch import bitio
from xvc_tpu_torch import constants as k
from xvc_tpu_torch import segment as port_segment
from xvc_tpu_torch.codec.decoder import decode_stream
from xvc_tpu_torch.gpu import dsp, flat_cases, intra_scan, itx, recon
from xvc_tpu_torch.gpu.records import (C_CBF0, C_COEFF0, C_DCONLY0, C_H,
                                       C_PRED, C_QP, C_SPLIT, C_TSKIP0,
                                       C_TT00, C_TT01, C_TT10, C_TT11, C_W,
                                       C_X, C_Y)
from xvc_tpu_torch.nal import split_nal_units, write_nal_units

from . import test_torch_deblock as tdb
from .encode_clips import jax_session_decode
from .test_torch_mc_picture import jax_mc, port_mc
from .util import read_data

B15 = ["ra64x48b15", "tiles64x128b15"]


def hash_list(name):
    with open("tests/data/%s_dec.sha256" % name) as f:
        return [line.split()[0] for line in f]


def sha(pics):
    return [hashlib.sha256(p.bytes).hexdigest() for p in pics]


def jax_decode_f5_repaired(data):
    """The JAX package's host decode with the residual of a DC-only block
    of the DCT-2 family above 14 bit set to the encoder's (0)."""
    real = jtx.inverse_transform_np

    def itx(coeff, tx_ver, tx_hor, bitdepth, high_precision,
            dc_only=False):
        if dc_only and bitdepth > 14 and tx_ver <= 1 and tx_hor <= 1:
            return np.zeros(coeff.shape, np.int32)
        return real(coeff, tx_ver, tx_hor, bitdepth, high_precision,
                    dc_only)

    jtx.inverse_transform_np = itx
    try:
        return jax_session_decode(data)
    finally:
        jtx.inverse_transform_np = real


@pytest.mark.parametrize("engine", ["native", "python"])
@pytest.mark.parametrize("name", B15)
def test_b15_decodes_to_its_hash_list(name, engine, monkeypatch):
    if engine == "python":
        monkeypatch.setenv("XVC_NATIVE", "0")
    pics = decode_stream(read_data(name + ".xvc"), device="cpu")
    assert [p.conforming for p in pics] == [True] * len(pics)
    assert sha(pics) == hash_list(name)


def test_b15_host_tail_decodes_to_its_hash_list(monkeypatch):
    """The replay path's sequential host tail at 15 bit: with the scans
    off every intra block (LM included) is predicted on the host."""
    monkeypatch.setattr(recon.Reconstructor, "_can_scan_intra",
                        lambda self: False)
    recon.LAST_TAIL_BLOCKS = -1
    pics = decode_stream(read_data("ra64x48b15.xvc"), device="cpu")
    assert all(p.conforming for p in pics)
    assert sha(pics) == hash_list("ra64x48b15")
    assert recon.LAST_TAIL_BLOCKS > 0


@pytest.mark.parametrize("name", B15)
def test_b15_equals_the_jax_host_decode(name):
    data = read_data(name + ".xvc")
    port = sha(decode_stream(data, device="cpu"))
    jax = jax_session_decode(data)
    assert len(jax) == len(port)
    for n, pic in enumerate(jax):
        if pic.conforming:
            assert sha([pic])[0] == port[n], n
    # F5: the JAX decode fails every picture with such a block; with the
    # encoder's residual it conforms and equals the port everywhere
    assert not all(p.conforming for p in jax)
    repaired = jax_decode_f5_repaired(data)
    assert all(p.conforming for p in repaired)
    assert sha(repaired) == port


def test_jax_device_route_equals_its_default(monkeypatch):
    """XVC_DSP=jax (JaxReconstructor) decodes ra64x48b15 as the JAX
    package's default decode does: the same pictures conform, with the
    same samples, and F5 fails the same three (each route leaves its own
    partial samples there)."""
    data = read_data("ra64x48b15.xvc")
    default = jax_session_decode(data)
    monkeypatch.setenv("XVC_DSP", "jax")
    device = jax_session_decode(data)
    assert [p.conforming for p in device] == \
        [p.conforming for p in default] == [True, False, False, False, True]
    assert sha(device[::4]) == sha(default[::4]) == \
        hash_list("ra64x48b15")[::4]


def test_the_encoder_gives_a_dc_only_block_a_zero_residual():
    """The JAX package's encoder reconstruction (native
    ``xvcn_recon_dist``, the DC-only kind) at 15 bit: residual 0, where
    its host decode's DC-only inverse raises."""
    lib = jnative.LIB
    levels = np.zeros((8, 8), np.int32)
    levels[0, 0] = 37
    pred = np.full((8, 8), 1000, np.int32)
    rec = np.zeros((8, 8), np.int32)
    resi = np.full(64, 99, np.int32)
    P = lambda a: a.ctypes.data  # noqa: E731
    lib.xvcn_recon_dist(P(levels), 8, 8, 181, 7, 1, None, None, 0, 0, 0,
                        0, 0, 14 - 15, P(pred), 8, P(pred), 8, P(rec), 8,
                        P(resi), 15, 0, 32, ctypes.c_double(0.0))
    assert not resi.any() and (rec == 1000).all()
    with pytest.raises(ValueError):
        jtx.inverse_transform_np(np.pad([[1000]], ((0, 7), (0, 7))),
                                 k.TransformType.DEFAULT,
                                 k.TransformType.DEFAULT, 15, True,
                                 dc_only=True)


def test_sixteen_bit_header_raises():
    """The segment header's 4-bit bit depth field (``xvc_tpu/segment.py``
    ``read_segment_header``) set to 16: the first picture raises."""
    nals = list(split_nal_units(read_data("ra64x48b15.xvc")))
    header = bytearray(nals[0])
    calls = []

    class Spy(bitio.BitReader):
        def read_bits(self, n):
            at = self.pos * 8 + 8 - self.bit_mask.bit_length()
            value = super().read_bits(n)
            calls.append((at, n, value))
            return value

    reader = Spy(bytes(header))
    port_segment.parse_nal_unit_header(reader)
    port_segment.read_segment_header(reader, 0)
    # the bit depth field: 4 bits holding 15 - 8, after the chroma format
    at = next(a for (a, n, v), (_, n0, _) in zip(calls[1:], calls)
              if n == 4 and n0 == 4 and v == 7)
    for i in range(4):
        bit = (8 >> i) & 1     # 16 - 8
        byte, mask = (at + 3 - i) // 8, 0x80 >> ((at + 3 - i) % 8)
        header[byte] = (header[byte] | mask) if bit else \
            (header[byte] & ~mask)
    data = write_nal_units([bytes(header)] + nals[1:])
    with pytest.raises(NotImplementedError, match="item 6"):
        decode_stream(data, device="cpu")


# ---------------------------------------------------------------------------
# The plain versions at 15 bit
# ---------------------------------------------------------------------------

def jax_host_itx(pic):
    """Every coded block of ``pic`` through the JAX package's host
    dequantization and inverse transforms, in planes."""
    r, arena = pic["records"], pic["coeff"]
    planes = [np.zeros((pic["height"], pic["width"]), np.int32)] + \
        [np.zeros((pic["Hc"], pic["Wc"]), np.int32) for _ in range(2)]
    kinds = set()
    bd = pic["bitdepth"]
    for row in r:
        if row[C_SPLIT]:
            continue
        qp = jq.Qp(int(row[C_QP]), k.ChromaFormat.YUV420, bd, 0.0, 0, 0, 0)
        for c in range(3):
            off = int(row[C_COEFF0 + c])
            if not row[C_CBF0 + c] or off < 0:
                continue
            s = 0 if c == 0 else 1
            w, h = int(row[C_W]) >> s, int(row[C_H]) >> s
            x, y = int(row[C_X]) >> s, int(row[C_Y]) >> s
            t0, t1 = (row[C_TT00], row[C_TT01]) if c == 0 else \
                (row[C_TT10], row[C_TT11])
            coeff = arena[off:off + w * h].astype(np.int16).astype(
                np.int32).reshape(h, w)
            dq = jq.dequant_np(coeff, c, qp, w, h, bd)
            if row[C_TSKIP0 + c]:
                kinds.add("skip%d" % w)
                resi = jtx.transform_skip_inverse_np(dq, bd)
            elif (c == 0 and row[C_PRED] == 0 and t0 == 0 and t1 == 0 and
                  w == 4 and h == 4):
                kinds.add("dst4")
                resi = jtx.inverse_transform_dst4_np(dq, bd, True)
            elif row[C_DCONLY0 + c] and t0 <= 1 and t1 <= 1:
                kinds.add("dc")
                with pytest.raises(ValueError):   # F5
                    jtx.inverse_transform_np(dq, t0, t1, bd, True, True)
                resi = np.zeros((h, w), np.int32)  # the encoder's
            else:
                kinds.add("gen")
                resi = jtx.inverse_transform_np(dq, t0, t1, bd, True)
            p = planes[c]
            ph, pw = p[y:y + h, x:x + w].shape
            p[y:y + ph, x:x + pw] = resi[:ph, :pw]
    return planes, kinds


@pytest.mark.parametrize("seed", [3, 4])
def test_itx_picture_plain_at_15_bit_matches_the_jax_host(seed):
    pic = flat_cases.b15_picture(seed)
    want, kinds = jax_host_itx(pic)
    assert {"dc", "dst4", "gen", "skip32"} <= kinds
    args = flat_cases.itx_args(pic, "cpu")
    itx.itx_picture_plain(*args)
    got = [args[0][0].numpy(), args[1][0].numpy(), args[1][1].numpy()]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _jax_ref(plane, pad):
    return types.SimpleNamespace(padded_plane=lambda comp: plane,
                                 pad_x=[pad] * 3, pad_y=[pad] * 3)


@pytest.mark.parametrize("short_out", [False, True])
@pytest.mark.parametrize("luma", [True, False])
def test_mc_core_at_15_bit_matches_the_jax_host(luma, short_out):
    """Each fractional case of ``dsp._mc_core_builder`` (the core of
    ``mc_picture_plain``) against ``inter_mc.mc_unipred_sample`` /
    ``mc_unipred_short`` of the JAX package (its native MC) on one
    seeded 15-bit plane; the full-pel bi-prediction intermediate is
    -8192 everywhere (``dsp.fullpel_short``)."""
    rng = np.random.RandomState(1 + luma + 2 * short_out)
    pad, size, bd = 16, 48, 15
    plane = rng.randint(0, 1 << bd, (size + 2 * pad, size + 2 * pad))
    plane = plane.astype(np.int32)
    ref = _jax_ref(plane, pad)
    taps = 8 if luma else 4
    half = taps // 2 - 1
    nphase = 16 if luma else 32
    restr = JaxRestrictions()
    w, h = 8, 4
    core = dsp._mc_core_builder(w, h, luma, bd, True, short_out)
    cases = [(0, 0), (5, 0), (0, 9), (7, 3), (nphase - 1, nphase - 1)]
    for fx, fy in cases:
        x0, y0 = rng.randint(0, size - w), rng.randint(0, size - h)
        ctx = jmc.McContext(ref, 0 if luma else 1, x0, y0, w, h, bd, restr)
        fn = jmc.mc_unipred_short if short_out else jmc.mc_unipred_sample
        want = fn(ctx, x0, y0, fx, fy)
        got = core(torch.from_numpy(plane[None].astype(np.int16)),
                   torch.tensor([0]), torch.tensor([pad + y0 - half]),
                   torch.tensor([pad + x0 - half]), torch.tensor([fx]),
                   torch.tensor([fy]))[0].numpy()
        np.testing.assert_array_equal(got, want)
        if short_out and fx == fy == 0:
            assert (got == -8192).all()


def test_add_avg_at_15_bit_matches_the_jax_host():
    rng = np.random.RandomState(5)
    l0 = rng.randint(-8192, 24576, (16, 16)).astype(np.int16)
    l1 = rng.randint(-8192, 24576, (16, 16)).astype(np.int16)
    l0[0, :4] = l1[0, :4] = -8192          # full-pel bi: both at -8192
    want = jmc.add_avg_bi(l0, l1, 15)
    got = dsp.make_add_avg(16, 16, 15)(torch.from_numpy(l0),
                                       torch.from_numpy(l1))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[0, :4].any()


def test_mc_picture_plain_at_15_bit_matches_the_jax_job_path():
    pic = flat_cases.synthetic_picture(2, bitdepth=15)
    for g, w in zip(port_mc(pic, 7), jax_mc(pic, 7)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("flags", tdb.FLAGS)
def test_deblock_luma_pass_at_15_bit(flags):
    tdb.test_luma_pass_matches_jax(flags, 15)


def test_deblock_chroma_pass_at_15_bit():
    tdb.test_chroma_pass_matches_jax(15)


@pytest.mark.parametrize("size", [(4, 4), (8, 4), (16, 16), (32, 8)])
def test_lm_model_at_15_bit_matches_the_jax_host(size):
    """The chroma scan's LM model from its neighbour sums at 15 bit, where
    the sums of squares pass 2^31, against ``derive_lm_params``."""
    w, h = size
    rng = np.random.RandomState(w * 7 + h)
    for trial in range(20):
        has_a, has_l = [(True, True), (True, False), (False, True)][
            trial % 3]
        base = rng.randint(0, 32768)
        spread = rng.randint(1, 32768 - base + 1)
        ref_a = rng.randint(base, base + spread, w)
        ref_l = rng.randint(base, base + spread, h)
        src_a = np.clip(ref_a // 2 + rng.randint(-300, 300, w), 0, 32767)
        src_l = np.clip(ref_l // 2 + rng.randint(-300, 300, h), 0, 32767)
        want = jip.derive_lm_params(w, h, has_a, has_l, src_a, src_l,
                                    ref_a, ref_l, 15)
        xs, ys = [], []
        if has_a:
            dx = max(1, w // h) if has_l else 1
            xs += list(ref_a[::dx])
            ys += list(src_a[::dx])
        if has_l:
            dy = max(1, h // w) if has_a else 1
            xs += list(ref_l[::dy])
            ys += list(src_l[::dy])
        X, Y = np.array(xs, np.int64), np.array(ys, np.int64)
        sums = [int(X.sum()), int(Y.sum()), int((X * X).sum()),
                int((X * Y).sum())]
        got = intra_scan.derive_lm(sums, len(xs), has_a, has_l, 15)
        assert tuple(got) == tuple(want), (trial, sums)
