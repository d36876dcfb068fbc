"""Dequant + inverse transform of a whole picture in the PyTorch port
(``xvc_tpu_torch/gpu/itx.py`` ``itx_picture``; on the CPU its plain
version, the same job derivation the CUDA kernel makes) against the JAX
package on the CPU backend, tolerance 0.

The reference side: the jobs that ``xvc_tpu/tpu/flat_recon.py``
``_build_itx_groups`` builds from the same records and arena, run through
its ``make_itx_scatter_gen`` / ``make_itx_scatter``.

- real record tables (``gpu/flat_cases.parse_pictures``): hd720_ld
  pictures 0 (intra, two CU trees) and 3 (inter, the stream's affine CU),
  one inter picture of fhd1080_ra and of qhd1440_ra10 (10 bit);
- synthetic tables from a numpy seed (``flat_cases.synthetic_picture``):
  every variant (gen with every family pair, DC-only, DST-4, transform
  skip), coefficients that wrap to int16, 4:2:0 and monochrome, two CU
  trees, 10 bit, DST-4 and high precision off;
- damaged rows (``flat_cases.damaged_rows``) are dropped: with them
  appended the residual planes stay as they were.
"""
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xvc_tpu.ops.quant import Qp as JaxQp
from xvc_tpu.tpu import flat_recon as jfr
from xvc_tpu_torch import constants as k
from xvc_tpu_torch.gpu import flat_cases, itx
from xvc_tpu_torch.gpu.records import C_ORDER, C_SPLIT

from .util import read_data

REAL = [("hd720_ld", 0), ("hd720_ld", 3), ("fhd1080_ra", 3),
        ("qhd1440_ra10", 1)]
# (4:2:0 at 8 bit with one CU tree is the real pictures')
SYNTHETIC = {
    "mono, no dst, low precision": dict(seed=8, mono=True, no_dst=True,
                                        hp_tx=False),
    "dual tree 10 bit": dict(seed=8, dual=True, bitdepth=10),
}


@functools.lru_cache(maxsize=None)
def real_picture(name, n):
    return flat_cases.parse_pictures(read_data("bench/%s.xvc" % name),
                                     {n})[n]


def jax_reconstructor(pic):
    """The JAX package's FlatReconstructor over a picture of flat_cases:
    only what its job derivation reads, and its reference table stubbed with
    ``flat_cases.ref_table``'s slots."""
    fr = jfr.FlatReconstructor.__new__(jfr.FlatReconstructor)
    sx, sy, p = pic["sx"], pic["sy"], pic["pad"]
    fr.pd = types.SimpleNamespace(
        _parse_coeff=pic["coeff"], chroma_shift_x=sx, chroma_shift_y=sy,
        chroma_format=k.ChromaFormat.MONOCHROME if pic["mono"]
        else k.ChromaFormat.YUV420, bitdepth=pic["bitdepth"],
        width=pic["width"], height=pic["height"])
    fr.rec = types.SimpleNamespace(shift_x=[0, sx, sx], shift_y=[0, sy, sy],
                                   pad_x=[p[0], p[2], p[2]],
                                   pad_y=[p[1], p[3], p[3]])
    fr.restr = types.SimpleNamespace(
        disable_ext2_transform_dst=pic["no_dst"],
        disable_inter_chroma_subpel=not pic["chroma_subpel"])
    table, off_u, off_v = pic["qp_key"]
    fr.segment = types.SimpleNamespace(chroma_qp_offset_table=table,
                                       chroma_qp_offset_u=off_u,
                                       chroma_qp_offset_v=off_v)
    fr.bitdepth, fr.hp_tx, fr.hp_mv = pic["bitdepth"], pic["hp_tx"], \
        pic["hp_mv"]
    fr.mono = pic["mono"]
    refs = flat_cases.ref_table(pic)
    fr._ref_tables = lambda: (np.maximum(refs[:, :, 0], 0), refs[:, :, 1],
                              refs[:, :, 2])
    return fr


def leaves(records):
    """The leaves in decode order, as the JAX run hands them over."""
    lv = records[records[:, C_SPLIT] == 0]
    return lv[np.argsort(lv[:, C_ORDER], kind="stable")]


def jax_itx(pic):
    fr = jax_reconstructor(pic)
    H, W, Hc, Wc = pic["height"], pic["width"], pic["Hc"], pic["Wc"]
    resi = {False: jnp.zeros((1, H, W), jnp.int32),
            True: None if pic["mono"] else jnp.zeros((2, Hc, Wc), jnp.int32)}
    for (w, h, txv, txh, var, chroma), cf, scales, params in \
            fr._build_itx_groups(leaves(pic["records"])):
        B = cf.shape[0]
        dims = (2, Hc, Wc) if chroma else (1, H, W)
        if var == 0:
            fn = jfr.make_itx_scatter_gen(w, h, pic["bitdepth"],
                                          pic["hp_tx"], B, *dims)
        else:
            fn = jfr.make_itx_scatter(w, h, pic["bitdepth"], txv, txh,
                                      jfr._VAR_NAMES[var], pic["hp_tx"], B,
                                      *dims)
        flat32 = np.concatenate([scales, params.reshape(-1)])
        resi[chroma] = fn(resi[chroma], jnp.asarray(cf.reshape(-1)), 0,
                          jnp.asarray(flat32), 0, B)
    return [np.asarray(r) for r in resi.values() if r is not None]


def port_itx(pic, records=None):
    args = flat_cases.itx_args(pic, "cpu", records)
    itx.itx_picture(*args)
    return [r.numpy() for r in args[:2] if r is not None]


def _assert_planes(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name,n", REAL)
def test_itx_picture_matches_jax_on_real_records(name, n):
    pic = real_picture(name, n)
    got = port_itx(pic)
    _assert_planes(got, jax_itx(pic))
    assert all(np.any(g) for g in got), "no residual"


@pytest.mark.parametrize("case", sorted(SYNTHETIC))
def test_itx_picture_matches_jax_on_synthetic_records(case):
    pic = flat_cases.synthetic_picture(**SYNTHETIC[case])
    jobs = itx.itx_jobs(torch.from_numpy(pic["records"]), len(pic["coeff"]),
                        torch.from_numpy(itx.qp_scale_table(
                            k.ChromaFormat.MONOCHROME if pic["mono"] else
                            k.ChromaFormat.YUV420, pic["bitdepth"],
                            *pic["qp_key"])),
                        pic["bitdepth"], pic["no_dst"], pic["sx"], pic["sy"],
                        [(pic["height"], pic["width"])] +
                        ([] if pic["mono"] else [(pic["Hc"], pic["Wc"])]))
    # the case holds what it claims: gen, skip and (unless off) DST-4
    variants = set(torch.cat([j["var"] for j in jobs]).tolist())
    assert variants == ({0, 3} if pic["no_dst"] else {0, 1, 3})
    _assert_planes(port_itx(pic), jax_itx(pic))


@pytest.mark.parametrize("source", ["synthetic", "hd720_ld picture 3"])
def test_itx_picture_drops_damaged_rows(source):
    pic = flat_cases.synthetic_picture(5) if source == "synthetic" else \
        real_picture("hd720_ld", 3)
    bad = flat_cases.damaged_rows(pic, "itx")
    assert len(bad) >= 40
    want = port_itx(pic)
    _assert_planes(port_itx(pic, np.concatenate([pic["records"], bad])),
                   want)
    assert not any(np.any(g) for g in port_itx(pic, bad))


@pytest.mark.parametrize("bitdepth", [8, 10])
def test_qp_scale_table_matches_the_jax_qp(bitdepth):
    fmt = k.ChromaFormat.YUV420
    table = itx.qp_scale_table(fmt, bitdepth, 1, 3, -2)
    for i in range(0, itx.QP_COUNT, 7):
        qp = JaxQp(itx.QP_MIN + i, fmt, bitdepth, 0.0, 1, 3, -2)
        assert list(table[:, i]) == [qp.get_inv_scale(c) for c in range(3)]


def test_itx_picture_refuses_what_the_kernel_does_not_take():
    pic = flat_cases.synthetic_picture(0)
    args = list(flat_cases.itx_args(pic, "cpu"))
    bad = [(0, args[0].to(torch.int16)), (2, args[2][:, :60]),
           (4, args[4][:2]), (3, args[3].to(torch.int64)),
           (1, args[1][:1])]
    for i, value in bad:
        a = list(args)
        a[i] = value.contiguous()
        with pytest.raises(ValueError):
            itx.itx_picture(*a)
