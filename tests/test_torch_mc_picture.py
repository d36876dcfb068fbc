"""Motion compensation of a whole picture in the PyTorch port
(``xvc_tpu_torch/gpu/mc.py`` ``mc_picture``; on the CPU its plain
version, the same job derivation the CUDA kernel makes, affine expansion
included) against the JAX package on the CPU backend, tolerance 0.

The reference side: the jobs that ``xvc_tpu/tpu/flat_recon.py``
``_build_mc_groups`` (with its row emitters and affine expansion) builds
from the same records, run through its ``make_mc_scatter`` on the same
frame-store contents (random samples from a seed; its ``_ref_tables`` is
stubbed with the same slot table).

- real record tables (``gpu/flat_cases.parse_pictures``): hd720_ld
  picture 3 (bi leaves and the stream's one affine CU), an inter picture
  of fhd1080_ra (two references a list) and of qhd1440_ra10 (10 bit);
- synthetic tables from a numpy seed: L0, L1 and bi leaves, MVs that
  clip, full-pel and every phase, affine CUs with uneven subblocks and
  uniform ones, monochrome, 10 bit with low-precision MVs and chroma
  sub-pel off, three references in L0;
- damaged rows are dropped.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xvc_tpu.tpu import flat_recon as jfr
from xvc_tpu_torch.gpu import flat_cases, mc
from xvc_tpu_torch.gpu.records import C_AFFINE, C_DIR, C_PRED, C_SPLIT

from .test_torch_itx_picture import jax_reconstructor, leaves, real_picture

REAL = [("hd720_ld", 3), ("fhd1080_ra", 3), ("qhd1440_ra10", 1)]
SYNTHETIC = {
    "420": dict(seed=2),
    "mono": dict(seed=8, mono=True),
    "10 bit, low-precision MVs, no chroma sub-pel": dict(
        seed=8, bitdepth=10, hp_mv=False, chroma_subpel=False,
        nrefs=(3, 1)),
}


def jax_mc(pic, seed):
    fr = jax_reconstructor(pic)
    H, W, Hc, Wc = pic["height"], pic["width"], pic["Hc"], pic["Wc"]
    luma, chroma = flat_cases.store(pic, seed)
    planes = {True: jnp.asarray(luma),
              False: None if chroma is None else jnp.asarray(chroma)}
    out = {True: [jnp.zeros((2, H, W), jnp.int16),
                  jnp.zeros((1, H, W), jnp.int16)],
           False: None if pic["mono"] else
           [jnp.zeros((4, Hc, Wc), jnp.int16),
            jnp.zeros((2, Hc, Wc), jnp.int16)]}
    groups, _ = fr._build_mc_groups(leaves(pic["records"]))
    for (wb, hb, luma_, short), params in groups:
        fn = jfr.make_mc_scatter(wb, hb, luma_, pic["bitdepth"],
                                 pic["hp_mv"], short, params.shape[1],
                                 H if luma_ else Hc, W if luma_ else Wc,
                                 1 if luma_ else 2)
        out[luma_] = list(fn(*out[luma_], planes[luma_],
                             jnp.asarray(params.reshape(-1)), 0))
    return [np.asarray(x) for v in out.values() if v is not None for x in v]


def port_mc(pic, seed, records=None):
    args = flat_cases.mc_args(pic, "cpu", seed, records)
    mc.mc_picture(*args)
    return [x.numpy() for x in args[:4] if x is not None]


def _assert_planes(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _inter(pic):
    r = pic["records"]
    return r[(r[:, C_SPLIT] == 0) & (r[:, C_PRED] == 1)]


@pytest.mark.parametrize("name,n", REAL)
def test_mc_picture_matches_jax_on_real_records(name, n):
    pic = real_picture(name, n)
    got = port_mc(pic, n)
    _assert_planes(got, jax_mc(pic, n))
    assert np.any(got[0]) and np.any(got[1]), "no bi prediction"
    if name == "hd720_ld":
        assert (_inter(pic)[:, C_AFFINE] != 0).sum() == 1


@pytest.mark.parametrize("case", sorted(SYNTHETIC))
def test_mc_picture_matches_jax_on_synthetic_records(case):
    pic = flat_cases.synthetic_picture(**SYNTHETIC[case])
    inter = _inter(pic)
    # the case holds what it claims: L0, L1 and bi leaves, affine CUs
    assert set(inter[:, C_DIR].tolist()) == {0, 1, 2}
    assert (inter[:, C_AFFINE] != 0).sum() >= 1
    _assert_planes(port_mc(pic, 7), jax_mc(pic, 7))


def test_affine_cu_expands_into_uneven_subblocks():
    """The affine CU of hd720_ld picture 3 and those of a synthetic
    picture: their jobs (``mc.mc_jobs``) are subblocks of more than one
    size across the CUs, all inside their CU."""
    sizes = set()
    for pic in (real_picture("hd720_ld", 3), flat_cases.synthetic_picture(0),
                flat_cases.synthetic_picture(2)):
        aff = _inter(pic)
        aff = aff[aff[:, C_AFFINE] != 0]
        rows = mc.mc_jobs(torch.from_numpy(aff),
                          torch.from_numpy(flat_cases.ref_table(pic)),
                          flat_cases.STORE_SLOTS,
                          [(pic["height"], pic["width"]),
                           (pic["Hc"], pic["Wc"])], flat_cases.mc_flags(pic))
        luma = rows[:, rows[0] == 1]
        sizes |= set(map(tuple, luma[10:12].T.tolist()))
    assert len(sizes) >= 3, sizes


@pytest.mark.parametrize("source", ["synthetic", "hd720_ld picture 3"])
def test_mc_picture_drops_damaged_rows(source):
    pic = flat_cases.synthetic_picture(5) if source == "synthetic" else \
        real_picture("hd720_ld", 3)
    bad = flat_cases.damaged_rows(pic, "mc")
    assert len(bad) >= 40
    want = port_mc(pic, 3)
    _assert_planes(port_mc(pic, 3, np.concatenate([pic["records"], bad])),
                   want)
    assert not any(np.any(g) for g in port_mc(pic, 3, bad))


def test_mc_picture_refuses_what_the_kernel_does_not_take():
    pic = flat_cases.synthetic_picture(0)
    args = list(flat_cases.mc_args(pic, "cpu", 0))
    bad = [(0, args[0][:1]), (1, args[1].to(torch.int32)),
           (4, args[4][:, :60]), (5, args[5][:1]),
           (7, args[7][:3]), (6, args[6].to(torch.int32))]
    for i, value in bad:
        a = list(args)
        a[i] = value.contiguous()
        with pytest.raises(ValueError):
            mc.mc_picture(*a)
