"""The port's replay reconstruction path (``xvc_tpu_torch/gpu/recon.py``
``Reconstructor``) against the JAX package on the CPU, tolerance 0 (every
stage is integer).

The pictures the flat path refuses (LIC on, chroma 4:2:2 / 4:4:4, a
restricted intra toolset) decode through the port's CU-tree replay, the
picture kernels' plain versions, the intra scans where the JAX rules
allow them, and the host tail; the JAX side is its own recon path
(``XVC_DSP=jax``, ``xvc_tpu/tpu/recon.py`` ``JaxReconstructor``) or its
host decode.

- every golden of tests/data with a ``_dec.yuv`` (but ``scal16to24``)
  decodes byte-identical to it, every picture conforming, with the JAX
  package's picture count; ``scal16to24`` (spliced, with rescaled
  cross-segment references) equals the JAX package's host decode;
- ``itx_picture_plain`` on the replay's record table equals the residual
  planes of ``JaxReconstructor._gather_itx``, and ``mc_picture_plain``
  (the store holding the JAX recon path's reference planes) its
  ``_gather_mc`` prediction planes on every non-LIC inter leaf, on every
  picture the JAX recon path reconstructs of ra64x48, cf_c422, cf_c444,
  cf_mono, rm1_64x48 to rm4_64x48, and the port's own 4:2:2 and 4:4:4
  streams with inter pictures, c422_ra64x48 and c444_ra64x48 (which also
  equal the JAX package's host decode, as their hash lists do);
- the replayed CU tree equals the JAX package's field for field (ra64x48,
  cf_c444, c444_ra64x48);
- on LIC pictures, where neither package scans, the tail's block count
  ``recon.LAST_TAIL_BLOCKS`` equals the JAX package's;
- a 4:2:2 picture decodes to the same bytes with the luma scan and with
  everything on the host tail (the JAX package's quarter-area rule is
  not copied);
- the full-width bench stream hd720_lic (recipe: ``make_hd720_lic``) has
  LIC and non-LIC inter leaves in every inter picture.
"""
import functools
import hashlib
import os

import numpy as np
import pytest
import torch

from xvc_tpu_torch.codec.decoder import decode_stream
from xvc_tpu_torch.gpu import flat_cases, intra_scan, itx, mc, recon
from xvc_tpu_torch.gpu.records import C_LIC, C_PRED, C_SPLIT, C_TREE
from xvc_tpu_torch.native import pic as port_native_pic

from .util import DATA, read_data

GOLDENS = sorted(n[:-len("_dec.yuv")] for n in os.listdir(DATA)
                 if n.endswith("_dec.yuv"))
SPLICE = "scal16to24"
# the port's own 4:2:2 / 4:4:4 streams with inter pictures (LIC, bi),
# which no reference golden has (recipe: make_chroma_ra)
CHROMA_INTER = ["c422_ra64x48", "c444_ra64x48"]
KERNEL_STREAMS = ["ra64x48", "cf_c422", "cf_c444", "cf_mono", "rm1_64x48",
                  "rm2_64x48", "rm3_64x48", "rm4_64x48"] + CHROMA_INTER


def jax_host_decode(data):
    """The JAX package's host decode, drained with the blocking pull."""
    from xvc_tpu.codec.decoder import Decoder
    from xvc_tpu.nal import split_nal_units
    dec = Decoder()
    pics = []
    for nal in split_nal_units(data):
        dec.decode_nal(nal)
        while (pic := dec.get_decoded_picture()) is not None:
            pics.append(pic)
    dec.flush()
    while (pic := dec.get_decoded_picture()) is not None:
        pics.append(pic)
    return pics


def test_every_golden_with_a_decode_is_listed():
    assert len(GOLDENS) == 33 and SPLICE in GOLDENS


@pytest.mark.parametrize("name", [n for n in GOLDENS if n != SPLICE])
def test_golden_decodes_through_the_port(name):
    data = read_data(name + ".xvc")
    pics = decode_stream(data, device="cpu")
    assert len(pics) == len(jax_host_decode(data))
    assert all(p.conforming for p in pics), "checksum mismatch"
    assert b"".join(p.bytes for p in pics) == read_data(name + "_dec.yuv")


def test_scalability_splice_equals_the_jax_host_decode():
    data = read_data(SPLICE + ".xvc")
    want = jax_host_decode(data)
    got = decode_stream(data, device="cpu")
    assert len(got) == len(want)
    assert all(p.conforming for p in got)
    for a, b in zip(want, got):
        assert a.bytes == b.bytes, "poc %d" % a.poc


@pytest.mark.parametrize("name", CHROMA_INTER)
def test_chroma_inter_stream_equals_the_jax_host_decode(name):
    data = read_data(name + ".xvc")
    want = jax_host_decode(data)
    got = decode_stream(data, device="cpu")
    assert len(got) == len(want) == 5
    assert all(p.conforming for p in got)
    assert [p.bytes for p in got] == [p.bytes for p in want]
    # the hash list chip_smoke.py and the card tests hold the card to
    with open(os.path.join(DATA, name + "_dec.sha256")) as f:
        assert [line.split()[0] for line in f if line.strip()] == \
            [hashlib.sha256(p.bytes).hexdigest() for p in want]


# ---------------------------------------------------------------------------
# The JAX recon path, captured picture by picture
# ---------------------------------------------------------------------------

def _jax_recon_capture(name):
    """Decode ``name`` with the JAX package's recon path and capture, per
    picture it reconstructs (decode order): its decode index, records,
    residual planes (``_gather_itx``), prediction planes after
    ``_gather_mc``, the non-LIC inter blocks (``_inter_recs``), the
    reference planes MC read per (list, index), whether LIC was on, and
    ``LAST_TAIL_BLOCKS``."""
    from xvc_tpu.native import pic as jax_native_pic
    from xvc_tpu.tpu import recon as jrecon
    JR = jrecon.JaxReconstructor
    out, count = [], [0]
    mp = pytest.MonkeyPatch()
    mp.setenv("XVC_DSP", "jax")
    orig_parse = jax_native_pic.parse_picture

    def parse(*a, **kw):
        count[0] += 1
        return orig_parse(*a, **kw)

    orig_itx, orig_mc, orig_run = JR._gather_itx, JR._gather_mc, \
        JR.reconstruct_picture

    def gather_itx(self, launched):
        resi = orig_itx(self, launched)
        self._cap_resi = [r.copy() for r in resi if r is not None]
        return resi

    def gather_mc(self, launched):
        orig_mc(self, launched)
        self._cap_pred = {key: p.copy()
                          for key, p in self._pred_planes.items()}

    def run(self):
        orig_run(self)
        rpl = self.pic.ref_pic_lists
        refs = {}
        for lst in (0, 1):
            for i in range(rpl.get_num_ref_pics(lst)):
                ref = rpl.get_ref_pic(lst, i)
                planes = {}
                for comp in range(self.pic.max_num_components):
                    ent = self._planes.get((id(ref), comp))
                    if ent is not None:
                        shape, idx = ent
                        planes[comp] = np.asarray(self._stacks[shape][idx])
                refs[lst, i] = planes
        out.append(dict(
            index=count[0] - 1, poc=self.pic.poc,
            records=self.pic._parse_records.copy(),
            resi=self._cap_resi, pred=getattr(self, "_cap_pred", {}),
            inter=[(cu.pos(c), cu.size(c), c, kind)
                   for cu, c, kind in self._inter_recs],
            refs=refs, lic=bool(self.pic.lic_active),
            tail=jrecon.LAST_TAIL_BLOCKS))

    mp.setattr(jax_native_pic, "parse_picture", parse)
    mp.setattr(JR, "_gather_itx", gather_itx)
    mp.setattr(JR, "_gather_mc", gather_mc)
    mp.setattr(JR, "reconstruct_picture", run)
    try:
        pics = jax_host_decode(read_data(name + ".xvc"))
    finally:
        mp.undo()
    assert all(p.conforming for p in pics)
    return out


@functools.lru_cache(maxsize=None)
def jax_recon(name):
    return _jax_recon_capture(name)


@functools.lru_cache(maxsize=None)
def port_pictures(name, indices):
    return flat_cases.parse_pictures(read_data(name + ".xvc"), set(indices))


def _pairs(name):
    caps = jax_recon(name)
    assert caps, "the JAX recon path reconstructed no picture of " + name
    pics = port_pictures(name, tuple(c["index"] for c in caps))
    for cap in caps:
        pic = pics[cap["index"]]
        assert pic["poc"] == cap["poc"]
        np.testing.assert_array_equal(pic["records"], cap["records"])
        yield pic, cap


def _mc_args_from(pic, cap):
    """``mc.mc_picture`` arguments whose frame store holds the reference
    planes the JAX recon path read, one slot per (list, index)."""
    keys = sorted(cap["refs"])
    S = max(len(keys), 1)
    luma = np.zeros((S,) + pic["luma_store"], np.int16)
    chroma = None if pic["mono"] else \
        np.zeros((2 * S,) + pic["chroma_store"], np.int16)
    refs = np.full((2, mc.MAX_REFS, 3), -1, np.int32)
    refs[:, :, 1:] = pic["ref_dims"]
    for slot, key in enumerate(keys):
        planes = cap["refs"][key]
        if not planes:
            continue
        for comp, plane in planes.items():
            dst = luma[slot] if comp == 0 else chroma[2 * slot + comp - 1]
            h = min(dst.shape[0], plane.shape[0])
            w = min(dst.shape[1], plane.shape[1])
            dst[:h, :w] = plane[:h, :w]
        refs[key[0], key[1], 0] = slot
    args = list(flat_cases.mc_args(pic, "cpu", 0))
    args[5] = torch.from_numpy(refs)
    args[6] = torch.from_numpy(luma)
    args[7] = None if chroma is None else torch.from_numpy(chroma)
    return args


@pytest.mark.parametrize("name", KERNEL_STREAMS)
def test_picture_kernels_equal_the_jax_recon_path(name):
    n_inter = 0
    for pic, cap in _pairs(name):
        a = flat_cases.itx_args(pic, "cpu")
        itx.itx_picture_plain(*a)
        got = [a[0][0]] + ([] if a[1] is None else [a[1][0], a[1][1]])
        assert len(got) == len(cap["resi"])
        for comp, (g, w) in enumerate(zip(got, cap["resi"])):
            np.testing.assert_array_equal(g.numpy(), w, "comp %d" % comp)
        if not cap["inter"]:
            continue
        b = _mc_args_from(pic, cap)
        mc.mc_picture_plain(*b)
        pred_l, pred_c = b[0].numpy(), None if b[2] is None else b[2].numpy()
        for (cx, cy), (w, h), comp, kind in cap["inter"]:
            for dslot in ((0, 1) if kind == "bi" else (0,)):
                want = cap["pred"][dslot, comp][cy:cy + h, cx:cx + w]
                got = pred_l[dslot] if comp == 0 else \
                    pred_c[2 * dslot + comp - 1]
                np.testing.assert_array_equal(
                    got[cy:cy + h, cx:cx + w], want,
                    "poc %d comp %d at %d,%d slot %d" % (
                        cap["poc"], comp, cx, cy, dslot))
            n_inter += 1
    if name in ["ra64x48"] + CHROMA_INTER:
        assert n_inter, "no inter block compared"


# ---------------------------------------------------------------------------
# The replay, the tail count and the scan rule
# ---------------------------------------------------------------------------

_FIELDS = ("cu_tree", "depth", "pos_x", "pos_y", "width", "height",
           "split", "pred_mode", "intra_mode_luma", "intra_mode_chroma",
           "inter_dir", "use_affine", "use_lic", "mv", "ref_idx", "cbf")


def _tree_rows(pd):
    rows = []

    def walk(cu):
        rows.append(tuple(
            [int(getattr(cu, f)) for f in _FIELDS[:13]] +
            [[list(map(tuple, lst)) for lst in cu.mv], list(cu.ref_idx),
             [bool(b) for b in cu.cbf]]))
        for sub in cu.sub_cus:
            if sub is not None:
                walk(sub)
    for tree in range(pd.num_cu_trees):
        for rsaddr in range(pd.ctu_num_x * pd.ctu_num_y):
            walk(pd.get_ctu(tree, rsaddr))
    return rows


def _replayed_trees(module, mp):
    """The CU tree of every picture ``module.parse_picture`` replays."""
    trees = []
    orig = module.parse_picture

    def parse(pic_decoder, *a, **kw):
        ok = orig(pic_decoder, *a, **kw)
        if kw.get("replay"):
            trees.append(_tree_rows(pic_decoder.pic_data))
        return ok
    mp.setattr(module, "parse_picture", parse)
    return trees


@pytest.mark.parametrize("name", ["ra64x48", "cf_c444", "c444_ra64x48"])
def test_replayed_tree_equals_the_jax_package_s(name):
    from xvc_tpu.native import pic as jax_native_pic
    mp = pytest.MonkeyPatch()
    try:
        mine = _replayed_trees(port_native_pic, mp)
        decode_stream(read_data(name + ".xvc"), device="cpu")
        mp.setenv("XVC_DSP", "jax")
        theirs = _replayed_trees(jax_native_pic, mp)
        jax_host_decode(read_data(name + ".xvc"))
    finally:
        mp.undo()
    assert mine and len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert a == b


def _port_tails(name):
    """(poc, LIC on, LAST_TAIL_BLOCKS) of every picture of ``name`` the
    port's replay path reconstructs, and the decoded bytes."""
    out = []
    orig = recon.Reconstructor.run

    def run(self):
        res = orig(self)
        out.append((self.pd.poc, bool(self.pd.lic_active),
                    recon.LAST_TAIL_BLOCKS))
        return res
    mp = pytest.MonkeyPatch()
    mp.setattr(recon.Reconstructor, "run", run)
    try:
        pics = decode_stream(read_data(name + ".xvc"), device="cpu")
    finally:
        mp.undo()
    assert all(p.conforming for p in pics)
    return out, b"".join(p.bytes for p in pics)


@pytest.mark.parametrize("name", ["ld64x48", "ra64x48"] + CHROMA_INTER)
def test_tail_block_count_equals_the_jax_package_s_on_lic_pictures(name):
    mine, _ = _port_tails(name)
    theirs = [(c["poc"], c["lic"], c["tail"]) for c in jax_recon(name)]
    lic = [t for t in mine if t[1]]
    assert lic and lic == [t for t in theirs if t[1]]
    assert any(t[2] > 0 for t in lic)


def test_4_2_2_scan_and_host_tail_give_equal_bytes():
    calls = []
    orig = intra_scan.intra_scan

    def counted(*a):
        calls.append(1)
        return orig(*a)
    mp = pytest.MonkeyPatch()
    mp.setattr(intra_scan, "intra_scan", counted)
    try:
        scanned, with_scan = _port_tails("cf_c422")
    finally:
        mp.undo()
    assert calls, "the luma scan never ran"
    mp.setattr(recon.Reconstructor, "_can_scan_intra", lambda self: False)
    try:
        hosted, host_only = _port_tails("cf_c422")
    finally:
        mp.undo()
    assert sum(t[2] for t in hosted) > sum(t[2] for t in scanned)
    assert with_scan == host_only == read_data("cf_c422_dec.yuv")


# ---------------------------------------------------------------------------
# The full-width LIC bench stream
# ---------------------------------------------------------------------------

def make_hd720_lic(path):
    """Write tests/data/bench/hd720_lic.xvc's recipe to ``path`` (about
    two to three minutes on one CPU core): bench.gen_yuv's 1280x720 clip of
    8 pictures, +6*t added to the luma of picture t on its left half (x <
    640, clipped to 0..255), encoded by the JAX package's encode_stream at
    qp 32, random access with sub_gop_length 4 and num_ref_pics 2, the
    default speed mode (1) and checksum_mode 1.  The hash list beside it
    is the JAX package's host decode of it."""
    import tempfile

    import bench
    from xvc_tpu.codec.encoder import encode_stream
    from xvc_tpu.nal import write_nal_units
    W, H, N = 1280, 720, 8
    with tempfile.TemporaryDirectory() as tmp:
        yuv = os.path.join(tmp, "hd720_8.yuv")
        bench.gen_yuv(yuv, W, H, N)
        raw = bytearray(open(yuv, "rb").read())
    fs = W * H * 3 // 2
    for t in range(N):
        y = np.frombuffer(bytes(raw[t * fs:t * fs + W * H]),
                          np.uint8).reshape(H, W).astype(np.int32)
        y[:, :W // 2] += 6 * t
        raw[t * fs:t * fs + W * H] = np.clip(y, 0, 255).astype(
            np.uint8).tobytes()
    nals = encode_stream(bytes(raw), W, H, N, qp=32, sub_gop_length=4,
                         num_ref_pics=2, speed_mode=1, checksum_mode=1)
    with open(path, "wb") as f:
        f.write(write_nal_units(nals))


def test_hd720_lic_has_lic_and_plain_inter_leaves_in_every_inter_picture():
    pics = flat_cases.parse_pictures(read_data("bench/hd720_lic.xvc"),
                                     set(range(8)))
    assert sorted(p["poc"] for p in pics.values()) == list(range(8))
    for n, pic in sorted(pics.items()):
        r = pic["records"]
        inter = (r[:, C_SPLIT] == 0) & (r[:, C_TREE] == 0) & \
            (r[:, C_PRED] == 1)
        lic = inter & (r[:, C_LIC] != 0)
        if n == 0:
            assert not inter.any()   # intra: the flat path
            continue
        assert lic.any() and (inter & ~lic).any(), "picture %d" % n


def make_chroma_ra(path, chroma_format):
    """Write the recipe of tests/data/c422_ra64x48.xvc (chroma_format 2)
    and c444_ra64x48.xvc (3) to ``path``: inter pictures in 4:2:2 and
    4:4:4, which no reference golden has.  Five 64x48 pictures of a
    textured gradient that moves by (3, 2) samples a picture, with +8*t
    added to the luma of picture t on its left half (so that LIC is
    chosen for some leaves), encoded by the JAX package's EncoderSession
    at qp 32, random access with sub_gop_length 4 and num_ref_pics 2, the
    default speed mode and checksum_mode 1.  The hash list beside it is
    the JAX package's host decode of it."""
    from xvc_tpu import api
    W, H, N = 64, 48, 5
    rng = np.random.RandomState(7)
    tex = rng.randint(0, 256, (H + 32, W + 32))
    yy, xx = np.mgrid[0:H + 32, 0:W + 32]
    base = (0.5 * tex + 0.5 * ((xx * 4 + yy * 3) % 256)).astype(np.int32)
    cw = W if chroma_format == 3 else W // 2
    raw = b""
    for t in range(N):
        y = base[2 * t:2 * t + H, 3 * t:3 * t + W].copy()
        y[:, :W // 2] += 8 * t
        u = 128 + (base[2 * t:2 * t + H, 3 * t:3 * t + cw] - 128) // 4
        v = 128 - (base[2 * t:2 * t + H, 3 * t:3 * t + cw] - 128) // 4
        raw += b"".join(np.clip(p, 0, 255).astype(np.uint8).tobytes()
                        for p in (y, u, v))
    fs = len(raw) // N
    enc = api.EncoderSession(api.EncoderParameters(
        width=W, height=H, qp=32, checksum_mode=1,
        chroma_format=chroma_format, sub_gop_length=4, num_ref_pics=2))
    nals = []
    for i in range(N):
        nals += enc.encode(raw[i * fs:(i + 1) * fs])
    nals += enc.flush()
    with open(path, "wb") as f:
        f.write(b"".join(len(n).to_bytes(4, "little") + n for n in nals))
