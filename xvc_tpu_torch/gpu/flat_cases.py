"""Inputs of the picture kernels (``itx.itx_picture``, ``mc.mc_picture``),
shared by the CPU tests, the card tests and ``chip_smoke.py``.

A *picture* here is a dict of numpy arrays and ints: the record table
and the coefficient arena of one parsed picture, and what its ITX and MC
need besides (bit depth, chroma shifts, the segment's transform and MV
switches and qp offsets, the frame store's margins and shapes, the size
of each reference of each list).

- ``parse_pictures``: the pictures of a stream, parsed by the port's own
  decoder on the CPU with nothing reconstructed (the parse needs no
  samples), so a test gets real record tables in a fraction of a decode
  (of either path's pictures: 4:2:2 and 4:4:4, LIC and restricted
  toolsets too);
- ``synthetic_picture``: a record table and an arena from a numpy seed:
  quad and binary splits of 64x64 CTUs over a picture whose right and
  bottom CTUs stick out, intra and inter leaves, every transform variant
  and family pair, uni (L0 and L1) and bi leaves, MVs that clip, affine
  CUs with uneven subblocks and a uniform one, 4:2:0 or monochrome, one
  or two CU trees;
- ``b15_picture``: a synthetic picture at 15 bit with DC-only blocks
  and 32x32 transform skip, its levels of a real stream's size;
- ``damaged_rows``: record rows that each break one guard of the
  kernels, to be dropped;
- ``itx_args`` / ``mc_args``: a picture's wrapper arguments on a device,
  the frame store filled from a seed.
"""
import numpy as np
import torch

from .. import constants as k
from ..codec.yuv import PAD
from . import itx
from . import mc
from .flat_recon import padded_shape
from .records import (C_AFFINE, C_CBF0, C_COEFF0, C_DCONLY0, C_DIR, C_H,
                      C_MV, C_ORDER, C_PRED, C_QP, C_REF0, C_SPLIT, C_TREE,
                      C_TSKIP0, C_TT00, C_W, C_X, C_Y)

STRIDE = 72          # native/pic.py PARSE_REC_STRIDE
STORE_SLOTS = 4      # frame-store slots of mc_args


def _picture(records, coeff, bitdepth, width, height, mono=False,
             hp_tx=True, no_dst=False, hp_mv=True, chroma_subpel=True,
             qp_key=(0, 0, 0), ref_dims=None, nrefs=(0, 0), poc=0,
             pad=None, chroma_format=None):
    if chroma_format is None:
        chroma_format = k.ChromaFormat.MONOCHROME if mono else \
            k.ChromaFormat.YUV420
    sx = 0 if mono else k.chroma_shift_x(chroma_format)
    sy = 0 if mono else k.chroma_shift_y(chroma_format)
    # the picture's margins, as YuvPicture pads its planes
    pad = (PAD, PAD, PAD >> sx, PAD >> sy) if pad is None else tuple(pad)
    Hc, Wc = height >> sy, width >> sx
    ref_dims = np.zeros((2, mc.MAX_REFS, 2), np.int64) if ref_dims is None \
        else np.asarray(ref_dims, np.int64)
    r = records
    inter = bool(((r[:, C_SPLIT] == 0) & (r[:, C_TREE] == 0) &
                  (r[:, C_PRED] == 1)).any())
    return dict(records=np.ascontiguousarray(records, np.int32),
                coeff=np.ascontiguousarray(coeff, np.int32),
                bitdepth=bitdepth, mono=mono, width=width, height=height,
                chroma_format=int(chroma_format),
                Hc=Hc, Wc=Wc, sx=sx, sy=sy, hp_tx=hp_tx, no_dst=no_dst,
                hp_mv=hp_mv, chroma_subpel=chroma_subpel,
                qp_key=tuple(qp_key), pad=pad,
                luma_store=padded_shape(height + 2 * pad[1],
                                        width + 2 * pad[0]),
                chroma_store=padded_shape(Hc + 2 * pad[3], Wc + 2 * pad[2]),
                ref_dims=ref_dims, nrefs=tuple(nrefs), inter=inter, poc=poc)


# ---------------------------------------------------------------------------
# Real record tables
# ---------------------------------------------------------------------------

def parse_pictures(data, pictures):
    """Parse the stream ``data`` with the port's decoder on the CPU and
    return ``{n: picture}`` for the pictures of decode-order index n in
    ``pictures``.  Nothing is reconstructed or deblocked, so the
    pictures come out non-conforming; the parse itself (records, arena,
    MVs) is the decode's."""
    from ..codec import decoder
    from . import flat_recon, recon
    got, count = {}, [0]

    def capture(self):
        n = count[0]
        count[0] += 1
        if n in pictures:
            pd, rec, restr, seg = self.pd, self.rec, self.restr, self.segment
            dims = np.zeros((2, mc.MAX_REFS, 2), np.int64)
            nrefs = [0, 0]
            if pd.ref_pic_lists is not None and not pd.is_intra_pic():
                for lst in range(2):
                    nrefs[lst] = min(pd.ref_pic_lists.get_num_ref_pics(lst),
                                     mc.MAX_REFS)
                    for i in range(nrefs[lst]):
                        ref = pd.ref_pic_lists.entries[lst][i].rec_pic
                        dims[lst, i] = (ref.width[0], ref.height[0])
            got[n] = _picture(
                pd._parse_records.copy(), pd._parse_coeff.copy(),
                pd.bitdepth, pd.width, pd.height, self.mono, self.hp_tx,
                restr.disable_ext2_transform_dst, self.hp_mv,
                not restr.disable_inter_chroma_subpel,
                (seg.chroma_qp_offset_table, seg.chroma_qp_offset_u,
                 seg.chroma_qp_offset_v), dims, nrefs, pd.poc,
                (rec.pad_x[0], rec.pad_y[0], rec.pad_x[1], rec.pad_y[1]),
                pd.chroma_format)
        self.pd.deblock = False   # nothing to deblock
        return None

    classes = (flat_recon.FlatReconstructor, recon.Reconstructor)
    runs = [cls.run for cls in classes]
    for cls in classes:
        cls.run = capture
    try:
        dec = decoder.Decoder("cpu")
        from ..nal import split_nal_units
        for nal in split_nal_units(data):
            dec.decode_nal(nal)
            while dec.get_decoded_picture() is not None:
                pass
            if count[0] > max(pictures):
                break
    finally:
        for cls, run in zip(classes, runs):
            cls.run = run
    missing = sorted(set(pictures) - set(got))
    if missing:
        raise ValueError("the stream has no pictures %r" % (missing,))
    return got


# ---------------------------------------------------------------------------
# Synthetic record tables
# ---------------------------------------------------------------------------

def _split(rng, x, y, w, h, depth, out, width, height):
    """Random quad / binary splits down to 4 (at least 8 for an inter
    leaf's own size class); appends (x, y, w, h, split) rows, a node
    before its children.  Nodes whose origin is outside the picture are
    left out, as the parse leaves them out."""
    if x >= width or y >= height:
        return
    kinds = []
    if w == h and w > 4:
        kinds.append("quad")
    if h > 4:
        kinds.append("hor")
    if w > 4:
        kinds.append("ver")
    split = w > 64 or (kinds and rng.rand() < (0.7 if w > 16 else 0.5))
    out.append((x, y, w, h, int(bool(split))))
    if not split:
        return
    kind = "quad" if w > 64 else kinds[rng.randint(len(kinds))]
    if kind == "quad":
        kids = [(x, y), (x + w // 2, y), (x, y + h // 2),
                (x + w // 2, y + h // 2)]
        size = (w // 2, h // 2)
    elif kind == "hor":
        kids, size = [(x, y), (x, y + h // 2)], (w, h // 2)
    else:
        kids, size = [(x, y), (x + w // 2, y)], (w // 2, h)
    for cx, cy in kids:
        _split(rng, cx, cy, *size, depth + 1, out, width, height)


def _tree(rng, width, height):
    nodes = []
    for y in range(0, height, 64):
        for x in range(0, width, 64):
            _split(rng, x, y, 64, 64, 0, nodes, width, height)
    return nodes


def synthetic_picture(seed, width=136, height=72, bitdepth=8, mono=False,
                      dual=False, hp_mv=True, chroma_subpel=True,
                      no_dst=False, hp_tx=True, nrefs=(2, 2)):
    """A picture of random leaves (see the module note).  ``dual``: the
    chroma blocks come from a second CU tree (an intra picture's)."""
    rng = np.random.RandomState(seed)
    ncomp = 1 if mono else 3
    rows, arena, n_coeff = [], [], 0
    trees = [(0, _tree(rng, width, height))]
    if dual:
        trees.append((1, _tree(rng, width, height)))
    sx = sy = 0 if mono else 1
    qp_lo = -6 * (bitdepth - 8)
    for tree, nodes in trees:
        for x, y, w, h, split in nodes:
            r = np.zeros(STRIDE, np.int64)
            r[C_TREE], r[C_X], r[C_Y], r[C_W], r[C_H] = tree, x, y, w, h
            r[C_SPLIT] = split
            r[C_COEFF0:C_COEFF0 + 3] = -1
            r[C_ORDER] = -1 if split else len(rows)
            rows.append(r)
            if split:
                continue
            inter = tree == 0 and not dual and rng.rand() < 0.7 and \
                min(w, h) >= 8
            r[C_PRED] = int(inter)
            r[C_QP] = rng.randint(qp_lo, 52)
            r[C_TT00:C_TT00 + 4] = rng.randint(0, 6, 4)
            if rng.rand() < 0.3:
                r[C_TT00:C_TT00 + 4] = 0   # DEFAULT: DST-4 for intra 4x4
            comps = [0] if tree == 0 and dual else \
                ([1, 2] if tree == 1 else range(ncomp))
            for c in comps:
                cw, ch = (w, h) if c == 0 else (w >> sx, h >> sy)
                if rng.rand() < 0.25 or min(cw, ch) < 2:
                    continue
                r[C_CBF0 + c] = 1
                r[C_TSKIP0 + c] = int(rng.rand() < 0.12)
                r[C_COEFF0 + c] = n_coeff
                cf = rng.randint(-40000, 40000, cw * ch)  # wraps to int16
                cf[rng.rand(cw * ch) < 0.6] = 0
                if rng.rand() < 0.2:
                    cf[1:] = 0                           # DC only
                arena.append(cf)
                n_coeff += cw * ch
            if not inter:
                continue
            d = rng.randint(3)
            r[C_DIR] = d
            for lst in (0, 1):
                r[C_REF0 + lst] = rng.randint(max(nrefs[lst], 1))
                for corner in range(3):
                    mv = rng.randint(-3000, 3000, 2)
                    if rng.rand() < 0.1:
                        mv = rng.randint(-60000, 60000, 2)   # clips
                    if rng.rand() < 0.2:
                        mv &= ~15                            # full pel
                    r[C_MV + 8 * lst + 2 * corner:][:2] = mv
            if min(w, h) >= 16 and rng.rand() < 0.25:
                r[C_AFFINE] = 1
                for lst in (0, 1):
                    base = C_MV + 8 * lst
                    mv0 = r[base:base + 2].copy()
                    # small corner differences: subblocks of 4 to 16
                    r[base + 2:base + 4] = mv0 + rng.randint(-40, 41, 2)
                    r[base + 4:base + 6] = mv0 + rng.randint(-40, 41, 2)
                    if rng.rand() < 0.2:
                        r[base + 2:base + 4] = mv0          # uniform
    records = np.stack(rows).astype(np.int32)
    coeff = np.concatenate(arena) if arena else np.zeros(0, np.int64)
    dims = np.zeros((2, mc.MAX_REFS, 2), np.int64)
    for lst in (0, 1):
        for i in range(nrefs[lst]):
            dims[lst, i] = (width, height)
    return _picture(records, coeff.astype(np.int32), bitdepth, width, height,
                    mono, hp_tx, no_dst, hp_mv, chroma_subpel,
                    (0, 0, 0), dims, nrefs)


def b15_picture(seed):
    """A synthetic 15-bit picture (``synthetic_picture`` at 160x96) with
    levels of a real stream's size (1-199, whose dequantized values the
    host takes exactly; the full int16 range of ``synthetic_picture``
    tests the wraps), the parse's DC-only flag on every block whose only
    nonzero level is its first, and every coded 32x32 luma block in
    transform skip."""
    pic = synthetic_picture(seed, width=160, height=96, bitdepth=15)
    rng = np.random.RandomState(seed)
    arena = pic["coeff"]
    small = rng.randint(1, 200, arena.shape) * rng.choice([-1, 1],
                                                          arena.shape)
    arena[:] = np.where(arena != 0, small, 0)
    for row in pic["records"]:
        if row[C_SPLIT]:
            continue
        # the codec gives blocks with a side below 4 the DCT-2 only
        if min(row[C_W], row[C_H]) < 8:
            row[C_TT00 + 2:C_TT00 + 4] = 0
        if row[C_W] == 32 and row[C_H] == 32 and row[C_CBF0]:
            row[C_TSKIP0] = 1
        for c in range(3):
            off = row[C_COEFF0 + c]
            if not row[C_CBF0 + c] or off < 0:
                continue
            s = 0 if c == 0 else 1
            block = arena[off:off + (row[C_W] >> s) * (row[C_H] >> s)]
            row[C_DCONLY0 + c] = int(block[0] != 0 and
                                     np.count_nonzero(block) == 1)
    return pic


def damaged_rows(pic, kind):
    """Copies of the picture's leaf rows of ``kind`` ("itx": coded
    blocks, "mc": inter leaves), each with one field broken so that the
    kernels must drop every job of the row: an origin outside the plane,
    a side that is no power of two or too large, coefficients past the
    arena (itx), a qp outside the table (itx), a reference index outside
    0..4 or past its list (mc)."""
    r = pic["records"].astype(np.int64)
    leaf = r[:, C_SPLIT] == 0
    if kind == "itx":
        src = r[leaf & (r[:, C_CBF0:C_CBF0 + 3] != 0).any(1)]
    else:
        src = r[leaf & (r[:, C_TREE] == 0) & (r[:, C_PRED] == 1)]
    src = src[:4]
    broken = []
    W, H, n = pic["width"], pic["height"], len(pic["coeff"])
    edits = [(C_X, -8), (C_X, W + 16), (C_Y, -2), (C_Y, H), (C_W, 3),
             (C_W, 256), (C_H, 0), (C_H, -8)]
    if kind == "itx":
        edits += [(C_COEFF0, n - 1), (C_COEFF0 + 1, n - 1),
                  (C_COEFF0 + 2, n - 1), (C_QP, 500), (C_QP, -100)]
    else:
        edits += [(C_REF0, 5), (C_REF0, -1), (C_REF0 + 1, 7),
                  (C_REF0, pic["nrefs"][0]), (C_REF0 + 1, pic["nrefs"][1])]
    for row in src:
        for col, val in edits:
            b = row.copy()
            if kind == "itx" and col >= C_COEFF0:
                # every coded component past the arena
                b[C_COEFF0:C_COEFF0 + 3] = np.where(
                    b[C_COEFF0:C_COEFF0 + 3] >= 0, val, -1)
            elif kind == "mc" and col in (C_REF0, C_REF0 + 1):
                b[C_DIR] = col - C_REF0   # L0 / L1: the list read
                b[col] = val
            else:
                b[col] = val
            broken.append(b)
    return np.stack(broken).astype(np.int32)


# ---------------------------------------------------------------------------
# Wrapper arguments on a device
# ---------------------------------------------------------------------------

def itx_args(pic, device, records=None):
    """(resi_l, resi_c, records, coeff, qp_scales, bitdepth, hp_tx,
    no_dst, sx, sy) of ``itx.itx_picture``; residual planes zeroed."""
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    zeros = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
    fmt = k.ChromaFormat(pic["chroma_format"])
    return (zeros(1, pic["height"], pic["width"]),
            None if pic["mono"] else zeros(2, pic["Hc"], pic["Wc"]),
            T(pic["records"] if records is None else records),
            T(pic["coeff"]),
            T(itx.qp_scale_table(fmt, pic["bitdepth"], *pic["qp_key"])),
            pic["bitdepth"], pic["hp_tx"], pic["no_dst"], pic["sx"],
            pic["sy"])


def store(pic, seed):
    """Frame-store stacks of ``STORE_SLOTS`` slots from a seed: luma (S,
    Hp, Wp), chroma (2S, Hpc, Wpc) int16 samples of the bit depth (None
    for monochrome)."""
    rng = np.random.RandomState(seed)
    top = 1 << pic["bitdepth"]
    luma = rng.randint(0, top, (STORE_SLOTS,) + pic["luma_store"])
    chroma = None if pic["mono"] else rng.randint(
        0, top, (2 * STORE_SLOTS,) + pic["chroma_store"])
    return luma.astype(np.int16), \
        None if chroma is None else chroma.astype(np.int16)


def ref_table(pic):
    """int32 (2, 5, 3) reference table: slots (lst * 5 + i) % S for the
    list's entries, -1 past them, and the references' luma sizes."""
    refs = np.full((2, mc.MAX_REFS, 3), -1, np.int32)
    for lst in (0, 1):
        for i in range(mc.MAX_REFS):
            refs[lst, i, 1:] = pic["ref_dims"][lst, i]
            if i < pic["nrefs"][lst]:
                refs[lst, i, 0] = (lst * mc.MAX_REFS + i) % STORE_SLOTS
    return refs


def mc_flags(pic):
    return mc.McFlags(pic["bitdepth"], pic["hp_mv"], pic["chroma_subpel"],
                      pic["sx"], pic["sy"], tuple(pic["pad"]), pic["width"],
                      pic["height"])


def mc_args(pic, device, seed, records=None):
    """(pred_l, mask_l, pred_c, mask_c, records, refs, luma_stack,
    chroma_stack, flags) of ``mc.mc_picture``: planes zeroed, the store
    from ``store(pic, seed)``."""
    T = lambda a: None if a is None else \
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
    zeros = lambda *s: torch.zeros(s, dtype=torch.int16, device=device)
    H, W, Hc, Wc = pic["height"], pic["width"], pic["Hc"], pic["Wc"]
    luma, chroma = store(pic, seed)
    mono = pic["mono"]
    return (zeros(2, H, W), zeros(1, H, W),
            None if mono else zeros(4, Hc, Wc),
            None if mono else zeros(2, Hc, Wc),
            T(pic["records"] if records is None else records),
            T(ref_table(pic)), T(luma), T(chroma), mc_flags(pic))
