"""Flat, record-driven picture reconstruction on a torch device.

Port of ``xvc_tpu/tpu/flat_recon.py``.  The native CABAC parse emits a
flat record table and a coefficient arena; every job of the picture is
derived from them with vectorized numpy, uploaded once, and run on the
device in this order:

  1. dequant + inverse transform, scattered into residual planes
     (``gpu/itx.py``, kernel 2);
  2. sub-pel MC from the frame store, scattered into prediction planes
     (``gpu/mc.py``, kernel 1);
  3. uni/bi combine + residual + clip (``combine``, plain PyTorch);
  4. the intra luma scan, then the chroma scan with LM
     (``gpu/intra_scan.py``, kernels 5 and 6: one launch each);
  5. deblock (``gpu/deblock.py``: edge decisions, luma walk and chroma
     pass, three kernels);
  6. a frame-store write and one download.

Reference pictures live in a per-device ``FrameStore`` (int16 (S, Hp,
Wp) luma and (S, 2, Hp, Wp) chroma), written in place with ``copy_``
(the JAX version's donated ``_store_set3``/``_store_set4``).  The padded
geometry is the JAX version's (``_padded_shape``), so MC window clamping
matches.  A picture's slots hang on ``rec_pic._torch_slots``, never on
the JAX package's ``_dev_slots``.

The numpy job builders (``_build_itx_groups``, ``_build_mc_groups``,
``_emit_mc_rows``, ``_emit_affine_rows``, ``_affine_plain``,
``_affine_subblocks``, ``_build_intra_meta``, ``_qp_scales``) are copies
of the JAX module's, as is the intra-toolset test of
``xvc_tpu/codec/intra_search.py``: this package imports nothing of
``xvc_tpu``.
"""
import weakref

import numpy as np
import torch

from .. import constants as k
from ..codec import inter_mc as mc
from ..codec import inter_mv as mv_mod
from ..ops.quant import Qp
from ..profiling import span
from ..restrictions import Restrictions
from . import dsp
from . import intra_scan
from . import itx
from . import mc as mc_kernel

# ---------------------------------------------------------------------------
# Parse-record column layout (must match xvcn_pic.inc xvcn_export_parse)
# ---------------------------------------------------------------------------
C_TREE, C_DEPTH, C_X, C_Y, C_W, C_H, C_SPLIT = range(7)
C_PRED, C_QP, C_SKIP, C_MERGE, C_MERGEIDX, C_DIR, C_FULLPEL, C_AFFINE, \
    C_LIC, C_ROOTCBF = 11, 12, 13, 14, 15, 16, 17, 18, 19, 20
C_CBF0, C_TSKIP0, C_DCONLY0 = 21, 24, 27
C_TT00, C_TT01, C_TT10, C_TT11, C_TXSEL = 30, 31, 32, 33, 34
C_REF0, C_REF1, C_IML, C_IMC = 35, 36, 39, 40
C_MV = 41            # [list][corner][x/y]: 41 + 8*l + 2*c (+1 for y)
C_COEFF0 = 65
C_SBL, C_SAR, C_ORDER = 68, 69, 70

_BIG = 1 << 20       # out-of-bounds scatter target (dropped)


# ---------------------------------------------------------------------------
# Device-resident frame store
# ---------------------------------------------------------------------------

class FrameStore:
    """Per-geometry device store: int16 superstacks (S, Hp, Wp) for luma
    and (S, 2, Hp, Wp) for chroma.  Slots are assigned per decoded
    picture and written in place; MC reads windows straight from the
    superstack (chroma reshaped (S*2, Hp, Wp))."""

    def __init__(self, luma_shape, chroma_shape, device, n0=8):
        self.luma_shape = luma_shape
        self.chroma_shape = chroma_shape  # None for monochrome
        self.device = device
        self.n = 0
        self.free = []
        self.luma = None
        self.chroma = None
        self._grow(n0)

    def _grow(self, new_n):
        old_n = self.n
        luma = torch.zeros((new_n,) + self.luma_shape, dtype=torch.int16,
                           device=self.device)
        if old_n:
            luma[:old_n].copy_(self.luma)
        self.luma = luma
        if self.chroma_shape is not None:
            ch = torch.zeros((new_n, 2) + self.chroma_shape,
                             dtype=torch.int16, device=self.device)
            if old_n:
                ch[:old_n].copy_(self.chroma)
            self.chroma = ch
        self.free.extend(range(old_n, new_n))
        self.n = new_n

    def put(self, dev_planes):
        """dev_planes: {comp: (Hp, Wp) device plane}.  Returns the slot."""
        if not self.free:
            self._grow(self.n * 2)
        slot = self.free.pop()
        self.luma[slot].copy_(dev_planes[0])
        if self.chroma_shape is not None and 1 in dev_planes:
            self.chroma[slot, 0].copy_(dev_planes[1])
            self.chroma[slot, 1].copy_(dev_planes[2])
        return slot

    def release(self, slot):
        if slot not in self.free:
            self.free.append(slot)


_STORES = {}


def _padded_shape(rec_pic, comp):
    """Same geometry as the JAX frame store (tile-aligned margins), so
    that MC window clamping is identical."""
    h, w = rec_pic._plane_shapes[comp]
    return (-(-(h + 64) // 8) * 8, -(-(w + 64) // 128) * 128)


def get_store(rec_pic, device):
    ls = _padded_shape(rec_pic, 0)
    cs = _padded_shape(rec_pic, 1) \
        if rec_pic.chroma_format != k.ChromaFormat.MONOCHROME else None
    key = (ls, cs, str(device))
    st = _STORES.get(key)
    if st is None:
        st = FrameStore(ls, cs, device)
        _STORES[key] = st
    return st


def _slot_map(rec_pic):
    slots = getattr(rec_pic, "_torch_slots", None)
    if slots is None:
        slots = {}
        rec_pic._torch_slots = slots
    return slots


def release_slot(rec_pic):
    """Free the picture's store slots (its buffer is being recycled)."""
    slots = getattr(rec_pic, "_torch_slots", None)
    if slots:
        for store, slot, fin in slots.values():
            fin.detach()
            store.release(slot)
        slots.clear()


def _register(rec_pic, store, slot):
    # a finalizer frees the slot when the picture object dies, so
    # sessions that end without recycling their buffers leak no slots
    fin = weakref.finalize(rec_pic, store.release, slot)
    _slot_map(rec_pic)[str(store.device)] = (store, slot, fin)
    return slot


def frame_store_put(rec_pic, dev_planes, device):
    """Register a picture's final padded device planes in the store."""
    release_slot(rec_pic)
    store = get_store(rec_pic, device)
    return _register(rec_pic, store, store.put(dev_planes))


def ensure_slot(rec_pic, device):
    """Slot of a reference picture; a picture never written by this
    package (decoded elsewhere) uploads its host padded planes once."""
    ent = _slot_map(rec_pic).get(str(device))
    if ent is not None:
        return ent[1]
    ncomp = 1 if rec_pic.chroma_format == k.ChromaFormat.MONOCHROME else 3
    planes = {}
    for comp in range(ncomp):
        base = rec_pic.padded_plane(comp).astype(np.int16)
        th, tw = _padded_shape(rec_pic, comp)
        host = np.pad(base, ((0, th - base.shape[0]),
                             (0, tw - base.shape[1])), mode="edge")
        planes[comp] = torch.from_numpy(host).to(device)
        dsp.STATS["uploads"] += 1
        dsp.STATS["upload_bytes"] += host.nbytes
    store = get_store(rec_pic, device)
    return _register(rec_pic, store, store.put(planes))


def device_pad_planes(rec, planes_dev):
    """Edge-replicate padding on device: visible plane -> padded plane
    plus the aligned right/bottom margin for bucketed MC windows (the
    device pad_border, ref: yuv_pic.cc PadBorder)."""
    out = {}
    for comp, pl in planes_dev.items():
        px, py = rec.pad_x[comp], rec.pad_y[comp]
        th, tw = _padded_shape(rec, comp)
        h, w = pl.shape
        dev = pl.device
        rows = (torch.arange(th, device=dev) - py).clamp(0, h - 1)
        cols = (torch.arange(tw, device=dev) - px).clamp(0, w - 1)
        out[comp] = pl[rows][:, cols]
    return out


# ---------------------------------------------------------------------------
# Eligibility
# ---------------------------------------------------------------------------

_INTRA_TOOL_FLAGS = (
    "disable_intra_ref_padding", "disable_intra_ref_sample_filter",
    "disable_intra_dc_post_filter", "disable_intra_ver_hor_post_filter",
    "disable_intra_planar", "disable_ext2_intra_67_modes",
    "disable_ext2_intra_6_predictors",
    "disable_ext_intra_unrestricted_predictor")


def _intra_restrictions_default(restr):
    """The device intra stages implement the default (unrestricted)
    intra toolset only."""
    default = Restrictions()
    return all(getattr(restr, f) == getattr(default, f)
               for f in _INTRA_TOOL_FLAGS)


def ineligible_reason(pd, restr):
    """Why the flat path cannot decode this picture, or None.  Covers
    the default (unrestricted) toolset on 4:2:0 / monochrome; the
    reasons match ``xvc_tpu.tpu.flat_recon.eligible``."""
    if pd.lic_active:
        return "LIC (local illumination compensation) is on"
    if pd.bitdepth > 14:
        return "bitdepth %d > 14" % pd.bitdepth
    if restr.disable_ext2_intra_67_modes:
        return "restrictions: 67 intra modes disabled"
    if not _intra_restrictions_default(restr):
        return "restrictions: non-default intra toolset"
    if pd.chroma_format == k.ChromaFormat.MONOCHROME:
        return None
    if pd.chroma_format != k.ChromaFormat.YUV420:
        return "chroma format %s (4:2:0 and monochrome only)" % \
            k.ChromaFormat(pd.chroma_format).name
    if restr.disable_intra_chroma_predictor or \
            restr.disable_ext2_intra_chroma_from_luma:
        return "restrictions: chroma intra predictor or LM disabled"
    return None


def eligible(pd, restr):
    return ineligible_reason(pd, restr) is None


# ---------------------------------------------------------------------------
# Combine
# ---------------------------------------------------------------------------

def combine(pred, mask, resi, H, W, ph, pw, bitdepth):
    """Inter reconstruction: per pixel select uni (slot-0 prediction is
    final samples) or bi (both slots are 14-bit intermediates -> AddAvg,
    ref: inter_prediction.cc AddAvg), add the residual, clip, and place
    into the zero-padded scan canvas.  Returns (canvas int16, residual
    canvas int32), leading dim nplanes (1 luma / 2 chroma)."""
    nplanes = resi.shape[0]
    max_val = (1 << bitdepth) - 1
    pt = intra_scan.PAD_TL
    p0 = pred[:nplanes].to(torch.int32)
    avg = dsp.make_add_avg(W, H, bitdepth)(p0, pred[nplanes:])
    base = torch.where(mask > 0, avg, p0)
    dev = pred.device
    canvas = torch.zeros((nplanes, ph, pw), dtype=torch.int16, device=dev)
    canvas[:, pt:pt + H, pt:pt + W] = (base + resi).clamp(0, max_val)
    rcanvas = torch.zeros((nplanes, ph, pw), dtype=torch.int32, device=dev)
    rcanvas[:, pt:pt + H, pt:pt + W] = resi
    return canvas, rcanvas


# ---------------------------------------------------------------------------
# Reconstruction
# ---------------------------------------------------------------------------

def _pad_canvas_dims(h, w):
    ph = -(-(h + intra_scan.PAD_TL + intra_scan.PAD_BR) // 128) * 128
    pw = -(-(w + intra_scan.PAD_TL + intra_scan.PAD_BR) // 128) * 128
    return ph, pw


_VAR_NAMES = {0: "gen", 1: "dst4", 2: "dc", 3: "skip"}


class FlatReconstructor:
    def __init__(self, pic_decoder, segment, device):
        self.pd = pic_decoder.pic_data
        self.rec = pic_decoder.rec_pic
        self.restr = segment.restrictions
        self.segment = segment
        self.device = device
        self.bitdepth = self.pd.bitdepth
        self.hp_tx = not self.restr.disable_ext2_transform_high_precision
        self.hp_mv = not self.restr.disable_ext2_inter_high_precision_mv
        self.mono = self.pd.chroma_format == k.ChromaFormat.MONOCHROME

    # ------------------------------------------------------------------
    def run(self):
        """Device reconstruction of the parsed picture.  Without deblock
        it stores the picture and fills the host rec planes (one
        download) and returns None; with deblock it returns the visible
        device planes {comp: (H, W) int16} for ``deblock_picture``."""
        pd = self.pd
        dev = self.device
        rec_arr = pd._parse_records
        leaves = rec_arr[rec_arr[:, C_SPLIT] == 0]
        # pool-slot order is allocation order; the scans need decode
        # (z-)order, exported by the native derive walk (r[70])
        leaves = leaves[np.argsort(leaves[:, C_ORDER], kind="stable")]
        H, W = pd.height, pd.width
        Hc, Wc = self.rec.height[1], self.rec.width[1]
        ph, pw = _pad_canvas_dims(H, W)
        phc, pwc = _pad_canvas_dims(Hc, Wc) if not self.mono else (0, 0)

        with span("flat.build"):
            itx_groups = self._build_itx_groups(leaves)
            mc_groups, have_inter = self._build_mc_groups(leaves)
            lmeta, cmeta = self._build_intra_meta(leaves)
            batch = dsp.DevBatch()
            itx_prep = [(key, batch.add(c), batch.add(s), batch.add(p))
                        for key, c, s, p in itx_groups]
            mc_prep = [(key, batch.add(p)) for key, p in mc_groups]
            # the scan metadata rides in the picture's one upload
            if lmeta is not None:
                h_lmeta = batch.add(lmeta)
            if cmeta is not None:
                h_cmeta = batch.add(cmeta)
        with span("flat.upload"):
            batch.upload(dev)

        with span("flat.dispatch"):
            zeros = lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev)
            resi_l = zeros((1, H, W), torch.int32)
            resi_c = zeros((2, Hc, Wc), torch.int32) if not self.mono else None
            for (wc, hc, txv, txh, var, is_chroma), hc_, hs_, hp_ in itx_prep:
                args = (resi_c if is_chroma else resi_l, batch.get(hc_),
                        batch.get(hs_), batch.get(hp_))
                dsp.STATS["dispatches"] += 1
                if var == 0:
                    itx.itx_scatter_gen(*args, wc, hc, self.bitdepth,
                                        self.hp_tx)
                else:
                    itx.itx_scatter(*args, wc, hc, self.bitdepth, txv, txh,
                                    _VAR_NAMES[var], self.hp_tx)

            # prediction planes + bi coverage masks; channel layout
            # chan = dslot * nplanes + plane (slot-0 planes first)
            pred_l = zeros((2, H, W), torch.int16)
            mask_l = zeros((1, H, W), torch.int16)
            if not self.mono:
                pred_c = zeros((4, Hc, Wc), torch.int16)
                mask_c = zeros((2, Hc, Wc), torch.int16)
            if have_inter:
                store = get_store(self.rec, dev)
                luma_stack = store.luma
                chroma_stack = None if self.mono else \
                    store.chroma.view((-1,) + store.chroma_shape)
                for (wb, hb, luma, short), hp_ in mc_prep:
                    dsp.STATS["dispatches"] += 1
                    if luma:
                        mc_kernel.mc_scatter(pred_l, mask_l, luma_stack,
                                             batch.get(hp_), wb, hb, True,
                                             self.bitdepth, self.hp_mv, short)
                    else:
                        mc_kernel.mc_scatter(pred_c, mask_c, chroma_stack,
                                             batch.get(hp_), wb, hb, False,
                                             self.bitdepth, self.hp_mv, short)

            plane_l, rpad_l = combine(pred_l, mask_l, resi_l, H, W, ph, pw,
                                      self.bitdepth)
            plane_l, rpad_l = plane_l[0], rpad_l[0]
            if not self.mono:
                plane_c, rpad_c = combine(pred_c, mask_c, resi_c, Hc, Wc, phc,
                                          pwc, self.bitdepth)

        # intra scans (decode order; read and write the canvases)
        if lmeta is not None:
            with span("flat.intra_scan"):
                intra_scan.intra_scan(plane_l, rpad_l, batch.get(h_lmeta),
                                      self.bitdepth)
        if cmeta is not None:
            with span("flat.chroma_scan"):
                intra_scan.intra_chroma_scan(plane_c, rpad_c, plane_l,
                                             batch.get(h_cmeta),
                                             self.bitdepth)

        # visible device planes
        pt = intra_scan.PAD_TL
        planes_dev = {0: plane_l[pt:pt + H, pt:pt + W].contiguous()}
        if not self.mono:
            planes_dev[1] = plane_c[0, pt:pt + Hc, pt:pt + Wc].contiguous()
            planes_dev[2] = plane_c[1, pt:pt + Hc, pt:pt + Wc].contiguous()
        if pd.deblock:
            return planes_dev
        store_and_download(self.rec, planes_dev, dev)
        return None

    # ------------------------------------------------------------------
    def _qp_scales(self, qp_raw, comp):
        """Vectorized Qp.get_inv_scale over per-leaf raw qps."""
        cache = self._qp_cache if hasattr(self, "_qp_cache") else {}
        self._qp_cache = cache
        uq = np.unique(qp_raw)
        out = np.empty(qp_raw.shape, np.int64)
        for q in uq:
            key = (int(q), comp)
            if key not in cache:
                qo = Qp(int(q), self.pd.chroma_format, self.bitdepth, 0.0,
                        self.segment.chroma_qp_offset_table,
                        self.segment.chroma_qp_offset_u,
                        self.segment.chroma_qp_offset_v)
                cache[key] = qo.get_inv_scale(comp)
            out[qp_raw == q] = cache[key]
        return out

    def _build_itx_groups(self, leaves):
        """Group coded blocks by (w, h, variant, chroma) and gather their
        coefficients from the flat arena."""
        pd = self.pd
        coeff = pd._parse_coeff
        DEFAULT = int(k.TransformType.DEFAULT)
        DCT2 = int(k.TransformType.DCT2)
        no_dst = self.restr.disable_ext2_transform_dst
        sx, sy = pd.chroma_shift_x, pd.chroma_shift_y
        groups = []
        ncomp = 1 if self.mono else 3
        for comp in range(ncomp):
            sel = leaves[(leaves[:, C_CBF0 + comp] != 0) &
                         (leaves[:, C_COEFF0 + comp] >= 0)]
            if not len(sel):
                continue
            if comp == 0:
                cx, cy = sel[:, C_X], sel[:, C_Y]
                w, h = sel[:, C_W], sel[:, C_H]
                t0, t1 = sel[:, C_TT00], sel[:, C_TT01]
            else:
                cx, cy = sel[:, C_X] >> sx, sel[:, C_Y] >> sy
                w, h = sel[:, C_W] >> sx, sel[:, C_H] >> sy
                t0, t1 = sel[:, C_TT10], sel[:, C_TT11]
            scale = self._qp_scales(sel[:, C_QP], comp)
            wl2 = np.int64(np.log2(w))
            hl2 = np.int64(np.log2(h))
            bias = ((wl2 + 1 + hl2 + 1) % 2) != 0
            scale = np.where(bias, scale * 181, scale)
            tskip = sel[:, C_TSKIP0 + comp] != 0
            dst4 = ((comp == 0) & (sel[:, C_PRED] == 0) &
                    (t0 == DEFAULT) & (t1 == DEFAULT) &
                    (w == 4) & (h == 4) & (not no_dst))
            # dc-only blocks run through the merged gen kernel (same
            # exact result: the dc fast path is a shortcut of the full
            # DCT-2, ref: transform.cc:115-121); the per-block transform
            # family is data, so 'gen' needs ONE group per block shape
            var = np.where(tskip, 3, np.where(dst4, 1, 0))
            fam1 = np.maximum(t0, 1) - 1  # DEFAULT->DCT2 family index
            fam2 = np.maximum(t1, 1) - 1
            keys = np.stack([w, h, var], axis=1)
            uniq, inv = np.unique(keys, axis=0, return_inverse=True)
            inv = inv.reshape(-1)
            offs_all = sel[:, C_COEFF0 + comp]
            for gi, (gw, gh, gv) in enumerate(uniq):
                m = inv == gi
                b = int(m.sum())
                bp = dsp.pad_pow2(b)
                offs = offs_all[m]
                idx = offs[:, None] + np.arange(gw * gh)[None, :]
                cf = np.zeros((bp, gh, gw), np.int16)
                cf[:b] = coeff[idx].astype(np.int16).reshape(b, gh, gw)
                scales = np.zeros((bp,), np.int32)
                scales[:b] = scale[m]
                nrows = 5 if gv == 0 else 3
                params = np.full((nrows, bp), _BIG, np.int32)
                params[0, :b] = 0 if comp == 0 else comp - 1
                params[1, :b] = cy[m]
                params[2, :b] = cx[m]
                if gv == 0:
                    params[3, :b] = fam1[m]
                    params[4, :b] = fam2[m]
                    params[3, b:] = 0  # padding lanes: valid fam index
                    params[4, b:] = 0
                groups.append(((int(gw), int(gh), 0, 0, int(gv),
                                comp > 0), cf, scales, params))
        return groups

    # ------------------------------------------------------------------
    def _ref_tables(self):
        """Per (list, ref_idx): frame-store slot + ref luma dims."""
        rpl = self.pd.ref_pic_lists
        slots = np.zeros((2, 5), np.int32)
        refw = np.zeros((2, 5), np.int32)
        refh = np.zeros((2, 5), np.int32)
        for lst in range(2):
            n = rpl.get_num_ref_pics(lst)
            for i in range(min(n, 5)):
                entry = rpl.entries[lst][i]
                slots[lst, i] = ensure_slot(entry.rec_pic, self.device)
                refw[lst, i] = entry.rec_pic.width[0]
                refh[lst, i] = entry.rec_pic.height[0]
        return slots, refw, refh

    def _build_mc_groups(self, leaves):
        """Vectorized MC job emission: returns [(key, params (10, B)
        int32)], key = (wb, hb, luma, short)."""
        inter = leaves[(leaves[:, C_TREE] == 0) & (leaves[:, C_PRED] == 1)]
        if not len(inter):
            return [], False
        slots, refw, refh = self._ref_tables()
        BI = int(k.InterDir.BI)
        L1 = int(k.InterDir.L1)
        rows = []
        normal = inter[inter[:, C_AFFINE] == 0]
        affine = inter[inter[:, C_AFFINE] != 0]
        ncomp = 1 if self.mono else 3
        for dslot in (0, 1):
            if dslot == 0:
                sel = normal
                lst = np.where(sel[:, C_DIR] == L1, 1, 0)
            else:
                sel = normal[normal[:, C_DIR] == BI]
                lst = np.ones(len(sel), np.int64)
            if not len(sel):
                continue
            short = (sel[:, C_DIR] == BI)
            ridx = sel[np.arange(len(sel)), C_REF0 + lst]
            mvx = sel[np.arange(len(sel)), C_MV + 8 * lst]
            mvy = sel[np.arange(len(sel)), C_MV + 8 * lst + 1]
            # clip_mv (ref: inter_prediction.cc:769-782)
            sh = mv_mod.MV_PRECISION_SHIFT
            posx, posy = sel[:, C_X], sel[:, C_Y]
            rw = refw[lst, ridx]
            rh = refh[lst, ridx]
            mvx = np.clip(mvx, -((k.MAX_BLOCK_SIZE + 8 + posx - 1) << sh),
                          (rw + 8 - posx - 1) << sh)
            mvy = np.clip(mvy, -((k.MAX_BLOCK_SIZE + 8 + posy - 1) << sh),
                          (rh + 8 - posy - 1) << sh)
            sslot = slots[lst, ridx]
            for comp in range(ncomp):
                self._emit_mc_rows(rows, sel, comp, sslot, mvx, mvy,
                                   short, dslot)
        for r in affine:
            self._emit_affine_rows(rows, r, slots, refw, refh, ncomp)
        if not rows:
            return [], False
        allrows = np.concatenate(rows, axis=1)  # (12, N) incl. key cols

        def buck(v):
            return np.where(v <= 8, 8, np.where(v <= 16, 16,
                            np.where(v <= 32, 32, 64)))

        wb = buck(allrows[10])
        hb = buck(allrows[11])
        keys = np.stack([allrows[0], allrows[1], wb, hb], axis=1)
        uniq, inv = np.unique(keys, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        groups = []
        for gi, (luma, short, gwb, ghb) in enumerate(uniq):
            m = inv == gi
            b = int(m.sum())
            bp = dsp.pad_pow2(b)
            params = np.full((10, bp), _BIG, np.int32)
            params[:, :b] = allrows[2:12, m].astype(np.int32)
            # order: stack_idx, ypad, xpad, fx, fy, dslot, cy, cx, w, h
            groups.append(((int(gwb), int(ghb), bool(luma), bool(short)),
                           params))
        return groups, True

    def _emit_mc_rows(self, rows, sel, comp, sslot, mvx, mvy, short,
                      dslot):
        """Fullpel/frac split + window origin for one component
        (ref: inter_prediction.cc:1174-1205 GetFullpelRef)."""
        rec = self.rec
        sx = rec.shift_x[comp]
        sy = rec.shift_y[comp]
        shift_x = mv_mod.MV_PRECISION_SHIFT + sx
        shift_y = mv_mod.MV_PRECISION_SHIFT + sy
        if comp == 0:
            pel_x = mvx >> shift_x
            pel_y = mvy >> shift_y
            fx = mvx & ((1 << shift_x) - 1)
            fy = mvy & ((1 << shift_y) - 1)
        elif self.restr.disable_inter_chroma_subpel:
            pel_x = (mvx + (1 << (shift_x - 1))) >> shift_x
            pel_y = (mvy + (1 << (shift_y - 1))) >> shift_y
            fx = np.zeros_like(mvx)
            fy = np.zeros_like(mvy)
        else:
            pel_x = mvx >> shift_x
            pel_y = mvy >> shift_y
            fx = (mvx & ((1 << shift_x) - 1)) << (1 - sx)
            fy = (mvy & ((1 << shift_y) - 1)) << (1 - sy)
        if not self.hp_mv:
            fx = fx >> mv_mod.HIGH_TO_NORMAL_DELTA
            fy = fy >> mv_mod.HIGH_TO_NORMAL_DELTA
        cx = sel[:, C_X] >> sx
        cy = sel[:, C_Y] >> sy
        w = sel[:, C_W] >> sx
        h = sel[:, C_H] >> sy
        luma = comp == 0
        taps = mc.NUM_TAPS_LUMA if luma else mc.NUM_TAPS_CHROMA
        half = taps // 2 - 1
        # chroma superstack is reshaped (S*2, Hp, Wp): stack idx carries
        # the uv plane; scatter channel = dslot * nplanes + plane
        stack_idx = sslot if luma else sslot * 2 + (comp - 1)
        chan = dslot if luma else dslot * 2 + (comp - 1)
        ypad = rec.pad_y[comp] + cy + pel_y - half
        xpad = rec.pad_x[comp] + cx + pel_x - half
        n = len(sel)
        rows.append(np.stack([
            np.full(n, 1 if luma else 0), short.astype(np.int64),
            stack_idx, ypad, xpad, fx, fy,
            np.full(n, chan), cy, cx, w, h]).astype(np.int64))

    def _emit_affine_rows(self, rows, r, slots, refw, refh, ncomp):
        """Affine subblock expansion for one CU (exact twin of
        inter_mc.affine_subblock_jobs, ref: inter_prediction.cc:
        1044-1136), emitted straight from the record row."""
        rec = self.rec
        BI = int(k.InterDir.BI)
        L1 = int(k.InterDir.L1)
        d = int(r[C_DIR])
        lists = [(0 if d != L1 else 1, d == BI)]
        if d == BI:
            lists = [(0, True), (1, True)]
        posx, posy = int(r[C_X]), int(r[C_Y])
        width, height = int(r[C_W]), int(r[C_H])
        sh = mv_mod.MV_PRECISION_SHIFT
        for dslot, (lst, short) in enumerate(lists):
            ridx = int(r[C_REF0 + lst])
            rw, rh = int(refw[lst, ridx]), int(refh[lst, ridx])
            sslot = int(slots[lst, ridx])

            def clip(mvp):
                x = min(max(mvp[0],
                            -((k.MAX_BLOCK_SIZE + 8 + posx - 1) << sh)),
                        (rw + 8 - posx - 1) << sh)
                y = min(max(mvp[1],
                            -((k.MAX_BLOCK_SIZE + 8 + posy - 1) << sh)),
                        (rh + 8 - posy - 1) << sh)
                return (x, y)

            mv3 = [clip((int(r[C_MV + 8 * lst + 2 * c]),
                         int(r[C_MV + 8 * lst + 2 * c + 1])))
                   for c in range(3)]
            for comp in range(ncomp):
                sx = rec.shift_x[comp]
                sy = rec.shift_y[comp]
                cw, ch = width >> sx, height >> sy
                ccx, ccy = posx >> sx, posy >> sy
                if mv3[0] == mv3[1]:
                    # uniform: plain MC with mv3[0]
                    self._affine_plain(rows, comp, sslot, mv3[0], short,
                                       dslot, ccx, ccy, cw, ch)
                    continue
                jobs, sw, shh = self._affine_subblocks(
                    mv3, comp, posx, posy, cw, ch, sx, sy)
                luma = comp == 0
                taps = mc.NUM_TAPS_LUMA if luma else mc.NUM_TAPS_CHROMA
                half = taps // 2 - 1
                stack_idx = sslot if luma else sslot * 2 + (comp - 1)
                chan = dslot if luma else dslot * 2 + (comp - 1)
                arr = np.asarray(jobs, np.int64).T  # (6, J)
                x0, y0, fx, fy, dx, dy = arr
                n = arr.shape[1]
                rows.append(np.stack([
                    np.full(n, 1 if luma else 0),
                    np.full(n, 1 if short else 0),
                    np.full(n, stack_idx),
                    rec.pad_y[comp] + y0 - half,
                    rec.pad_x[comp] + x0 - half,
                    fx, fy, np.full(n, chan),
                    ccy + dy, ccx + dx,
                    np.full(n, sw), np.full(n, shh)]).astype(np.int64))

    def _affine_plain(self, rows, comp, sslot, mv, short, dslot, ccx,
                      ccy, cw, ch):
        rec = self.rec
        sx, sy = rec.shift_x[comp], rec.shift_y[comp]
        shift_x = mv_mod.MV_PRECISION_SHIFT + sx
        shift_y = mv_mod.MV_PRECISION_SHIFT + sy
        mvx, mvy = mv
        if comp == 0:
            pel_x, pel_y = mvx >> shift_x, mvy >> shift_y
            fx = mvx & ((1 << shift_x) - 1)
            fy = mvy & ((1 << shift_y) - 1)
        elif self.restr.disable_inter_chroma_subpel:
            pel_x = (mvx + (1 << (shift_x - 1))) >> shift_x
            pel_y = (mvy + (1 << (shift_y - 1))) >> shift_y
            fx = fy = 0
        else:
            pel_x, pel_y = mvx >> shift_x, mvy >> shift_y
            fx = (mvx & ((1 << shift_x) - 1)) << (1 - sx)
            fy = (mvy & ((1 << shift_y) - 1)) << (1 - sy)
        if not self.hp_mv:
            fx >>= mv_mod.HIGH_TO_NORMAL_DELTA
            fy >>= mv_mod.HIGH_TO_NORMAL_DELTA
        luma = comp == 0
        taps = mc.NUM_TAPS_LUMA if luma else mc.NUM_TAPS_CHROMA
        half = taps // 2 - 1
        stack_idx = sslot if luma else sslot * 2 + (comp - 1)
        chan = dslot if luma else dslot * 2 + (comp - 1)
        rows.append(np.asarray(
            [[1 if luma else 0], [1 if short else 0], [stack_idx],
             [rec.pad_y[comp] + ccy + pel_y - half],
             [rec.pad_x[comp] + ccx + pel_x - half],
             [fx], [fy], [chan], [ccy], [ccx], [cw], [ch]], np.int64))

    def _affine_subblocks(self, mv, comp, posx, posy, width, height,
                          scale_x, scale_y):
        """Subblock job list (x0, y0, fx, fy, dx, dy) in component
        coords; mv are the three clipped corner MVs."""
        AFFINE_PREC = 8
        sh = mv_mod.MV_PRECISION_SHIFT
        mv_scale = 1 << sh
        mv_shift_x = sh + scale_x
        mv_shift_y = sh + scale_y

        def get_subblock_size(ref, mv_uni, size, scale):
            MIN_SUBBLOCK = 4
            SIZE_SHIFT = 6 - sh
            max_len = max(abs(mv_uni[0] - ref[0]), abs(mv_uni[1] - ref[1]))
            if not max_len:
                return size
            sub = max(1, (size >> SIZE_SHIFT) // max_len)
            while size % sub:
                sub -= 1
            return max(MIN_SUBBLOCK, sub) >> scale

        sw = get_subblock_size(mv[0], mv[1], width, scale_x)
        shh = get_subblock_size(mv[0], mv[2], height, scale_y)
        luma_w, luma_h = self.pd.width, self.pd.height
        mv_max_x = (luma_w - posx + 8 - 1) * mv_scale
        mv_min_x = (-k.MAX_BLOCK_SIZE - posx - 8 + 1) * mv_scale
        mv_max_y = (luma_h - posy + 8 - 1) * mv_scale
        mv_min_y = (-k.MAX_BLOCK_SIZE - posy - 8 + 1) * mv_scale

        def trunc_div(a, b):
            q = abs(a) // b
            return -q if a < 0 else q

        delta_hor_x = trunc_div((mv[1][0] - mv[0][0]) * (1 << AFFINE_PREC),
                                width)
        delta_hor_y = trunc_div((mv[1][1] - mv[0][1]) * (1 << AFFINE_PREC),
                                width)
        delta_ver_x = -delta_hor_y
        delta_ver_y = delta_hor_x
        hor_x = mv[0][0] * (1 << AFFINE_PREC)
        hor_y = mv[0][1] * (1 << AFFINE_PREC)
        ver_x, ver_y = hor_x, hor_y
        ccx, ccy = posx >> scale_x, posy >> scale_y
        jobs = []
        for sub_y in range(0, height, shh):
            for sub_x in range(0, width, sw):
                mv_x = min(max((hor_x + delta_hor_x * (sw >> 1) +
                                delta_ver_x * (shh >> 1)) >> AFFINE_PREC,
                               mv_min_x), mv_max_x)
                mv_y = min(max((hor_y + delta_hor_y * (sw >> 1) +
                                delta_ver_y * (shh >> 1)) >> AFFINE_PREC,
                               mv_min_y), mv_max_y)
                x0 = ccx + sub_x + (mv_x >> mv_shift_x)
                y0 = ccy + sub_y + (mv_y >> mv_shift_y)
                jobs.append((x0, y0, mv_x & ((1 << mv_shift_x) - 1),
                             mv_y & ((1 << mv_shift_y) - 1), sub_x, sub_y))
                hor_x += delta_hor_x * sw
                hor_y += delta_hor_y * sw
            ver_x += delta_ver_x * shh
            ver_y += delta_ver_y * shh
            hor_x, hor_y = ver_x, ver_y
        return jobs, sw, shh

    # ------------------------------------------------------------------
    def _build_intra_meta(self, leaves):
        """Luma + chroma scan metadata straight from the records (the
        decode-order availability sbl/sar is exported by the native
        derive walk, xvcn_pic.inc parse_derive_cu)."""
        pd = self.pd
        lsel = leaves[(leaves[:, C_TREE] == 0) & (leaves[:, C_PRED] == 0)]
        lmeta = None
        if len(lsel):
            n = len(lsel)
            np2 = dsp.pad_pow2(n)
            lmeta = np.zeros((np2, intra_scan.META_COLS), np.int32)
            has_l = (lsel[:, C_X] > 0).astype(np.int32)
            has_a = (lsel[:, C_Y] > 0).astype(np.int32)
            lmeta[:n] = np.stack([
                lsel[:, C_X], lsel[:, C_Y], lsel[:, C_W], lsel[:, C_H],
                lsel[:, C_IML], has_l, has_a, has_l & has_a,
                np.clip(lsel[:, C_SBL], 0, 64),
                np.clip(lsel[:, C_SAR], 0, 64),
                np.ones(n, np.int64)], axis=1).astype(np.int32)
        if self.mono:
            return lmeta, None
        dual = pd.has_secondary_cu_tree()
        ctree = 1 if dual else 0
        csel = leaves[leaves[:, C_TREE] == ctree]
        if not dual:
            csel = csel[csel[:, C_PRED] == 0]
        if not len(csel):
            return lmeta, None
        # resolve DM to the co-located primary-tree luma mode
        cmode = csel[:, C_IMC].copy()
        dm = cmode == k.INTRA_CHROMA_DM
        if dm.any():
            if dual:
                map_w = (pd.width + 3) >> 2
                map_h = (pd.height + 3) >> 2
                lmap = np.zeros((map_h, map_w), np.int32)
                for r in lsel:
                    x0, y0 = int(r[C_X]) >> 2, int(r[C_Y]) >> 2
                    x1 = min(map_w, (int(r[C_X]) + int(r[C_W]) + 3) >> 2)
                    y1 = min(map_h, (int(r[C_Y]) + int(r[C_H]) + 3) >> 2)
                    lmap[y0:y1, x0:x1] = r[C_IML]
                cmode[dm] = lmap[csel[dm, C_Y] >> 2, csel[dm, C_X] >> 2]
            else:
                cmode[dm] = csel[dm, C_IML]
        is_lm = (csel[:, C_IMC] == k.INTRA_MODE_LM_CHROMA).astype(np.int32)
        sx, sy = pd.chroma_shift_x, pd.chroma_shift_y
        csh = max(sx, sy)
        ccx = csel[:, C_X] >> sx
        ccy = csel[:, C_Y] >> sy
        has_l = (ccx > 0).astype(np.int32)
        has_a = (ccy > 0).astype(np.int32)
        n = len(csel)
        base = np.stack([
            ccx, ccy, csel[:, C_W] >> sx, csel[:, C_H] >> sy,
            np.maximum(cmode, 0), is_lm, has_l, has_a, has_l & has_a,
            np.clip(csel[:, C_SBL], 0, 64) >> csh,
            np.clip(csel[:, C_SAR], 0, 64) >> csh,
            np.ones(n, np.int64)], axis=1).astype(np.int32)
        # one row per (leaf, uv) in the host decode order (u then v)
        rows = np.zeros((2 * n, intra_scan.CMETA_COLS), np.int32)
        rows[0::2, 0] = 0
        rows[1::2, 0] = 1
        rows[0::2, 1:] = base
        rows[1::2, 1:] = base
        np2 = dsp.pad_pow2(2 * n)
        cmeta = np.zeros((np2, intra_scan.CMETA_COLS), np.int32)
        cmeta[:2 * n] = rows
        return lmeta, cmeta


def store_and_download(rec, planes_dev, device, stage="flat"):
    """Pad the final visible device planes into the frame store and fill
    the host rec planes with one download (spans ``<stage>.store`` and
    ``<stage>.download``)."""
    with span(stage + ".store"):
        frame_store_put(rec, device_pad_planes(rec, planes_dev), device)
    comps = sorted(planes_dev)
    with span(stage + ".download"):
        flat, offs = dsp.gather_flat([planes_dev[c] for c in comps])
    for comp, (off, shape) in zip(comps, offs):
        rec.plane_view(comp)[:] = \
            flat[off:off + int(np.prod(shape))].reshape(shape)
