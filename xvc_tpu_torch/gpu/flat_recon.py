"""Flat, record-driven picture reconstruction on a torch device.

Port of ``xvc_tpu/tpu/flat_recon.py``.  The native CABAC parse emits a
flat record table and a coefficient arena; both go to the device in the
picture's one upload, with the intra scans' metadata (built on the host)
and the reference table, and the device runs in this order:

  1. dequant + inverse transform of every coded block, derived from the
     records on the device (``gpu/itx.py`` ``itx_picture``: one launch);
  2. sub-pel MC of every inter leaf (affine CUs expanded there) from the
     frame store, derived the same way (``gpu/mc.py`` ``mc_picture``:
     one launch);
  3. uni/bi combine + residual + clip (``combine``, plain PyTorch);
  4. the intra luma scan, then the chroma scan with LM
     (``gpu/intra_scan.py``, kernels 5 and 6: one launch each);
  5. deblock (``gpu/deblock.py``: edge decisions, luma walk and chroma
     pass, three kernels);
  6. a frame-store write and one download.

Steps 1-4 and the store are shared with the replay path of the pictures
this path refuses (``gpu/recon.py``, whose ``Reconstructor`` subclasses
``FlatReconstructor``; ``ineligible_reason`` says which).

Reference pictures live in a ``FrameStore`` a place (int16 (S, Hp, Wp)
luma and (S, 2, Hp, Wp) chroma), written in place with ``copy_`` (the
JAX version's donated ``_store_set3``/``_store_set4``).  A place is the
mesh slot the thread is pinned to (``engine.set_pin_device``), else the
device: a picture decoded on one slot is moved into another slot's
store once, when a picture there first reads it (``ensure_slot``,
counted in the span table's ``xfer.move`` rows).  Under a mesh with no
pin the replay path shares its ITX and MC jobs over the mesh's slots
(``_dispatch_sharded``).  The padded
geometry is the JAX version's (``_padded_shape``), so MC window clamping
matches.  A picture's slots hang on ``rec_pic._torch_slots``, never on
the JAX package's ``_dev_slots``.

``_build_intra_meta`` is a copy of the JAX module's, as is the
intra-toolset test of ``xvc_tpu/codec/intra_search.py``: this package
imports nothing of ``xvc_tpu``.  The JAX module's ITX and MC job
derivation (``_build_itx_groups``, ``_build_mc_groups``) has no host twin
here: the kernels make it (and ``itx.itx_jobs`` / ``mc.mc_jobs`` in the
plain versions).
"""
import threading
import weakref

import numpy as np
import torch

from .. import constants as k
from ..engine import get_pin_device, mesh_for, pin_for
from ..parallel import mesh as mesh_mod
from ..profiling import span
from ..restrictions import Restrictions
from . import dsp
from . import intra_scan
from . import itx
from . import mc as mc_kernel
from .records import (C_H, C_IMC, C_IML, C_ORDER, C_PRED, C_SAR, C_SBL,
                      C_SPLIT, C_TREE, C_W, C_X, C_Y)


# ---------------------------------------------------------------------------
# Device-resident frame store
# ---------------------------------------------------------------------------

# The workers of a threaded decode share the stores: slots are assigned,
# released and the superstacks grown under this lock, and a reader takes
# both superstacks in one ``stacks()`` call.  A finalizer takes no lock
# (it can run inside any locked section of any thread): it hands its slot
# to ``release_later``.
_STORE_LOCK = threading.RLock()


class FrameStore:
    """Per-geometry device store: int16 superstacks (S, Hp, Wp) for luma
    and (S, 2, Hp, Wp) for chroma.  Slots are assigned per decoded
    picture and written in place; MC reads windows straight from the
    superstack (chroma reshaped (S*2, Hp, Wp)).  Growing replaces the
    superstacks (an MC launch already issued reads the old ones, which
    hold every slot it can name)."""

    def __init__(self, luma_shape, chroma_shape, device, key, n0=8):
        self.luma_shape = luma_shape
        self.chroma_shape = chroma_shape  # None for monochrome
        self.device = device
        self.key = key
        self.n = 0
        self.free = []
        self.released = []  # slots of pictures that died, not yet free
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

    def reserve(self):
        """A free slot, the superstacks grown if there is none.  Its
        writer takes the superstacks (``stacks()``) and enqueues its writes
        before it lets go of the lock, so a later growth copies them."""
        with _STORE_LOCK:
            while self.released:
                self.release(self.released.pop())
            if not self.free:
                self._grow(self.n * 2)
            return self.free.pop()

    def put(self, dev_planes):
        """dev_planes: {comp: (Hp, Wp) device plane}.  Returns the slot."""
        with _STORE_LOCK:
            slot = self.reserve()
            self.luma[slot].copy_(dev_planes[0])
            if self.chroma_shape is not None and 1 in dev_planes:
                self.chroma[slot, 0].copy_(dev_planes[1])
                self.chroma[slot, 1].copy_(dev_planes[2])
            return slot

    def release(self, slot):
        with _STORE_LOCK:
            if slot not in self.free:
                self.free.append(slot)

    def release_later(self, slot):
        """Free ``slot`` at the next ``put`` (for finalizers)."""
        self.released.append(slot)

    def stacks(self):
        """(luma, chroma stack (S*2, Hp, Wp) or None) as they are now."""
        with _STORE_LOCK:
            chroma = None if self.chroma is None else \
                self.chroma.view((-1,) + self.chroma_shape)
            return self.luma, chroma


_STORES = {}


def padded_shape(h, w):
    """The store's shape of a padded plane h x w: the JAX frame store's
    geometry (tile-aligned margins), so that MC window clamping is
    identical."""
    return (-(-(h + 64) // 8) * 8, -(-(w + 64) // 128) * 128)


def _padded_shape(rec_pic, comp):
    return padded_shape(*rec_pic._plane_shapes[comp])


def place_key(device):
    """The key of the frame stores of ``device`` for this thread: the
    slot it is pinned to where that slot lies on ``device``, else the
    device itself."""
    pin = get_pin_device()
    if pin is not None and pin.device == torch.device(device):
        return pin.key
    return str(device)


def get_store(rec_pic, device):
    """The store of the picture's geometry at this thread's place on
    ``device`` (``place_key``)."""
    ls = _padded_shape(rec_pic, 0)
    cs = _padded_shape(rec_pic, 1) \
        if rec_pic.chroma_format != k.ChromaFormat.MONOCHROME else None
    place = place_key(device)
    key = (ls, cs, place)
    with _STORE_LOCK:
        st = _STORES.get(key)
        if st is None:
            st = _STORES[key] = FrameStore(ls, cs, device, place)
        return st


def _slot_map(rec_pic):
    slots = getattr(rec_pic, "_torch_slots", None)
    if slots is None:
        slots = {}
        rec_pic._torch_slots = slots
    return slots


def release_slot(rec_pic):
    """Free the picture's store slots (its buffer is being recycled)."""
    with _STORE_LOCK:
        slots = getattr(rec_pic, "_torch_slots", None)
        if slots:
            for store, slot, fin in slots.values():
                fin.detach()
                store.release(slot)
            slots.clear()


def _register(rec_pic, store, slot):
    # a finalizer frees the slot when the picture object dies, so
    # sessions that end without recycling their buffers leak no slots
    fin = weakref.finalize(rec_pic, store.release_later, slot)
    _slot_map(rec_pic)[store.key] = (store, slot, fin)
    return slot


def frame_store_put(rec_pic, dev_planes, device):
    """Register a picture's final padded device planes in the store."""
    with _STORE_LOCK:
        release_slot(rec_pic)
        store = get_store(rec_pic, device)
        return _register(rec_pic, store, store.put(dev_planes))


def ensure_slot(rec_pic, device):
    """Slot of a reference picture in the store of this thread's place
    on ``device`` (``place_key``).  A picture stored at another place
    (another mesh slot) has its padded planes copied from that store,
    once (the JAX package's device-to-device move, ``xvc_tpu/tpu/
    flat_recon.py:220-260``); a picture never written by this package
    (decoded elsewhere, or an alternative reconstruction that several
    workers' pictures may ask for at once) uploads its host padded
    planes once."""
    with _STORE_LOCK:
        return _ensure_slot(rec_pic, device)


def _move_planes(src, device):
    """The padded planes of the store entry ``src`` (store, slot, _) on
    ``device`` (views where it is the source's device), for a ``put`` on
    the current stream.  The source was written on its own slot's stream
    before its picture's download (a host sync), which comes before any
    dependent picture starts; the allocator keeps the source superstacks
    until this stream has read them, even if their store grows
    meanwhile."""
    store, slot, _ = src
    luma, chroma = store.stacks()
    stream = mesh_mod.current_stream(device)
    parts = [luma[slot]]
    if chroma is not None:
        parts += [chroma[2 * slot], chroma[2 * slot + 1]]
    planes = {}
    for comp, part in enumerate(parts):
        if stream is not None and part.device == stream.device:
            part.record_stream(stream)
        planes[comp] = dsp.move(part, device)  # the store's put copies it
    return planes


def _ensure_slot(rec_pic, device):
    slots = _slot_map(rec_pic)
    ent = slots.get(place_key(device))
    if ent is not None:
        return ent[1]
    store = get_store(rec_pic, device)
    src = next(iter(slots.values()), None)
    if src is not None:
        return _register(rec_pic, store,
                         store.put(_move_planes(src, device)))
    ncomp = 1 if rec_pic.chroma_format == k.ChromaFormat.MONOCHROME else 3
    planes = {}
    for comp in range(ncomp):
        base = rec_pic.padded_plane(comp).astype(np.int16)
        th, tw = _padded_shape(rec_pic, comp)
        host = np.pad(base, ((0, th - base.shape[0]),
                             (0, tw - base.shape[1])), mode="edge")
        planes[comp] = dsp.upload(torch.from_numpy(host), device)
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
    """Why the flat path cannot decode this picture, or None (the
    picture then takes the replay path, ``gpu/recon.py``, up to 14 bit).
    Covers the default (unrestricted) toolset on 4:2:0 / monochrome; the
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


_QP_SCALES = {}


def qp_scales_on(device, pd, segment):
    """The segment's ``itx.qp_scale_table`` on ``device`` (cached; the
    workers of a threaded decode keep the first one made)."""
    key = (str(device), int(pd.chroma_format), pd.bitdepth,
           segment.chroma_qp_offset_table, segment.chroma_qp_offset_u,
           segment.chroma_qp_offset_v)
    t = _QP_SCALES.get(key)
    if t is None:
        t = _QP_SCALES.setdefault(key, dsp.upload(torch.from_numpy(
            itx.qp_scale_table(*key[1:])), device))
    return t


def decode_order_leaves(records):
    """The leaf rows of a record table in decode (z-)order: pool-slot
    order is allocation order, and the native derive walk exports the
    decode order (``C_ORDER``)."""
    leaves = records[records[:, C_SPLIT] == 0]
    return leaves[np.argsort(leaves[:, C_ORDER], kind="stable")]


class FlatReconstructor:
    """Device reconstruction of a parsed picture.  ``_device_half``,
    ``_scans`` and ``_visible`` are shared with the replay path
    (``gpu/recon.py`` ``Reconstructor``, a subclass), whose spans carry
    its ``STAGE`` prefix instead of ``flat``."""
    STAGE = "flat"

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
        with span("flat.build"):
            leaves = decode_order_leaves(self.pd._parse_records)
            lmeta, cmeta = self._build_intra_meta(leaves)
        self._device_half(leaves, lmeta, cmeta)
        self._scans()
        planes_dev = self._visible()
        if self.pd.deblock:
            return planes_dev
        store_and_download(self.rec, planes_dev, self.device)
        return None

    def _device_half(self, leaves, lmeta, cmeta):
        """One upload of the records, the arena, the reference table and
        the scans' metadata, then ITX, MC and combine (spans
        ``<STAGE>.upload``, ``<STAGE>.dispatch``).  Leaves on ``self``
        the zero-padded scan canvases of the reconstruction before the
        intra scans (``plane_l``, ``plane_c`` int16), the residual
        canvases (``rpad_l``, ``rpad_c`` int32; chroma None for
        monochrome) and the scans' metadata on the device (``lmeta``,
        ``cmeta``, or None)."""
        pd = self.pd
        dev = self.device
        stage = self.STAGE
        rec_arr = pd._parse_records
        H, W = pd.height, pd.width
        Hc, Wc = self.rec.height[1], self.rec.width[1]
        ph, pw = _pad_canvas_dims(H, W)
        phc, pwc = _pad_canvas_dims(Hc, Wc) if not self.mono else (0, 0)
        have_inter = bool(((leaves[:, C_TREE] == 0) &
                           (leaves[:, C_PRED] == 1)).any())

        # a mesh and no pin: the ITX and MC jobs are shared over the slots
        mesh = mesh_for(dev) if pin_for(dev) is None else None
        with span(stage + ".upload"):
            # the records and the arena go up as they are: the kernels
            # derive every ITX and MC job from them (the decode-order
            # leaves alone when the slots take ranges of them)
            batch = dsp.DevBatch()
            h_rec = batch.add(rec_arr if mesh is None else leaves)
            h_coeff = batch.add(pd._parse_coeff)
            if have_inter:
                h_refs = batch.add(self._ref_tables())
            metas = [None if m is None else batch.add(m)
                     for m in (lmeta, cmeta)]
            qp_scales = qp_scales_on(dev, pd, self.segment)
            batch.upload(dev)
            self.lmeta, self.cmeta = [None if h is None else batch.get(h)
                                      for h in metas]

        with span(stage + ".dispatch"):
            planes = self._zero_planes(dev)
            resi_l, resi_c, pred_l, mask_l, pred_c, mask_c = planes
            records = batch.get(h_rec)
            refs = batch.get(h_refs) if have_inter else None
            if mesh is not None:
                self._dispatch_sharded(mesh, planes, records,
                                       batch.get(h_coeff), refs)
            else:
                self._dispatch(planes, records, batch.get(h_coeff),
                               qp_scales, refs,
                               get_store(self.rec, dev).stacks()
                               if have_inter else None)

            plane_l, rpad_l = combine(pred_l, mask_l, resi_l, H, W, ph, pw,
                                      self.bitdepth)
            self.plane_l, self.rpad_l = plane_l[0], rpad_l[0]
            self.plane_c = self.rpad_c = None
            if not self.mono:
                self.plane_c, self.rpad_c = combine(
                    pred_c, mask_c, resi_c, Hc, Wc, phc, pwc, self.bitdepth)

    def _zero_planes(self, dev):
        """Zero residual planes (int32 (1, H, W) luma, (2, Hc, Wc) chroma)
        and prediction planes and bi coverage masks (int16 (2, H, W) and
        (1, H, W) luma, (4, Hc, Wc) and (2, Hc, Wc) chroma; channel
        chan = dslot * nplanes + plane, slot-0 planes first) on ``dev``;
        chroma None for monochrome."""
        zeros = lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev)
        H, W = self.pd.height, self.pd.width
        Hc, Wc = self.rec.height[1], self.rec.width[1]
        chroma = not self.mono
        return (zeros((1, H, W), torch.int32),
                zeros((2, Hc, Wc), torch.int32) if chroma else None,
                zeros((2, H, W), torch.int16), zeros((1, H, W), torch.int16),
                zeros((4, Hc, Wc), torch.int16) if chroma else None,
                zeros((2, Hc, Wc), torch.int16) if chroma else None)

    def _dispatch(self, planes, records, coeff, qp_scales, refs, stacks):
        """``itx_picture`` and, where the picture has inter leaves (refs
        and the store's ``stacks`` not None), ``mc_picture`` of the rows
        ``records`` into ``planes`` (``_zero_planes``), on the current
        stream of their device."""
        pd = self.pd
        resi_l, resi_c, pred_l, mask_l, pred_c, mask_c = planes
        itx.itx_picture(resi_l, resi_c, records, coeff, qp_scales,
                        self.bitdepth, self.hp_tx,
                        self.restr.disable_ext2_transform_dst,
                        pd.chroma_shift_x, pd.chroma_shift_y)
        if refs is not None:
            mc_kernel.mc_picture(pred_l, mask_l, pred_c, mask_c, records,
                                 refs, stacks[0], stacks[1],
                                 self._mc_flags())

    def _dispatch_sharded(self, mesh, planes, leaves, coeff, refs):
        """The block-sharded dispatch (``xvc_tpu/tpu/recon.py:62-69``,
        ``_launch_itx_sharded`` :374, ``_launch_mc_sharded`` :401): each
        of this process's slots takes a contiguous range of the
        decode-order leaves (an affine CU is one leaf, so its subblocks
        never split), the arena and the referenced store slots (copied to
        the slot once a picture, counted as moves), and launches
        ``itx_picture`` and ``mc_picture`` on its device and stream into
        planes of its own.  The picture's device then adds them up into
        ``planes``: a sample is written by one leaf only and every other
        slot's plane is zero there, so the sums are the planes one launch
        would write."""
        dev = self.device
        caller = mesh_mod.current_stream(dev)
        stacks = None
        if refs is not None:
            stacks, refs = self._used_references(refs)
        slots = mesh.local_slots
        parts = []
        for slot, (lo, hi) in zip(slots, mesh_mod.shard_bounds(
                leaves.shape[0], len(slots))):
            if lo == hi:
                continue
            mesh_mod.wait_for(slot, caller)
            with mesh_mod.placed(slot):
                sd = slot.device
                own = self._zero_planes(sd)
                slot_stacks = None
                if stacks is not None:
                    slot_stacks = [None if t is None else
                                   dsp.move(t, sd, copy=True)
                                   for t in stacks]
                self._dispatch(own, leaves[lo:hi].to(sd), coeff.to(sd),
                               qp_scales_on(sd, self.pd, self.segment),
                               None if refs is None else refs.to(sd),
                               slot_stacks)
            parts.append((slot, own))
        for slot, own in parts:
            for total, part in zip(planes, own):
                if total is not None:
                    total += mesh_mod.join(part, slot, caller).to(dev)

    def _used_references(self, refs):
        """(luma, chroma) stacks of the store slots ``refs`` names, in
        order of slot, and ``refs`` renumbered into them."""
        luma, chroma = get_store(self.rec, self.device).stacks()
        tab = dsp.download(refs).numpy().copy()
        used = sorted({int(v) for v in tab[:, :, 0].ravel() if v >= 0})
        sel = dsp.upload(torch.tensor(used, dtype=torch.long), luma.device)
        luma = luma.index_select(0, sel)
        if chroma is not None:
            chroma = chroma.view((-1, 2) + chroma.shape[1:]).index_select(
                0, sel).view((-1,) + chroma.shape[1:])
        new = {v: i for i, v in enumerate(used)}
        tab[:, :, 0] = [[new.get(int(v), -1) for v in row]
                        for row in tab[:, :, 0]]
        return (luma, chroma), dsp.upload(torch.from_numpy(tab), refs.device)

    def _scans(self):
        """The intra scans whose metadata ``_device_half`` uploaded
        (decode order; they read and write the canvases)."""
        if self.lmeta is not None:
            with span(self.STAGE + ".intra_scan"):
                intra_scan.intra_scan(self.plane_l, self.rpad_l, self.lmeta,
                                      self.bitdepth)
        if self.cmeta is not None:
            with span(self.STAGE + ".chroma_scan"):
                intra_scan.intra_chroma_scan(self.plane_c, self.rpad_c,
                                             self.plane_l, self.cmeta,
                                             self.bitdepth)

    def _visible(self, canvases=None):
        """The visible area of the canvases (default: the reconstruction
        canvases), {comp: (H, W) contiguous device plane}."""
        luma, chroma = canvases or (self.plane_l, self.plane_c)
        pt = intra_scan.PAD_TL
        H, W = self.pd.height, self.pd.width
        out = {0: luma[pt:pt + H, pt:pt + W].contiguous()}
        if not self.mono:
            Hc, Wc = self.rec.height[1], self.rec.width[1]
            out[1] = chroma[0, pt:pt + Hc, pt:pt + Wc].contiguous()
            out[2] = chroma[1, pt:pt + Hc, pt:pt + Wc].contiguous()
        return out

    # ------------------------------------------------------------------
    def _ref_tables(self):
        """int32 (2, 5, 3): per (list, ref_idx) the frame-store slot (-1
        where the list has no such entry) and the reference's luma width
        and height."""
        rpl = self.pd.ref_pic_lists
        refs = np.zeros((2, mc_kernel.MAX_REFS, 3), np.int32)
        refs[:, :, 0] = -1
        for lst in range(2):
            n = rpl.get_num_ref_pics(lst)
            for i in range(min(n, mc_kernel.MAX_REFS)):
                pic = rpl.entries[lst][i].rec_pic
                refs[lst, i] = (ensure_slot(pic, self.device), pic.width[0],
                                pic.height[0])
        return refs

    def _mc_flags(self):
        rec = self.rec
        return mc_kernel.McFlags(
            self.bitdepth, self.hp_mv,
            not self.restr.disable_inter_chroma_subpel, rec.shift_x[1],
            rec.shift_y[1], (rec.pad_x[0], rec.pad_y[0], rec.pad_x[1],
                             rec.pad_y[1]), self.pd.width, self.pd.height)

    # ------------------------------------------------------------------
    def _build_intra_meta(self, leaves, chroma=True):
        """Luma + chroma scan metadata straight from the records (the
        decode-order availability sbl/sar is exported by the native
        derive walk, xvcn_pic.inc parse_derive_cu); the luma half alone
        without ``chroma``.  In a picture of CTU tile rows a leaf's above
        neighbours are available only inside its tile: ``has_a`` is
        ``y > tile_top`` (xvc_tpu/tpu/recon.py ``_device_intra_luma`` /
        ``_device_intra_chroma``); the parse already cut ``sar``."""
        pd = self.pd
        tops = np.array([pd.tile_top_y_of_row(r)
                         for r in range(pd.ctu_num_y)], np.int32)
        lsel = leaves[(leaves[:, C_TREE] == 0) & (leaves[:, C_PRED] == 0)]
        lmeta = None
        if len(lsel):
            n = len(lsel)
            np2 = dsp.pad_pow2(n)
            lmeta = np.zeros((np2, intra_scan.META_COLS), np.int32)
            has_l = (lsel[:, C_X] > 0).astype(np.int32)
            has_a = (lsel[:, C_Y] >
                     tops[lsel[:, C_Y] // k.CTU_SIZE]).astype(np.int32)
            lmeta[:n] = np.stack([
                lsel[:, C_X], lsel[:, C_Y], lsel[:, C_W], lsel[:, C_H],
                lsel[:, C_IML], has_l, has_a, has_l & has_a,
                np.clip(lsel[:, C_SBL], 0, 64),
                np.clip(lsel[:, C_SAR], 0, 64),
                np.ones(n, np.int64)], axis=1).astype(np.int32)
        if self.mono or not chroma:
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
        has_a = (ccy > (tops[csel[:, C_Y] // k.CTU_SIZE] >> sy)).astype(
            np.int32)
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
