"""Device motion estimation: the TZ search's fullpel SAD sweeps (kernel
``me_sad``).

Port of ``xvc_tpu/tpu/me.py``.  The TZ search (ref:
src/xvc_enc_lib/inter_tz_search.cc:85-330; ``codec/inter_me.py``
``_tz_search``) evaluates its candidate motion vectors one SAD at a time.
Under ``XVC_ME=jax`` (``engine.use_device_me``) it keeps its decisions
on the host but takes the SADs of three sweeps from a table filled in
one device call each: the initial diamond sweep around a fixed centre
(every point of every range, ``tz_initial_candidates``), the raster grid
and the refinement sweeps.  A SAD from the table equals the host
metric's, so the stream is the same bytes either way.

``DeviceSadTable`` keeps the reference's cache and routing: a metric
other than SAD and SAD_FAST, a candidate box wider or taller than the
192 x 192 window, and a window that leaves the padded plane leave the
call's candidates to the host metric, as does a vector never prefetched.
A device call packs the window, the block and the offsets into one
buffer (``pack``); on the card that is one upload from pinned staging,
one ``me_sad`` launch and one download, on the CPU ``sad_sweep_plain``
on the packed buffer's views.  ``STATS`` counts the calls and where they
went.

Not ported: the per-picture device pin of ``prefetch``
(``me.py:151-158``), which belongs to the encode pipeline's mesh
(ROADMAP queue 1 item 7).
"""
import threading

import numpy as np
import torch

from .. import kernels
from ..ops import metrics as met
from ..profiling import span

WIN = 192  # the gather window of the reference (me.py _WIN)

# prefetches: every call; host_routed: calls the routing leaves to the
# host metric; device_calls / device_candidates: calls on the encoder's
# device and the candidates they evaluated; host_dists: dist() lookups of
# a vector that was never prefetched
STATS = {"prefetches": 0, "host_routed": 0, "device_calls": 0,
         "device_candidates": 0, "host_dists": 0}


def reset_stats():
    for key in STATS:
        STATS[key] = 0


def tz_initial_candidates(mv_base, search_range):
    """Candidate list of the initial TZ diamond sweep around a fixed
    center: every point of every doubling range (the host replay applies
    the bounds/early-exit logic).  Returns [(mv_x, mv_y), ...]."""
    bx, by = mv_base
    out = []
    rng = 1
    while rng <= search_range:
        if rng == 1:
            out += [(bx, by - rng), (bx - rng, by), (bx + rng, by),
                    (bx, by + rng)]
        elif rng <= 8:
            r2 = rng >> 1
            out += [(bx, by - rng), (bx - r2, by - r2), (bx + r2, by - r2),
                    (bx - rng, by), (bx + rng, by), (bx - r2, by + r2),
                    (bx + r2, by + r2), (bx, by + rng)]
        else:
            out += [(bx, by - rng), (bx - rng, by), (bx + rng, by),
                    (bx, by + rng)]
            for i in range(1, 4):
                r14 = i * (rng >> 2)
                r34 = rng - r14
                out += [(bx - r14, by - r34), (bx + r14, by - r34),
                        (bx - r14, by + r34), (bx + r14, by + r34)]
        rng *= 2
    return out


def _wrap32(v):
    """int64 -> the int32 value it wraps to."""
    return (v + (1 << 31)).remainder(1 << 32) - (1 << 31)


def sad_sweep_plain(window, orig, cands, fast, bitdepth):
    """The plain version of ``sad_sweep``: int32 gathers of each
    candidate's block, |orig - block|, a sum that wraps to int32 (as the
    JAX function's ``jnp.sum`` does; ``torch.sum`` of int32 would give
    int64), doubled for SAD_FAST, then ``>> (bitdepth - 8)``."""
    h, w = orig.shape
    step = 2 if fast else 1
    dev = window.device
    rows = torch.arange(0, h, step, device=dev)
    cols = torch.arange(w, device=dev)
    y = cands[0].long()
    x = cands[1].long()
    blk = window.to(torch.int32)[
        (y[:, None, None] + rows[None, :, None]),
        (x[:, None, None] + cols[None, None, :])]
    d = (orig.to(torch.int32)[rows][None] - blk).abs()
    s = _wrap32(d.sum((1, 2), dtype=torch.int64))
    if fast:
        s = _wrap32(s * 2)
    return (s >> (bitdepth - 8)).to(torch.int32)


def _check(window, orig, cands, bitdepth):
    """The numpy inputs of ``device_sads``: shapes, bit depth, and every
    candidate's block inside the window (the kernel reads no sample it
    was not given)."""
    if window.ndim != 2 or orig.ndim != 2 or cands.ndim != 2 or \
            cands.shape[0] != 2 or not 8 <= bitdepth <= 16:
        raise ValueError(
            "me_sad takes window [H, W], orig [h, w], cands [2, N] and a "
            "bit depth of 8 to 16; got %r, %r, %r, %r" % (
                window.shape, orig.shape, cands.shape, bitdepth))
    h, w = orig.shape
    if cands.shape[1] and (int(cands.min()) < 0 or
                           int(cands[0].max()) + h > window.shape[0] or
                           int(cands[1].max()) + w > window.shape[1]):
        raise ValueError("me_sad: a candidate's block leaves the window")


def packed_dtype(bitdepth):
    """The element type of the kernel's packed buffer: int16 where the
    samples fit (bitdepth <= 15), int32 above."""
    return torch.int16 if bitdepth <= 15 else torch.int32


def packed_size(wh, ww, h, w, n):
    return wh * ww + h * w + 2 * n


def pack(window, orig, cands, out):
    """Pack numpy window [wh, ww], orig [h, w] and cands [2, N] into the
    1-d numpy ``out`` (the kernel's element type) in the kernel's layout:
    window, orig, then the y and the x offsets."""
    a = window.size
    b = a + orig.size
    out[:a].reshape(window.shape)[:] = window
    out[a:b].reshape(orig.shape)[:] = orig
    out[b:b + cands.size].reshape(cands.shape)[:] = cands


def unpack(packed, wh, ww, h, w, n):
    """The window, orig and cands views of a packed 1-d tensor."""
    a = wh * ww
    b = a + h * w
    return (packed[:a].view(wh, ww), packed[a:b].view(h, w),
            packed[b:b + 2 * n].view(2, n))


def sad_sweep(packed, dims, fast, bitdepth, out=None):
    """SAD of the h x w block against the wh x ww window at each of the n
    (y, x) offsets, all three packed in the 1-d tensor ``packed``
    (``pack``; ``dims`` = (wh, ww, h, w, n)), as int32 [n] on its device.
    On the card one ``me_sad`` launch into ``out`` (int32, at least n;
    made where None); on the CPU ``sad_sweep_plain`` of the buffer's
    views; any other device raises."""
    wh, ww, h, w, n = dims
    if packed.dim() != 1 or packed.dtype != packed_dtype(bitdepth) or \
            packed.numel() < packed_size(wh, ww, h, w, n):
        raise ValueError(
            "me_sad takes a 1-d %s buffer of at least %d elements at %d "
            "bit; got %s %r" % (packed_dtype(bitdepth),
                                packed_size(wh, ww, h, w, n), bitdepth,
                                packed.dtype, tuple(packed.shape)))
    if not kernels.on_cuda(packed):
        return sad_sweep_plain(*unpack(packed, wh, ww, h, w, n), fast,
                               bitdepth)
    from ..kernels import build
    if out is None:
        out = torch.empty(n, dtype=torch.int32, device=packed.device)
    if n:
        rc = build.lib().xvc_me_sad(
            build.ptr(packed), packed.element_size(), wh, ww, h, w, n,
            1 if fast else 0, bitdepth, build.ptr(out),
            build.stream_of(packed))
        build.check(rc, "me_sad")
        kernels.count_launch("me_sad")
    return out[:n]


# Per thread and device: the pinned packed buffer a call fills, its copy
# on the card, the card's result buffer, the pinned result and the event
# its download records.  A call reuses them only after waiting for its own
# download, which follows its upload on the stream.
_STAGING = threading.local()


def _staging(device, dtype, size, n):
    bufs = getattr(_STAGING, "bufs", None)
    if bufs is None:
        bufs = _STAGING.bufs = {}
    key = (str(device), dtype)
    got = bufs.get(key)
    if got is None or got[0].numel() < size or got[2].numel() < n:
        size = max(size, packed_size(WIN, WIN, 64, 64, 2048))
        n = max(n, 2048)
        got = (torch.empty(size, dtype=dtype, pin_memory=True),
               torch.empty(size, dtype=dtype, device=device),
               torch.empty(n, dtype=torch.int32, device=device),
               torch.empty(n, dtype=torch.int32, pin_memory=True),
               torch.cuda.Event())
        bufs[key] = got
    return got


def device_sads(window, orig, cands, fast, bitdepth, device):
    """``sad_sweep`` of numpy window [wh, ww], orig [h, w] and cands [2, N]
    on ``device``, as a numpy int32 [N].  The three are checked and
    packed (``pack``); on the card into the thread's pinned staging, then
    one upload, one ``me_sad`` launch and one download waited for on an
    event; on the CPU into a plain buffer that ``sad_sweep`` reads."""
    _check(window, orig, cands, bitdepth)
    dev = torch.device(device)
    wh, ww = window.shape
    h, w = orig.shape
    n = cands.shape[1]
    dims = (wh, ww, h, w, n)
    dt = packed_dtype(bitdepth)
    size = packed_size(*dims)
    if dev.type != "cuda":
        host = torch.empty(size, dtype=dt)
        pack(window, orig, cands, host.numpy())
        return sad_sweep(host.to(dev), dims, fast, bitdepth).numpy()
    host, buf, out, result, done = _staging(dev, dt, size, n)
    pack(window, orig, cands, host.numpy())
    buf[:size].copy_(host[:size], non_blocking=True)
    sad_sweep(buf, dims, fast, bitdepth, out)
    result[:n].copy_(out[:n], non_blocking=True)
    done.record(torch.cuda.current_stream(dev))
    done.synchronize()
    return result[:n].numpy().copy()


class DeviceSadTable:
    """Precomputed SAD cache for one (CU, reference) TZ search.

    Candidates whose windows fall outside the gather window or that were
    not prefetched fall back to the host metric (identical values)."""

    def __init__(self, search, cu, metric, ref_pic, orig_buffer, device):
        self.search = search
        self.cu = cu
        self.metric = metric
        self.ref_pic = ref_pic
        self.orig = orig_buffer
        self.device = device
        self.cache = {}
        self._host_fn = None

    def _ensure_host(self, qp):
        if self._host_fn is None:
            self._host_fn = self.search._make_dist_fullpel(
                self.cu, qp, self.metric, self.ref_pic, self.orig)
        return self._host_fn

    def prefetch(self, qp, mvs):
        """Batch-evaluate a candidate MV list in one device call."""
        STATS["prefetches"] += 1
        mt = self.metric.type
        fast = mt == met.MetricType.SAD_FAST
        if mt not in (met.MetricType.SAD, met.MetricType.SAD_FAST):
            STATS["host_routed"] += 1
            return  # LIC/affine metrics stay on the host path
        mvs = [m for m in mvs if m not in self.cache]
        if not mvs:
            return
        cu = self.cu
        cx, cy = cu.pos(0)
        w, h = cu.width, cu.height
        # the window starts at the top-left of the candidates' box
        xs = [m[0] for m in mvs]
        ys = [m[1] for m in mvs]
        x0, x1 = min(xs), max(xs)
        y0, y1 = min(ys), max(ys)
        if x1 - x0 + w > WIN or y1 - y0 + h > WIN:
            STATS["host_routed"] += 1
            return  # enormous range: host path
        plane = self.ref_pic.padded_plane(0)
        px, py = self.ref_pic.pad_x[0], self.ref_pic.pad_y[0]
        wy0 = py + cy + y0
        wx0 = px + cx + x0
        if wy0 < 0 or wx0 < 0 or wy0 + WIN > plane.shape[0] or \
                wx0 + WIN > plane.shape[1]:
            STATS["host_routed"] += 1
            return
        # the candidates read the window's top-left box alone
        window = plane[wy0:wy0 + y1 - y0 + h, wx0:wx0 + x1 - x0 + w]
        orig = self.orig[:h, :w]
        cands = np.array([[m[1] - y0 for m in mvs], [m[0] - x0 for m in mvs]],
                         np.int32)
        with span("encode.me_prefetch"):
            sads = device_sads(window, orig, cands, fast,
                               self.metric.bitdepth, self.device)
        STATS["device_calls"] += 1
        STATS["device_candidates"] += len(mvs)
        weight = qp.distortion_weight[0]
        for m, sad in zip(mvs, sads.tolist()):
            self.cache[m] = int(int(sad) * weight)

    def dist(self, qp, mv_x, mv_y):
        v = self.cache.get((mv_x, mv_y))
        if v is not None:
            return v
        STATS["host_dists"] += 1
        return self._ensure_host(qp)(mv_x, mv_y)
