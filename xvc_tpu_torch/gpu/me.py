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
A device call reads the reference picture's padded luma where it lies
on the device: one copy a picture and device (``reference_luma``), made
at the first sweep that reads it there and dropped when the picture's
planes get new content.  A sweep (``sad_sweep``) sends only the block
and the offsets; on the card they go into mapped pinned host memory that
the ``me_sad`` launch reads in place, and the SADs come back the same
way: one device operation and an event wait.  On the CPU the same call is
``sad_sweep_plain``.  ``STATS`` counts the calls, where they went, and
the reference copies.  A picture pinned to a mesh slot (the encode
pipeline's, ``engine.set_pin_device``; ``xvc_tpu/tpu/me.py:150-158``)
runs its sweeps on the slot's device and stream.
"""
import contextlib
import ctypes
import threading

import numpy as np
import torch

from .. import kernels
from ..engine import pin_for
from ..ops import metrics as met
from ..parallel.mesh import placed
from ..profiling import span

WIN = 192  # the gather window of the reference (me.py _WIN)
MAX_SIDE = 64  # the largest block the kernel takes (a CU side)

# prefetches: every call; host_routed: calls the routing leaves to the
# host metric; device_calls / device_candidates: calls on the encoder's
# device and the candidates they evaluated; host_dists: dist() lookups of
# a vector that was never prefetched; reference_uploads: copies of a
# reference picture's padded luma made on the device
STATS = {"prefetches": 0, "host_routed": 0, "device_calls": 0,
         "device_candidates": 0, "host_dists": 0, "reference_uploads": 0}
_STATS_LOCK = threading.Lock()


def reset_stats():
    with _STATS_LOCK:
        for key in STATS:
            STATS[key] = 0


def _count(**adds):
    """Add to ``STATS`` under its lock (the encoder's picture threads
    share it)."""
    with _STATS_LOCK:
        for key, v in adds.items():
            STATS[key] += v


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


def packed_dtype(bitdepth):
    """The element type of the resident plane and of the staged block:
    int16 where the samples fit (bitdepth <= 15), int32 above."""
    return torch.int16 if bitdepth <= 15 else torch.int32


def _np_dtype(bitdepth):
    return np.dtype(np.int16 if bitdepth <= 15 else np.int32)


def sad_sweep_plain(plane, oy, ox, orig, cands, fast, bitdepth):
    """The plain version of ``sad_sweep``: the SAD of ``orig`` [h, w]
    against the block of ``plane`` at (oy + y, ox + x) for each (y, x) of
    ``cands`` [2, N], as int32 [N] on the plane's device: int64 gathers,
    |orig - block|, a sum that wraps to int32 (as the JAX function's
    ``jnp.sum`` does; ``torch.sum`` of int32 would give int64), doubled
    for SAD_FAST, then ``>> (bitdepth - 8)``."""
    h, w = orig.shape
    step = 2 if fast else 1
    dev = plane.device
    rows = torch.arange(0, h, step, device=dev)
    cols = torch.arange(w, device=dev)
    y = cands[0].to(dev).long() + oy
    x = cands[1].to(dev).long() + ox
    blk = plane.long()[(y[:, None, None] + rows[None, :, None]),
                       (x[:, None, None] + cols[None, None, :])]
    d = (orig.to(dev).long()[rows][None] - blk).abs()
    s = _wrap32(d.sum((1, 2)))
    if fast:
        s = _wrap32(s * 2)
    return (s >> (bitdepth - 8)).to(torch.int32)


def _check(plane, oy, ox, orig, cands, bitdepth):
    """The inputs of ``sad_sweep``: shapes, bit depth, element type, and
    every candidate's block inside the plane (the kernel reads no sample
    outside it)."""
    if plane.dim() != 2 or orig.ndim != 2 or cands.ndim != 2 or \
            cands.shape[0] != 2 or not 8 <= bitdepth <= 16 or \
            not 1 <= orig.shape[0] <= MAX_SIDE or \
            not 1 <= orig.shape[1] <= MAX_SIDE or \
            plane.dtype != packed_dtype(bitdepth) or plane.stride(1) != 1:
        raise ValueError(
            "me_sad takes a row-major plane [H, W] of packed_dtype(bitdepth),"
            " orig [h, w] of at most %d x %d, cands [2, N] and a bit depth "
            "of 8 to 16; got %s %r, %r, %r, %r" % (
                MAX_SIDE, MAX_SIDE, plane.dtype, tuple(plane.shape),
                orig.shape, cands.shape, bitdepth))
    h, w = orig.shape
    if cands.shape[1]:
        lo = cands.min(axis=1)
        hi = cands.max(axis=1)
        if oy + int(lo[0]) < 0 or ox + int(lo[1]) < 0 or \
                oy + int(hi[0]) + h > plane.shape[0] or \
                ox + int(hi[1]) + w > plane.shape[1]:
            raise ValueError("me_sad: a candidate's block leaves the plane")


def staging_bytes(h, w, n, bitdepth):
    """The bytes of a sweep's staging: the offsets, then the block."""
    return 8 * n + h * w * _np_dtype(bitdepth).itemsize


def stage_sweep(buf, orig, cands, bitdepth):
    """Write numpy ``orig`` [h, w] and ``cands`` [2, N] into the numpy
    uint8 ``buf`` in the kernel's staging layout: the offsets y [N] and
    x [N] as int32, then the block in ``packed_dtype(bitdepth)``.
    Returns the bytes written."""
    n = cands.shape[1]
    dtype = _np_dtype(bitdepth)
    end = staging_bytes(orig.shape[0], orig.shape[1], n, bitdepth)
    buf[:8 * n].view(np.int32).reshape(2, n)[:] = cands
    buf[8 * n:end].view(dtype).reshape(orig.shape)[:] = orig
    return end


def _host_alloc(nbytes):
    """``nbytes`` of mapped pinned host memory: (host address, the
    address the card reads it at)."""
    from ..kernels import build
    host, dev = ctypes.c_void_p(), ctypes.c_void_p()
    rc = build.lib().xvc_host_alloc(nbytes, ctypes.byref(host),
                                    ctypes.byref(dev))
    if rc != 0:
        raise RuntimeError("me_sad: mapped host memory of %d bytes failed "
                           "with CUDA error %d" % (nbytes, rc))
    return host.value, dev.value


class _Staging:
    """A sweep's mapped pinned host memory: ``inp`` (``stage_sweep``'s
    layout; the kernel reads it in place) and ``out`` (int32 SADs, which
    the kernel writes in place), with the event a call waits on."""

    def __init__(self, in_bytes, n):
        self.in_bytes, self.n = in_bytes, n
        self.in_host, self.in_dev = _host_alloc(in_bytes)
        try:
            self.out_host, self.out_dev = _host_alloc(4 * n)
        except RuntimeError:
            self.free()
            raise
        self.inp = np.ctypeslib.as_array(
            ctypes.cast(self.in_host, ctypes.POINTER(ctypes.c_uint8)),
            (in_bytes,))
        self.out = np.ctypeslib.as_array(
            ctypes.cast(self.out_host, ctypes.POINTER(ctypes.c_int32)),
            (n,))
        self.done = torch.cuda.Event()

    def free(self):
        from ..kernels import build
        for name in ("in_host", "out_host"):
            addr = getattr(self, name, None)
            if addr:
                build.lib().xvc_host_free(ctypes.c_void_p(addr))
                setattr(self, name, None)


# Free staging, by device.  A call takes one for its own use and gives it
# back after waiting for its launch, so a buffer is never shared while a
# kernel may read it; there are as many as calls ever ran at once, and
# none is freed by a finalizer (ROADMAP hazard 11).
_POOL = {}
_POOL_LOCK = threading.Lock()
_MIN_BYTES = 8 * 4096 + 4 * MAX_SIDE * MAX_SIDE
_MIN_N = 4096


def _take_staging(device, in_bytes, n):
    with _POOL_LOCK:
        free = _POOL.setdefault(device, [])
        st = free.pop() if free else None
    if st is not None and (st.in_bytes < in_bytes or st.n < n):
        in_bytes = max(in_bytes, 2 * st.in_bytes)
        n = max(n, 2 * st.n)
        st.free()
        st = None
    if st is None:
        st = _Staging(max(in_bytes, _MIN_BYTES), max(n, _MIN_N))
    return st


def _give_staging(device, st):
    with _POOL_LOCK:
        _POOL[device].append(st)


def _launch(plane, oy, ox, staging, h, w, n, fast, bitdepth, out):
    """One ``me_sad`` launch on the plane's current stream: ``staging``
    and ``out`` are addresses the card reads and writes (mapped host
    memory or device memory)."""
    from ..kernels import build
    rc = build.lib().xvc_me_sad(
        build.ptr(plane), plane.element_size(), plane.shape[0],
        plane.shape[1], plane.stride(0), int(oy), int(ox),
        ctypes.c_void_p(staging), int(h), int(w), int(n), 1 if fast else 0,
        int(bitdepth), ctypes.c_void_p(out), build.stream_of(plane))
    build.check(rc, "me_sad")
    kernels.count_launch("me_sad")


def sad_sweep(plane, oy, ox, orig, cands, fast, bitdepth):
    """SAD of numpy ``orig`` [h, w] against the block of ``plane`` (a
    tensor: a reference's padded luma, ``reference_luma``) whose top-left
    sample is (oy + y, ox + x), for each (y, x) of numpy ``cands`` [2, N],
    as a numpy int32 [N].  On the card the offsets and the block go into
    mapped pinned staging, one ``me_sad`` launch reads them there and
    writes the SADs to mapped memory, and the call waits on an event; on
    the CPU ``sad_sweep_plain``; any other device raises."""
    _check(plane, oy, ox, orig, cands, bitdepth)
    if not kernels.on_cuda(plane):
        return sad_sweep_plain(plane, oy, ox, torch.from_numpy(orig),
                               torch.from_numpy(cands), fast,
                               bitdepth).numpy()
    n = cands.shape[1]
    if not n:
        return np.zeros(0, np.int32)
    h, w = orig.shape
    device = plane.device.index
    st = _take_staging(device, staging_bytes(h, w, n, bitdepth), n)
    try:
        stage_sweep(st.inp, orig, cands, bitdepth)
        _launch(plane, oy, ox, st.in_dev, h, w, n, fast, bitdepth,
                st.out_dev)
        st.done.record(torch.cuda.current_stream(plane.device))
        st.done.synchronize()
        return st.out[:n].copy()
    finally:
        _give_staging(device, st)


_RESIDENT_LOCK = threading.Lock()


def _resolve(device):
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def reference_luma(ref_pic, device):
    """``ref_pic``'s padded luma on ``device`` in ``packed_dtype``: the
    copy on that device kept on the picture (``YuvPicture.device_luma``:
    (generation, {device: plane}), one copy a device) while the
    picture's ``luma_generation`` is the one it was taken at, else a new
    one (counted in ``STATS["reference_uploads"]``).  The upload is a
    copy from pageable memory, complete when it returns, so a slot on
    another stream of the same card reads it as it is.  The padded plane
    is copied as the host holds it, border included: a picture that was
    never padded keeps its buffer's old border, which the reference
    reads too (ROADMAP hazard 10).  Made under one lock, so threads that
    share a reference upload it once."""
    dev = _resolve(device)
    with _RESIDENT_LOCK:
        gen = ref_pic.luma_generation
        got = ref_pic.device_luma
        if got is None or got[0] != gen:
            got = ref_pic.device_luma = (gen, {})
        plane = got[1].get(dev)
        if plane is not None:
            return plane
        with span("encode.me_reference"):
            plane = torch.from_numpy(ref_pic.padded_plane(0).astype(
                _np_dtype(ref_pic.bitdepth))).to(dev)
        got[1][dev] = plane
        _count(reference_uploads=1)
        return plane


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
        _count(prefetches=1)
        mt = self.metric.type
        fast = mt == met.MetricType.SAD_FAST
        if mt not in (met.MetricType.SAD, met.MetricType.SAD_FAST):
            _count(host_routed=1)
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
            _count(host_routed=1)
            return  # enormous range: host path
        ph, pw = self.ref_pic.padded_plane(0).shape
        px, py = self.ref_pic.pad_x[0], self.ref_pic.pad_y[0]
        wy0 = py + cy + y0
        wx0 = px + cx + x0
        if wy0 < 0 or wx0 < 0 or wy0 + WIN > ph or wx0 + WIN > pw:
            _count(host_routed=1)
            return
        cands = np.array([[m[1] - y0 for m in mvs], [m[0] - x0 for m in mvs]],
                         np.int32)
        # a picture pinned to a mesh slot sweeps on the slot
        pin = pin_for(self.device)
        with span("encode.me_prefetch"), \
                contextlib.nullcontext() if pin is None else placed(pin):
            plane = reference_luma(self.ref_pic, self.device if pin is None
                                   else pin.device)
            sads = sad_sweep(plane, wy0, wx0, self.orig[:h, :w], cands, fast,
                             self.metric.bitdepth)
        _count(device_calls=1, device_candidates=len(mvs))
        weight = qp.distortion_weight[0]
        for m, sad in zip(mvs, sads.tolist()):
            self.cache[m] = int(int(sad) * weight)

    def dist(self, qp, mv_x, mv_y):
        v = self.cache.get((mv_x, mv_y))
        if v is not None:
            return v
        _count(host_dists=1)
        return self._ensure_host(qp)(mv_x, mv_y)
