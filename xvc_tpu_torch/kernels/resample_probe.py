"""Where the fused resample kernel spends its time, on the card.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python -m xvc_tpu_torch.kernels.resample_probe

It copies the package into ``build/resample_probe/<variant>/`` with
``kernels/csrc/resample.cu`` cut down by a textual edit, builds each copy
in a child process and times ``gpu.resample.resample_picture`` there on
random 4:2:0 pictures that sit in the frame store (device time from
``torch.profiler``, the mean of 50 launches after a warm-up):

- ``fused``: the kernel as it is (held to ``resample_plain``);
- ``empty``: every block returns once it knows its tile (the launch and
  the blocks' start);
- ``load_only``: every block copies its window span into shared memory,
  waits for it and returns (no pass runs);
- ``no_load``: the passes run on whatever shared memory holds (no span
  is copied);
- ``traced``: the kernel as it is, each block recording its SM, its
  start, the moment its copies are issued and its end
  (``%globaltimer``), for one launch at 1920x1080 -> 1280x720.

It prints one JSON line per variant, then the card's name and power
limit.
"""
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CASES = ((1920, 1080, 1280, 720, 8), (1280, 720, 1920, 1080, 8),
         (2560, 1440, 1920, 1080, 10), (1920, 1080, 640, 360, 8))

_LAST_PASS = ("    passes<1>(P, span16, pitch, shift, nrows, chunk, ry0, vx0, "
              "nvx, oy0,\n              ox0, ny, nx, tmp);\n}")
_GUARD = '''  if (nrows > P.rows_cap || nwords > P.pitch_words) return;'''
_ISSUED = '''  // window column cx lies at span column cx - cx0 + (e0 & 1)'''
_COPY = ("      for (int w = lane; w < nwords; w += 32) "
         "cp_async4(s + w, g + w);")
_KERNEL = '''    resample_picture(const __grid_constant__ Params prm) {
  extern __shared__ __align__(16) unsigned char smem[];'''
_TRACE = '''__device__ unsigned long long g_trace[4096][4];
__device__ __forceinline__ unsigned long long probe_time() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
'''
# variant -> [(text of resample.cu, its replacement)]; None: append
VARIANTS = {
    "fused": [],
    "empty": [(_GUARD, _GUARD + "\n  if (P.maxv >= 0) return;")],
    "load_only": [(_ISSUED, "  cp_async_wait(0);\n  __syncthreads();\n"
                   "  if (P.maxv >= 0) return;\n" + _ISSUED)],
    "no_load": [(_COPY, "      if (nwords < 0) cp_async4(s, g);")],
    "traced": [
        ("__global__ void __launch_bounds__(kThreads)",
         _TRACE + "__global__ void __launch_bounds__(kThreads)"),
        (_KERNEL, _KERNEL + "\n  const unsigned long long t0 = "
         "probe_time();"),
        (_ISSUED,
         "  const unsigned long long t1 = probe_time();\n" + _ISSUED),
        (_LAST_PASS, _LAST_PASS[:-2] + '''
  __syncthreads();
  if (threadIdx.x == 0 && blockIdx.x < 4096) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    g_trace[blockIdx.x][0] = sm;
    g_trace[blockIdx.x][1] = t0;
    g_trace[blockIdx.x][2] = t1;
    g_trace[blockIdx.x][3] = probe_time();
  }
}'''),
        (None, '''
extern "C" int xvc_resample_trace(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace));
}
''')],
}


def make_variant(name):
    """A copy of the package under build/resample_probe/<name> with the
    variant's edits; returns its root."""
    root = os.path.join(ROOT, "build", "resample_probe", name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "xvc_tpu_torch"),
                    os.path.join(root, "xvc_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(root, "xvc_tpu_torch", "kernels", "csrc",
                        "resample.cu")
    with open(path) as f:
        src = f.read()
    for old, new in VARIANTS[name]:
        if old is None:
            src += new
            continue
        if src.count(old) != 1:
            raise RuntimeError("variant %s: the text to replace is not in "
                               "resample.cu once: %r" % (name, old[:60]))
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    return root


def stored_picture(torch, dev, width, height, bd, seed):
    """A random 4:2:0 picture with its border padded and its planes in a
    frame-store slot on ``dev``, as the decoder leaves it."""
    import numpy as np
    from xvc_tpu_torch.codec.yuv import YuvPicture
    from xvc_tpu_torch.gpu import flat_recon
    rng = np.random.RandomState(seed)
    pic = YuvPicture(1, width, height, bd, True)
    for c in range(3):
        pic.plane_view(c)[:] = rng.randint(0, 1 << bd,
                                           pic.plane_view(c).shape)
    pic.pad_border()
    flat_recon.frame_store_put(pic, flat_recon.device_pad_planes(pic, {
        c: torch.from_numpy(pic.plane_view(c).astype(np.int16)).to(dev)
        for c in range(3)}), dev)
    return pic


def picture_jobs(torch, rsm, pic, dw, dh, bd, dev):
    """PlaneJobs of the three planes into one packed buffer."""
    buf = torch.empty(dw * dh * 3 // 2, device=dev,
                      dtype=torch.uint8 if bd <= 8 else torch.int16)
    jobs, off = [], 0
    for c in range(3):
        w, h = (dw, dh) if c == 0 else (dw // 2, dh // 2)
        jobs.append(rsm.PlaneJob(c, pic.pad_y[c], pic.pad_x[c],
                                 pic.width[c], pic.height[c], w, h,
                                 buf[off:off + w * h].view(h, w)))
        off += w * h
    return buf, jobs


def child(name):
    """Time the variant whose package is first on sys.path."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import xvc_tpu_torch
    from xvc_tpu_torch.gpu import flat_recon
    from xvc_tpu_torch.gpu import resample as rsm
    if not xvc_tpu_torch.__file__.startswith(sys.path[0] + os.sep):
        raise AssertionError("imported " + xvc_tpu_torch.__file__)
    dev = torch.device("cuda", 0)
    out = {"variant": name}
    for sw, sh, dw, dh, bd in CASES:
        pic = stored_picture(torch, dev, sw, sh, bd, sw + dw)
        buf, jobs = picture_jobs(torch, rsm, pic, dw, dh, bd, dev)
        fn = lambda: rsm.resample_picture(pic, jobs, bd, bd, dev, True)
        fn()
        torch.cuda.synchronize()
        row = {}
        if name == "fused":
            want = torch.cat([rsm.resample_plain(
                torch.from_numpy(rsm.cut_window(
                    pic.padded_plane(j.comp), j.origin_y, j.origin_x,
                    j.src_w, j.src_h)).to(dev), bd, j.dst_w, j.dst_h,
                bd).reshape(-1) for j in jobs])
            row["equal"] = bool(torch.equal(buf.to(torch.int32) & 0xFFFF,
                                            want))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", 0) or 0
                 for e in prof.key_averages() if "resample" in e.key)
        row["device_ms"] = us / 1e3 / 50
        row["tile"] = list(rsm.plan(sw, sh, bd, dw, dh, bd).tiles)
        if name == "traced" and (sw, dw) == (1920, 1280):
            row["trace"] = trace(torch, rsm, fn, jobs, bd)
        out["%dx%d->%dx%d@%d" % (sw, sh, dw, dh, bd)] = row
        flat_recon.release_slot(pic)
    print("PROBE " + json.dumps(out), flush=True)


def trace(torch, rsm, fn, jobs, bd):
    """Per-block times of one launch (ns; percentiles 0, 50, 90, 100)."""
    import numpy as np
    from xvc_tpu_torch.kernels import build
    lib = build.lib()
    lib.xvc_resample_trace.argtypes = [build.ctypes.c_void_p]
    fn()
    torch.cuda.synchronize()
    tr = np.zeros((4096, 4), np.uint64)
    if lib.xvc_resample_trace(tr.ctypes.data):
        raise RuntimeError("xvc_resample_trace failed")
    n = 0
    for j in jobs:
        t = rsm.plan(j.src_w, j.src_h, bd, j.dst_w, j.dst_h, bd).tiles
        n += -(-j.out.shape[0] // t.tile_h) * -(-j.out.shape[1] // t.tile_w)
    t = tr[:n].astype(np.int64)
    first = t[:, 1].min()
    pct = lambda a: [int(np.percentile(a, q)) for q in (0, 50, 90, 100)]
    per_sm = np.bincount(t[:, 0])
    return dict(blocks=int(n), kernel_ns=int((t[:, 3] - first).max()),
                sms=int((per_sm > 0).sum()),
                sms_by_blocks=np.bincount(per_sm[per_sm > 0]).tolist(),
                start_ns=pct(t[:, 1] - first),
                copies_issued_ns=pct(t[:, 2] - t[:, 1]),
                block_ns=pct(t[:, 3] - t[:, 1]))


def main():
    for name in VARIANTS:
        root = make_variant(name)
        res = subprocess.run(
            [sys.executable, "-c",
             "import sys; sys.path.insert(0, %r); "
             "from xvc_tpu_torch.kernels import resample_probe; "
             "resample_probe.child(%r)" % (root, name)],
            capture_output=True, text=True, timeout=600, cwd=root)
        lines = [ln for ln in res.stdout.splitlines()
                 if ln.startswith("PROBE ")]
        if res.returncode or not lines:
            raise RuntimeError("variant %s failed:\n%s" % (
                name, res.stderr[-3000:]))
        print(lines[-1][len("PROBE "):], flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
