#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA decode path (xvc_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases:
  0  device: nvidia-smi name and power limit, torch device name;
  1  build: compile the CUDA kernels from xvc_tpu_torch/kernels/csrc;
  2  kernels: MC, ITX and luma deblock on the card against their plain
     PyTorch versions on the same inputs (numpy seed, main-path shapes),
     bit-exact, each timed with CUDA events beside its plain version;
  3  main path: decode tests/data/bench/hd720_ld.xvc (1280x720, 8
     pictures) with xvc_tpu_torch.codec.decoder.decode_stream on the
     card; every picture must be checksum-conforming and byte-identical
     to the host native decode of xvc_tpu, and every kernel's launch
     count over that decode must be above 0;
  4  goldens: sp_fast, ai64x48 and ai64x48b10 against tests/data.

Any mismatch raises, so the exit code is nonzero.  The second-to-last
lines are a JSON object of per-kernel results and the nvidia-smi line;
the last line is {"ok": true, "device": {...}}.  Without a CUDA device
the script exits with code 2 and prints no result.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")
SEED = 20261016
_BIG = 1 << 20

KERNELS = {
    "mc": ("xvc_tpu_torch/kernels/csrc/mc.cu",
           "xvc_tpu/tpu/pallas_mc.py:43"),
    "itx": ("xvc_tpu_torch/kernels/csrc/itx.cu",
            "xvc_tpu/tpu/flat_recon.py:336"),
    "deblock_luma": ("xvc_tpu_torch/kernels/csrc/deblock.cu",
                     "xvc_tpu/tpu/deblock_jax.py:179"),
}


def log(*args):
    print(*args, flush=True)


def cuda_ms(torch, fn, iters=20):
    """Mean milliseconds per call of fn on the card (CUDA events, after
    one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(torch, a, b):
    if a.shape != b.shape:
        raise AssertionError("shape %r != %r" % (tuple(a.shape),
                                                 tuple(b.shape)))
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


# ---------------------------------------------------------------------------
# Phase 2 inputs
# ---------------------------------------------------------------------------

def _tiles(n, tw, th, B):
    """Disjoint target positions for B jobs of tw x th on an n-wide grid."""
    import numpy as np
    ty, tx = np.divmod(np.arange(B), n)
    return ty * th, tx * tw


def mc_case(rng, luma, wb, hb, bd, short, B, S, Hp, Wp):
    import numpy as np
    nplanes = 1 if luma else 2
    nph = 16 if luma else 32
    taps = 8 if luma else 4
    wh, ww = hb + taps - 1, wb + taps - 1
    planes = rng.randint(0, 1 << bd, (S, Hp, Wp)).astype(np.int16)
    nx = 32
    cy, cx = _tiles(nx, wb, hb, B)
    H, W = int(cy.max()) + hb, nx * wb
    # window origins: mostly inside, some past either edge (clamped)
    ypad = rng.randint(-12, Hp - wh + 12, B)
    xpad = rng.randint(-12, Wp - ww + 12, B)
    fx = rng.randint(0, nph, B) * (rng.rand(B) > 0.25)
    fy = rng.randint(0, nph, B) * (rng.rand(B) > 0.25)
    w = rng.randint(wb // 2 + 1 if wb > 8 else 4, wb + 1, B)
    h = rng.randint(hb // 2 + 1 if hb > 8 else 4, hb + 1, B)
    params = np.stack([rng.randint(0, S, B), ypad, xpad, fx, fy,
                       rng.randint(0, 2 * nplanes, B), cy, cx, w,
                       h]).astype(np.int32)
    params[:, B - B // 16:] = _BIG  # padding lanes
    pred = np.zeros((2 * nplanes, H, W), np.int16)
    mask = np.zeros((nplanes, H, W), np.int16)
    return planes, params, pred, mask


def itx_case(rng, w, h, bd, B, nplanes, gen):
    import numpy as np
    nx = max(1, 512 // w)
    cy, cx = _tiles(nx, w, h, B)
    H, W = int(cy.max()) + h, nx * w
    coeff = rng.randint(-32768, 32768, (B, h, w)).astype(np.int16)
    coeff[rng.rand(B, h, w) < 0.7] = 0
    scale = rng.randint(1, 1 << 22, B).astype(np.int32)
    rows = [rng.randint(0, nplanes, B), cy, cx]
    if gen:
        rows += [rng.randint(0, 5, B), rng.randint(0, 5, B)]
    params = np.stack(rows).astype(np.int32)
    params[:3, B - B // 8:] = _BIG
    if gen:
        params[3:, B - B // 8:] = 0
    resi = np.zeros((nplanes, H, W), np.int32)
    return coeff, scale, params, resi


def deblock_case(rng, H, W, bd):
    """A blocky plane (8x8 steps + small noise) so that strong, weak and
    untouched edges all occur, with random per-edge tc/beta/mask."""
    import numpy as np
    from xvc_tpu.ops import deblock as dbk
    blocks = rng.randint(0, 1 << bd, (H // 8 + 1, W // 8 + 1))
    plane = np.repeat(np.repeat(blocks, 8, 0), 8, 1)[:H, :W]
    step = (1 << (bd - 8)) * 6
    plane = (blocks.mean() + (plane - blocks.mean()) // 16 +
             rng.randint(-step, step + 1, (H, W)))
    plane = np.clip(plane, 0, (1 << bd) - 1).astype(np.int16)
    xs = np.arange(4, W, 4).astype(np.int32)
    G = H // 4
    qp = rng.randint(18, 52, (len(xs), G))
    beta = (np.asarray(dbk.BETA_TABLE)[np.clip(qp, 0, 51)]
            << (bd - 8)).astype(np.int32)
    tc = (np.asarray(dbk.TC_TABLE)[np.clip(qp + 2, 0, 53)]
          << (bd - 8)).astype(np.int32)
    mask = (rng.rand(len(xs), G) < 0.8).astype(np.int32)
    return plane, xs, mask, tc, beta


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_kernels(torch, dev):
    """Each kernel against its plain version on the same CUDA inputs."""
    import numpy as np
    from xvc_tpu import constants as k
    from xvc_tpu.codec.yuv import YuvPicture
    from xvc_tpu_torch.gpu import deblock, flat_recon, itx, mc
    rng = np.random.RandomState(SEED)
    T = lambda a: torch.from_numpy(np.array(a)).to(dev)  # a copy
    pic = YuvPicture(k.ChromaFormat.YUV420, 1280, 720, 8, True)
    res = {}

    # MC: luma and chroma, every bucket, clipped and short, 8 and 10 bit
    err = 0
    buckets = [(8, 8), (16, 16), (32, 32), (64, 64), (8, 16), (16, 8),
               (32, 64), (64, 32), (8, 64), (64, 8)]
    for luma in (True, False):
        Hp, Wp = flat_recon._padded_shape(pic, 0 if luma else 1)
        S = 4 if luma else 8
        for wb, hb in buckets:
            for bd in (8, 10):
                for short in (False, True):
                    planes, params, pred, mask = mc_case(
                        rng, luma, wb, hb, bd, short, 96, S, Hp, Wp)
                    outs = []
                    for fn in (mc.mc_scatter, mc.mc_scatter_plain):
                        p, m = T(pred), T(mask)
                        fn(p, m, T(planes), T(params), wb, hb, luma, bd,
                           True, short)
                        outs.append((p, m))
                    torch.cuda.synchronize()
                    e = max(max_err(torch, outs[0][0], outs[1][0]),
                            max_err(torch, outs[0][1], outs[1][1]))
                    if e:
                        raise AssertionError("mc mismatch %r" % (
                            (luma, wb, hb, bd, short), ))
                    err = max(err, e)
    planes, params, pred, mask = mc_case(
        rng, True, 16, 16, 8, False, 1024, 4,
        *flat_recon._padded_shape(pic, 0))
    args = (T(planes), T(params), 16, 16, True, 8, True, False)
    p, m = T(pred), T(mask)
    res["mc"] = dict(
        max_abs_err=err, shape="luma 16x16 uni, B=1024, 720p store",
        ms=cuda_ms(torch, lambda: mc.mc_scatter(p, m, *args)),
        plain_ms=cuda_ms(torch, lambda: mc.mc_scatter_plain(p, m, *args),
                         5))
    log("phase 2: mc bit-exact over %d cases; 16x16 x1024: kernel %.4f ms,"
        " plain %.4f ms" % (len(buckets) * 8, res["mc"]["ms"],
                            res["mc"]["plain_ms"]))

    # ITX: every family at each size, non-square, dst4, dc and skip
    err = 0
    sizes = [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 8), (8, 4),
             (16, 64), (64, 16), (32, 8), (8, 32), (2, 2), (4, 2), (2, 8)]
    cases = [(w, h, bd, None) for w, h in sizes for bd in (8, 10)]
    cases += [(4, 4, bd, "dst4") for bd in (8, 10)]
    cases += [(w, h, 8, v) for v in ("dc", "skip")
              for w, h in ((4, 4), (8, 8), (32, 32), (16, 4))]
    cases += [(w, h, 10, "gen") for w, h in ((8, 8), (64, 64), (16, 32))]
    for w, h, bd, var in cases:
        coeff, scale, params, resi = itx_case(rng, w, h, bd, 64, 2,
                                              var is None)
        outs = []
        for plain in (False, True):
            r = T(resi)
            a = (r, T(coeff), T(scale), T(params), w, h, bd)
            if plain:
                itx.itx_scatter_plain(*a, True, var, 1, 4)
            elif var is None:
                itx.itx_scatter_gen(*a, True)
            else:
                itx.itx_scatter(*a, 1, 4, var, True)
            outs.append(r)
        torch.cuda.synchronize()
        e = max_err(torch, outs[0], outs[1])
        if e:
            raise AssertionError("itx mismatch %r" % ((w, h, bd, var),))
        err = max(err, e)
    coeff, scale, params, resi = itx_case(rng, 8, 8, 8, 2048, 1, True)
    r = T(resi)
    a = (r, T(coeff), T(scale), T(params), 8, 8, 8)
    res["itx"] = dict(
        max_abs_err=err, shape="gen 8x8, B=2048",
        ms=cuda_ms(torch, lambda: itx.itx_scatter_gen(*a, True)),
        plain_ms=cuda_ms(torch, lambda: itx.itx_scatter_plain(*a, True),
                         5))
    log("phase 2: itx bit-exact over %d cases; 8x8 x2048: kernel %.4f ms, "
        "plain %.4f ms" % (len(cases), res["itx"]["ms"],
                           res["itx"]["plain_ms"]))

    # luma deblock: both directions on a 1280x720 plane
    err = 0
    flags_list = [(False,) * 5, (False, False, False, True, False),
                  (True, False, False, False, True), (False, True, False,
                                                      False, False)]
    for bd in (8, 10):
        for flags in flags_list:
            for direction in (0, 1):
                H, W = (720, 1280) if direction == 0 else (1280, 720)
                plane, xs, mask, tc, beta = deblock_case(rng, H, W, bd)
                outs = []
                for fn in (deblock.luma_pass, deblock.luma_pass_plain):
                    pl = T(plane)
                    fn(pl, T(xs), T(mask), T(tc), T(beta), bd, flags)
                    outs.append(pl)
                torch.cuda.synchronize()
                e = max_err(torch, outs[0], outs[1])
                changed = int((outs[0] != T(plane)).sum().item())
                if e or not changed:
                    raise AssertionError("deblock mismatch or no-op %r" % (
                        (bd, flags, direction, e, changed),))
                err = max(err, e)
    plane, xs, mask, tc, beta = deblock_case(rng, 720, 1280, 8)
    pl = T(plane)
    a = (T(xs), T(mask), T(tc), T(beta), 8, (False,) * 5)
    res["deblock_luma"] = dict(
        max_abs_err=err,
        shape="vertical edges, 1280x720, %d edges" % len(xs),
        ms=cuda_ms(torch, lambda: deblock.luma_pass(pl, *a)),
        plain_ms=cuda_ms(torch, lambda: deblock.luma_pass_plain(pl, *a),
                         3))
    log("phase 2: deblock_luma bit-exact over %d cases; 720p: kernel "
        "%.4f ms, plain %.4f ms" % (2 * len(flags_list) * 2,
                                    res["deblock_luma"]["ms"],
                                    res["deblock_luma"]["plain_ms"]))
    return res


def host_decode(data):
    """xvc_tpu's host native decode, drained with the blocking pull."""
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


def phase_decode(torch, dev):
    from xvc_tpu_torch import kernels
    from xvc_tpu_torch.codec.decoder import decode_stream
    with open(os.path.join(DATA, "bench", "hd720_ld.xvc"), "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    host = host_decode(data)
    host_s = time.perf_counter() - t0
    if len(host) != 8:
        raise AssertionError("host decode returned %d pictures" % len(host))
    decode_stream(data, device=dev)  # warm-up (first-use costs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    pics = decode_stream(data, device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if len(pics) != 8:
        raise AssertionError("device decode returned %d pictures"
                             % len(pics))
    for a, b in zip(pics, host):
        if not a.conforming:
            raise AssertionError("poc %d not conforming" % a.poc)
        if a.bytes != b.bytes or a.poc != b.poc:
            raise AssertionError("poc %d differs from the host decode"
                                 % a.poc)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError("kernel %s was not launched" % name)
    out = dict(pictures=len(pics), seconds=dt, ms_per_picture=dt * 1e3 / 8,
               mpix_per_s=1280 * 720 * 8 / dt / 1e6, host_seconds=host_s,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               launches=launches)
    log("phase 3: hd720_ld 8/8 conforming, byte-identical to host; "
        "%.2f ms/picture, %.3f Mpix/s, peak %d bytes, launches %s "
        "(host native decode %.3f s)" % (
            out["ms_per_picture"], out["mpix_per_s"],
            out["max_memory_allocated"], launches, host_s))
    return out


def phase_goldens(dev):
    from xvc_tpu_torch.codec.decoder import decode_stream
    for name, count in (("sp_fast", 6), ("ai64x48", 3), ("ai64x48b10", 2)):
        with open(os.path.join(DATA, name + ".xvc"), "rb") as f:
            data = f.read()
        with open(os.path.join(DATA, name + "_dec.yuv"), "rb") as f:
            want = f.read()
        pics = decode_stream(data, device=dev)
        if len(pics) != count or not all(p.conforming for p in pics) or \
                b"".join(p.bytes for p in pics) != want:
            raise AssertionError("golden %s differs" % name)
    log("phase 4: sp_fast, ai64x48, ai64x48b10 equal their goldens")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    os.environ.pop("XVC_DSP", None)  # the reference is the host path
    import xvc_tpu_torch  # noqa: F401  (fails outside a checkout)
    from xvc_tpu_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    log("phase 0: %s | torch %s cuda %s | python %s" % (
        name, torch.__version__, torch.version.cuda, sys.version.split()[0]))

    t0 = time.perf_counter()
    build.lib()
    build_s = time.perf_counter() - t0
    log("phase 1: kernels built and loaded in %.2f s" % build_s)
    for line in build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log("  ptxas: " + line.strip())

    res = phase_kernels(torch, dev)
    dec = phase_decode(torch, dev)
    phase_goldens(dev)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    log(json.dumps({"build_seconds": build_s, "decode": dec,
                    "timed_shapes": {n: r["shape"] for n, r in res.items()}}))
    log(json.dumps({"kernels": [
        dict(name=n, route="cuda", source=KERNELS[n][0],
             replaces=KERNELS[n][1], launches=dec["launches"][n],
             max_abs_err=res[n]["max_abs_err"], ms=res[n]["ms"],
             plain_ms=res[n]["plain_ms"])
        for n in ("mc", "itx", "deblock_luma")]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
