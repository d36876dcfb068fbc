"""Device time of the MC and ITX cores, back to back.

Port of ``xvc_tpu/tpu/device_bench.py`` (``mc_device_bench`` :41,
``itx_device_bench`` :92) at the same shapes: 16x16 luma blocks with the
2-D filter, B = 4096, from six 512x768 int16 planes; and 16x16 DCT-2
blocks, B = 4096.  On the card each times ``iters`` launches of the
port's group kernel (``mc.mc_scatter``, ``itx.itx_scatter``) between two
CUDA events, after one warm-up launch; on the CPU (``device="cpu"``) the
plain versions with the host clock.  The JAX module's correction for its
device link's round trip has no counterpart: nothing here crosses a link
between the events.

Each returns the microseconds a call, Mpix/s and GMAC/s, and, on the
card, the shares of the H100 figures that ``PERF.md``'s bounds use: the
bytes the call must move over 3.35 TB/s of HBM, and its operations (two
a multiply-add) over 67 TOP/s (float32 outside the tensor cores, the
rate of int32 arithmetic).  On the CPU the shares are None: a host time
says nothing of the card.
"""
import time

import numpy as np
import torch

from .. import constants as k
from ..engine import resolve_device
from . import itx, mc

HBM_BYTES_S = 3.35e12   # one H100's HBM rate
INT32_OPS_S = 67e12     # one H100's float32 (and int32) rate, no tensor cores


def _seconds_per_call(fn, iters, dev):
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def _result(dev, per_call, pix, macs, nbytes, iters, batch):
    card = dev.type == "cuda"
    return {
        "device": torch.cuda.get_device_name(dev) if card else "cpu",
        "timing": "cuda events, kernel" if card else "host clock, plain "
                  "version",
        "iters": iters, "batch": batch,
        "device_us_per_call": per_call * 1e6,
        "mpix_s": pix / per_call / 1e6,
        "gmac_s": macs / per_call / 1e9,
        "bytes": nbytes,
        "share_of_hbm_3.35TB_s": nbytes / per_call / HBM_BYTES_S
        if card else None,
        "share_of_int32_67TOP_s": 2 * macs / per_call / INT32_OPS_S
        if card else None,
    }


def _grid(batch, block, per_row=64):
    """Disjoint destinations of ``batch`` blocks, ``per_row`` a row."""
    cy, cx = np.divmod(np.arange(batch), per_row)
    rows = -(-batch // per_row)
    return cy * block, cx * block, (rows * block, per_row * block)


def mc_device_bench(batch=4096, iters=64, bitdepth=8, block=16,
                    device=None):
    """Batched luma sub-pel MC (both fractions set: the 2-D filter) from
    six 512x768 planes."""
    dev = resolve_device(device)
    S, Hp, Wp = 6, 512, 768
    taps = 8
    rng = np.random.RandomState(0)
    planes = torch.from_numpy(rng.randint(
        0, 1 << bitdepth, (S, Hp, Wp)).astype(np.int16)).to(dev)
    cy, cx, shape = _grid(batch, block)
    params = torch.from_numpy(np.stack([
        rng.randint(0, S, batch),
        rng.randint(0, Hp - block - taps, batch),
        rng.randint(0, Wp - block - taps, batch),
        rng.randint(1, 16, batch), rng.randint(1, 16, batch),
        np.zeros(batch, np.int64), cy, cx, np.full(batch, block),
        np.full(batch, block)]).astype(np.int32)).to(dev)
    pred = torch.zeros((2,) + shape, dtype=torch.int16, device=dev)
    mask = torch.zeros((1,) + shape, dtype=torch.int16, device=dev)
    per_call = _seconds_per_call(
        lambda: mc.mc_scatter(pred, mask, planes, params, block, block, True,
                              bitdepth, True, False), iters, dev)
    pix = batch * block * block
    # the horizontal pass over the block's rows and the taps - 1 more the
    # vertical pass needs, then the vertical pass
    macs = pix * taps * ((block + taps - 1) / block + 1)
    window = (block + taps - 1) ** 2 * 2
    nbytes = min(batch * window, planes.numel() * 2) + \
        params.numel() * 4 + pix * 2
    return _result(dev, per_call, pix, macs, nbytes, iters, batch)


def itx_device_bench(batch=4096, iters=64, bitdepth=8, block=16,
                     device=None):
    """Batched dequantization and 2-D inverse DCT-2."""
    dev = resolve_device(device)
    rng = np.random.RandomState(1)
    coeff = torch.from_numpy(rng.randint(
        -256, 256, (batch, block, block)).astype(np.int16)).to(dev)
    scale = torch.full((batch,), 64, dtype=torch.int32, device=dev)
    cy, cx, shape = _grid(batch, block)
    params = torch.from_numpy(np.stack([
        np.zeros(batch, np.int64), cy, cx]).astype(np.int32)).to(dev)
    resi = torch.zeros((1,) + shape, dtype=torch.int32, device=dev)
    dct2 = int(k.TransformType.DCT2)
    per_call = _seconds_per_call(
        lambda: itx.itx_scatter(resi, coeff, scale, params, block, block,
                                bitdepth, dct2, dct2, "gen", True),
        iters, dev)
    pix = batch * block * block
    macs = 2 * batch * block ** 3  # two n x n matrix passes
    nbytes = coeff.numel() * 2 + scale.numel() * 4 + params.numel() * 4 + \
        pix * 4
    return _result(dev, per_call, pix, macs, nbytes, iters, batch)


if __name__ == "__main__":
    import json
    print(json.dumps({"mc": mc_device_bench(), "itx": itx_device_bench()}))
