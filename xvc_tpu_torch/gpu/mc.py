"""Batched sub-pel motion compensation + scatter (kernel 1).

Port of ``xvc_tpu/tpu/pallas_mc.py`` (the Pallas MC kernel), of the MC
core of ``xvc_tpu/tpu/dsp.py`` and of the scatter in
``xvc_tpu/tpu/flat_recon.py make_mc_scatter``.  ``mc_scatter`` launches
``kernels/csrc/mc.cu`` for tensors on the card and runs
``mc_scatter_plain`` for tensors on the CPU.  Both read the frame-store
stack directly (luma (S, Hp, Wp), chroma reshaped to (2S, Hp, Wp)) and
the job parameters (10, B) int32 ``[stack_idx, ypad, xpad, fx, fy, chan,
cy, cx, w, h]``, and write the valid w x h region of each prediction
into ``pred[chan]``.  Lanes carrying the ``_BIG`` sentinel write nothing.
"""
import torch

from ..codec import inter_mc as mc_tab
from .. import kernels
from . import dsp


def _check(pred, mask, planes, params):
    kernels.require(pred, torch.int16, 3, "pred")
    kernels.require(mask, torch.int16, 3, "mask")
    kernels.require(planes, torch.int16, 3, "planes")
    kernels.require(params, torch.int32, 2, "params")
    if params.shape[0] != 10:
        raise ValueError("params must be (10, B), got %r"
                         % (tuple(params.shape),))
    if pred.shape[1:] != mask.shape[1:] or \
            pred.shape[0] != 2 * mask.shape[0]:
        raise ValueError("pred (2n, H, W) and mask (n, H, W) disagree: %r %r"
                         % (tuple(pred.shape), tuple(mask.shape)))


def mc_scatter(pred, mask, planes, params, wb, hb, luma, bitdepth,
               high_prec, short_out):
    """In place: predict the jobs of one (wb, hb, luma, short) group and
    store them into ``pred`` (2*nplanes, H, W) int16; in short groups
    slot-1 jobs also set ``mask`` (nplanes, H, W) to 1."""
    _check(pred, mask, planes, params)
    if not kernels.on_cuda(pred, mask, planes, params):
        mc_scatter_plain(pred, mask, planes, params, wb, hb, luma, bitdepth,
                         high_prec, short_out)
        return
    from ..kernels import build
    taps = mc_tab.NUM_TAPS_LUMA if luma else mc_tab.NUM_TAPS_CHROMA
    table = dsp._filter_table(luma, high_prec)
    R, Hp, Wp = planes.shape
    nchan, H, W = pred.shape
    if Hp < hb + taps - 1 or Wp < wb + taps - 1:
        raise ValueError("reference planes %r smaller than a window"
                         % ((Hp, Wp),))
    rc = build.lib().xvc_mc_scatter(
        build.ptr(planes), R, Hp, Wp, build.ptr(params), params.shape[1],
        wb, hb, taps, table.shape[0], table.ctypes.data, bitdepth,
        1 if short_out else 0, build.ptr(pred), nchan, H, W,
        build.ptr(mask), mask.shape[0], build.stream_of(pred))
    build.check(rc, "mc_scatter")
    kernels.LAUNCHES["mc"] += 1


def mc_scatter_plain(pred, mask, planes, params, wb, hb, luma, bitdepth,
                     high_prec, short_out):
    """Plain PyTorch version of ``mc_scatter`` (same result)."""
    core = dsp._mc_core_builder(wb, hb, luma, bitdepth, high_prec,
                                short_out)
    out = core(planes, params[0], params[1], params[2], params[3],
               params[4])
    nchan, H, W = pred.shape
    nplanes = mask.shape[0]
    p = params.long()
    chan, cy, cx, w, h = p[5], p[6], p[7], p[8], p[9]
    dev = pred.device
    ar_h = torch.arange(hb, device=dev)
    ar_w = torch.arange(wb, device=dev)
    yy = cy[:, None] + ar_h[None, :]
    xx = cx[:, None] + ar_w[None, :]
    ok_y = (ar_h[None, :] < h[:, None]) & (yy >= 0) & (yy < H)
    ok_x = (ar_w[None, :] < w[:, None]) & (xx >= 0) & (xx < W)
    lane = (chan >= 0) & (chan < nchan)
    keep = lane[:, None, None] & ok_y[:, :, None] & ok_x[:, None, :]
    b, i, j = keep.nonzero(as_tuple=True)
    pred[chan[b], yy[b, i], xx[b, j]] = out[b, i, j]
    if short_out:
        sel = chan[b] >= nplanes
        b, i, j = b[sel], i[sel], j[sel]
        mask[chan[b] - nplanes, yy[b, i], xx[b, j]] = 1

