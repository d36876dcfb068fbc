"""Deblocking's host side (gpu/deblock.py, ops/deblock.py): spans
deblock.meta and deblock.upload, milliseconds a picture of the window,
summed over the clients."""


def read(run):
    return run.span_ms("deblock.meta", "deblock.upload")
