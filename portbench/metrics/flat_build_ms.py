"""The flat path's host half (gpu/flat_recon.py, gpu/dsp.py): span
flat.build, milliseconds a picture of the window, summed over the
clients."""


def read(run):
    return run.span_ms("flat.build")
