"""The host blocked on the card before a download (gpu/dsp.py
download): span device.wait, milliseconds a picture of the window,
summed over the clients."""


def read(run):
    return run.span_ms("device.wait")
