"""The native parse (native/pic.py, native/csrc): span decode.parse,
milliseconds a picture of the window, summed over the clients."""


def read(run):
    return run.span_ms("decode.parse")
