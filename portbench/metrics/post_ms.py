"""Post and output (codec/picture_decoder.py, codec/output.py,
codec/checksum.py): span decode.post, milliseconds a picture of the
window, summed over the clients."""


def read(run):
    return run.span_ms("decode.post")
