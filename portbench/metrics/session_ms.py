"""The decoder session's own work (api.DecoderSession, codec/decoder.py:
headers, reference lists, picture decoders, the output picture): span
decode.session, milliseconds a picture of the window, summed over the
clients."""


def read(run):
    return run.span_ms("decode.session")
