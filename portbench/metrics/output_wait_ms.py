"""The session's output queue: row session.output_wait of the port's span
table (from the return of a picture's decode to its hand-out by
DecoderSession.get_picture), milliseconds a picture of the window,
summed over the clients."""


def read(run):
    return run.span_ms("session.output_wait")
