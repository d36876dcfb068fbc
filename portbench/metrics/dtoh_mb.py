"""Device-to-host bytes: the counter row xfer.dtoh.bytes of the port's
span table, in MB (10^6 bytes) a picture of the window, summed over the
clients."""


def read(run):
    row = run.spans.get("xfer.dtoh.bytes")
    if row is None or not run.pictures:
        return None
    return row["calls"] / 1e6 / run.pictures
