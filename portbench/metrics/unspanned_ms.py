"""Client time that no span of the port covers: in each client's trace,
the time inside its calls into the session (``CALLS``; not ``sleep``)
that no range of a port span covers, clipped to the window, summed over
the clients, in milliseconds a picture of the window.  The spans are
checked against each other: work the port does outside every span shows
here."""
from .. import stats

CALLS = ("new_session", "decode_nal", "get_picture", "flush")
# the client's own rows of its trace that are no span of the port
NOT_SPANS = CALLS + ("sleep",)


def uncovered_s(rows, lo, hi):
    """Seconds of ``[lo, hi]`` inside a call of ``rows`` ([name, start,
    end]) that no span row covers."""
    calls = [(s, e) for n, s, e in rows if n in CALLS]
    spans = [(s, e) for n, s, e in rows if n not in NOT_SPANS]
    return (stats.union_seconds(calls + spans, lo, hi) -
            stats.union_seconds(spans, lo, hi))


def read(run):
    tr = run.trace
    if tr is None or not run.pictures or not any(
            n in CALLS for rows in tr.host.values() for n, _, _ in rows):
        return None
    return sum(uncovered_s(rows, tr.lo, tr.hi)
               for rows in tr.host.values()) * 1e3 / run.pictures
