"""Whether the pictures the clients were handed are the reference's.

Every picture a client is handed from the window's start on (and the
streams it finishes after the close) is compared with the reference
decoder's picture at the same place in the stream: its bytes as handed
out, by their sha256, and its conformance flag.  A picture that a finished
stream or a due live picture never delivered is missing.  The decode is
exact, so each number's limit is 0.
"""

LIMITS = {"mismatched": 0, "nonconforming": 0, "missing": 0}


def _judge(pic, want, counts):
    """Counts the picture's faults; 1 if it has any, else 0."""
    wrong = pic.digest != want["digest"]
    counts["mismatched"] += wrong
    counts["nonconforming"] += not pic.conforming
    return int(wrong or not pic.conforming)


def compare(clients, kind, ref):
    """(attempted, failed, counts) over every client's pictures."""
    n = len(ref)
    counts = dict.fromkeys(LIMITS, 0)
    attempted = failed = 0
    for c in clients:
        if kind == "closed":
            at = 0
            for _, got in c.streams:
                for i in range(got):
                    pic = c.delivered[at + i][1]
                    if i < n:
                        failed += _judge(pic, ref[i], counts)
                    else:
                        counts["mismatched"] += 1
                        failed += 1
                counts["missing"] += max(n - got, 0)
                attempted += max(n, got)
                at += got
        else:
            due = len(c.schedule)
            for k, (_, pic) in enumerate(c.delivered):
                failed += _judge(pic, ref[(c.offset + k) % n], counts)
            counts["missing"] += max(due - len(c.delivered), 0)
            attempted += max(due, len(c.delivered))
    return attempted, failed + counts["missing"], counts


def verdict(attempted, counts):
    return attempted > 0 and all(counts[n] <= LIMITS[n] for n in LIMITS)


def check_lines(counts):
    """Each number compared beside its limit."""
    return {n: {"value": counts[n], "limit": LIMITS[n]} for n in LIMITS}
