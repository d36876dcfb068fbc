"""Reads a traced window: the device's operations, and what the clients
were doing meanwhile.

Each client traces itself with the port's own trace
(``xvc_tpu_torch.profiling.start_trace`` / ``stop_trace``:
``torch.profiler`` over the card's kernels and copies, and the port's
spans as host ranges) and hands back its device operations and host
ranges on the ``perf_counter`` clock (``client.read_trace``).  Here they
are put together over the window: the device's busy time is the union
of every client's operations, since the clients share the card, and an
idle stretch is named by the innermost span or call that each client had
open in its middle.
"""
import bisect
import collections
import math
import re

from . import stats


def kernel_name(name):
    """A device event's name without its return type, namespaces, template
    arguments and parameters: ``void (anonymous namespace)::luma_walk<4>(
    short*, ...)`` -> ``luma_walk``; a copy keeps its name (``Memcpy
    DtoH``)."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::",
                                                  "")
    name = re.split(r"[<(]", name, 1)[0]
    return name.rsplit("::", 1)[-1].strip()


class Trace:
    """The window ``(lo, hi)`` and the device's events, in seconds."""

    def __init__(self, device, window):
        self.device = device          # [(name, start, end)]
        self.host = {}                # client -> [(name, start, end)]
        self.lo, self.hi = window

    def add_host(self, client, rows):
        """A client's calls and spans, ``[(name, start, end)]``."""
        self.host.setdefault(client, []).extend(rows)
        self._by_start = None

    @property
    def window_s(self):
        return self.hi - self.lo

    def device_intervals(self):
        return [(s, e) for _, s, e in self.device]

    def busy_s(self):
        return stats.union_seconds(self.device_intervals(), self.lo, self.hi)

    def device_seconds_by_name(self):
        out = collections.Counter()
        for name, s, e in self.device:
            s, e = max(s, self.lo), min(e, self.hi)
            if e > s:
                out[kernel_name(name)] += e - s
        return out

    def launches(self, kernel):
        """Device events of ``kernel`` that start inside the window."""
        return sum(1 for name, s, _ in self.device
                   if kernel_name(name) == kernel and self.lo <= s < self.hi)

    def _sorted_host(self):
        """Each client's rows by start, with the latest end so far."""
        if getattr(self, "_by_start", None) is None:
            self._by_start = []
            for rows in self.host.values():
                rows = sorted(rows, key=lambda r: r[1])
                ends, top = [], -math.inf
                for _, _, e in rows:
                    top = max(top, e)
                    ends.append(top)
                self._by_start.append(([r[1] for r in rows], rows, ends))
        return self._by_start

    def host_at(self, t):
        """What the clients were doing at ``t``: for each client the
        innermost span or call open then (the one that opened last),
        counted, as ``flat.build x2 + sleep x2``."""
        counts = collections.Counter()
        for starts, rows, ends in self._sorted_host():
            i = bisect.bisect_right(starts, t) - 1
            while i >= 0 and ends[i] > t:
                if rows[i][2] > t:
                    counts[rows[i][0]] += 1
                    break
                i -= 1
        if not counts:
            return "no client in a call"
        return " + ".join("%s x%d" % (n, c) for n, c in sorted(counts.items()))

    def idle_by_host(self):
        """The idle seconds of the window, by what the host was doing in
        the middle of each idle stretch; the largest first."""
        out = collections.Counter()
        for s, e in stats.gaps(self.device_intervals(), self.lo, self.hi):
            out[self.host_at((s + e) / 2)] += e - s
        return out
