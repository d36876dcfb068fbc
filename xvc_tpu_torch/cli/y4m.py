"""y4m (YUV4MPEG2) stream reader/writer for the port's apps.

Copy of ``cli/y4m.py``: behavioral equivalents of the reference helpers
(ref: app/xvc_enc_app/y4m_reader.cc, app/xvc_dec_app/y4m_writer.cc).
"""

_CHROMA_BY_TAG = {
    "420": (1, 8), "420p10": (1, 10), "420p12": (1, 12),
    "422": (2, 8), "422p10": (2, 10), "422p12": (2, 12),
    "444": (3, 8), "444p10": (3, 10), "444p12": (3, 12),
    "mono": (0, 8),
}
_TAG_BY_CHROMA = {1: "420", 2: "422", 3: "444", 0: "mono"}


class Y4mReader:
    """Parses the stream header; returns None fields when not y4m."""

    def __init__(self, stream):
        self.stream = stream
        self.is_y4m = False
        self.width = 0
        self.height = 0
        self.framerate = 0.0
        self.chroma_format = 1
        self.bitdepth = 8

    def read_header(self, peeked: bytes) -> bytes:
        """peeked: bytes already read from the stream.  Returns leftover
        payload bytes after the header (start of first frame line)."""
        if not peeked.startswith(b"YUV4MPEG2 "):
            return peeked
        while b"\n" not in peeked:
            more = self.stream.read(80)
            if not more:
                break
            peeked += more
        line, _, rest = peeked.partition(b"\n")
        self.is_y4m = True
        pos = 10
        buf = line.decode("ascii", "replace")
        while pos < len(buf):
            c = buf[pos]
            if c == " ":
                pos += 1
                continue
            pos += 1
            start = pos
            while pos < len(buf) and buf[pos] != " ":
                pos += 1
            val = buf[start:pos]
            if c == "W":
                self.width = int(val)
            elif c == "H":
                self.height = int(val)
            elif c == "F":
                den, num = val.split(":")
                self.framerate = float(den) / float(num)
            elif c == "C":
                if val in _CHROMA_BY_TAG:
                    self.chroma_format, self.bitdepth = _CHROMA_BY_TAG[val]
        return rest

    def skip_frame_header(self, buffered: bytes) -> bytes:
        """Consume one FRAME line; buffered holds unread payload bytes.
        Returns the remaining buffered payload."""
        while b"\n" not in buffered:
            more = self.stream.read(80)
            if not more:
                return b""
            buffered += more
        _, _, rest = buffered.partition(b"\n")
        return rest


class Y4mWriter:
    """(ref: y4m_writer.cc:29-75)"""

    def __init__(self):
        self.header_written = False

    def frame_header(self, width, height, framerate, chroma_format,
                     bitdepth) -> bytes:
        out = b""
        if not self.header_written:
            self.header_written = True
            if framerate == int(framerate):
                fps = f"{int(framerate)}:1"
            else:
                fps = f"{int(1000 * framerate)}:1000"
            tag = _TAG_BY_CHROMA.get(int(chroma_format), "420")
            if bitdepth > 8 and tag != "mono":
                tag += f"p{bitdepth}"
            out += (f"YUV4MPEG2 W{width} H{height} F{fps} Ip"
                    f" C{tag} \n").encode("ascii")
        return out + b"FRAME\n"
