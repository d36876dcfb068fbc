"""The reference decode of a stream, with the work its pictures need.

``decode(data)`` runs the plain host decoder (``xvcref``) over a whole
stream and returns, in output order, each picture's bytes, conformance
flag and POC, and the bytes that the port's picture kernels have to move
for it at the least, counted from the reference's own parse so that the
count does not move when the port changes:

- ``itx``: per coded transform block of a component, its coefficients
  read once (``min(w, 32) x min(h, 32)`` int32: the rows and columns
  past 32 are zero by the standard) and its residual samples inside the
  plane written once (int32);
- ``mc``: the union of the reference samples that the picture's motion
  compensation reads, taps included (int16, each sample once), and per
  predicted block and reference list its samples inside the plane
  written once (int16);
- ``deblock_luma`` / ``deblock_chroma``: each sample that deblocking
  changes read and written once (int16);
- ``deblock_edges``: each leaf CU's position and size read once
  (four int32).

These are lower bounds of what a kernel must move, so a share of the
roofline built on them can only read low, never above 100%.  The
samples are int16 and the coefficients and residuals int32 because the
port's surfaces are so; the count is what those inputs and outputs
need, not what a kernel does with them.
"""
import hashlib
import json
import sys

import numpy as np

from .xvcref import constants as k
from .xvcref.codec import decoder as xdec
from .xvcref.codec import inter_mc
from .xvcref.nal import split_nal_units

SAMPLE_BYTES = 2
COEFF_BYTES = 4
RESIDUAL_BYTES = 4
CU_RECORD_BYTES = 16
KINDS = ("itx", "mc", "deblock_luma", "deblock_chroma", "deblock_edges")


def _leaves(cu):
    if cu is None:
        return
    if cu.split != k.SplitType.NONE:
        for sub in cu.sub_cus:
            yield from _leaves(sub)
    else:
        yield cu


class _Counter:
    """Collects one picture's work while the reference decodes it;
    ``skip_deblocking`` turns the in-loop filter off (the control)."""

    def __init__(self, skip_deblocking=False):
        self.masks = {}     # (id of the reference picture, comp) -> bool
        self.pending = {}   # poc -> (work, pre-deblock planes)
        self.skip_deblocking = skip_deblocking

    def read(self, ref_pic, comp, row, col, h, w):
        key = (id(ref_pic), comp)
        mask = self.masks.get(key)
        if mask is None:
            mask = self.masks[key] = np.zeros(
                ref_pic.padded_plane(comp).shape, bool)
        mask[max(row, 0):max(row + h, 0), max(col, 0):max(col + w, 0)] = True

    def parsed(self, pic_dec):
        """After the parse and reconstruction, before deblocking."""
        pd = pic_dec.pic_data
        rec = pic_dec.rec_pic
        work = dict.fromkeys(KINDS, 0)
        trees = [k.CuTree.PRIMARY]
        if pd.has_secondary_cu_tree():
            trees.append(k.CuTree.SECONDARY)
        for tree in trees:
            comps = pd.get_components(tree)
            for rsaddr in range(pd.get_number_of_ctus()):
                for cu in _leaves(pd.get_ctu(tree, rsaddr)):
                    work["deblock_edges"] += CU_RECORD_BYTES
                    for comp in comps:
                        x, y = cu.pos(comp)
                        w, h = cu.size(comp)
                        inside = max(min(w, rec.width[comp] - x), 0) * \
                            max(min(h, rec.height[comp] - y), 0)
                        if cu.cbf[comp]:
                            work["itx"] += min(w, 32) * min(h, 32) * \
                                COEFF_BYTES + inside * RESIDUAL_BYTES
                        if cu.is_inter():
                            lists = sum(cu.has_mv(r) for r in (0, 1))
                            work["mc"] += lists * inside * SAMPLE_BYTES
        work["mc"] += sum(int(m.sum()) for m in self.masks.values()) * \
            SAMPLE_BYTES
        self.masks = {}
        planes = [rec.plane_view(c).copy()
                  for c in range(k.num_components(rec.chroma_format))]
        self.pending[pd.poc] = (work, planes)
        if self.skip_deblocking:
            pd.deblock = False

    def output(self, pic):
        """At output: count the samples that deblocking changed."""
        work, before = self.pending.pop(pic.poc)
        after = planes_of(pic)
        if after is not None:
            work["deblock_luma"] = int((after[0] != before[0]).sum()) * \
                2 * SAMPLE_BYTES
            work["deblock_chroma"] = sum(
                int((a != b).sum()) for a, b in zip(after[1:], before[1:])
            ) * 2 * SAMPLE_BYTES
        return work


def planes_of(pic):
    """The planes of an output picture's bytes (4:2:0 / 4:0:0, at 8 bit
    one byte a sample, above it two little-endian); None for other
    formats."""
    fmt = int(pic.chroma_format)
    if fmt not in (int(k.ChromaFormat.MONOCHROME), int(k.ChromaFormat.YUV420)):
        return None
    dtype = np.uint8 if pic.bitdepth <= 8 else np.dtype("<u2")
    w, h = pic.width, pic.height
    shapes = [(h, w)]
    if fmt == int(k.ChromaFormat.YUV420):
        shapes += [((h + 1) // 2, (w + 1) // 2)] * 2
    buf = np.frombuffer(pic.bytes, dtype)
    out, at = [], 0
    for shape in shapes:
        n = shape[0] * shape[1]
        out.append(buf[at:at + n].reshape(shape).astype(np.int32))
        at += n
    return out


def decode(data, skip_deblocking=False):
    """The reference's pictures of a whole stream, in output order: a list
    of dicts with ``bytes``, ``conforming``, ``poc``, ``width``,
    ``height`` and ``work`` (bytes by kind, above).  ``skip_deblocking``
    leaves the in-loop deblocking filter out: the benchmark's control, a
    decode that breaks the exactness the configuration states."""
    counter = _Counter(skip_deblocking)
    dec = xdec.Decoder(on_parsed=counter.parsed)
    out = []

    def drain():
        while True:
            pic = dec.get_decoded_picture()
            if pic is None:
                return
            out.append(dict(bytes=pic.bytes, conforming=pic.conforming,
                            poc=pic.poc, width=pic.width, height=pic.height,
                            work=counter.output(pic)))

    inter_mc.READS = counter.read
    try:
        for nal in split_nal_units(data):
            dec.decode_nal(nal)
            drain()
        dec.flush()
        drain()
    finally:
        inter_mc.READS = None
    return out


def digest(pic):
    """The sha256 (hex) of a reference picture's bytes."""
    return hashlib.sha256(pic["bytes"]).hexdigest()


def work_file(pics):
    """A configuration's work file: each picture's POC and its bytes by
    kind, in output order."""
    return {"pictures": [dict(poc=p["poc"], **p["work"]) for p in pics]}


def main(argv=None):
    """``python3 -m portbench.reference.work <stream.xvc>`` prints the
    stream's work file."""
    path, = (sys.argv[1:] if argv is None else argv)
    with open(path, "rb") as f:
        print(json.dumps(work_file(decode(f.read())), indent=1))


if __name__ == "__main__":
    main()
