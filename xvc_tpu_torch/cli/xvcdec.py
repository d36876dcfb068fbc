"""xvcdec-compatible decoder app of the port.

Copy of ``cli/xvcdec.py`` on this package: accepts the reference decoder
app's arguments (ref: app/xvc_dec_app/decoder_app.cc) and decodes on the
card, or on the device ``-device`` names.  ``-threads N`` decodes on N
picture threads (``parallel/pipeline.DecodePipeline``).  ``-simd-mask 0``
decodes without the native parse, as the JAX app does: every picture
takes the Python parse on the pure-Python arithmetic decoder
(``XVC_PIC_NATIVE=0`` and ``XVC_NATIVE=0`` for the decode), and the
reconstruction stays on the device::

    python -m xvc_tpu_torch.cli.xvcdec -bitstream-file out.xvc \\
        -output-file dec.yuv -threads 4
"""
import argparse
import contextlib
import os
import struct
import sys
import time

from ..api import DecoderParameters, DecoderSession
from .y4m import Y4mWriter


def make_parser():
    p = argparse.ArgumentParser(prog="xvcdec", add_help=False)
    a = p.add_argument
    a("-h", action="help")
    a("-bitstream-file", required=True)
    a("-output-file", default=None)
    a("-output-width", type=int, default=0)
    a("-output-height", type=int, default=0)
    a("-output-chroma-format", type=int, default=-1)
    a("-output-color-matrix", type=int, default=0)
    a("-output-bitdepth", type=int, default=0)
    a("-max-framerate", type=float, default=0)
    a("-threads", type=int, default=0)
    a("-simd-mask", type=int, default=None)
    a("-dither", type=int, default=0)
    a("-loop", type=int, default=1)
    a("-verbose", type=int, default=0)
    a("-device", default=None)  # default: the card
    return p


@contextlib.contextmanager
def _python_parse(on):
    """XVC_PIC_NATIVE=0 and XVC_NATIVE=0 for the decode inside (``on``),
    as before after."""
    names = ("XVC_PIC_NATIVE", "XVC_NATIVE")
    saved = {name: os.environ.get(name) for name in names}
    if on:
        os.environ.update(dict.fromkeys(names, "0"))
    try:
        yield
    finally:
        if on:
            for name, value in saved.items():
                if value is None:
                    os.environ.pop(name, None)
                else:
                    os.environ[name] = value


def main(argv=None):
    args = vars(make_parser().parse_args(argv))
    # the analog of the reference's -simd-mask 0: no native code parses
    with _python_parse(args.get("simd_mask") == 0):
        return _main(args)


def _main(args):
    g = lambda name: args[name.replace("-", "_")]  # noqa: E731
    params = DecoderParameters(
        output_width=g("output-width"), output_height=g("output-height"),
        output_chroma_format=g("output-chroma-format"),
        output_color_matrix=g("output-color-matrix"),
        output_bitdepth=g("output-bitdepth"),
        max_framerate=g("max-framerate"), dither=g("dither"),
        threads=g("threads"))
    session = DecoderSession(params, device=g("device"))

    data = sys.stdin.buffer.read() if g("bitstream-file") == "-" \
        else open(g("bitstream-file"), "rb").read()
    out = None
    y4m_writer = None
    if g("output-file"):
        if g("output-file") == "-":
            out = sys.stdout.buffer
            y4m_writer = Y4mWriter()
        else:
            out = open(g("output-file"), "wb")
            if g("output-file").endswith(".y4m"):
                y4m_writer = Y4mWriter()

    def write_pic(pic):
        if g("verbose"):
            line = (f"NUT:{pic.nal_unit_type:6d}  POC:{pic.poc:6d}"
                    f"  DOC:{pic.doc:6d}  SOC:{pic.soc:6d}"
                    f"  TID:{pic.tid:6d}   QP:{pic.qp:6d}")
            if pic.l0 or pic.l1:
                line += "  RefPics: L0: { " + \
                    ", ".join(f"{p:3d}" for p in pic.l0) + " } L1: { " + \
                    ", ".join(f"{p:3d}" for p in pic.l1) + " }"
            print(line, file=sys.stderr)
        if y4m_writer is not None:
            out.write(y4m_writer.frame_header(
                pic.width, pic.height, pic.framerate, pic.chroma_format,
                pic.bitdepth))
        out.write(pic.bytes)
    start = time.time()
    num_pics = 0
    for _ in range(max(1, g("loop")) - 1):
        # benchmark loops decode without writing output
        # (ref: decoder_app.cc -loop)
        warm = DecoderSession(params, device=g("device"))
        pos = 0
        while pos + 4 <= len(data):
            (size,) = struct.unpack_from("<I", data, pos)
            pos += 4
            warm.decode_nal(data[pos:pos + size])
            pos += size
            while warm.get_picture() is not None:
                pass
        warm.flush()
        while warm.get_picture() is not None:
            pass
    pos = 0
    while pos + 4 <= len(data):
        (size,) = struct.unpack_from("<I", data, pos)
        pos += 4
        nal = data[pos:pos + size]
        pos += size
        session.decode_nal(nal)
        pic = session.get_picture()
        if pic is not None:
            num_pics += 1
            if out:
                write_pic(pic)
    session.flush()
    while True:
        pic = session.get_picture()
        if pic is None:
            break
        num_pics += 1
        if out:
            write_pic(pic)
    if out and out is not sys.stdout.buffer:
        out.close()
    dt = time.time() - start
    print(f"Decoded:    {num_pics} pictures", file=sys.stderr)
    print(f"Total time: {dt:.2f} s", file=sys.stderr)
    # Conformance check (ref: decoder_app.cc:300-330)
    if num_pics == 0:
        print("No pictures were decoded.", file=sys.stderr)
        return 2
    if session.num_corrupted_pics:
        print(f"Error: A decoding mismatch occured in "
              f"{session.num_corrupted_pics} pictures.", file=sys.stderr)
        print("The bitstream is NOT a conforming bitstream.",
              file=sys.stderr)
        return 1
    print("Conformance verified.", file=sys.stderr)
    print("The bitstream is a conforming bitstream.", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
