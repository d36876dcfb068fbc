"""xvcenc-compatible encoder app of the port.

Copy of ``cli/xvcenc.py`` on this package: accepts the reference encoder
app's arguments (ref: app/xvc_enc_app/encoder_app.cc) and produces
identical bitstreams, with the encoder's device stages on the card, or on
the device ``-device`` names.  ``-threads N`` codes the pictures of a
sub-GOP on N picture threads (``parallel/pipeline.EncodePipeline``).
``-simd-mask 0`` codes every picture with the Python CU encoder, as
``XVC_ENC_NATIVE=0`` does (the reference's switch off of its native
kernels; both encoders give the same stream)::

    python -m xvc_tpu_torch.cli.xvcenc -input-file in.y4m \\
        -output-file out.xvc -rec-file rec.yuv -speed-mode 3 -threads 4
"""
import argparse
import contextlib
import os
import struct
import sys
import time

from .. import constants as k
from ..api import EncoderParameters, EncoderSession
from .y4m import Y4mReader


def make_parser():
    p = argparse.ArgumentParser(prog="xvcenc", add_help=False,
                                prefix_chars="-")
    a = p.add_argument
    a("-h", action="help")
    a("-input-file", required=True)
    a("-output-file", required=True)
    a("-rec-file", default=None)
    a("-input-width", type=int, default=0)
    a("-input-height", type=int, default=0)
    a("-input-chroma-format", type=int, default=1)
    a("-input-color-matrix", type=int, default=0)
    a("-input-bitdepth", type=int, default=8)
    a("-internal-bitdepth", type=int, default=None)
    a("-framerate", type=float, default=60)
    a("-skip-pictures", type=int, default=0)
    a("-temporal-subsample", type=int, default=1)
    a("-max-pictures", type=int, default=-1)
    a("-sub-gop-length", type=int, default=0)
    a("-max-keypic-distance", type=int, default=640)
    a("-closed-gop", type=int, default=0)
    a("-low-delay", type=int, default=0)
    a("-num-ref-pics", type=int, default=-1)
    a("-restricted-mode", type=int, default=0)
    a("-checksum-mode", type=int, default=0)
    a("-chroma-qp-offset-table", type=int, default=0)
    a("-chroma-qp-offset-u", type=int, default=0)
    a("-chroma-qp-offset-v", type=int, default=0)
    a("-deblock", type=int, default=1)
    a("-beta-offset", type=int, default=0)
    a("-tc-offset", type=int, default=0)
    a("-qp", type=int, default=32)
    a("-flat-lambda", type=int, default=0)
    a("-speed-mode", type=int, default=-1)
    a("-tune", type=int, default=0)
    a("-threads", type=int, default=0)
    a("-simd-mask", type=int, default=None)  # 0: the Python CU encoder
    a("-explicit-encoder-settings", default="")
    a("-multi-passes", type=int, default=0)  # 0=off 1=lookahead 2=full
    a("-verbose", type=int, default=0)
    a("-device", default=None)  # default: the card
    return p


class LambdaCurve:
    """Rate-distortion model over (SSE, bits) points
    (ref: encoder_app.cc:914-951)."""

    def __init__(self, p0, qp0, p1, qp1):
        import math
        sse0, sse1 = math.log(p0[0]), math.log(p1[0])
        bits0, bits1 = math.log(p0[1]), math.log(p1[1])
        lambda0, lambda1 = sse0 - bits0, sse1 - bits1
        self.dist_scale = (lambda1 - lambda0) / (sse1 - sse0)
        self.dist_offset = lambda0 - self.dist_scale * sse0
        self.qp_scale = (lambda1 - lambda0) / (qp1 - qp0)
        self.qp_offset = lambda0 - self.qp_scale * qp0

    @classmethod
    def rescaled(cls, curve, p, qp):
        import math
        c = cls.__new__(cls)
        c.dist_scale = curve.dist_scale
        c.qp_scale = curve.qp_scale
        lam = math.log(p[0]) - math.log(p[1])
        c.dist_offset = lam - c.dist_scale * math.log(p[0])
        c.qp_offset = lam - c.qp_scale * qp
        return c

    def is_point_better(self, p):
        import math
        lam = math.log(p[0]) - math.log(p[1])
        return lam > self.dist_scale * math.log(p[0]) + self.dist_offset

    def qp_at_distortion(self, distortion):
        import math
        lam = self.dist_scale * math.log(distortion) + self.dist_offset
        return (lam - self.qp_offset) / self.qp_scale


def _lookahead(params, frames, device):
    """Leading-pictures determination via two 2-frame probes
    (ref: encoder_app.cc:593-663 StartPictureDetermination)."""
    import copy
    poc_ratio = 0.6875
    sub_gop = params.sub_gop_length if params.sub_gop_length >= 1 else 16
    if frames is None or sub_gop < 4 or len(frames) < sub_gop:
        print("Warning: Singlepass lookahead not attempted", file=sys.stderr)
        return
    middle_poc = int(poc_ratio * sub_gop + 0.5)
    test_positions = [(0, middle_poc), (sub_gop - 1, middle_poc)]
    result = []
    for positions in test_positions:
        p = copy.deepcopy(params)
        p.speed_mode = 2
        p.sub_gop_length = 2
        session = EncoderSession(p, device=device)
        nals = []
        for poc in positions:
            nals += session.encode(frames[poc])
        nals += session.flush()
        result.append(len(nals[0]))
    params.leading_pictures = 1 if result[1] <= result[0] else 0
    print(f"Leading Picture:  {params.leading_pictures}", file=sys.stderr)


def _multi_pass(params, encode_one_pass):
    """Full multi-pass RD preset search with a lambda-curve model
    (ref: encoder_app.cc:665-746 MultiPass)."""
    import copy
    from ..api import OK, encoder_parameters_apply_rd_preset

    def run(p):
        s = encode_one_pass(p)
        return (max(s["sse"], 1), max(s["bytes"], 1))

    best_preset = 0
    p = copy.deepcopy(params)
    p.speed_mode = 2
    encoder_parameters_apply_rd_preset(best_preset, p)
    best_qp = p.qp

    p.qp = best_qp - 2
    dist_bits1 = run(p)
    p.qp = best_qp
    dist_bits0 = run(p)
    curve = LambdaCurve(dist_bits0, best_qp, dist_bits1, best_qp - 2)
    base_distortion = dist_bits0[0]

    preset = -1
    while True:
        preset += 1
        if preset == best_preset:
            continue
        p = copy.deepcopy(params)
        p.speed_mode = 2
        p.qp = best_qp
        if encoder_parameters_apply_rd_preset(preset, p) != OK:
            break
        print(f"Eval multi-pass preset: {preset} QP: {p.qp}",
              file=sys.stderr)
        dist_bits = run(p)
        if not curve.is_point_better(dist_bits):
            continue
        scaled = LambdaCurve.rescaled(curve, dist_bits, p.qp)
        qp_steps_frac = scaled.qp_at_distortion(base_distortion) - p.qp
        qp_steps = round(qp_steps_frac)
        change_best_qp = qp_steps != 0
        if qp_steps == 0:
            qp_steps = 1 if qp_steps_frac > 0 else -1
        p.qp += qp_steps
        print(f"Refine multi-pass preset: {preset} QP: {p.qp}",
              file=sys.stderr)
        dist_bits2 = run(p)
        if not curve.is_point_better(dist_bits2):
            continue
        best_preset = preset
        curve = LambdaCurve(dist_bits, best_qp, dist_bits2, p.qp)
        if change_best_qp:
            best_qp += qp_steps

    print(f"Best preset:      {best_preset}", file=sys.stderr)
    encoder_parameters_apply_rd_preset(best_preset, params)
    params.qp = best_qp


def _print_nal_info(ns, size, width, height, chroma):
    """Per-NAL verbose line (ref: encoder_app.cc:857-912)."""
    line = f"NUT:{ns.nal_unit_type:6d}"
    if ns.nal_unit_type < 16:
        line += (f"  POC:{ns.poc:6d}  DOC:{ns.doc:6d}"
                 f"  SOC:{ns.soc:6d}  TID:{ns.tid:6d}   QP:{ns.qp:6d}")
    else:
        line += "     - not a picture -                                " \
            "      "
    line += f"  Bytes: {size:10d}"
    if ns.nal_unit_type < 16:
        bpp = 8 * size / (width * height)
        line += f"  Bpp: {bpp:10.5f}"
        line += f"  PSNR-Y: {ns.psnr[0]:6.3f}"
        if chroma != k.ChromaFormat.MONOCHROME:
            line += f"  PSNR-U: {ns.psnr[1]:6.3f}"
            line += f"  PSNR-V: {ns.psnr[2]:6.3f}"
        if ns.l0 or ns.l1:
            line += "  RefPics: L0: { " + \
                ", ".join(f"{p:3d}" for p in ns.l0) + " } L1: { " + \
                ", ".join(f"{p:3d}" for p in ns.l1) + " }"
    print(line)


@contextlib.contextmanager
def _python_cu_encoder(on):
    """XVC_ENC_NATIVE=0 for the encodes inside (``on``), as before after."""
    saved = os.environ.get("XVC_ENC_NATIVE")
    if on:
        os.environ["XVC_ENC_NATIVE"] = "0"
    try:
        yield
    finally:
        if on:
            if saved is None:
                os.environ.pop("XVC_ENC_NATIVE", None)
            else:
                os.environ["XVC_ENC_NATIVE"] = saved


def main(argv=None):
    args = vars(make_parser().parse_args(argv))
    # the analog of the reference's -simd-mask 0: no native kernel codes a
    # picture (the port's parse and block coder stay native)
    with _python_cu_encoder(args.get("simd_mask") == 0):
        return _main(args)


def _main(args):
    g = lambda name: args[name.replace("-", "_")]  # noqa: E731
    device = g("device")
    width, height = g("input-width"), g("input-height")
    bitdepth = g("input-bitdepth")
    chroma = g("input-chroma-format")
    framerate = g("framerate")

    infile = sys.stdin.buffer if g("input-file") == "-" \
        else open(g("input-file"), "rb")
    y4m = Y4mReader(infile)
    leftover = y4m.read_header(infile.read(10))
    if y4m.is_y4m:
        width, height = y4m.width, y4m.height
        bitdepth = y4m.bitdepth
        chroma = y4m.chroma_format
        if y4m.framerate:
            framerate = y4m.framerate
    internal = g("internal-bitdepth") or bitdepth
    params = EncoderParameters(
        width=width, height=height, chroma_format=chroma,
        color_matrix=g("input-color-matrix"), input_bitdepth=bitdepth,
        internal_bitdepth=internal, framerate=framerate,
        sub_gop_length=g("sub-gop-length"),
        max_keypic_distance=g("max-keypic-distance"),
        closed_gop=g("closed-gop"), low_delay=g("low-delay"),
        num_ref_pics=g("num-ref-pics"),
        restricted_mode=g("restricted-mode"),
        checksum_mode=g("checksum-mode"),
        chroma_qp_offset_table=g("chroma-qp-offset-table"),
        chroma_qp_offset_u=g("chroma-qp-offset-u"),
        chroma_qp_offset_v=g("chroma-qp-offset-v"),
        deblock=g("deblock"), beta_offset=g("beta-offset"),
        tc_offset=g("tc-offset"), qp=g("qp"),
        flat_lambda=g("flat-lambda"), speed_mode=g("speed-mode"),
        tune_mode=g("tune"), threads=g("threads"),
        explicit_encoder_settings=g("explicit-encoder-settings"))
    sample_bytes = 1 if bitdepth <= 8 else 2
    if chroma == k.ChromaFormat.MONOCHROME:
        pic_samples = width * height
    elif chroma == k.ChromaFormat.YUV422:
        pic_samples = width * height * 2
    elif chroma == k.ChromaFormat.YUV444:
        pic_samples = width * height * 3
    else:
        pic_samples = width * height * 3 // 2
    frame_size = pic_samples * sample_bytes

    def read_frame():
        nonlocal leftover
        if y4m.is_y4m:
            leftover = y4m.skip_frame_header(leftover)
        need = frame_size
        chunks = []
        if leftover:
            take = leftover[:need]
            chunks.append(take)
            leftover = leftover[len(take):]
            need -= len(take)
        if need:
            chunks.append(infile.read(need))
        return b"".join(chunks)

    max_pics = g("max-pictures")
    skip = g("skip-pictures")
    subsample = max(1, g("temporal-subsample"))
    multipass = g("multi-passes")
    seekable = infile is not sys.stdin.buffer
    if multipass and not seekable:
        print("Warning: Disabling multi-pass and lookahead on "
              "non-seekable input", file=sys.stderr)
        multipass = 0

    frames = None
    if multipass:
        frames = []
        for _ in range(skip):
            read_frame()
        idx = 0
        while max_pics < 0 or len(frames) < max_pics:
            data = read_frame()
            if len(data) < frame_size:
                break
            if idx % subsample == 0:
                frames.append(data)
            idx += 1

    def encode_one_pass(pass_params, write=False):
        """Returns (total_sse, total_bytes)
        (ref: encoder_app.cc:420-557 EncodeOnePass)."""
        session = EncoderSession(pass_params, device=device)
        out = open(g("output-file"), "wb") if write else None
        rec_out = open(g("rec-file"), "wb") if write and g("rec-file") \
            else None
        stats = {"nals": 0, "bytes": 0, "sse": 0, "encoded": 0,
                 "psnr": [0.0, 0.0, 0.0], "pics": 0,
                 "seg_bytes": 0, "seg_pics": 0,
                 "max_seg_bytes": 0, "max_seg_pics": 0}
        verbose = write and g("verbose")

        def emit(nal):
            stats["nals"] += 1
            stats["bytes"] += len(nal)
            ns = session.nal_stats[stats["nals"] - 1]
            if ns.nal_unit_type >= 16:  # segment header: new segment
                if stats["seg_bytes"] > stats["max_seg_bytes"]:
                    stats["max_seg_bytes"] = stats["seg_bytes"]
                    stats["max_seg_pics"] = stats["seg_pics"]
                stats["seg_bytes"] = 0
                stats["seg_pics"] = 0
            else:
                stats["seg_pics"] += 1
                stats["pics"] += 1
                for c in range(min(3, len(ns.psnr))):
                    stats["psnr"][c] += ns.psnr[c]
            stats["seg_bytes"] += len(nal)
            if verbose:
                _print_nal_info(ns, len(nal), width, height, chroma)
            if out:
                out.write(struct.pack("<I", len(nal)))
                out.write(nal)

        def drain_rec():
            if rec_out is not None:
                for rec in session.rec_pictures:
                    rec_out.write(rec)
            session.rec_pictures.clear()

        def source():
            if frames is not None:
                yield from frames
                return
            for _ in range(skip):
                read_frame()
            idx = 0
            encoded = 0
            while max_pics < 0 or encoded < max_pics:
                data = read_frame()
                if len(data) < frame_size:
                    break
                if idx % subsample == 0:
                    encoded += 1
                    yield data
                idx += 1

        for data in source():
            for nal in session.encode(data):
                emit(nal)
            drain_rec()
            stats["encoded"] += 1
        for nal in session.flush():
            emit(nal)
        drain_rec()
        stats["sse"] = session.total_sse
        if out:
            out.close()
        if rec_out:
            rec_out.close()
        return stats

    if multipass == 1:
        _lookahead(params, frames, device)
    elif multipass >= 2:
        _multi_pass(params, encode_one_pass)

    start = time.time()
    stats = encode_one_pass(params, write=True)
    encoded, total_bytes, total_nals = \
        stats["encoded"], stats["bytes"], stats["nals"]
    if stats["seg_bytes"] > stats["max_seg_bytes"]:
        stats["max_seg_bytes"] = stats["seg_bytes"]
        stats["max_seg_pics"] = stats["seg_pics"]
    if infile is not sys.stdin.buffer:
        infile.close()
    dt = time.time() - start
    seq_seconds = encoded / framerate if framerate else 0
    print(f"Encoded:       {encoded} pictures")
    print(f"Total time:    {dt:.2f} s")
    print(f"Total written: {total_bytes} bytes ({total_nals} nal units)")
    if seq_seconds:
        print(f"Total bitrate: "
              f"{total_bytes * 8 / (1000 * seq_seconds):.2f} kbit/s")
    if stats["max_seg_pics"]:
        peak = stats["max_seg_bytes"] * 8 / \
            (1000 * (stats["max_seg_pics"] / framerate))
        print(f"Peak bitrate:  {peak:.2f} kbit/s")
    if stats["pics"]:
        line = f"Average PSNR:  Y: {stats['psnr'][0]/stats['pics']:6.3f}"
        if chroma != k.ChromaFormat.MONOCHROME:
            line += (f"  U: {stats['psnr'][1]/stats['pics']:6.3f}"
                     f"  V: {stats['psnr'][2]/stats['pics']:6.3f}")
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
