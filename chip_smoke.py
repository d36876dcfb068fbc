#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (xvc_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--parent TREE]

Phases:
  0  device: nvidia-smi name and power limit, torch device name;
  1  build: compile the CUDA kernels from xvc_tpu_torch/kernels/csrc
     (one nvcc per source, all at once) and, beside them, the native
     parse library from xvc_tpu_torch/native/csrc (g++);
  2  kernels: MC and ITX (the group kernels, and the picture kernels
     that derive every job of a picture from its record table), the
     deblock edge decisions, luma walk and chroma
     pass, SATD (also at the shape the per-CU pre-pass gave it before
     intra_satd, one CU's 67 predictions), the all-mode intra SATD
     (intra_satd: every mode predicted on chip and its SATD summed; B = 1
     at the per-CU sizes, B = 77 at every size with mode steps 1, 4 and
     8 at 8-14 bit, the real blocks of picture 0 of hd720_ld at the
     lookahead's and the split DP's shapes, each timed beside its plain
     version, its bound and the parent's path on the same inputs: the
     batched predictor and satd.cu; and the whole per-CU call, host ms
     and device operations, beside the parent's call) and the intra luma
     and chroma scans on the card against
     their plain PyTorch versions on the same inputs (numpy seed,
     main-path shapes; for the scans and the deblock kernels also the
     real inputs of pictures of hd720_ld, captured during a decode),
     bit-exact, each timed with CUDA events beside its plain version
     and beside its bound (the least time the card could take: bytes
     over the HBM rate, or operations over the peak rate); for the
     scans also the schedule each case took (parallel inside the
     dependency contract of gpu/scan_deps.py, with its tickets in
     wavefront order or, on the interleaved tiled case, in decode
     order; ordered outside it), the longest chain of that schedule and
     the time per step, at pictures 0 and 3 and on the interleaved
     tiled case; with --parent TREE also the scan kernels of the
     checkout TREE (a parent commit, say) on the same inputs, in a child
     process (and TREE's transform-RD stages, below, and TREE's
     make_intra_satd_fn and per-CU call on intra_satd's timed inputs);
     the picture
     kernels on the record tables of every picture of hd720_ld and of
     one picture of each other bench stream (parsed on
     the CPU, the frame store from a seed) and on every picture of the
     goldens the flat path refuses (4:2:2 and 4:4:4, intra and inter, a
     restricted toolset, LIC), on synthetic tables
     (xvc_tpu_torch/gpu/flat_cases.py) and with damaged rows appended,
     each timed per picture of hd720_ld and of hd720_lic beside its
     bound; the encoder's prepass kernel (txrd: from the SATD screen to
     the kept modes) on synthetic cases at each block size and on the
     real inputs of picture 0 of hd720_s3 (captured from an encode of
     that picture at speed 3 on the card), bit for bit against its plain
     version, timed beside it and its bound, and with --parent TREE
     beside the stages TREE runs on the same inputs (before txrd: a
     stable sort, a gather, a float64 transform and the rank-only
     kernel); the resampler's fused kernel (resample: both passes of
     every plane of a picture in one launch) on the nine cases of
     tests/test_resample_device.py, one case per scale class at 8, 10
     and 14 bit and the extreme ratios, random and full-scale, as one
     plane and as two planes of a launch (packed output; int32 output
     with the store's edge replication), on the full-width planes of
     1920x1080 -> 1280x720 and back (luma and chroma) one at a time, and
     on decoded pictures (picture 3 of fhd1080_ra to 1280x720, of
     hd720_ld to 1920x1080) from their frame-store slots: the kernel
     timed beside its plain version, its bound, PR 10's bound of the
     same planes, the dense float64 matmuls of the JAX formulation
     (library_ms), the whole per-picture call (with and without the
     border ring) and its spans, the alternative reconstruction, and the
     per-plane host-window calls (window cut, upload, kernel, download,
     pack) of this tree and, with --parent TREE, of TREE; the motion
     search's SAD sweep (me_sad) on every CU shape from 4x4 to 64x64,
     SAD and SAD_FAST, 8-16 bit, 1-754 candidates with the window's
     corners among them, in a padded 1280x720 plane resident on the
     card, at the plane's four corners, and through DeviceSadTable on a
     reference whose border was never padded and on a recycled picture,
     through the per-prefetch call, bit for bit against its plain
     version (timed in phase 9);
  3  decode paths: decode tests/data/bench/hd720_ld.xvc (1280x720, 8
     pictures, the flat path) with xvc_tpu_torch.codec.decoder.
     decode_stream on the card; every picture must be
     checksum-conforming and equal the recorded host decode
     (tests/data/bench/hd720_ld_dec.sha256), the launch count of every
     kernel of that path must be above 0 and that of the group ITX / MC
     kernels 0; then hd720_lic (1280x720, 8 pictures, LIC on in the 7
     inter pictures: the replay path of gpu/recon.py, with its host tail)
     and the other bench streams (cif_ai, fhd1080_ra, qhd1440_ra10 at
     10 bit, uhd2160_ra10 at 10 bit) the same way, with the scans' status
     words of every launch and the host tail's blocks per replayed
     picture; then for hd720_ld, hd720_lic and fhd1080_ra the stage
     profile of one more decode with synchronising spans
     (xvc_tpu_torch.profiling) and the device's busy share of a decode
     (torch.profiler, busy time and decode time from the same run);
  4  goldens: every golden of tests/data with a _dec.yuv (33 streams,
     each held to its golden and its picture count; 23 of them take the
     replay path) and the 4:2:2 / 4:4:4 inter streams c422_ra64x48 and
     c444_ra64x48 (held to their _dec.sha256);
  5  lookahead path: the luma plane of picture 0 of phase 3 (1280x720,
     8 bit) through xvc_tpu_torch.gpu.lookahead.frame_intra_lookahead on
     the card, sizes 4/8/16/32, 67 modes; the maps must equal the same
     call on the CPU device (plain versions) bit for bit, and the
     intra_satd kernel's launch count over that call must be above 0;
  6  encode path: hd720_s3 (1280x720, 4 pictures, 1 intra and 3 inter,
     low delay, qp 32, made from a seed by make_hd720_s3, a copy of the
     recipe in tests/encode_clips.py) through
     xvc_tpu_torch.api.EncoderSession on the card at speed 3 (the split
     DP and the transform-RD prepass on the card, the native CTU search on
     the host) and with the split DP alone.  The split-DP stream must
     equal the JAX package's (sha256 in
     tests/data/bench/hd720_s3_enc.json); the speed-3 stream must too, or
     else show no kernel-vs-plain difference, fewer than 0.1% of the
     prepass blocks unlike tests/data/bench/hd720_s3_cands.npz, bytes
     within 1% and PSNR within 0.05 dB.  Per picture it prints the prepass
     blocks unlike the JAX package's and those where the kernel and its
     plain version differ (0 required); both streams decode on the card,
     conforming and equal to the encoder's reconstruction; then ms per
     picture, the launches of satd, intra_satd and txrd per encode (set
     to 0 just
     before each timed encode, read just after), the stage profile of
     the first two pictures (spans encode.txrd_prepass and its extract /
     upload / device / download per picture, encode.split_dp,
     encode.native.*), the device's busy and idle share of an encode of
     those two under torch.profiler, and
     the operator list of one prepass call (no sort, no float64);
  7  resampling decode paths, through DecoderSession with no device (the
     card): tests/data/bench/hd720_fhd1080_splice.xvc (1280x720, then
     1920x1080 from picture 8, output latched at 1280x720), every picture
     equal to its hash list and conforming as recorded there (the three
     tail pictures that predict from the downscaled 1080p key picture
     fail their checksum in the JAX package's decode too), the resample
     launches split into the alternative reconstruction's and the
     output's (one launch for the alternative picture and one for each
     resized picture, no reference slot uploaded), ms per picture, the
     stage profile with decode.post's share and the device's idle share;
     hd720_ld resized to 1920x1080, fhd1080_ra to 1280x720 and
     qhd1440_ra10 to 1920x1080 at 8 bit, each to its hash list with one
     launch a picture, in turns with the decode at its own size;
     hd720_ld and fhd1080_ra with 4 picture threads
     beside sequential decodes in turns, each to its _dec.sha256, with
     the threaded decode's idle share;
  8  the Python CU encoder (xvc_tpu_torch/codec/cu_encoder.py, the
     route the JAX package takes for tpu_intra_lookahead and
     XVC_INTRA_PREPASS=jax) through xvc_tpu_torch.api.EncoderSession on
     the card: crops at (0, 0) of pictures of hd720_ld as the card
     decodes them (their hashes checked), all-intra, qp 32, speed mode 2:
     cif_la (352x288, 1 picture, tpu_intra_lookahead: the lookahead's
     four intra_satd launches rank every CU's modes) and qcif_pp
     (176x144, 2 pictures, XVC_INTRA_PREPASS=jax: one intra_satd launch
     per CU the per-CU pre-pass evaluates); each stream must equal the
     JAX package's (tests/data/bench/python_cu_enc.json) and decode on
     the card, conforming, to the encoder's reconstruction; the
     intra_satd and deblock kernels must be launched and satd not
     (counts set to 0 just before each encode and read just after).  It
     prints ms per picture, the lookahead's and the per-CU pre-pass's
     launches and seconds a picture, ms and device operations a per-CU
     call, the deblock launches and the device's idle share;
  9  the Python CU encoder's inter half (xvc_tpu_torch/codec/inter_me.py)
     under XVC_ME=jax through xvc_tpu_torch.api.EncoderSession on the
     card: qcif_me (crops at (0, 0) of pictures 0-1 of hd720_ld as the
     card decodes them, 176x144, low delay, one reference, speed mode 2,
     the uni-prediction search range at 64) and ra64x48_me (pictures 0-4
     of tests/data/ra64x48_in.yuv, random access, sub-GOP 4, two
     references); each stream must equal the JAX package's
     (tests/data/bench/python_cu_inter.json) and decode on the card,
     conforming, to the encoder's reconstruction; the TZ search's
     prefetches and device sweeps must equal the JAX package's counts
     there, and me_sad's launches the device sweeps (counts set to 0
     just before each encode and read just after).  It prints ms per
     picture, prefetches per picture and their device and host shares,
     candidates per device call, the device route's ms a call, device
     operations and the idle share, and the reference uploads (at most
     one a reference picture the sweeps read).  Then me_sad on every
     device sweep of the qcif_me encode as the search gave it (the
     resident plane, the origin, the block, the offsets), held to its
     plain version and to the encode's SADs: the kernel's time a sweep
     (CUDA events and device time, from mapped and from device-memory
     staging) beside its plain version, torch.cdist (library_ms) and its
     bound (the plane samples the blocks cover); the per-prefetch call's
     host ms over every sweep with mapped staging (one device operation)
     and with one copy (two), in turns, its time in the encode, and in
     child processes this tree's call and, with --parent TREE, TREE's
     (before the resident reference: box cut, pack, upload, launch,
     download) on the same
     sweeps, with their device operations; then one prefetch per 16x16
     CU of a 1280x720 picture (hd720_ld picture 1 against picture 0,
     range 64), the same numbers;
 10  picture-threaded encoding (xvc_tpu_torch/parallel/pipeline.py
     EncodePipeline) through xvc_tpu_torch.api.EncoderSession on the
     card: ra720_s3 (1280x720, 9 pictures, random access, sub-GOP 8,
     speed mode 3, from a seed by make_ra720_s3, a copy of the recipe in
     tests/encode_clips.py) with no picture threads and with 4, each
     under torch.profiler with the launch counts set to 0 just before and
     read just after; the two streams and reconstructions must be equal
     byte for byte and the launches of txrd, intra_satd and satd equal,
     the stream equal to the JAX package's
     (tests/data/bench/ra720_s3_enc.json) or inside phase 6's carve-out
     (prepass candidates against ra720_s3_cands.npz, txrd against its
     plain version on every call), decoded on the card to the
     reconstruction, with the pipeline in use and more than one picture
     in flight; it prints ms per picture of both, the worker count, the
     launches and the idle shares.  Then ra64x48_me with 4 threads under
     XVC_ME=jax, held to its sha256 and prefetch counts in
     tests/data/bench/python_cu_inter.json (sums over the workers),
     me_sad launches equal to the device sweeps, decoded on the card.
     Then the apps as a user runs them: python -m xvc_tpu_torch.cli.xvcenc
     -threads 4 on the first 2 pictures of ra720_s3 written as y4m, and
     xvcdec -threads 4, whose output must equal the app encoder's
     reconstruction;
 11  CTU tile rows (the tile extension: a size-prefixed CABAC substream a
     tile row, prediction cut at the tile's top): hd720_tiles4
     (tests/data/bench/hd720_tiles4.xvc, 1280x720, 12 CTU rows in 4
     tiles, one intra and two inter pictures, made by the JAX package's
     encoder) through DecoderSession on the card, every picture on the
     flat path (no replayed picture, so no host tail block), conforming
     and equal to its _dec.sha256, the picture kernels, both scans and
     the deblock kernels launched and the group ITX / MC kernels not; ms
     per picture beside hd720_ld's, decoded in turns; the stage profile
     with decode.parse and the tiles it parsed; the device's idle share;
     then with 4 picture threads, every picture equal to the sequential
     decode; tiles64x128_lic (2 tiles, LIC on: the replay path) to its
     _dec.sha256; then qcif_tiles (qcif_me's crops and settings in 3
     tiles, XVC_ME=jax and XVC_INTRA_PREPASS=jax) through EncoderSession
     on the card, its stream and reconstruction equal to the JAX
     package's (tests/data/bench/python_cu_tiles.json), its prefetch
     counts too, me_sad's launches equal to the device sweeps, intra_satd
     launched, decoded on the card, conforming, to the reconstruction;
     ms per picture;
 12  bit depth 15 and the Python parse: tests/data/bench/hd720_b15.xvc
     (1280x720, 15-bit 4:2:0, low delay, 4 pictures, made by the JAX
     package's encoder, recipe tests/encode_clips.py B15_STREAMS) through
     DecoderSession on the card, every picture through the Python parse
     (codec/cu_decoder.py over syntax/reader.py, the record table from
     gpu/tree_records.py) and the replay path, none through the native
     parse, conforming and equal to its hash list (the JAX package's
     encoder's reconstructions), the picture kernels, both scans and the
     deblock kernels launched and the group kernels not; ms per picture,
     the stage profile (decode.parse, recon.*, deblock.*) and the idle
     share; the first 2 pictures of hd720_ld with XVC_PIC_NATIVE=0 in
     turns with the native parse, each equal to its hash list; then at 15
     bit itx_picture and mc_picture on the records of every picture of
     hd720_b15 and on synthetic 15-bit tables (DC-only blocks, 32x32
     transform skip, full int16 levels), the scans on synthetic 15-bit
     cases and picture 0's inputs, the deblock kernels on synthetic
     15-bit cases and on the edges and planes of pictures 0 and 1, each
     bit-exact against its plain version and timed on the real inputs
     beside it and its bound, with its launches a hd720_b15 decode;
 13  meshes of slots of the card (xvc_tpu_torch/parallel/mesh.py: a slot
     is a device, a stream and a frame store): phase 5's lookahead over 4
     slots (one intra_satd launch a slot a size) equal to the unsharded
     maps, its n = 4 step unsharded, sharded and one shard timed beside
     the shard's bound; ra720_s3 on 4 picture threads pinned to 4 slots,
     the stream and reconstructions of phase 10, ms a picture beside
     phase 10's; hd720_ld and fhd1080_ra on 4 picture threads pinned to
     2 slots, to their hash lists, in turns with unmeshed decodes, the
     reference moves between the slots' stores and their bytes;
     hd720_lic's replay pictures through the block-sharded dispatch (a
     mesh and no pin), planes equal to the unsharded dispatch's; two
     processes of a gloo group on the card (this script with
     --multihost-rank): the lookahead over the global mesh equal to the
     unsharded maps and a multihost_gop encode of ra720_s3's first 5
     pictures (speed 3, the GOP pipeline's restriction profile) equal to
     the one-process encode; the device bench (gpu/device_bench.py);
     a torch.profiler trace of hd720_ld's first 2 pictures that names
     the picture kernels.  Then the seconds of each phase.

Any mismatch raises, so the exit code is nonzero.  The lines before the
last are a JSON object with the stage profile, a JSON object of
per-kernel results, one of the same kernels at 15 bit (phase 12) and the
nvidia-smi line; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device
the script exits with code 2 and prints no result.
"""
import concurrent.futures
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")
SEED = 20261016
_BIG = 1 << 20

KERNELS = {
    "mc": ("xvc_tpu_torch/kernels/csrc/mc.cu",
           "xvc_tpu/tpu/pallas_mc.py:43"),
    "itx": ("xvc_tpu_torch/kernels/csrc/itx.cu",
            "xvc_tpu/tpu/flat_recon.py:336"),
    "mc_picture": ("xvc_tpu_torch/kernels/csrc/mc.cu",
                   "xvc_tpu/tpu/pallas_mc.py:43"),
    "itx_picture": ("xvc_tpu_torch/kernels/csrc/itx.cu",
                    "xvc_tpu/tpu/flat_recon.py:336"),
    "deblock_edges": ("xvc_tpu_torch/kernels/csrc/deblock_edges.cu",
                      "xvc_tpu/tpu/deblock_jax.py:44"),
    "deblock_luma": ("xvc_tpu_torch/kernels/csrc/deblock.cu",
                     "xvc_tpu/tpu/deblock_jax.py:179"),
    "deblock_chroma": ("xvc_tpu_torch/kernels/csrc/deblock.cu",
                       "xvc_tpu/tpu/deblock_jax.py:295"),
    "satd": ("xvc_tpu_torch/kernels/csrc/satd.cu",
             "xvc_tpu/tpu/pallas_satd.py:62"),
    "intra_satd": ("xvc_tpu_torch/kernels/csrc/intra_satd.cu",
                   "xvc_tpu/tpu/analysis.py:27"),
    "intra_luma": ("xvc_tpu_torch/kernels/csrc/intra_scan.cu",
                   "xvc_tpu/tpu/intra_scan.py:51"),
    "intra_chroma": ("xvc_tpu_torch/kernels/csrc/intra_scan.cu",
                     "xvc_tpu/tpu/intra_scan.py:296"),
    "txrd": ("xvc_tpu_torch/kernels/csrc/txrd.cu",
             "xvc_tpu/tpu/txrd_prepass.py:80"),
    "resample": ("xvc_tpu_torch/kernels/csrc/resample.cu",
                 "xvc_tpu/tpu/resample_jax.py:44"),
    "me_sad": ("xvc_tpu_torch/kernels/csrc/me_sad.cu",
               "xvc_tpu/tpu/me.py:30"),
}
# the kernels each path must launch, and those the decode must not (the
# group kernels, whose jobs the picture kernels derive on the card)
DECODE_KERNELS = ("mc_picture", "itx_picture", "deblock_edges",
                  "deblock_luma", "deblock_chroma", "intra_luma",
                  "intra_chroma")
OFF_DECODE_KERNELS = ("mc", "itx")
# the bench streams phase 3 decodes, with their pictures: hd720_ld is the
# flat path's main stream, hd720_lic (LIC on in every inter picture) the
# replay path's (gpu/recon.py)
BENCH = (("hd720_ld", 8), ("hd720_lic", 8), ("cif_ai", 16),
         ("fhd1080_ra", 8), ("qhd1440_ra10", 5), ("uhd2160_ra10", 3))
RECON_STREAM = "hd720_lic"
PROFILED = ("hd720_ld", "hd720_lic", "fhd1080_ra")
# phase 2: the pictures whose record tables the picture kernels are held
# on (decode-order indices; paths under tests/data): every picture of
# hd720_ld and hd720_lic (the two timed), one picture of each other bench
# stream, and every picture of goldens the flat path refuses: 4:2:2 and
# 4:4:4 (c4*_ra64x48 with inter pictures), a restricted toolset, LIC
PICTURE_CASES = (("bench/hd720_ld", tuple(range(8))),
                 ("bench/hd720_lic", tuple(range(8))),
                 ("bench/cif_ai", (0,)), ("bench/fhd1080_ra", (3,)),
                 ("bench/qhd1440_ra10", (1,)), ("bench/uhd2160_ra10", (1,)),
                 ("cf_c422", (0, 1)), ("cf_c444", (0, 1)),
                 ("c422_ra64x48", tuple(range(5))),
                 ("c444_ra64x48", tuple(range(5))),
                 ("rm1_64x48", (0, 1, 2)), ("ra64x48", tuple(range(10))))
TIMED_STREAMS = ("bench/hd720_ld", "bench/hd720_lic")
# phase 4: every golden of tests/data with a _dec.yuv, with its picture
# count (the JAX package's host decode of each gives the same), and the
# port's own 4:2:2 / 4:4:4 inter streams with their _dec.sha256 (the JAX
# package's host decode)
GOLDENS = {"ai16x16": 2, "ai352x288": 2, "ai44x36": 2, "ai64x48": 3,
           "ai64x48b10": 2, "ai64x48q27": 2, "ai64x48q37": 2, "b12": 2,
           "cf_c422": 2, "cf_c444": 2, "cf_mono": 2, "cg48x32": 6,
           "enc_encap": 3, "ld64x48": 8, "ra128x96": 17, "ra64x48": 10,
           "ra64x48b10": 9, "ra96x64pl": 9, "radbg": 10, "res16x24": 2,
           "res20x36": 2, "res24x16": 2, "res44x20": 2, "rm1_64x48": 3,
           "rm2_64x48": 3, "rm3_64x48": 3, "rm4_64x48": 3,
           "scal16to24": 17, "sp_cksum0": 6, "sp_fast": 6,
           "sp_leadpics": 6, "sp_placebo": 6, "sp_tunepsnr": 6}
HASHED = (("c422_ra64x48", 5), ("c444_ra64x48", 5))
LOOKAHEAD_KERNELS = ("intra_satd",)
# phase 6: the kernels an encode at speed 3 must launch (the SATD of the
# prepass's predictions; the all-mode intra SATD of the split DP's
# lookahead; the prepass's txrd, from the SATD screen to the kept modes)
ENCODE_KERNELS = ("satd", "intra_satd", "txrd")
# phase 6's stage profile and torch.profiler trace encode the first two
# pictures of hd720_s3 (an intra and an inter picture; cut from four to
# keep the script inside its time limit with phase 10)
PROFILED_ENCODE_PICTURES = 2
# hd720_s3, the encode clip of phase 6: a copy of tests/test_torch_encode.py
# HD720_S3 and make_hd720_s3 (a test holds the two equal)
HD720_S3 = dict(width=1280, height=720, frames=4, qp=32, seed=20261017)
# the carve-out of the speed-3 stream (the transform-RD prepass's float
# arithmetic): where its bytes differ from the JAX package's, the run must
# show no kernel-vs-plain difference, fewer than this share of prepass
# blocks unlike hd720_s3_cands.npz, bytes within 1% and every picture's
# PSNR within 0.05 dB of the JAX stream's
# phase 8: the Python CU encoder's clips, a copy of tests/encode_clips.py
# PYTHON_CU and PYTHON_CU_SOURCE (tests/test_torch_python_cu.py holds the
# two equal): crops at (0, 0) of the first pictures of hd720_ld as
# decoded, all-intra, qp 32, speed mode 2; cif_la with the lookahead,
# qcif_pp under XVC_INTRA_PREPASS=jax (the per-CU device pre-pass)
PYTHON_CU = {
    "cif_la": dict(width=352, height=288, pictures=1,
                   settings="tpu_intra_lookahead 1", env={}),
    "qcif_pp": dict(width=176, height=144, pictures=2, settings="",
                    env={"XVC_INTRA_PREPASS": "jax"}),
}
PYTHON_CU_SOURCE = ("hd720_ld", 1280, 720)
# phase 8 traces cif_la's encode itself under torch.profiler (some 700
# device operations: the profiler costs it nothing measurable), and
# qcif_pp's on a second encode of its first picture (about 900,000 device
# operations a picture, which the profiler slows by about a quarter; one
# picture, not both, to keep the script inside its time limit)
PYTHON_CU_TRACED_APART = ("qcif_pp",)
PYTHON_CU_KERNELS = ("intra_satd", "deblock_edges", "deblock_luma",
                     "deblock_chroma")
# phase 9: the Python CU encoder's inter clips, a copy of
# tests/encode_clips.py PYTHON_CU_INTER (tests/test_torch_python_cu_inter.py
# holds the two equal), both under XVC_ME=jax: qcif_me, crops of the first
# two pictures of hd720_ld as decoded, low delay, the uni-prediction search
# range at 64 so that the TZ sweeps fit the device window; ra64x48_me,
# random access with two references
PYTHON_CU_INTER = {
    "qcif_me": dict(
        source="bench/hd720_ld.xvc", width=176, height=144, pictures=2,
        params=dict(num_ref_pics=1, sub_gop_length=1, low_delay=1,
                    speed_mode=2),
        settings="inter_search_range_uni_max 64 inter_search_range_uni_min 64",
        env={"XVC_ME": "jax"}),
    "ra64x48_me": dict(
        source="ra64x48_in.yuv", width=64, height=48, pictures=5,
        params=dict(num_ref_pics=2, sub_gop_length=4), settings="",
        env={"XVC_ME": "jax"}),
}
# the device shares of the prefetches the JAX package's TZ search made on
# the CPU, as measured when the slice was planned (a 176x144 low-delay
# crop at range 64, default speed; ra64x48 pictures 0-4); printed beside
# this run's
PYTHON_CU_INTER_PLANNED_DEVICE_SHARE = {"qcif_me": 0.53, "ra64x48_me": 0.059}
# the clip whose device sweeps time me_sad (its launches are the kernels
# line's)
ME_SWEEPS_CLIP = "qcif_me"
PYTHON_CU_INTER_KERNELS = ("me_sad", "deblock_edges", "deblock_luma",
                           "deblock_chroma")
# phase 10: ra720_s3, the threaded encode clip, a copy of
# tests/encode_clips.py RA720_S3 and make_ra720_s3 (a test holds the two
# equal): random access, sub-GOP 8, speed mode 3 and its one reference
# picture; encoded with no picture threads and with THREADS, then
# ra64x48_me (phase 9's clip) with THREADS, then the apps with THREADS on
# the first APP_PICTURES pictures of ra720_s3 as y4m
RA720_S3 = dict(width=1280, height=720, frames=9, qp=32, sub_gop_length=8,
                seed=20261018)
THREADS = 4
THREADED_INTER_CLIP = "ra64x48_me"
APP_PICTURES = 2
# phase 11: the tile-row streams of tests/encode_clips.py TILE_STREAMS
# (made by the JAX package's encoder; tests/test_torch_tiles_encode.py
# holds these names and picture counts equal to its table), with their
# pictures: hd720_tiles4, 1280x720 in 4 tiles, the flat path's;
# tiles64x128_lic, 2 tiles with LIC on, the replay path's (tiles64x256 is
# the card tests'); hd720_tiles4 is decoded TILES_TURNS times in turns with
# hd720_ld
TILE_STREAMS = {"hd720_tiles4": 3, "tiles64x256": 3, "tiles64x128_lic": 3}
TILES_STREAM = "hd720_tiles4"
TILES_REPLAY_STREAM = "tiles64x128_lic"
TILES_TURNS = 2
# phase 11's encode clip, a copy of tests/encode_clips.py PYTHON_CU_TILES
# (tests/test_torch_tiles_encode.py holds the two equal): qcif_me's crops
# and settings, its 3 CTU rows in 3 tiles, under XVC_ME=jax and
# XVC_INTRA_PREPASS=jax
PYTHON_CU_TILES = {
    "qcif_tiles": dict(
        source="bench/hd720_ld.xvc", width=176, height=144, pictures=2,
        params=dict(num_ref_pics=1, sub_gop_length=1, low_delay=1,
                    speed_mode=2),
        settings="inter_search_range_uni_max 64 inter_search_range_uni_min "
                 "64 tile_rows 3",
        env={"XVC_ME": "jax", "XVC_INTRA_PREPASS": "jax"}),
}
PYTHON_CU_TILES_KERNELS = ("me_sad", "intra_satd", "deblock_edges",
                           "deblock_luma", "deblock_chroma")
# phase 2: me_sad's cases, (w, h) of every CU shape with SAD and SAD_FAST,
# the bit depth and the candidate count cycling over these (me_sad is
# timed on the device sweeps of phase 9's qcif_me encode)
# phase 12: the 15-bit stream (tests/data/bench/hd720_b15.xvc, the JAX
# package's encoder, recipe tests/encode_clips.py B15_STREAMS), the
# kernels of its path, and hd720_ld's first pictures through the Python
# parse in turns with the native parse
B15_STREAM = "hd720_b15"
B15_PICTURES = 4
B15_KERNELS = ("itx_picture", "mc_picture", "deblock_edges",
               "deblock_luma", "deblock_chroma", "intra_luma",
               "intra_chroma")
B15_TURNS = 1
PYTHON_PARSE_PICTURES = 2
ME_SIZES = (4, 8, 16, 32, 64)
ME_BITDEPTHS = (8, 10, 12, 16)
ME_COUNTS = (1, 44, 86, 754)
# phase 2: the per-CU pre-pass's shapes (one CU, its 67 modes)
PER_CU_SIZES = (4, 8, 16, 32)
# phase 2: the all-mode intra SATD's real shapes, (n, mode step) on the
# luma of picture 0 of hd720_ld: lookahead720's four sizes, then the
# split DP's lookahead (16 and 32 at step 4, 64 at step 8); the first is
# the row of the kernels line
INTRA_SATD_LOOKAHEAD = ((4, 1), (8, 1), (16, 1), (32, 1))
INTRA_SATD_SPLIT_DP = ((16, 4), (32, 4), (64, 8))
CARVE_OUT_BLOCKS = 0.001
CARVE_OUT_BYTES = 0.01
CARVE_OUT_DB = 0.05
SEGMENT_HEADER = 16  # NalUnitType.SEGMENT_HEADER
# phase 2: the full-width planes the resampler is timed on (luma and
# chroma of 1080p -> 720p and back), 8 bit
RESAMPLE_PLANES = (((1920, 1080), (1280, 720)), ((960, 540), (640, 360)),
                   ((1280, 720), (1920, 1080)), ((640, 360), (960, 540)))
# phase 2: the decoded pictures the per-picture call is timed on (stream,
# decode-order index, output size), and the one of the kernels line
RESAMPLE_PICTURES = {"fhd1080_to_720": ("fhd1080_ra", 3, (1280, 720)),
                     "hd720_to_1080": ("hd720_ld", 3, (1920, 1080))}
RESAMPLE_TIMED = "fhd1080_to_720"
# phase 7: the open-GOP splice of a 1280x720 and a 1920x1080 stream
# (tests/encode_clips.py make_splice): the output stays at 1280x720, so
# the 1080p pictures are downscaled on output and the 720p tail pictures
# predict from the 1080p key picture downscaled (the alternative
# reconstruction); the bench streams resized on output, a copy of
# tests/encode_clips.py RESIZED (a test holds the two equal): hash list ->
# (stream, DecoderParameters fields); the streams decoded with picture
# threads beside sequential decodes
SPLICE = "hd720_fhd1080_splice"
RESIZED_STREAMS = {
    "hd720_ld_out1920x1080": ("hd720_ld", dict(output_width=1920,
                                               output_height=1080)),
    "fhd1080_ra_out1280x720": ("fhd1080_ra", dict(output_width=1280,
                                                  output_height=720)),
    "qhd1440_ra10_out1920x1080b8": ("qhd1440_ra10", dict(
        output_width=1920, output_height=1080, output_bitdepth=8))}
THREADED_STREAMS = (("hd720_ld", 4), ("fhd1080_ra", 4))
# phase 13: meshes of slots on the card (parallel/mesh.py): the lookahead
# over MESH_SLOTS slots, ra720_s3 on THREADS picture threads pinned to
# MESH_SLOTS slots, the threaded decodes of THREADED_STREAMS pinned to
# MESH_DECODE_SLOTS slots, MESH_REPLAY_STREAM's replay pictures through
# the block-sharded dispatch, two processes of a gloo group (the
# lookahead over the global mesh and a multihost_gop encode of ra720_s3's
# first MESH_GOP_PICTURES pictures; each process given MESH_WORKER_S),
# the device bench and a trace of TRACE_PICTURES pictures of hd720_ld
MESH_SLOTS = 4
MESH_DECODE_SLOTS = 2
MESH_REPLAY_STREAM = "hd720_lic"
MESH_GOP_PICTURES = 5
MESH_WORKER_S = 300
TRACE_PICTURES = 2
GOP_PIPELINE_PROFILE = ("disable_inter_tmvp_mvp",
                        "disable_inter_tmvp_merge",
                        "disable_inter_tmvp_ref_list_derivation")

# Published peaks of one H100 SXM (NVIDIA's data sheet).  The sheet gives
# no int32 rate: the CUDA cores' float32 rate stands in for their integer
# operations, which issue at that rate at most, so a bound computed with
# it is still a time the card cannot beat.
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12
# float64 outside the tensor cores (the same data sheet: 34 TFLOP/s)
FP64_OPS_PER_S = 34e12
# One dependent global store -> done bit -> load round trip inside a block,
# assumed (not measured here) at two L2 accesses of about 270 cycles at
# 1.7 GHz.  Used only for the scans' chain estimate, which is no bound.
STORE_LOAD_ROUND_TRIP_S = 0.32e-6
# the pictures of hd720_ld whose scan inputs phase 2 captures and times:
# 0 (intra, 5,234 luma leaves) and 3 (inter, 14 intra luma leaves)
SCAN_PICTURES = (0, 3)
# One step of the luma deblock walk, arithmetic only: assumed (not
# measured here) at about 170 cycles at 1.7 GHz (some 30 dependent integer
# operations, two shuffle rounds, a ballot and a vote).  Used only for the
# walk's chain estimate, which is no bound.
LUMA_STEP_S = 0.1e-6


def bound(nbytes, ops):
    """The least time the card could take: the larger of bytes over the
    HBM rate and operations over the CUDA cores' peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=int(nbytes), bound_ops=int(ops))


def log(*args):
    print(*args, flush=True)


def make_hd720_s3(seed=HD720_S3["seed"]):
    """The raw 8-bit 4:2:0 bytes of hd720_s3: 1280x720, 4 pictures, from
    a numpy seed.  Luma quadrants: flat (top left, +2 a picture),
    diagonal stripes moving 4 samples a picture (top right), a noise
    texture moving by (2, 1) (bottom left), a ramp brightening by 3 a
    picture (bottom right), so that the split DP forces decisions both
    ways and the prepass has real choices; smooth chroma."""
    import numpy as np
    W, H, N = HD720_S3["width"], HD720_S3["height"], HD720_S3["frames"]
    rng = np.random.RandomState(seed)
    tex = rng.randint(-40, 41, (H // 2 + 8, W // 2 + 8))
    yy, xx = np.mgrid[0:H, 0:W]
    cy, cx = np.mgrid[0:H // 2, 0:W // 2]
    out = []
    for t in range(N):
        y = np.empty((H, W), np.int64)
        y[:H // 2, :W // 2] = 90 + 2 * t
        tr = (xx[:H // 2, W // 2:] + yy[:H // 2, W // 2:] // 2 + 4 * t) // 12
        y[:H // 2, W // 2:] = 60 + 130 * (tr & 1)
        y[H // 2:, :W // 2] = 128 + tex[t:t + H // 2, 2 * t:2 * t + W // 2]
        y[H // 2:, W // 2:] = ((xx[H // 2:, W // 2:] - W // 2) * 200 //
                               (W // 2) + (yy[H // 2:, W // 2:] - H // 2)
                               // 8 + 3 * t)
        u = 128 + (30 * np.sin(cx / 40.0 + t / 4.0)).astype(np.int64)
        v = 120 + (cy * 40) // (H // 2)
        out += [np.clip(p, 0, 255).astype(np.uint8).tobytes()
                for p in (y, u, v)]
    return b"".join(out)


def hd720_s3_session(api, prepass, dev):
    """The port's EncoderSession for hd720_s3 on ``dev``: low delay, one
    reference picture, sub-GOP 1, qp 32, speed mode 3, checksum mode 1;
    ``prepass`` False keeps the split DP alone (tpu_txrd_prepass 0)."""
    return api.EncoderSession(api.EncoderParameters(
        width=HD720_S3["width"], height=HD720_S3["height"],
        qp=HD720_S3["qp"], speed_mode=3, low_delay=1, num_ref_pics=1,
        sub_gop_length=1, checksum_mode=1,
        explicit_encoder_settings="" if prepass else "tpu_txrd_prepass 0"),
        device=dev)


def session_encode(session, yuv, frames):
    """Every NAL of the first ``frames`` pictures of hd720_s3's raw
    bytes ``yuv`` through ``session``."""
    fs = HD720_S3["width"] * HD720_S3["height"] * 3 // 2
    nals = []
    for i in range(frames):
        nals += session.encode(yuv[i * fs:(i + 1) * fs])
    return nals + session.flush()


def crop_pictures(pictures, src_w, src_h, w, h):
    """The 4:2:0 8-bit bytes of the top-left w x h crop of each picture
    (a copy of tests/encode_clips.py crop_pictures)."""
    import numpy as np
    out = []
    for pic in pictures:
        buf = np.frombuffer(pic, np.uint8)
        y = buf[:src_w * src_h].reshape(src_h, src_w)
        cw, ch = src_w // 2, src_h // 2
        u = buf[src_w * src_h:][:cw * ch].reshape(ch, cw)
        v = buf[src_w * src_h + cw * ch:][:cw * ch].reshape(ch, cw)
        out += [np.ascontiguousarray(y[:h, :w]).tobytes(),
                np.ascontiguousarray(u[:h // 2, :w // 2]).tobytes(),
                np.ascontiguousarray(v[:h // 2, :w // 2]).tobytes()]
    return b"".join(out)


def python_cu_params(api, name):
    """EncoderParameters of a PYTHON_CU clip (a copy of
    tests/encode_clips.py python_cu_params)."""
    clip = PYTHON_CU[name]
    return api.EncoderParameters(
        width=clip["width"], height=clip["height"], qp=32, speed_mode=2,
        num_ref_pics=0, sub_gop_length=1, checksum_mode=1,
        explicit_encoder_settings=clip["settings"])


def python_cu_inter_params(api, name, threads=0):
    """EncoderParameters of a PYTHON_CU_INTER clip with ``threads``
    picture threads (a copy of tests/encode_clips.py
    python_cu_inter_params)."""
    clip = PYTHON_CU_INTER[name]
    return api.EncoderParameters(
        width=clip["width"], height=clip["height"], qp=32, checksum_mode=1,
        explicit_encoder_settings=clip["settings"], threads=threads,
        **clip["params"])


def python_cu_tiles_params(api):
    """EncoderParameters of qcif_tiles (a copy of tests/encode_clips.py
    python_cu_inter_params on PYTHON_CU_TILES)."""
    clip = PYTHON_CU_TILES["qcif_tiles"]
    return api.EncoderParameters(
        width=clip["width"], height=clip["height"], qp=32, checksum_mode=1,
        explicit_encoder_settings=clip["settings"], threads=0,
        **clip["params"])


def make_ra720_s3(seed=RA720_S3["seed"]):
    """The raw 8-bit 4:2:0 bytes of ra720_s3: 1280x720, 9 pictures, from a
    numpy seed, with hd720_s3's content and more motion (a copy of
    tests/encode_clips.py make_ra720_s3)."""
    import numpy as np
    W, H, N = RA720_S3["width"], RA720_S3["height"], RA720_S3["frames"]
    rng = np.random.RandomState(seed)
    tex = rng.randint(-40, 41, (H // 2 + N, W // 2 + 3 * N))
    yy, xx = np.mgrid[0:H, 0:W]
    cy, cx = np.mgrid[0:H // 2, 0:W // 2]
    out = []
    for t in range(N):
        y = np.empty((H, W), np.int64)
        y[:H // 2, :W // 2] = 90 + 2 * t
        tr = (xx[:H // 2, W // 2:] + yy[:H // 2, W // 2:] // 2 + 6 * t) // 12
        y[:H // 2, W // 2:] = 60 + 130 * (tr & 1)
        y[H // 2:, :W // 2] = 128 + tex[t:t + H // 2, 3 * t:3 * t + W // 2]
        y[H // 2:, W // 2:] = ((xx[H // 2:, W // 2:] - W // 2) * 200 //
                               (W // 2) + (yy[H // 2:, W // 2:] - H // 2)
                               // 8 + 3 * t)
        u = 128 + (30 * np.sin(cx / 40.0 + t / 4.0)).astype(np.int64)
        v = 120 + (cy * 40) // (H // 2) + t
        out += [np.clip(p, 0, 255).astype(np.uint8).tobytes()
                for p in (y, u, v)]
    return b"".join(out)


def ra720_s3_params(api, threads=0):
    """EncoderParameters of ra720_s3 (a copy of tests/encode_clips.py
    ra720_s3_params)."""
    return api.EncoderParameters(
        width=RA720_S3["width"], height=RA720_S3["height"],
        qp=RA720_S3["qp"], speed_mode=3,
        sub_gop_length=RA720_S3["sub_gop_length"], checksum_mode=1,
        threads=threads)


def cuda_ms(torch, fn, iters=20, fresh=None):
    """Mean milliseconds per call of fn on the card (CUDA events, after
    one warm-up call).  Where fn changes its input in place, ``fresh``
    makes that input: every call gets a copy of its own, made before the
    first event, and fn takes it as its argument."""
    calls = [fn] * (iters + 1)
    if fresh is not None:
        calls = [lambda x=fresh(): fn(x) for _ in range(iters + 1)]
    calls[0]()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for call in calls[1:]:
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, name, iters=20):
    """Mean device time per call of fn of the kernels whose name holds
    ``name``, from torch.profiler over ``iters`` calls (after one warm-up
    call); None where the profiler records no device time for them.
    Unlike cuda_ms it does not see the host's launch path."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for ev in prof.key_averages():
        if name in ev.key:
            t = getattr(ev, "self_device_time_total", None)
            us += t if t is not None else getattr(ev, "self_cuda_time_total",
                                                  0)
    return us / 1e3 / iters if us else None


def max_err(torch, a, b):
    if a.shape != b.shape:
        raise AssertionError("shape %r != %r" % (tuple(a.shape),
                                                 tuple(b.shape)))
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


# ---------------------------------------------------------------------------
# Phase 2 inputs
# ---------------------------------------------------------------------------

def _tiles(n, tw, th, B):
    """Disjoint target positions for B jobs of tw x th on an n-wide grid."""
    import numpy as np
    ty, tx = np.divmod(np.arange(B), n)
    return ty * th, tx * tw


def mc_case(rng, luma, wb, hb, bd, short, B, S, Hp, Wp):
    import numpy as np
    nplanes = 1 if luma else 2
    nph = 16 if luma else 32
    taps = 8 if luma else 4
    wh, ww = hb + taps - 1, wb + taps - 1
    planes = rng.randint(0, 1 << bd, (S, Hp, Wp)).astype(np.int16)
    nx = 32
    cy, cx = _tiles(nx, wb, hb, B)
    H, W = int(cy.max()) + hb, nx * wb
    # window origins: mostly inside, some past either edge (clamped)
    ypad = rng.randint(-12, Hp - wh + 12, B)
    xpad = rng.randint(-12, Wp - ww + 12, B)
    fx = rng.randint(0, nph, B) * (rng.rand(B) > 0.25)
    fy = rng.randint(0, nph, B) * (rng.rand(B) > 0.25)
    w = rng.randint(wb // 2 + 1 if wb > 8 else 4, wb + 1, B)
    h = rng.randint(hb // 2 + 1 if hb > 8 else 4, hb + 1, B)
    params = np.stack([rng.randint(0, S, B), ypad, xpad, fx, fy,
                       rng.randint(0, 2 * nplanes, B), cy, cx, w,
                       h]).astype(np.int32)
    params[:, B - B // 16:] = _BIG  # padding lanes
    pred = np.zeros((2 * nplanes, H, W), np.int16)
    mask = np.zeros((nplanes, H, W), np.int16)
    return planes, params, pred, mask


def itx_case(rng, w, h, bd, B, nplanes, gen):
    import numpy as np
    nx = max(1, 512 // w)
    cy, cx = _tiles(nx, w, h, B)
    H, W = int(cy.max()) + h, nx * w
    coeff = rng.randint(-32768, 32768, (B, h, w)).astype(np.int16)
    coeff[rng.rand(B, h, w) < 0.7] = 0
    scale = rng.randint(1, 1 << 22, B).astype(np.int32)
    rows = [rng.randint(0, nplanes, B), cy, cx]
    if gen:
        rows += [rng.randint(0, 5, B), rng.randint(0, 5, B)]
    params = np.stack(rows).astype(np.int32)
    params[:3, B - B // 8:] = _BIG
    if gen:
        params[3:, B - B // 8:] = 0
    resi = np.zeros((nplanes, H, W), np.int32)
    return coeff, scale, params, resi


def satd_case(rng, shape, bd):
    """Differences over the full range +-(2^bd - 1), extremes included."""
    import numpy as np
    lim = (1 << bd) - 1
    diff = rng.randint(-lim, lim + 1, shape).astype(np.int32)
    diff.reshape(-1)[:2] = (lim, -lim)
    return diff


# ---------------------------------------------------------------------------
# Bounds: the bytes each kernel must move (every input read once, every
# output written once) and the integer operations it does, for the inputs
# of this run
# ---------------------------------------------------------------------------

def mc_bound(planes, params, taps, short):
    """Per valid job: its (h+taps-1) x (w+taps-1) int16 window (capped
    by the size of the store), its w x h int16 output (and mask when
    short); 2 operations per filter tap, horizontal pass over the
    extended rows when both fractions are set."""
    import numpy as np
    p = params[:, params[5] < _BIG].astype(np.int64)
    fx, fy, w, h = p[3], p[4], p[8], p[9]
    win = min(int(((h + taps - 1) * (w + taps - 1)).sum()) * 2,
              planes.nbytes)
    out = int((w * h).sum()) * 2 * (2 if short else 1)
    hor = np.where(fx != 0, np.where(fy != 0, h + taps - 1, h) * w, 0)
    ver = np.where(fy != 0, h * w, 0)
    ops = int((hor + ver).sum()) * 2 * taps + int((w * h).sum()) * 4
    return bound(win + params.nbytes + out, ops)


def itx_bound(coeff, scale, params, w, h):
    """Coefficients, scales, parameters and the two 5-family basis
    stacks in; w x h int32 residual out per valid block; 4 operations
    per coefficient to dequantize, 2 per multiply-add of the two
    passes (zero-out: at most 32 input rows/columns)."""
    valid = int((params[0] < _BIG).sum())
    in1, cols = min(h, 32), min(w, 32)
    bases = 5 * (in1 * h + cols * w + 2) * 4
    nbytes = coeff.nbytes + scale.nbytes + params.nbytes + bases + \
        valid * w * h * 4
    ops = valid * (4 * w * h + 2 * in1 * h * cols + 2 * cols * h * w +
                   8 * h * w)
    return bound(nbytes, ops)


def itx_picture_bound(pic):
    """What the picture's coded blocks need: the record table read once,
    the qp-scale table and the bases of the sides it uses, per block its
    w x h int32 coefficients and its int32 residual samples inside the
    plane; 4 operations per coefficient to dequantize, 2 per multiply-add
    of the two passes (zero-out: at most 32 input rows / columns) and 8
    per output sample, 6 per sample of a transform-skip block."""
    import numpy as np
    import torch
    from xvc_tpu_torch import constants as k
    from xvc_tpu_torch.gpu import itx
    qps = itx.qp_scale_table(k.ChromaFormat(pic["chroma_format"]),
                             pic["bitdepth"], *pic["qp_key"])
    dims = [(pic["height"], pic["width"])] + \
        ([] if pic["mono"] else [(pic["Hc"], pic["Wc"])])
    nbytes = pic["records"].nbytes + qps.nbytes
    ops = blocks = 0
    sides = set()
    for job in itx.itx_jobs(torch.from_numpy(pic["records"]),
                            len(pic["coeff"]), torch.from_numpy(qps),
                            pic["bitdepth"], pic["no_dst"], pic["sx"],
                            pic["sy"], dims):
        H, W = dims[min(job["comp"], 1)]
        x, y, w, h, var = (job[n].numpy().astype(np.int64)
                           for n in ("x", "y", "w", "h", "var"))
        inside = np.minimum(w, W - x) * np.minimum(h, H - y)
        in1, cols = np.minimum(h, 32), np.minimum(w, 32)
        mat = var != 3
        nbytes += int((w * h).sum()) * 4 + int(inside.sum()) * 4
        ops += int((mat * (4 * w * h + 2 * in1 * h * cols +
                           2 * cols * h * w + 8 * h * w)).sum())
        ops += int((~mat * 6 * w * h).sum())
        blocks += len(w)
        sides |= set(w[mat].tolist()) | set(h[mat].tolist())
    # five families of min(side, 32) x side int32 per side used
    nbytes += sum(5 * min(n, 32) * n * 4 for n in sides)
    return dict(nbytes=nbytes, ops=ops, blocks=blocks)


def mc_picture_bound(pic):
    """What the picture's MC jobs need: the record table and the
    reference table read once; the reference samples of the union of the
    jobs' windows (affine subblocks one by one), each (h + taps - 1) x (w
    + taps - 1) int16 where the kernel places it, read once; per job its w
    x h int16 samples inside the plane and, for the second prediction of a
    bi leaf, as many mask samples; 2 operations per filter tap (the
    horizontal pass over the extended rows when both phases are set), 4
    per sample."""
    import numpy as np
    import torch
    from xvc_tpu_torch.gpu import flat_cases, mc
    dims = [(pic["height"], pic["width"])] + \
        ([] if pic["mono"] else [(pic["Hc"], pic["Wc"])])
    refs = flat_cases.ref_table(pic)
    rows = mc.mc_jobs(torch.from_numpy(pic["records"]),
                      torch.from_numpy(refs), flat_cases.STORE_SLOTS, dims,
                      flat_cases.mc_flags(pic)).numpy()
    luma, short, fx, fy, chan, cy, cx, w, h = (rows[i] for i in (
        0, 1, 5, 6, 7, 8, 9, 10, 11))
    taps = np.where(luma == 1, 8, 4)
    H = np.where(luma == 1, dims[0][0], dims[-1][0])
    W = np.where(luma == 1, dims[0][1], dims[-1][1])
    inside = np.clip(np.minimum(w, W - cx), 0, None) * \
        np.clip(np.minimum(h, H - cy), 0, None)
    second = (short == 1) & (chan >= np.where(luma == 1, 1, 2))
    # the windows' union, per stack, as the kernel clamps them
    stacks = {1: np.zeros((flat_cases.STORE_SLOTS,) + pic["luma_store"],
                          bool)}
    if not pic["mono"]:
        stacks[0] = np.zeros((2 * flat_cases.STORE_SLOTS,) +
                             pic["chroma_store"], bool)
    bucket = lambda n: 8 if n <= 8 else (16 if n <= 16 else
                                         (32 if n <= 32 else 64))
    for j in range(rows.shape[1]):
        plane = stacks[int(luma[j])]
        R, Hp, Wp = plane.shape
        t = int(taps[j])
        r = min(max(int(rows[2, j]), 0), R - 1)
        y0 = min(max(int(rows[3, j]), 0), Hp - bucket(h[j]) - t + 1)
        x0 = min(max(int(rows[4, j]), 0), Wp - bucket(w[j]) - t + 1)
        plane[r, y0:y0 + h[j] + t - 1, x0:x0 + w[j] + t - 1] = True
    win = sum(int(p.sum()) for p in stacks.values()) * 2
    nbytes = pic["records"].nbytes + refs.nbytes + win + \
        int((inside * (1 + second)).sum()) * 2
    hor = np.where(fx != 0, np.where(fy != 0, h + taps - 1, h) * w, 0)
    ver = np.where(fy != 0, h * w, 0)
    ops = int(((hor + ver) * 2 * taps).sum()) + int((w * h).sum()) * 4
    return dict(nbytes=nbytes, ops=ops, jobs=rows.shape[1])


def luma_deblock_bound(plane, mask, entry_bytes):
    """The plane read and written once, the edge entries read once; about
    60 operations per line of an active (edge, 4-line group), 10 per
    inactive group.  mask (E, groups) numpy.  Beside the bound, and no
    bound itself, the chain estimate: the most edges any 4-line group
    filters (a block walks one group and skips its masked-out edges)
    times the assumed latency of one step."""
    active = int((mask != 0).sum())
    steps = int((mask != 0).sum(axis=0).max())
    return dict(bound(2 * plane.nbytes + entry_bytes,
                      active * 4 * 60 + (mask.size - active) * 10),
                chain_steps=steps,
                chain_estimate_ms=steps * LUMA_STEP_S * 1e3)


def chroma_deblock_bound(planes, apply, entry_bytes):
    """Both planes read and written once, the entries read once; about
    20 operations per applied (edge, sample) of a plane, 4 per other."""
    on = int((apply != 0).sum())
    return bound(2 * sum(p.nbytes for p in planes) + entry_bytes,
                 len(planes) * (on * 20 + (apply.size - on) * 4))


def edges_bound(attrs, cu_map, params):
    """The attribute table read once, the CU map and the entries written
    once; about 100 operations per entry, 2 per map cell."""
    return bound(attrs.nbytes + cu_map.nbytes + params.nbytes,
                 params.size * 100 + cu_map.size * 2)


def satd_bound(diff, n):
    """Every difference read once, one int32 out per block; per 8x8 tile
    2 x 192 butterfly additions, 64 |.| and 64 additions (per 4x4: 2 x 32
    + 16 + 16)."""
    blocks = diff.size // (n * n)
    per_block = 96 if n == 4 else (n // 8) ** 2 * 512
    return bound(diff.nbytes + blocks * 4, blocks * per_block)


def intra_satd_bound(blocks, n, modes):
    """Every block's orig, top and left read once (int32), its M costs
    written; some 20 integer operations a predicted sample (its two taps
    or the planar sum, the difference, its share of the butterflies and
    of |.|)."""
    return bound(blocks * (n * n + 4 * n + 1 + modes) * 4,
                 20 * blocks * modes * n * n)


def txrd_bound(torch, orig, preds, satd, n, bd, keep, p):
    """What the txrd kernel must do on these inputs.  Bytes: orig and
    satd read once, the 8 picked n x n tiles of preds (not the other
    modes), [B, keep] int32 written.  Operations, each type over its own
    peak rate: the transform's 2n int32 multiply-adds per coefficient
    (two operations each) and the squared error's multiply-add; per
    coefficient 16 float32 operations (the two floor shifts, |.|, the two
    quantizations with their clamps, the difference) and 2 float64 ones
    (the contracted product), and per coefficient of nonzero level, as
    this run's data has them, 3 more float32 (the bit term, log2 being a
    table lookup); the screen, 8 rounds over the M SATDs of a block."""
    from xvc_tpu_torch.gpu import txrd_prepass as tx
    blocks, m = satd.shape
    cand = tx._stable_best(satd, tx.SATD_KEEP)
    idx = cand[:, :, None, None].expand(-1, -1, n, n)
    coeff = tx.forward_transform(orig[:, None] - torch.gather(preds, 1, idx),
                                 n, bd)
    u = (coeff.abs().double() * p["scale"] + p["offset"]).float()
    nonzero = int((torch.floor(u * p["p_shift"]) > 0).sum().item())
    coeffs = blocks * tx.SATD_KEEP * n * n
    nbytes = (orig.numel() + satd.numel() + coeffs + blocks * keep) * 4
    ints = coeffs * (4 * n + 2) + blocks * tx.SATD_KEEP * m * 2
    f32 = 16 * coeffs + 3 * nonzero
    f64 = 2 * coeffs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ((ints + f32) / CUDA_CORE_OPS_PER_S + f64 / FP64_OPS_PER_S) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=int(nbytes), bound_ops=int(ints + f32 + f64))


def scan_bound(kind, meta, steps):
    """What this picture's rows need.  Per active row: its w x h int32
    residual read and int16 samples written; the canvas samples its
    reference line is made of (the h + sbl rows of the left column inside
    the line's w + h when has_l, the corner when has_al, the w above and
    the min(sar, h) above-right samples when has_a), int16 each; for an
    LM row the 2 (h + has_a) x (2 w + 3 has_l) int16 luma samples that
    rescale_luma reads; its metadata row.  An inactive row: its ACTIVE
    column alone.  About 12 operations per sample, 8 per entry of the
    2 (w + h) + 1 long reference line, 12 per LM grid sample.  Beside the
    bound, and no bound itself, the chain estimate: ``steps``, the rows of
    the longest chain of the schedule the kernel took (gpu/scan_deps.py),
    times one dependent store-to-load round trip."""
    import numpy as np
    luma = kind == "luma"
    live = meta[:, 10 if luma else 12] != 0
    m = meta[live].astype(np.int64)
    w, h, has_l, has_a, has_al, sbl, sar = (
        m[:, c] for c in ((2, 3, 5, 6, 7, 8, 9) if luma else
                          (3, 4, 7, 8, 9, 10, 11)))
    has_l, has_a, has_al = has_l != 0, has_a != 0, has_al != 0
    samples = int((w * h).sum())
    ref_read = int((has_l * np.minimum(h + sbl, w + h) + has_al +
                    has_a * (w + np.minimum(sar, h))).sum())
    ref_line = int((2 * (w + h) + 1).sum())
    nbytes = samples * 6 + ref_read * 2 + \
        len(m) * meta.shape[1] * 4 + int((~live).sum()) * 4
    ops = samples * 12 + ref_line * 8
    if not luma:
        lm = m[:, 6] != 0
        nbytes += int((lm * 2 * (h + has_a) * (2 * w + 3 * has_l)).sum()) * 2
        ops += int((lm * (h + 1) * (w + 1)).sum()) * 12
    return dict(bound(nbytes, ops), rows=len(m), samples=samples,
                ref_samples_read=ref_read, chain_steps=steps,
                chain_estimate_ms=steps * STORE_LOAD_ROUND_TRIP_S * 1e3)


def scan_schedule(torch, scan, kind, meta, shape):
    """The schedule the last launch of the ``kind`` scan took, held to
    the dependency model (gpu/scan_deps.py): parallel inside its
    contract, ordered outside it, every active row of each plane run,
    tickets in wavefront order where the model gives that order.
    Returns (schedule names, rows run, steps, ticket steps), the steps
    the most over the planes: steps is the graph's longest path (ordered:
    every row of the plane), ticket steps what the kernel's warps need
    taking tickets in its order (scan_deps.ticket_steps)."""
    from xvc_tpu_torch.gpu import scan_deps
    torch.cuda.synchronize()
    status = scan.last_status("intra_" + kind).cpu().numpy()
    scheds = scan_deps.analyse(kind, meta, shape)
    scheds = (scheds,) if kind == "luma" else scheds
    names, steps, tsteps = [], 0, 0
    for s, st in zip(scheds, status):
        order = None
        if s.in_contract:
            order = scan_deps.wavefront_order(kind, meta, shape, s)
        want = (scan.PARALLEL if s.in_contract else scan.ORDERED,
                len(s.rows), int(order is not None))
        if (st[0], st[1], st[4]) != want:
            raise AssertionError("intra_%s took (schedule, rows, wavefront) "
                                 "%r, the dependency model says %r"
                                 % (kind, tuple(st[[0, 1, 4]]), want))
        if not s.in_contract:
            names.append("ordered")
            steps = tsteps = max(steps, len(s.rows))
            continue
        names.append("wavefront" if order is not None else "parallel")
        steps = max(steps, s.longest)
        tsteps = max(tsteps, scan_deps.ticket_steps(
            s, s.rows if order is None else order, int(st[3])))
    return names, [int(st[1]) for st in status], steps, tsteps


def time_scans(torch, scans):
    """Milliseconds per launch of each scan kernel on the inputs of each
    entry of ``scans`` (picture -> kind -> arguments, as
    ``capture_inputs`` keeps them), every timed launch on a copy of the
    canvas made before the first event."""
    from xvc_tpu_torch.gpu import intra_scan as scan
    out = {}
    for pic, calls in scans.items():
        plane, resi, meta, bd = calls["luma"]
        out["intra_luma", pic] = cuda_ms(
            torch, lambda p: scan.intra_scan(p, resi, meta, bd),
            fresh=plane.clone)
        if "chroma" in calls:
            planes, resi_c, luma, meta_c, bd_c = calls["chroma"]
            out["intra_chroma", pic] = cuda_ms(
                torch, lambda p: scan.intra_chroma_scan(p, resi_c, luma,
                                                        meta_c, bd_c),
                fresh=planes.clone)
    return out


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def capture_inputs(data, scan_pictures=SCAN_PICTURES):
    """Decode ``data`` on the card and keep copies of what the luma and
    chroma scans of ``scan_pictures`` were given (before they wrote), of
    what every ``edge_params`` call of the first two pictures was given,
    and of those pictures' planes before deblocking; and the bytes of
    picture 0 as decoded."""
    from xvc_tpu_torch.codec import picture_decoder
    from xvc_tpu_torch.codec.decoder import decode_stream
    from xvc_tpu_torch.gpu import deblock, flat_recon, recon
    from xvc_tpu_torch.gpu import intra_scan as scan
    got = {"pictures": [], "scans": {}}
    flat = []  # one entry per picture either path reconstructs
    orig_l, orig_c = scan.intra_scan, scan.intra_chroma_scan
    orig_e, orig_d = deblock.edge_params, picture_decoder.deblock_picture
    classes = (flat_recon.FlatReconstructor, recon.Reconstructor)
    runs = [cls.run for cls in classes]

    def counted(run):
        def rec_r(self):
            flat.append(None)
            return run(self)
        return rec_r

    def rec_l(plane, resi, meta, bd):
        if len(flat) - 1 in scan_pictures:
            got["scans"].setdefault(len(flat) - 1, {})["luma"] = (
                plane.clone(), resi.clone(), meta.clone(), bd)
        return orig_l(plane, resi, meta, bd)

    def rec_c(planes, resi, luma, meta, bd):
        if len(flat) - 1 in scan_pictures:
            got["scans"].setdefault(len(flat) - 1, {})["chroma"] = (
                planes.clone(), resi.clone(), luma.clone(), meta.clone(), bd)
        return orig_c(planes, resi, luma, meta, bd)

    def rec_e(attrs, *args):
        if len(got["pictures"]) <= 2:
            got["pictures"][-1]["edges"].append((attrs.clone(),) + args)
        return orig_e(attrs, *args)

    def rec_d(filt, planes, device):
        if len(got["pictures"]) < 2:
            passes, flags = deblock.picture_passes(filt)
            got["pictures"].append(dict(
                planes={c: p.clone() for c, p in planes.items()},
                bitdepth=filt.pic.bitdepth, flags=flags, edges=[],
                secondary=len(passes) > 1))
        else:
            got["pictures"].append(None)
        return orig_d(filt, planes, device)

    scan.intra_scan, scan.intra_chroma_scan = rec_l, rec_c
    deblock.edge_params, picture_decoder.deblock_picture = rec_e, rec_d
    for cls, run in zip(classes, runs):
        cls.run = counted(run)
    try:
        got["picture0"] = decode_stream(data)[0].bytes
    finally:
        scan.intra_scan, scan.intra_chroma_scan = orig_l, orig_c
        deblock.edge_params, picture_decoder.deblock_picture = orig_e, orig_d
        for cls, run in zip(classes, runs):
            cls.run = run
    got["pictures"] = got["pictures"][:2]
    if sorted(got["scans"]) != list(scan_pictures):
        raise AssertionError("no scan inputs of pictures %r" % (
            sorted(set(scan_pictures) - set(got["scans"])),))
    return got


def phase_scan_kernels(torch, dev, res, real, parent):
    """The two intra scan kernels against their plain versions: the
    synthetic families of xvc_tpu_torch/gpu/scan_cases.py, then the real
    scan inputs of pictures 0 and 3 of hd720_ld (``real``, from
    ``capture_inputs``).  Per case: the schedule the kernel took (held to
    the dependency model), the longest chain of that schedule, the time
    of a launch and the time per step; both kernels timed at pictures 0
    and 3 and on the interleaved tiled case (10 bit), and, where
    ``parent`` names a checkout, its kernels on the same inputs."""
    from xvc_tpu_torch.gpu import scan_cases as cases
    from xvc_tpu_torch.gpu import intra_scan as scan
    T = lambda a: torch.from_numpy(a.copy()).to(dev)

    kernel = dict(luma=scan.intra_scan, chroma=scan.intra_chroma_scan)
    plain = dict(luma=scan.intra_scan_plain,
                 chroma=scan.intra_chroma_scan_plain)

    def run(fns, kind, plane, resi, luma, meta, bd):
        args = (resi, meta, bd) if kind == "luma" else (resi, luma, meta, bd)
        return fns[kind](plane.clone(), *args)

    def both(kind, plane, resi, luma, meta, bd, tag):
        """Bit-exact and not a no-op; then the schedule, the steps, a
        timed launch (on copies of the canvas) and the time per step."""
        got = run(kernel, kind, plane, resi, luma, meta, bd)
        names, rows, steps, tsteps = scan_schedule(
            torch, scan, kind, meta.cpu().numpy(), tuple(plane.shape))
        want = run(plain, kind, plane, resi, luma, meta, bd)
        torch.cuda.synchronize()
        e = max_err(torch, got, want)
        if e or torch.equal(got, plane):
            raise AssertionError("intra_%s mismatch or no-op: %r, err %d"
                                 % (kind, tag, e))
        args = (resi, meta, bd) if kind == "luma" else (resi, luma, meta, bd)
        ms = cuda_ms(torch, lambda p: kernel[kind](p, *args), 3,
                     fresh=plane.clone)
        log("phase 2: intra_%s %s: %s, rows %s, longest path %d, ticket "
            "steps %d, %.4f ms, %.3f us per step of the path, %.3f per "
            "ticket step" % (kind, tag, "/".join(names), rows, steps,
                             tsteps, ms, ms * 1e3 / max(steps, 1),
                             ms * 1e3 / max(tsteps, 1)))
        return e, names, (steps, tsteps)

    err = {"luma": 0, "chroma": 0}
    families = []
    for kind, dims in (("luma", cases.LUMA_DIMS),
                       ("chroma", cases.CHROMA_DIMS)):
        for bd in (8, 10):
            families.append(("corner", cases.corner_case(kind, bd)))
            families += [("shape %dx%d" % (w, h),
                          cases.shape_case(kind, w, h, bd))
                         for w in dims for h in dims]
            families.append(("tiled", cases.tiled_case(kind, bd)))
            families.append(("tiled interleaved",
                             cases.tiled_case(kind, bd, interleave=True)))
    families += [("lm_wrap", cases.lm_wrap_case(bd)) for bd in (8, 10, 12)]
    for name, c in families:
        luma = None if c["luma"] is None else T(c["luma"])
        e, names, _ = both(c["kind"], T(c["plane"]), T(c["resi"]), luma,
                           T(c["meta"]), c["bd"],
                           "%s %d-bit" % (name, c["bd"]))
        err[c["kind"]] = max(err[c["kind"]], e)
        want = {"tiled": "wavefront", "tiled interleaved": "parallel"}
        if names != [want.get(name, "ordered")] * len(names):
            raise AssertionError("intra_%s %s ran %s" % (c["kind"], name,
                                                         names))

    steps = {}
    for pic in SCAN_PICTURES:
        plane, resi, meta, bd = real["scans"][pic]["luma"]
        planes_c, resi_c, luma_c, meta_c, bd_c = real["scans"][pic]["chroma"]
        tag = "hd720_ld picture %d" % pic
        e, names, steps["luma", pic] = both("luma", plane, resi, None, meta,
                                            bd, tag)
        err["luma"] = max(err["luma"], e)
        e, cnames, steps["chroma", pic] = both(
            "chroma", planes_c, resi_c, luma_c, meta_c, bd_c, tag)
        err["chroma"] = max(err["chroma"], e)
        if pic == 0 and names + cnames != ["wavefront"] * 3:
            raise AssertionError("picture 0 ran %s / %s" % (names, cnames))
    timed = dict(real["scans"])
    lc, cc = (cases.tiled_case(kind, 10, interleave=True)
              for kind in ("luma", "chroma"))
    timed["interleaved"] = dict(
        luma=(T(lc["plane"]), T(lc["resi"]), T(lc["meta"]), lc["bd"]),
        chroma=(T(cc["plane"]), T(cc["resi"]), T(cc["luma"]), T(cc["meta"]),
                cc["bd"]))
    times = time_scans(torch, timed)
    parent_ms = None
    if parent is not None:
        parent_ms = {(n, p if p == "interleaved" else int(p)): ms for
                     (n, p), ms in time_of_tree(torch, parent, "time_scans",
                                                timed)}
        for key in sorted(times, key=str):
            log("phase 2: %s %s: %.4f ms, %s's %.4f ms (%.2fx)" % (
                key + (times[key], parent, parent_ms[key],
                       parent_ms[key] / times[key])))
    plane, resi, meta, bd = real["scans"][0]["luma"]
    planes_c, resi_c, luma_c, meta_c, bd_c = real["scans"][0]["chroma"]
    res["intra_luma"] = dict(
        max_abs_err=err["luma"],
        **scan_bound("luma", meta.cpu().numpy(), steps["luma", 0][0]),
        shape="hd720_ld picture 0: %d rows, canvas %dx%d" % (
            (len(meta),) + tuple(plane.shape)),
        ms=times["intra_luma", 0],
        plain_ms=cuda_ms(torch, lambda p: scan.intra_scan_plain(
            p, resi, meta, bd), 1, fresh=plane.clone))
    res["intra_chroma"] = dict(
        max_abs_err=err["chroma"],
        **scan_bound("chroma", meta_c.cpu().numpy(), steps["chroma", 0][0]),
        shape="hd720_ld picture 0: %d rows, canvas 2x%dx%d" % (
            (len(meta_c),) + tuple(planes_c.shape[1:])),
        ms=times["intra_chroma", 0],
        plain_ms=cuda_ms(torch, lambda p: scan.intra_chroma_scan_plain(
            p, resi_c, luma_c, meta_c, bd_c), 1, fresh=planes_c.clone))
    for name in ("intra_luma", "intra_chroma"):
        kind = name[6:]
        res[name].update(
            picture3_ms=times[name, 3], picture3_steps=steps[kind, 3][0],
            interleaved_ms=times[name, "interleaved"],
            ticket_steps=steps[kind, 0][1],
            us_per_step=res[name]["ms"] * 1e3 / res[name]["chain_steps"],
            us_per_ticket_step=res[name]["ms"] * 1e3 / steps[kind, 0][1],
            parent_ms=None if parent_ms is None else {
                str(p): parent_ms[name, p] for p in timed})
    # the plain versions' cached device tables are no part of a decode
    scan._DEV.clear()
    for name in ("intra_luma", "intra_chroma"):
        r = res[name]
        log("phase 2: %s bit-exact over %d synthetic cases and pictures %s "
            "of hd720_ld; %s (%d active rows, %d samples): kernel %.4f ms, "
            "%.3f us per step of %d (%.3f per ticket step of %d), plain "
            "%.4f ms, bound %.6f ms (%s), chain estimate %.4f ms (no "
            "bound); picture 3: %.4f ms, %d steps; interleaved tiled case: "
            "%.4f ms" % (
                name, sum(c["kind"] == name[6:] for _, c in families),
                list(SCAN_PICTURES), r["shape"], r["rows"], r["samples"],
                r["ms"], r["us_per_step"], r["chain_steps"],
                r["us_per_ticket_step"], r["ticket_steps"], r["plain_ms"],
                r["bound_ms"], r["bound_by"], r["chain_estimate_ms"],
                r["picture3_ms"], r["picture3_steps"], r["interleaved_ms"]))


def phase_deblock_kernels(torch, dev, res, real, rng):
    """The three deblock kernels against their plain versions, on
    synthetic inputs (xvc_tpu_torch/gpu/deblock_cases.py) and on the real
    records and planes of pictures 0 (intra, two CU trees) and 1 (inter)
    of hd720_ld (``real``, from ``capture_inputs``); each timed at
    1280x720 / 640x360 with the real entries of picture 0."""
    import numpy as np
    from xvc_tpu_torch.gpu import deblock
    from xvc_tpu_torch.gpu import deblock_cases as cases
    from xvc_tpu_torch.ops import deblock as dbk
    T = lambda a: torch.from_numpy(np.array(a)).to(dev)  # a copy
    H, W = 720, 1280

    errs = {"edges": 0, "luma": 0, "chroma": 0}

    def same(kernel, got, want, what):
        torch.cuda.synchronize()
        e = max_err(torch, got, want)
        errs[kernel] = max(errs[kernel], e)
        if e:
            raise AssertionError("deblock_%s differs from its plain version "
                                 "by %d: %s" % (kernel, e, what))

    # edge decisions: synthetic tiled pictures, then the real records
    n_edges = 0
    restr_sets = [(False,) * 3, (True, False, False), (False, True, False),
                  (False, False, True)]
    for size in cases.EDGE_SIZES:
        for sbs in (4, 8):
            for pred_type in (0, 1, 2):
                for bd, restr_flags in zip((8, 10, 8, 10), restr_sets):
                    pic = cases.tiled_picture(SEED + n_edges, *size,
                                              pred_type)
                    attrs, n = dbk.DeblockingFilter(
                        pic, None, 0, 0, None).build_cu_attrs(0)
                    lay = deblock.EdgeLayout(*size, sbs, 1, 1, True, True)
                    args = (T(attrs), n, lay, 1, -1, bd, pred_type == 0,
                            restr_flags)
                    for g, w in zip(deblock.edge_params(*args),
                                    deblock.edge_params_plain(*args)):
                        same("edges", g, w, (size, sbs, pred_type, bd,
                                             restr_flags))
                    n_edges += 1
    derived = []  # per picture: [(lay, params)] of its CU trees
    for n_pic, pic in enumerate(real["pictures"]):
        derived.append([])
        for args in pic["edges"]:
            got = deblock.edge_params(*args)
            for g, w in zip(got, deblock.edge_params_plain(*args)):
                same("edges", g, w, "hd720_ld picture %d" % n_pic)
            derived[-1].append((args[2], got[1]))
            n_edges += 1
    if not real["pictures"][0]["secondary"] or len(derived[1]) != 1:
        raise AssertionError("hd720_ld pictures 0 / 1 should have two CU "
                             "trees / one")
    attrs0, n0, lay0 = real["pictures"][0]["edges"][0][:3]
    rest0 = real["pictures"][0]["edges"][0][3:]
    map0, params0 = deblock.edge_params(attrs0, n0, lay0, *rest0)
    res["deblock_edges"] = dict(
        max_abs_err=errs["edges"], **edges_bound(*(t.cpu().numpy() for t in (
            attrs0, map0, params0))),
        shape="hd720_ld picture 0, primary tree: %d CUs, %d entries" % (
            n0, lay0.total),
        ms=cuda_ms(torch, lambda: deblock.edge_params(attrs0, n0, lay0,
                                                      *rest0)),
        plain_ms=cuda_ms(torch, lambda: deblock.edge_params_plain(
            attrs0, n0, lay0, *rest0), 2))

    # luma walk: both directions on the plane as it lies
    n_luma = 0
    flags_list = [(False,) * 5, (False, False, False, True, False),
                  (True, False, False, False, True), (False, True, False,
                                                      False, False)]

    def luma_both(case, bd, flags, direction, tag):
        outs = []
        for fn in (deblock.luma_pass, deblock.luma_pass_plain):
            pl, *a = [T(x) for x in case]
            fn(pl, *a, bd, flags, direction)
            outs.append(pl)
        same("luma", outs[0], outs[1], tag)
        return int((outs[0] != T(case[0])).sum().item())

    for bd in (8, 10):
        for flags in flags_list:
            for direction in (0, 1):
                tag = ("regular 720p", bd, flags, direction)
                if not luma_both(cases.luma_case(
                        "regular", bd, direction, SEED,
                        (H, W) if direction == 0 else (W, H)), bd, flags,
                        direction, tag):
                    raise AssertionError("deblock_luma no-op %r" % (tag,))
                n_luma += 1
    for kind in ("pruned", "clamped", "ragged", "odd"):
        for bd in (8, 10):
            for direction in (0, 1):
                luma_both(cases.luma_case(kind, bd, direction, SEED,
                                          (200, 328)), bd, (False,) * 5,
                          direction, (kind, bd, direction))
                n_luma += 1
    # ... and from the packed entries, on the real planes
    for n_pic, pic in enumerate(real["pictures"]):
        bd, flags = pic["bitdepth"], pic["flags"]
        got = {c: p.clone() for c, p in pic["planes"].items()}
        want = {c: p.clone() for c, p in pic["planes"].items()}
        for d in (0, 1):
            for lay, params in derived[n_pic]:
                deblock.luma_filter(got[0], params, lay, d, bd, flags)
                if lay.luma_off[d] >= 0:
                    xs, mask, tc, beta = deblock.luma_tensors(params, lay, d)
                    deblock.luma_pass_plain(want[0], xs, mask, tc, beta, bd,
                                            flags, d)
                if lay.chroma_off[d] >= 0:
                    deblock.chroma_filter([got[1], got[2]], params, lay, d,
                                          bd)
                    edges, apply, tc = deblock.chroma_tensors(params, lay, d)
                    for c in (1, 2):
                        deblock.chroma_pass_plain(want[c], edges, apply, tc,
                                                  bd, d)
        for c in got:
            same("chroma" if c else "luma", got[c], want[c],
                 "hd720_ld picture %d" % n_pic)
            # (chroma is filtered beside intra CUs only: picture 1 may
            # have none)
            if (c == 0 or n_pic == 0) and \
                    torch.equal(got[c], pic["planes"][c]):
                raise AssertionError("deblock of picture %d left component "
                                     "%d as it was" % (n_pic, c))
        n_luma += 2

    # timed: the packed-entry path at picture 0's shape, in place, every
    # call on a copy of the plane as the decode presents it: across
    # columns on the reconstruction, across rows on what across columns
    # left
    pic0 = real["pictures"][0]
    lay_l, par_l = derived[0][0]
    lay_c, par_c = derived[0][1]
    flags, bd = pic0["flags"], pic0["bitdepth"]
    plane = pic0["planes"][0].clone()
    uv = [pic0["planes"][1].clone(), pic0["planes"][2].clone()]
    deblock.luma_filter(plane, par_l, lay_l, 0, bd, flags)
    deblock.chroma_filter(uv, par_c, lay_c, 0, bd)
    src = [pic0["planes"][0], plane]
    src_uv = [[pic0["planes"][1], pic0["planes"][2]], uv]
    tens = [deblock.luma_tensors(par_l, lay_l, d) for d in (0, 1)]
    ms = [cuda_ms(torch, lambda p: deblock.luma_filter(p, par_l, lay_l, d,
                                                       bd, flags),
                  fresh=src[d].clone) for d in (0, 1)]
    plain = [cuda_ms(torch, lambda p: deblock.luma_pass_plain(
        p, *tens[d], bd, flags, d), 1, fresh=src[d].clone) for d in (0, 1)]
    bounds = [luma_deblock_bound(
        pic0["planes"][0].cpu().numpy(), tens[d][1].cpu().numpy(),
        lay_l.nx[d] * lay_l.ny[d] * 4) for d in (0, 1)]
    # the case the first version of the kernel was timed on: every edge
    # position of a synthetic plane, 80% of the entries on
    case = cases.luma_case("regular", 8, 0, SEED, (H, W))
    pl, *a = [T(x) for x in case]
    all_on_ms = cuda_ms(torch, lambda p: deblock.luma_pass(
        p, *a, 8, (False,) * 5), fresh=pl.clone)
    res["deblock_luma"] = dict(
        max_abs_err=errs["luma"], **bounds[0], ms=ms[0], plain_ms=plain[0],
        shape="hd720_ld picture 0, across columns: 1280x720, %d edge "
        "positions" % lay_l.nx[0],
        across_rows=dict(bounds[1], ms=ms[1], plain_ms=plain[1],
                         edge_positions=lay_l.nx[1]),
        every_position_on_ms=all_on_ms)
    log("phase 2: deblock_luma bit-exact over %d cases; picture 0 of "
        "hd720_ld across columns: kernel %.4f ms, plain %.4f ms, bound "
        "%.6f ms (%s), chain estimate %.4f ms (%d steps, no bound); across "
        "rows: kernel %.4f ms, plain %.4f ms, bound %.6f ms, chain estimate "
        "%.4f ms (%d steps); synthetic 720p plane, every position on: "
        "%.4f ms" % (
            n_luma, ms[0], plain[0], bounds[0]["bound_ms"],
            bounds[0]["bound_by"], bounds[0]["chain_estimate_ms"],
            bounds[0]["chain_steps"], ms[1], plain[1], bounds[1]["bound_ms"],
            bounds[1]["chain_estimate_ms"], bounds[1]["chain_steps"],
            all_on_ms))

    # chroma pass
    n_chroma = 0
    for case_bd in (8, 10):
        for direction in (0, 1):
            case = cases.chroma_case(case_bd, direction, SEED, (360, 640))
            outs = []
            for fn in (deblock.chroma_pass, deblock.chroma_pass_plain):
                pl, *a = [T(x) for x in case]
                fn(pl, *a, case_bd, direction)
                outs.append(pl)
            same("chroma", outs[0], outs[1], (case_bd, direction))
            if torch.equal(outs[0], T(case[0])):
                raise AssertionError("deblock_chroma no-op %r" % (
                    (case_bd, direction),))
            n_chroma += 1
    ctens = [deblock.chroma_tensors(par_c, lay_c, d) for d in (0, 1)]
    cms = [cuda_ms(torch, lambda ps: deblock.chroma_filter(ps, par_c, lay_c,
                                                           d, bd),
                   fresh=lambda: [p.clone() for p in src_uv[d]])
           for d in (0, 1)]
    cplain = [cuda_ms(torch, lambda ps: [deblock.chroma_pass_plain(
        p, *ctens[d], bd, d) for p in ps], 3,
        fresh=lambda: [p.clone() for p in src_uv[d]]) for d in (0, 1)]
    cbounds = [chroma_deblock_bound(
        [p.cpu().numpy() for p in uv], ctens[d][1].cpu().numpy(),
        lay_c.nce[d] * lay_c.ny[d] * 4) for d in (0, 1)]
    res["deblock_chroma"] = dict(
        max_abs_err=errs["chroma"], **cbounds[0], ms=cms[0], plain_ms=cplain[0],
        shape="hd720_ld picture 0, across columns: U and V 640x360, %d "
        "edges" % lay_c.nce[0],
        across_rows=dict(cbounds[1], ms=cms[1], plain_ms=cplain[1],
                         edges=lay_c.nce[1]))
    r = res["deblock_edges"]
    log("phase 2: deblock_edges equal tensor for tensor over %d cases (%s): "
        "kernel %.4f ms, plain %.4f ms, bound %.6f ms (%s); deblock_chroma "
        "bit-exact over %d cases and the real planes; picture 0, U and V: "
        "across columns kernel %.4f ms, plain %.4f ms, bound %.6f ms (%s), "
        "across rows kernel %.4f ms, plain %.4f ms" % (
            n_edges, r["shape"], r["ms"], r["plain_ms"], r["bound_ms"],
            r["bound_by"], n_chroma, cms[0], cplain[0],
            cbounds[0]["bound_ms"], cbounds[0]["bound_by"], cms[1],
            cplain[1]))


def phase_picture_kernels(torch, dev, res):
    """The picture kernels (itx_picture, mc_picture) against their plain
    versions: on the record tables of PICTURE_CASES (parsed on the CPU by
    flat_cases.parse_pictures; the frame store of MC from a seed), on the
    synthetic tables of flat_cases and with damaged rows appended (which
    must change nothing); each kernel timed on every picture of the
    TIMED_STREAMS (MC: their inter pictures) beside its bound and its
    plain version: hd720_ld's mean is the flat path's row of the kernels
    line, hd720_lic's (``recon``) the replay path's."""
    import numpy as np
    from xvc_tpu_torch import kernels
    from xvc_tpu_torch.gpu import flat_cases, itx, mc

    def both(pic, records=None, seed=11):
        """Kernel and plain planes of both kernels, launches checked."""
        outs = []
        for itx_fn, mc_fn in ((itx.itx_picture, mc.mc_picture),
                              (itx.itx_picture_plain, mc.mc_picture_plain)):
            kernels.reset_launches()
            a = flat_cases.itx_args(pic, dev, records)
            itx_fn(*a)
            b = flat_cases.mc_args(pic, dev, seed, records)
            mc_fn(*b)
            torch.cuda.synchronize()
            outs.append(([t for t in a[:2] if t is not None],
                         [t for t in b[:4] if t is not None]))
            if itx_fn is itx.itx_picture and (
                    kernels.LAUNCHES["itx_picture"] != 1 or
                    kernels.LAUNCHES["mc_picture"] != 1):
                raise AssertionError("picture kernels launched %r" % (
                    dict(kernels.LAUNCHES),))
        errs = [max(max_err(torch, g, w) for g, w in zip(outs[0][i],
                                                         outs[1][i]))
                for i in (0, 1)]
        return errs, outs[0]

    err = {"itx_picture": 0, "mc_picture": 0}
    cases = 0
    real = {}
    for name, pictures in PICTURE_CASES:
        with open(os.path.join(DATA, name + ".xvc"), "rb") as f:
            got = flat_cases.parse_pictures(f.read(), set(pictures))
        for n in pictures:
            real[name, n] = got[n]
            (e_itx, e_mc), _ = both(got[n])
            err["itx_picture"] = max(err["itx_picture"], e_itx)
            err["mc_picture"] = max(err["mc_picture"], e_mc)
            cases += 1
    synthetic = [dict(seed=2), dict(seed=8, mono=True),
                 dict(seed=8, dual=True, bitdepth=10),
                 dict(seed=8, no_dst=True, hp_tx=False),
                 dict(seed=8, bitdepth=10, hp_mv=False, chroma_subpel=False,
                      nrefs=(3, 1))] + [dict(seed=s) for s in range(20, 24)]
    for kw in synthetic:
        (e_itx, e_mc), _ = both(flat_cases.synthetic_picture(**kw))
        err["itx_picture"] = max(err["itx_picture"], e_itx)
        err["mc_picture"] = max(err["mc_picture"], e_mc)
        cases += 1
    # damaged rows: dropped, and the card reports no fault
    for pic in (flat_cases.synthetic_picture(5), real["bench/hd720_ld", 3]):
        bad = np.concatenate([flat_cases.damaged_rows(pic, "itx"),
                              flat_cases.damaged_rows(pic, "mc")])
        _, clean = both(pic)
        errs, dirty = both(pic, np.concatenate([pic["records"], bad]))
        for i in (0, 1):
            for g, w in zip(dirty[i], clean[i]):
                if max_err(torch, g, w):
                    raise AssertionError("a damaged row changed the planes")
        err["itx_picture"] = max(err["itx_picture"], errs[0])
        err["mc_picture"] = max(err["mc_picture"], errs[1])
        cases += 1
    for kernel, e in err.items():
        if e:
            raise AssertionError("%s differs from its plain version by %d"
                                 % (kernel, e))

    # timed on every picture of the main paths (MC: the inter ones)
    per = {"itx_picture": [], "mc_picture": []}
    for (name, n), pic in sorted(real.items()):
        if not name.startswith("bench/"):
            continue
        timed = name in TIMED_STREAMS
        name = name[len("bench/"):]
        a = flat_cases.itx_args(pic, dev)
        ib = itx_picture_bound(pic)
        row = dict(stream=name, picture=n, blocks=ib["blocks"],
                   bytes=ib["nbytes"], operations=ib["ops"],
                   bound_ms=bound(ib["nbytes"], ib["ops"])["bound_ms"],
                   ms=cuda_ms(torch, lambda: itx.itx_picture(*a)),
                   device_ms=device_ms(torch, lambda: itx.itx_picture(*a),
                                       "itx_picture_kernel"),
                   plain_ms=cuda_ms(torch, lambda: itx.itx_picture_plain(*a),
                                    2) if timed else None)
        per["itx_picture"].append(row)
        if not pic["inter"]:
            continue
        b = flat_cases.mc_args(pic, dev, 11)
        mb = mc_picture_bound(pic)
        per["mc_picture"].append(dict(
            stream=name, picture=n, jobs=mb["jobs"], bytes=mb["nbytes"],
            operations=mb["ops"],
            bound_ms=bound(mb["nbytes"], mb["ops"])["bound_ms"],
            ms=cuda_ms(torch, lambda: mc.mc_picture(*b)),
            device_ms=device_ms(torch, lambda: mc.mc_picture(*b),
                                "mc_picture_kernel"),
            plain_ms=cuda_ms(torch, lambda: mc.mc_picture_plain(*b), 2)
            if timed else None))

    def summary(kernel, stream):
        main = [r for r in per[kernel] if r["stream"] == stream]
        mean = lambda key: None if None in [r[key] for r in main] else \
            sum(r[key] for r in main) / len(main)
        return dict(
            max_abs_err=err[kernel],
            **bound(mean("bytes"), mean("operations")),
            shape="%s, the mean launch over its %d %spictures" % (
                stream, len(main), "inter " if kernel == "mc_picture"
                else ""),
            ms=mean("ms"), device_ms=mean("device_ms"),
            plain_ms=mean("plain_ms"))

    for kernel, rows in per.items():
        res[kernel] = dict(summary(kernel, "hd720_ld"), per_picture=rows,
                           recon=summary(kernel, RECON_STREAM))
        r = res[kernel]
        log("phase 2: %s on %s: kernel %.4f ms (device time alone %s ms), "
            "plain %.4f ms, bound %.6f ms (%s)" % (
                kernel, r["recon"]["shape"], r["recon"]["ms"],
                r["recon"]["device_ms"], r["recon"]["plain_ms"],
                r["recon"]["bound_ms"], r["recon"]["bound_by"]))
        log("phase 2: %s bit-exact over %d record tables (real, synthetic, "
            "damaged); %s: kernel %.4f ms (device time alone %s ms), plain "
            "%.4f ms, bound %.6f ms (%s); per picture (stream, picture, ms, "
            "device ms, bound ms): %s" % (
                kernel, cases, r["shape"], r["ms"], r["device_ms"],
                r["plain_ms"], r["bound_ms"], r["bound_by"],
                [(x["stream"], x["picture"], round(x["ms"], 4),
                  x["device_ms"] and round(x["device_ms"], 4),
                  round(x["bound_ms"], 6)) for x in rows]))


def phase_kernels(torch, dev, parent):
    """Each kernel against its plain version on the same CUDA inputs
    (``parent``: a checkout whose scan kernels phase 2 times beside)."""
    import numpy as np
    from xvc_tpu_torch import constants as k
    from xvc_tpu_torch.codec.yuv import YuvPicture
    from xvc_tpu_torch.gpu import flat_recon, itx, mc, satd
    rng = np.random.RandomState(SEED)
    T = lambda a: torch.from_numpy(np.array(a)).to(dev)  # a copy
    pic = YuvPicture(k.ChromaFormat.YUV420, 1280, 720, 8, True)
    res = {}

    # MC: luma and chroma, every bucket, clipped and short, 8 and 10 bit
    err = 0
    buckets = [(8, 8), (16, 16), (32, 32), (64, 64), (8, 16), (16, 8),
               (32, 64), (64, 32), (8, 64), (64, 8)]
    for luma in (True, False):
        Hp, Wp = flat_recon._padded_shape(pic, 0 if luma else 1)
        S = 4 if luma else 8
        for wb, hb in buckets:
            for bd in (8, 10):
                for short in (False, True):
                    planes, params, pred, mask = mc_case(
                        rng, luma, wb, hb, bd, short, 96, S, Hp, Wp)
                    outs = []
                    for fn in (mc.mc_scatter, mc.mc_scatter_plain):
                        p, m = T(pred), T(mask)
                        fn(p, m, T(planes), T(params), wb, hb, luma, bd,
                           True, short)
                        outs.append((p, m))
                    torch.cuda.synchronize()
                    e = max(max_err(torch, outs[0][0], outs[1][0]),
                            max_err(torch, outs[0][1], outs[1][1]))
                    if e:
                        raise AssertionError("mc mismatch %r" % (
                            (luma, wb, hb, bd, short), ))
                    err = max(err, e)
    planes, params, pred, mask = mc_case(
        rng, True, 16, 16, 8, False, 1024, 4,
        *flat_recon._padded_shape(pic, 0))
    args = (T(planes), T(params), 16, 16, True, 8, True, False)
    p, m = T(pred), T(mask)
    res["mc"] = dict(
        max_abs_err=err, shape="luma 16x16 uni, B=1024, 720p store",
        **mc_bound(planes, params, 8, False),
        ms=cuda_ms(torch, lambda: mc.mc_scatter(p, m, *args)),
        plain_ms=cuda_ms(torch, lambda: mc.mc_scatter_plain(p, m, *args),
                         5))
    log("phase 2: mc bit-exact over %d cases; 16x16 x1024: kernel %.4f ms,"
        " plain %.4f ms" % (len(buckets) * 8, res["mc"]["ms"],
                            res["mc"]["plain_ms"]))

    # ITX: every family at each size, non-square, dst4, dc and skip
    err = 0
    sizes = [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 8), (8, 4),
             (16, 64), (64, 16), (32, 8), (8, 32), (2, 2), (4, 2), (2, 8)]
    cases = [(w, h, bd, None) for w, h in sizes for bd in (8, 10)]
    cases += [(4, 4, bd, "dst4") for bd in (8, 10)]
    cases += [(w, h, 8, v) for v in ("dc", "skip")
              for w, h in ((4, 4), (8, 8), (32, 32), (16, 4))]
    cases += [(w, h, 10, "gen") for w, h in ((8, 8), (64, 64), (16, 32))]
    for w, h, bd, var in cases:
        coeff, scale, params, resi = itx_case(rng, w, h, bd, 64, 2,
                                              var is None)
        outs = []
        for plain in (False, True):
            r = T(resi)
            a = (r, T(coeff), T(scale), T(params), w, h, bd)
            if plain:
                itx.itx_scatter_plain(*a, True, var, 1, 4)
            elif var is None:
                itx.itx_scatter_gen(*a, True)
            else:
                itx.itx_scatter(*a, 1, 4, var, True)
            outs.append(r)
        torch.cuda.synchronize()
        e = max_err(torch, outs[0], outs[1])
        if e:
            raise AssertionError("itx mismatch %r" % ((w, h, bd, var),))
        err = max(err, e)
    coeff, scale, params, resi = itx_case(rng, 8, 8, 8, 2048, 1, True)
    r = T(resi)
    a = (r, T(coeff), T(scale), T(params), 8, 8, 8)
    res["itx"] = dict(
        max_abs_err=err, shape="gen 8x8, B=2048",
        **itx_bound(coeff, scale, params, 8, 8),
        ms=cuda_ms(torch, lambda: itx.itx_scatter_gen(*a, True)),
        plain_ms=cuda_ms(torch, lambda: itx.itx_scatter_plain(*a, True),
                         5))
    log("phase 2: itx bit-exact over %d cases; 8x8 x2048: kernel %.4f ms, "
        "plain %.4f ms" % (len(cases), res["itx"]["ms"],
                           res["itx"]["plain_ms"]))

    # SATD: every size, 8 and 10 bit, full-range differences, a batch
    # that fills no whole warp, tile or group of 1024; plain and fused
    err = 0
    cases = [(n, bd) for n in (4, 8, 16, 32, 64) for bd in (8, 10)]
    for n, bd in cases:
        diff = satd_case(rng, (1031, 3, n, n), bd)
        d = T(diff)
        got = satd.satd_square(d, bd)
        want = satd.satd_plain(d, bd)
        orig = rng.randint(0, 1 << bd, (1031, n, n)).astype(np.int32)
        fused = satd.satd_pred(T(orig), T(orig[:, None] - diff), bd)
        torch.cuda.synchronize()
        e = max(max_err(torch, got, want), max_err(torch, fused, want))
        if e:
            raise AssertionError("satd mismatch %r" % ((n, bd, e),))
        err = max(err, e)
    diff = satd_case(rng, (14400, 67, 8, 8), 8)
    d = T(diff)
    orig = T(rng.randint(0, 256, (14400, 8, 8)).astype(np.int32))
    res["satd"] = dict(
        max_abs_err=err, shape="[14400, 67, 8, 8] int32 (720p, n=8)",
        **satd_bound(diff, 8),
        ms=cuda_ms(torch, lambda: satd.satd_square(d, 8)),
        plain_ms=cuda_ms(torch, lambda: satd.satd_plain(d, 8), 3),
        fused_ms=cuda_ms(torch, lambda: satd.satd_pred(orig, d, 8)))
    log("phase 2: satd bit-exact over %d cases (plain-diff and fused); "
        "[14400, 67, 8, 8]: kernel %.4f ms, fused %.4f ms, plain %.4f ms, "
        "bound %.4f ms (%s)" % (len(cases), res["satd"]["ms"],
                                res["satd"]["fused_ms"],
                                res["satd"]["plain_ms"],
                                res["satd"]["bound_ms"],
                                res["satd"]["bound_by"]))
    # the per-CU pre-pass's shape: one CU, its 67 predictions (B = 1),
    # fused, 8 and 10 bit with the extremes; timed on the 10-bit case
    per_cu = {}
    for n in PER_CU_SIZES:
        for bd in (8, 10):
            diff = satd_case(rng, (1, 67, n, n), bd)
            orig = rng.randint(0, 1 << bd, (1, n, n)).astype(np.int32)
            o, p = T(orig), T(orig[:, None] - diff)
            got = satd.satd_pred(o, p, bd)
            want = satd.satd_plain(o[:, None] - p, bd)
            torch.cuda.synchronize()
            if max_err(torch, got, want):
                raise AssertionError("satd mismatch at the per-CU shape %r"
                                     % ((n, bd),))
        per_cu[n] = dict(
            ms=cuda_ms(torch, lambda: satd.satd_pred(o, p, 10)),
            plain_ms=cuda_ms(torch, lambda: satd.satd_plain(
                o[:, None] - p, 10), 5),
            **{k: v for k, v in satd_bound(diff, n).items()
               if k in ("bound_ms", "bound_by")})
    res["satd"]["per_cu"] = per_cu
    log("phase 2: satd bit-exact at the per-CU shape [1, 67, n, n], n = "
        "%s, 8 and 10 bit; fused kernel / plain / bound ms: %s" % (
            list(PER_CU_SIZES), {n: "%.4f / %.4f / %.6f" % (
                r["ms"], r["plain_ms"], r["bound_ms"])
                for n, r in per_cu.items()}))
    phase_txrd_kernel(torch, dev, res, parent)
    with open(os.path.join(DATA, "bench", "hd720_ld.xvc"), "rb") as f:
        real = capture_inputs(f.read())
    phase_intra_satd_kernel(torch, dev, res, real["picture0"], parent)
    phase_deblock_kernels(torch, dev, res, real, rng)
    phase_scan_kernels(torch, dev, res, real, parent)
    phase_picture_kernels(torch, dev, res)
    phase_resample_kernel(torch, dev, res, parent)
    phase_me_sad_kernel(torch, dev, res)
    return res


def capture_txrd_inputs(torch, dev):
    """What the txrd kernel was given at every size on picture 0 of
    hd720_s3, captured from one encode of it at speed 3 on the card
    (which also makes the first-use costs of phase 6): n -> (orig, preds,
    satd, n, bitdepth, keep, screen_step, params)."""
    from xvc_tpu_torch import api
    from xvc_tpu_torch.gpu import txrd_prepass
    caught = {}
    fn = txrd_prepass.txrd

    def spy(orig, preds, satd, n, *rest):
        caught[n] = (orig.clone(), preds.clone(), satd.clone(), n) + rest
        return fn(orig, preds, satd, n, *rest)

    txrd_prepass.txrd = spy
    try:
        session_encode(hd720_s3_session(api, True, dev), make_hd720_s3(), 1)
    finally:
        txrd_prepass.txrd = fn
    torch.cuda.synchronize()
    return caught


def time_txrd(torch, real):
    """Milliseconds per call, on the inputs of ``real`` (as
    ``capture_txrd_inputs`` keeps them, with "want" the kept modes), of
    what replaces the transform-RD stages after the SATD in the package
    that is imported: ``txrd`` where it has it; else the chain of PyTorch
    stages and the rank-only kernel that txrd replaced (the tail of
    ``screen``: a stable sort and a gather; ``forward_transform``;
    ``txrd_rank``).  Per size (ms, equal to "want")."""
    from xvc_tpu_torch.gpu import txrd_prepass as tx
    out = {}
    for n, (args, want) in real.items():
        orig, preds, satd, n, bd, keep, step, p = args
        if hasattr(tx, "txrd"):
            fn = lambda: tx.txrd(*args)
        else:
            def fn():
                cand = tx._stable_best(satd, tx.SATD_KEEP).to(torch.int32)
                idx = cand.long()[:, :, None, None].expand(-1, -1, n, n)
                coeff = tx.forward_transform(
                    orig[:, None] - torch.gather(preds, 1, idx), n, bd)
                return tx.txrd_rank(coeff, cand, keep, step, p)
        out[n] = (cuda_ms(torch, fn), bool(torch.equal(fn(), want)))
    return out


def time_intra_satd_steps(torch, inputs):
    """Milliseconds per call on the card of ``make_intra_satd_fn`` of the
    package that is imported (this tree's: the intra_satd kernel; before
    it: the batched predictor and satd.cu) on each entry of ``inputs``
    (key -> (orig, top, left, n, bitdepth, mode_step, want), CPU
    tensors), and whether it gives ``want``."""
    from xvc_tpu_torch.gpu import analysis
    dev = torch.device("cuda", 0)
    out = {}
    for key, (orig, top, left, n, bd, step, want) in inputs.items():
        args = [t.to(dev) for t in (orig, top, left)]
        fn = analysis.make_intra_satd_fn(n, bd, step)
        equal = bool(torch.equal(fn(*args).cpu(), want))
        out[key] = (cuda_ms(torch, lambda: fn(*args)), equal)
    return out


def time_per_cu_calls(torch, inputs):
    """The per-CU pre-pass call of the package that is imported
    (``intra_search.device_prepass_satd``) on the card for each n of
    ``inputs`` (n -> (orig, top, left, bitdepth, want), CPU tensors):
    host milliseconds a call (mean of 200 after a warm-up; the call ends
    with its result on the host), its device operations under
    torch.profiler (``device_ops``), and whether it gives ``want``."""
    import numpy as np
    from xvc_tpu_torch.codec.intra_search import device_prepass_satd
    dev = torch.device("cuda", 0)
    out = {}
    for n, (orig, top, left, bd, want) in inputs.items():
        o, t, l = (a.numpy() for a in (orig, top, left))
        call = lambda: device_prepass_satd(o, t, l, bd, dev)
        got = call()
        out[n] = (host_ms(torch, call), device_ops(torch, call),
                  bool(np.array_equal(got, want.numpy())))
    return out


def host_ms(torch, fn, iters=200):
    """Mean host milliseconds a call of fn (which waits for its own
    result), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def device_ops(torch, fn, iters=5):
    """The device operations (kernels and copies) of one call of fn (which
    waits for its own result), from torch.profiler: 2 + ``iters`` calls
    in one window, each in a range of its own, the first two not counted
    (the first events of a window can be lost).  A device event counts
    for the call whose range holds the CUDA runtime call that issued it
    (by correlation id), or its own start where there is none.  The count
    where every counted call saw the same number, not zero; else None
    (events were lost: late in a long run a window can lose all of
    them, so ``time_prefetch_calls`` counts in a child process)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2 + iters):
            with record_function("device_ops.call"):
                fn()
                torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    ranges = sorted((ev.start_ns(), ev.end_ns()) for ev in events
                    if ev.name() == "device_ops.call" and
                    not str(ev.device_type()).endswith("CUDA"))[2:]
    counts = [0] * len(ranges)
    # the CUDA runtime calls on the host, by the correlation id their
    # device operations carry
    issued = {ev.correlation_id(): ev.start_ns() for ev in events
              if not str(ev.device_type()).endswith("CUDA") and
              ev.name().startswith("cuda")}
    for ev in events:
        if str(ev.device_type()).endswith("CUDA") and \
                not getattr(ev, "is_user_annotation", bool)() and \
                ev.name() != "device_ops.call":
            t = issued.get(ev.correlation_id(), ev.start_ns())
            for j, (a, b) in enumerate(ranges):
                if a <= t <= b:
                    counts[j] += 1
    if len(ranges) != iters or len(set(counts)) != 1 or not counts[0]:
        log("device_ops: the calls saw %r of the window's %d device "
            "operations (events lost); not measured" % (
                counts, sum(str(ev.device_type()).endswith("CUDA")
                            for ev in events)))
        return None
    return counts[0]


def phase_intra_satd_kernel(torch, dev, res, picture0, parent):
    """The all-mode intra SATD kernel (intra_satd: every mode predicted on
    chip, its SATD summed) against its plain version on the card, bit for
    bit: B = 1 at the per-CU sizes (8 and 10 bit, a block of random lines
    with the extremes and one of sorted lines, each alone); B = 77 at
    every size with mode steps 1, 4 and 8 at 8, 10, 12 and 14 bit; the
    real blocks of the luma of picture 0 of hd720_ld (``picture0``, as
    decoded) at lookahead720's sizes and the split DP's.  Each real shape
    and the per-CU shapes timed: the kernel (CUDA events, and device time
    from torch.profiler), its plain version, the parent's path on the
    same inputs (the batched predictor and satd.cu's fused entry, the
    weights resident), its bound and, with ``parent``, that checkout's
    make_intra_satd_fn; and the whole per-CU call (host ms, device
    operations) beside the parent's call, emulated here (three uploads,
    the predictor, satd.cu, a download) and, with ``parent``, that
    checkout's own."""
    import numpy as np
    from xvc_tpu_torch.gpu import analysis, intra_batch, satd
    from xvc_tpu_torch.gpu import intra_satd as isa
    from xvc_tpu_torch.restrictions import Restrictions
    rng = np.random.RandomState(SEED + 13)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    cases = [0]

    def check(args, n, bd, step, what):
        got = isa.intra_satd(*args, n, bd, step)
        want = isa.intra_satd_plain(*args, n, bd, step)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError("intra_satd differs from its plain version "
                                 "on %s: %d of %d blocks" % (
                                     what, int((got != want).any(1).sum()),
                                     got.shape[0]))
        cases[0] += 1
        return want

    for n in PER_CU_SIZES:
        for bd in (8, 10):
            blocks = isa.synthetic_inputs(rng, 2, n, bd)
            for b in (0, 1):
                check([T(a[b:b + 1]) for a in blocks], n, bd, 1,
                      "B=1 n=%d %d bit block %d" % (n, bd, b))
    for n in isa.SIZES:
        for step in (1, 4, 8):
            for bd in (8, 10, 12, 14):
                check([T(a) for a in isa.synthetic_inputs(rng, 77, n, bd)],
                      n, bd, step, "B=77 n=%d step %d %d bit" % (n, step,
                                                                 bd))
    H, W = 720, 1280
    luma = np.frombuffer(picture0, np.uint8, count=H * W).reshape(H, W)
    timed, extracted = {}, {}
    for n, step in INTRA_SATD_LOOKAHEAD + INTRA_SATD_SPLIT_DP:
        if n not in extracted:
            extracted[n] = [T(a) for a in analysis.extract_blocks(
                luma, n, 8, Restrictions())]
        args = extracted[n]
        key = "%s_n%d" % ("lookahead" if step == 1 else "split_dp_step%d"
                          % step, n)
        timed[key] = (args, n, 8, step,
                      check(args, n, 8, step, "hd720_ld picture 0 " + key))
    for n in PER_CU_SIZES:
        args = [T(a) for a in isa.synthetic_inputs(rng, 1, n, 10)]
        timed["per_cu_n%d" % n] = (args, n, 10, 1,
                                   isa.intra_satd_plain(*args, n, 10, 1))
    per_shape = {}
    for key, (args, n, bd, step, want) in timed.items():
        call = lambda: isa.intra_satd(*args, n, bd, step)
        weights = isa.weights_on(n, step, dev)
        post = n <= 16 and step == 1
        parent_path = lambda: satd.satd_pred(
            args[0], intra_batch.predict_all_modes(
                n, args[1], args[2], weights, bd, post), bd)
        if not torch.equal(parent_path(), want):
            raise AssertionError("the parent's path differs on " + key)
        per_shape[key] = dict(
            blocks=args[0].shape[0], n=n, mode_step=step, bitdepth=bd,
            modes=want.shape[1], ms=cuda_ms(torch, call),
            device_ms=device_ms(torch, call, "intra_satd"),
            plain_ms=cuda_ms(torch, lambda: isa.intra_satd_plain(
                *args, n, bd, step), 3),
            parent_path_ms=cuda_ms(torch, parent_path, 5),
            **intra_satd_bound(args[0].shape[0], n, want.shape[1]))
        del weights
    if parent is not None:
        inputs = {key: tuple(t.cpu() for t in args) + (n, bd, step,
                                                       want.cpu())
                  for key, (args, n, bd, step, want) in timed.items()}
        for key, (ms, equal) in time_of_tree(torch, parent,
                                             "time_intra_satd_steps",
                                             inputs):
            if not equal:
                raise AssertionError("%s's make_intra_satd_fn differs on %s"
                                     % (parent, key))
            per_shape[key]["parent_ms"] = ms
    # the whole per-CU call, this tree's and the parent's
    calls = {}
    for n in PER_CU_SIZES:
        args, _, bd, _, want = timed["per_cu_n%d" % n]
        calls[n] = tuple(a[0].cpu() for a in args) + (bd, want[0].cpu())
    mine = time_per_cu_calls(torch, calls)
    per_cu_call = {}
    for n, (orig, top, left, bd, want) in calls.items():
        o, t, l = (a.numpy() for a in (orig, top, left))
        weights = isa.weights_on(n, 1, dev)

        def emulated():
            up = [torch.from_numpy(np.ascontiguousarray(
                a[None], dtype=np.int32)).to(dev) for a in (o, t, l)]
            preds = intra_batch.predict_all_modes(n, up[1], up[2], weights,
                                                  bd, n <= 16)
            return satd.satd_pred(up[0], preds, bd).cpu().numpy()[0]

        if not np.array_equal(emulated(), want.numpy()) or not mine[n][2]:
            raise AssertionError("per-CU call n=%d differs" % n)
        per_cu_call[n] = dict(
            ms=mine[n][0], device_ops=mine[n][1],
            parent_emulated_ms=host_ms(torch, emulated),
            parent_emulated_device_ops=device_ops(torch, emulated))
        if mine[n][1] is not None and mine[n][1] > 3:
            raise AssertionError("the per-CU call n=%d makes %d device "
                                 "operations" % (n, mine[n][1]))
    if parent is not None:
        for n, (ms, ops, equal) in time_of_tree(torch, parent,
                                                "time_per_cu_calls", calls):
            if not equal:
                raise AssertionError("%s's per-CU call differs at n=%s"
                                     % (parent, n))
            per_cu_call[int(n)].update(parent_ms=ms, parent_device_ops=ops)
    row = per_shape["lookahead_n4"]
    res["intra_satd"] = dict(
        max_abs_err=0, cases=cases[0], shape="lookahead720 n=4: orig "
        "[57600, 4, 4], top [57600, 9], left [57600, 8] int32, 67 modes",
        ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], bound_bytes=row["bound_bytes"],
        bound_ops=row["bound_ops"], per_shape=per_shape,
        per_cu_call=per_cu_call)
    log("phase 2: intra_satd bit-exact over %d cases (B = 1 at n = %s, B = "
        "77 at every n, mode steps 1/4/8, 8-14 bit, hd720_ld picture 0 at "
        "the lookahead's and the split DP's shapes); kernel / device / "
        "plain / parent's path%s / bound ms: %s" % (
            cases[0], list(PER_CU_SIZES),
            " / parent tree's" if parent is not None else "",
            {k: "%.4f / %s / %.4f / %.4f%s / %.6f (%s)" % (
                r["ms"], "%.4f" % r["device_ms"] if r["device_ms"] else None,
                r["plain_ms"], r["parent_path_ms"],
                " / %.4f" % r["parent_ms"] if "parent_ms" in r else "",
                r["bound_ms"], r["bound_by"])
             for k, r in per_shape.items()}))
    log("phase 2: the per-CU call (device_prepass_satd) on the card, host "
        "ms a call and device operations: %s" % (
            {n: "%.4f ms, %s ops; the parent's call emulated %.4f ms, %s "
                "ops%s" % (
                    r["ms"], r["device_ops"], r["parent_emulated_ms"],
                    r["parent_emulated_device_ops"],
                    "; %s's own %.4f ms, %s ops" % (
                        parent, r["parent_ms"], r["parent_device_ops"])
                    if "parent_ms" in r else "")
             for n, r in per_cu_call.items()},))


# Run in a child process: a timing function of this file (argv[4]) with
# the package of the checkout argv[1], on the inputs saved in argv[3].
_TIME_TREE = """
import importlib.util, json, os, sys
import torch
tree, smoke_py, inputs, name = sys.argv[1:5]
sys.path.insert(0, tree)
spec = importlib.util.spec_from_file_location("smoke", smoke_py)
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
import xvc_tpu_torch
if not os.path.abspath(xvc_tpu_torch.__file__).startswith(tree + os.sep):
    raise AssertionError("imported " + xvc_tpu_torch.__file__)
times = getattr(smoke, name)(torch, torch.load(inputs))
print(json.dumps([[k, v] for k, v in times.items()]))
"""


def time_of_tree(torch, tree, name, inputs):
    """The timing function ``name`` of this file with the package of the
    checkout ``tree`` (this one: ROOT), in a child process, on the same
    inputs (saved under build/).  Returns its result, keys as JSON gives
    them back."""
    path = os.path.join(ROOT, "build", "timed_inputs.pt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(inputs, path)
    try:
        out = subprocess.run(
            [sys.executable, "-c", _TIME_TREE, tree, os.path.abspath(__file__),
             path, name], capture_output=True, text=True, timeout=600)
    finally:
        os.remove(path)
    if out.returncode:
        raise RuntimeError("%s of %s failed:\n%s"
                           % (name, tree, out.stderr[-4000:]))
    return json.loads(out.stdout.strip().splitlines()[-1])


def phase_txrd_kernel(torch, dev, res, parent):
    """The prepass kernel (txrd: screen, residual, exact transform,
    ranking) against its plain version on the card: synthetic cases at
    each size, 8, 10 and 14 bit, three qps, intra and inter, keep 1-3, 67
    and 19 modes; then the real inputs of picture 0 of hd720_s3 at each size,
    bit for bit, each timed (n = 4, 57,600 blocks, the row of the
    kernels line) beside the plain version, the bound and, where
    ``parent`` names a checkout, the stages that checkout runs there."""
    import numpy as np
    from xvc_tpu_torch.gpu import txrd_prepass as tx
    from xvc_tpu_torch.ops.quant import Qp
    rng = np.random.RandomState(SEED + 9)
    cases = 0
    for n in (4, 8, 16, 32):
        # 14 bit: the row pass's sums pass 2^24 at n >= 8 (float32 shifts)
        for bd in (8, 10, 14):
            for qp in (22, 32, 37):
                step = 1 + cases % 4
                inputs = [torch.from_numpy(a).to(dev) for a in
                          tx.synthetic_inputs(rng, 1031 if n < 32 else 263,
                                              n, bd, 2 + -(-65 // step))]
                for intra in (True, False):
                    p = tx.rank_params(n, bd, Qp(qp, 1, bd, 0.57 * 2 ** (
                        (qp - 12) / 3)), intra)
                    for keep in (1, 2, 3):
                        args = tuple(inputs) + (n, bd, keep, step, p)
                        got = tx.txrd(*args)
                        want = tx.txrd_plain(*args)
                        torch.cuda.synchronize()
                        if not torch.equal(got, want):
                            raise AssertionError(
                                "txrd mismatch %r: %d blocks" % (
                                    (n, bd, qp, intra, keep, step),
                                    int((got != want).any(1).sum())))
                        cases += 1
    # log2 of every level + 1 the ranking can meet, float64 on each device
    # rounded to float32: the plain version's values on the CPU and the
    # card, and the kernel's table
    lv = torch.arange(1, 32769, dtype=torch.float64)
    on_card = torch.log2(lv.to(dev)).float().cpu()
    log2_differ = int((torch.log2(lv).float() != on_card).sum())
    table_differ = int((torch.from_numpy(tx.log2_table()) != on_card).sum())
    real = capture_txrd_inputs(torch, dev)
    per_size, timed = {}, {}
    for n in sorted(real):
        args = real[n]
        orig, preds, satd, _, bd, keep, step, p = args
        got = tx.txrd(*args)
        want = tx.txrd_plain(*args)
        torch.cuda.synchronize()
        differ = int((got != want).any(1).sum())
        if differ:
            raise AssertionError("txrd: %d blocks of picture 0 (n=%d) "
                                 "differ from the plain version" % (differ,
                                                                    n))
        timed[n] = (args, want)
        per_size[n] = dict(
            blocks=orig.shape[0], modes=satd.shape[1], equal_blocks=
            orig.shape[0], ms=cuda_ms(torch, lambda: tx.txrd(*args)),
            device_ms=device_ms(torch, lambda: tx.txrd(*args), "txrd"),
            plain_ms=cuda_ms(torch, lambda: tx.txrd_plain(*args), 5),
            **txrd_bound(torch, orig, preds, satd, n, bd, keep, p))
    if parent is not None:
        for n, (ms, equal) in time_of_tree(torch, parent, "time_txrd",
                                           timed):
            if not equal:
                raise AssertionError("%s's txrd stages differ at n=%s"
                                     % (parent, n))
            per_size[int(n)]["parent_ms"] = ms
    row = per_size[4]
    res["txrd"] = dict(
        max_abs_err=0, shape="picture 0 of hd720_s3, n=4: orig [57600, 4, "
        "4], preds [57600, 67, 4, 4], satd [57600, 67] int32, keep 1",
        ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], bound_bytes=row["bound_bytes"],
        bound_ops=row["bound_ops"], per_size=per_size,
        synthetic_cases=cases, log2_cpu_card_differ=log2_differ,
        log2_table_card_differ=table_differ)
    log("phase 2: txrd bit-exact over %d synthetic cases and picture 0 of "
        "hd720_s3 (%s); float64 log2 rounded to float32 differs between CPU "
        "and card at %d of 32,768 levels, the kernel's table from the card's "
        "at %d; per size: %s" % (
            cases, ", ".join("n=%d: %d blocks equal" % (n, r["equal_blocks"])
                             for n, r in per_size.items()), log2_differ,
            table_differ,
            {n: "kernel %.4f ms (device time alone %s), plain %.4f ms, bound "
                "%.4f ms (%s)%s" % (
                r["ms"], r["device_ms"], r["plain_ms"], r["bound_ms"],
                r["bound_by"],
                ", %s's stages %.4f ms" % (parent, r["parent_ms"])
                if "parent_ms" in r else "")
             for n, r in per_size.items()}))


def resample_bound(case, tab_x, tab_y):
    """PR 10's bound of one plane's rescale as its two-pass kernel took
    it: the int32 window read once, the two axis tables read and the int32
    output written once, and the multiply and the add of every tap of both
    passes; ``bound_unfused_ms`` adds the intermediate rows, written and
    read back once, which a launch a pass moves."""
    src_w, src_h, _, dst_w, dst_h, _ = case
    win_h = src_h + 16
    nbytes = 4 * (win_h * (src_w + 16) + tab_x.size + tab_y.size +
                  dst_w * dst_h)
    ops = 2 * ((tab_x.shape[1] - 1) * win_h * dst_w +
               (tab_y.shape[1] - 1) * dst_h * dst_w)
    out = bound(nbytes, ops)
    out["bound_unfused_ms"] = (nbytes + 8 * win_h * dst_w) / \
        HBM_BYTES_PER_S * 1e3
    return out


def picture_bound(planes):
    """The least time of one picture's rescale as the fused kernel does
    it: ``planes`` ((case, output element bytes) each), each plane's int16
    window read once, its two axis tables read once, its output written
    once, and the multiply and the add of every tap of both passes.  Also
    ``bound_int32_two_pass_ms``, PR 10's bound of the same planes (int32
    window and output, the intermediate written and read back)."""
    from xvc_tpu_torch.gpu import resample as rsm
    nbytes = ops = 0
    old = 0.0
    for case, esize in planes:
        src_w, src_h, _, dst_w, dst_h, _ = case
        p = rsm.plan(*case)
        win_h = src_h + 16
        nbytes += 2 * win_h * (src_w + 16) + 4 * (p.tab_x.size +
                                                  p.tab_y.size) + \
            esize * dst_w * dst_h
        ops += 2 * ((p.tab_x.shape[1] - 1) * win_h * dst_w +
                    (p.tab_y.shape[1] - 1) * dst_h * dst_w)
        old += resample_bound(case, p.tab_x, p.tab_y)["bound_unfused_ms"]
    out = bound(nbytes, ops)
    out["bound_int32_two_pass_ms"] = old
    return out


def dense_resample(torch, case, dev):
    """The yardstick of library_ms (never used by the port): the JAX
    package's formulation, the dense tap matrices of each axis as float64
    and two torch.matmul calls, the shifts as floor divisions by powers of
    two, then the clips.  Exact: every sum is an integer below 2^53."""
    import numpy as np
    from xvc_tpu_torch.gpu import resample as rsm
    src_w, src_h, src_bd, dst_w, dst_h, dst_bd = case
    scale_x, scale_y, shift_hor, shift_ver, maxv = rsm.geometry(*case)

    def dense(scale, out_size, src_size):
        table, post = rsm.axis_table(scale, out_size, src_size)
        m = np.zeros((src_size + 16, out_size))
        for k in range(table.shape[1] - 1):
            m[table[:, 0] + k, np.arange(out_size)] = table[:, 1 + k]
        return torch.from_numpy(m).to(dev), post

    mh, post_x = dense(scale_x, dst_w, src_w)
    mv, post_y = dense(scale_y, dst_h, src_h)
    mv = mv.t().contiguous()
    div_x, div_y = float(1 << (post_x + shift_hor)), \
        float(1 << (post_y + shift_ver))

    def fn(window):
        tmp = torch.floor(torch.matmul(window.double(), mh) / div_x)
        out = torch.floor(torch.matmul(mv, tmp.clamp_(0, 65535)) / div_y)
        return out.clamp_(0, maxv).to(torch.int32)
    return fn


def time_resample_planes(torch, inputs):
    """The per-plane host-window call of the package that is imported
    (``gpu.resample.resample``: the window cut from the host plane, its
    upload, a launch and a synchronous download, one plane at a time;
    then the planes packed into bytes), on each picture of ``inputs``
    ({name: [(padded int32 plane, (origin_y, origin_x, src_w, src_h, bd,
    dst_w, dst_h, dst_bd))]}): per picture, ms of the whole call and of
    its parts (each part ended by a synchronisation, 10 calls after a
    warm-up) and the sha256 of the bytes."""
    import numpy as np
    from xvc_tpu_torch.gpu import resample as rsm
    dev = torch.device("cuda", 0)
    iters = 10
    out = {}
    for name, planes in inputs.items():
        planes = [(t.numpy(), tuple(int(v) for v in g)) for t, g in planes]

        def clock():
            torch.cuda.synchronize()
            return time.perf_counter()

        parts = dict.fromkeys(("window", "upload", "kernel", "download",
                               "pack"), 0.0)
        for it in range(iters + 1):
            got = []
            for plane, (oy, ox, sw, sh, bd, dw, dh, dbd) in planes:
                t0 = clock()
                win = rsm.cut_window(plane, oy, ox, sw, sh)
                t1 = clock()
                dwin = torch.from_numpy(win).to(dev)
                t2 = clock()
                o = rsm.resample_window(dwin, bd, dw, dh, dbd)
                t3 = clock()
                got.append(o.cpu().numpy())
                t4 = clock()
                if it:
                    for key, dt in (("window", t1 - t0), ("upload", t2 - t1),
                                    ("kernel", t3 - t2),
                                    ("download", t4 - t3)):
                        parts[key] += dt
            t5 = clock()
            data = b"".join(p.astype(np.uint8 if dbd <= 8 else np.uint16)
                            .tobytes() for p in got)
            if it:
                parts["pack"] += time.perf_counter() - t5
        t0 = clock()
        for _ in range(iters):
            data = b"".join(
                rsm.resample(plane, *g, device=dev).astype(
                    np.uint8 if g[7] <= 8 else np.uint16).tobytes()
                for plane, g in planes)
        call_ms = (clock() - t0) * 1e3 / iters
        out[name] = dict(call_ms=call_ms, sha256=hashlib.sha256(
            data).hexdigest(), **{k + "_ms": v * 1e3 / iters
                                  for k, v in parts.items()})
    return out


def decoded_picture(torch, dev, stream, index):
    """Picture ``index`` of a bench stream as its decode on the card
    leaves it for the resampler: a 4:2:0 8-bit picture whose host border
    is padded and whose frame-store slot on the card holds its planes,
    edge-replicated (the samples from a decode of the stream on the card,
    held to its hash list)."""
    import numpy as np
    from xvc_tpu_torch import constants as k
    from xvc_tpu_torch.codec.decoder import decode_stream
    from xvc_tpu_torch.codec.yuv import YuvPicture
    from xvc_tpu_torch.gpu import flat_recon
    with open(os.path.join(DATA, "bench", stream + ".xvc"), "rb") as f:
        pics = decode_stream(f.read(), device=dev)
    hashes, _ = read_hashes(os.path.join(DATA, "bench",
                                         stream + "_dec.sha256"))
    src = pics[index]
    if hashlib.sha256(src.bytes).hexdigest() != hashes[index]:
        raise AssertionError("%s picture %d differs from its hash list"
                             % (stream, index))
    pic = YuvPicture(k.ChromaFormat.YUV420, src.width, src.height, 8, True)
    buf = np.frombuffer(src.bytes, np.uint8)
    off = 0
    for c in range(3):
        view = pic.plane_view(c)
        view[:] = buf[off:off + view.size].reshape(view.shape)
        off += view.size
    pic.pad_border()
    flat_recon.frame_store_put(pic, flat_recon.device_pad_planes(
        pic, {c: torch.from_numpy(pic.plane_view(c).astype(np.int16)).to(
            dev) for c in range(3)}), dev)
    return pic


def time_resample_picture(torch, dev, pic, fmt, border_padded, iters=10):
    """The per-picture call of output resizing
    (``codec.output.convert_to``: one launch from the frame-store slot
    into the packed output bytes, one download) on ``pic``: (bytes, ms
    of the whole call (host clock, 10 calls after a warm-up), ms per call
    of each span under ``profiling.enable(sync=True)``)."""
    from xvc_tpu_torch import profiling
    from xvc_tpu_torch.codec import output
    data = output.convert_to(pic, fmt, dev, border_padded)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        output.convert_to(pic, fmt, dev, border_padded)
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3 / iters
    profiling.reset()
    profiling.enable(sync=True)
    try:
        for _ in range(iters):
            output.convert_to(pic, fmt, dev, border_padded)
    finally:
        profiling.enable(False)
    spans = {n: r["seconds"] * 1e3 / iters
             for n, r in profiling.report().items()}
    profiling.reset()
    return data, call_ms, spans


def phase_resample_kernel(torch, dev, res, parent):
    """The resampler's fused kernel against its plain version on the card:
    the nine cases of tests/test_resample_device.py, one case per scale
    class at 8, 10 and 14 bit and the extreme ratios, each with random and
    with full-scale samples, as one plane (``resample_window``) and as two
    planes of one launch (a packed output, and an int32 output with the
    store's edge replication around it); the full-width planes of
    RESAMPLE_PLANES one at a time, each timed beside its plain version,
    its PR 10 bound, the dense float64 matmuls of the JAX formulation, the
    upload of its window and the whole per-plane host call; then the
    per-picture call on decoded pictures (RESAMPLE_PICTURES: 1080p ->
    720p and 720p -> 1080p, 4:2:0, 8 bit) from their frame-store slots,
    bit for bit against the per-plane calls and the plain version: the
    kernel (CUDA events and device time), its bound and PR 10's bound of
    the same planes, the plain version and the dense matmuls of its three
    planes, the whole call with and without the ring, its spans, the
    alternative reconstruction of the 1080p picture at 720p, and the
    per-plane calls of this tree and, with ``parent``, of the checkout
    ``parent`` (in a child process) on the same pictures."""
    import numpy as np
    from xvc_tpu_torch.gpu import flat_recon
    from xvc_tpu_torch.gpu import resample as rsm
    from xvc_tpu_torch.ops import resample as ors
    from xvc_tpu_torch.codec.yuv import YuvPicture
    cases = list(rsm.DEVICE_CASES) + [c for bd in (8, 10, 14)
                                      for c in rsm.class_cases(bd)] + \
        list(rsm.EXTREME_CASES)
    checked = 0
    for i, case in enumerate(cases):
        src_w, src_h, src_bd, dst_w, dst_h, dst_bd = case
        for full_scale in (False, True):
            win = torch.from_numpy(rsm.synthetic_window(
                case, SEED + i, full_scale)).to(dev)
            args = (win,) + case[2:]
            got = rsm.resample_window(*args)
            want = rsm.resample_plain(*args)
            h, w = win.shape
            win16 = torch.empty((h, w + (w & 1)), dtype=torch.int16,
                                device=dev)[:, :w]
            win16.copy_(win)
            packed = torch.empty((dst_h, dst_w), device=dev, dtype=(
                torch.uint8 if dst_bd <= 8 else torch.int16))
            padded = torch.empty((dst_h + 13, dst_w + 20), device=dev,
                                 dtype=torch.int32)
            rsm.run_planes(
                [rsm.PlaneJob(0, 8, 8, src_w, src_h, dst_w, dst_h, packed),
                 rsm.PlaneJob(0, 8, 8, src_w, src_h, dst_w, dst_h, padded,
                              5, 9)], [(win16, 0, 0)] * 2, src_bd, dst_bd)
            rows = (torch.arange(dst_h + 13, device=dev) - 5).clamp(
                0, dst_h - 1)
            cols = (torch.arange(dst_w + 20, device=dev) - 9).clamp(
                0, dst_w - 1)
            torch.cuda.synchronize()
            if not torch.equal(got, want) or \
                    not torch.equal(packed.to(torch.int32) & 0xFFFF,
                                    want) or \
                    not torch.equal(padded, want[rows][:, cols]):
                raise AssertionError("resample mismatch %r (full scale %s)"
                                     % (case, full_scale))
            checked += 1
    planes = []
    for src, dst in RESAMPLE_PLANES:
        case = src + (8,) + dst + (8,)
        host = rsm.synthetic_window(case, SEED)
        padded = np.pad(host, 8)
        win = torch.from_numpy(host).to(dev)
        args = (win,) + case[2:]
        library = dense_resample(torch, case, dev)
        got = rsm.resample_window(*args)
        want = rsm.resample_plain(*args)
        lib_out = library(win)
        torch.cuda.synchronize()
        if max_err(torch, got, want) or max_err(torch, lib_out, want):
            raise AssertionError("resample mismatch at %r (kernel %d, dense "
                                 "float64 %d)" % (case, max_err(
                                     torch, got, want), max_err(
                                         torch, lib_out, want)))
        p = rsm.plan(*case)
        t0 = time.perf_counter()
        for _ in range(10):
            rsm.resample(padded, 16, 16, src[0], src[1], 8, dst[0], dst[1],
                         8, dev)
        planes.append(dict(
            shape="%dx%d -> %dx%d, 8 bit" % (src + dst),
            ms=cuda_ms(torch, lambda: rsm.resample_window(*args)),
            device_ms=device_ms(torch, lambda: rsm.resample_window(*args),
                                "resample"),
            plain_ms=cuda_ms(torch, lambda: rsm.resample_plain(*args), 5),
            library_ms=cuda_ms(torch, lambda: library(win), 10),
            upload_ms=cuda_ms(torch, lambda: torch.from_numpy(host).to(dev),
                              10),
            call_ms=(time.perf_counter() - t0) * 100,
            **resample_bound(case, p.tab_x, p.tab_y)))
    log("phase 2: resample bit-exact over %d synthetic cases (every scale "
        "class, 8, 10 and 14 bit, extreme ratios, random and full-scale "
        "samples; one plane, and two planes of one launch) and the "
        "full-width planes; per plane (one launch, int32 window): %s" % (
            checked, [
                "%s: kernel %.4f ms (device time alone %s), plain %.4f ms, "
                "dense float64 matmuls %.4f ms, PR 10's bound %.4f ms (%s; "
                "%.4f with the intermediate), window upload %.4f ms, whole "
                "per-plane call %.4f ms" % (
                    p["shape"], p["ms"], p["device_ms"], p["plain_ms"],
                    p["library_ms"], p["bound_ms"], p["bound_by"],
                    p["bound_unfused_ms"], p["upload_ms"], p["call_ms"])
                for p in planes]))
    pictures = {}
    inputs = {}
    for name, (stream, index, size) in RESAMPLE_PICTURES.items():
        pic = decoded_picture(torch, dev, stream, index)
        fmt = dict(width=size[0], height=size[1], chroma_format=1,
                   bitdepth=8, color_matrix=0, dither=0)
        geoms = [(c, pic.pad_y[c], pic.pad_x[c], pic.get_display_width(c),
                  pic.get_display_height(c), size[0] >> (c > 0),
                  size[1] >> (c > 0)) for c in range(3)]
        inputs[name] = [
            (torch.from_numpy(np.ascontiguousarray(pic.padded_plane(c))),
             (oy, ox, sw, sh, 8, dw, dh, 8))
            for c, oy, ox, sw, sh, dw, dh in geoms]
        data, call_ms, spans = time_resample_picture(torch, dev, pic, fmt,
                                                     True)
        ring, ring_ms, ring_spans = time_resample_picture(torch, dev, pic,
                                                          fmt, False)
        total = sum(dw * dh for *_, dw, dh in geoms)
        buf = torch.empty(total, dtype=torch.uint8, device=dev)
        jobs, off = [], 0
        for c, oy, ox, sw, sh, dw, dh in geoms:
            jobs.append(rsm.PlaneJob(c, oy, ox, sw, sh, dw, dh,
                                     buf[off:off + dw * dh].view(dh, dw)))
            off += dw * dh
        kernel = lambda: rsm.resample_picture(pic, jobs, 8, 8, dev, True)
        cases3 = [(sw, sh, 8, dw, dh, 8)
                  for _, _, _, sw, sh, dw, dh in geoms]
        windows = [w[0][w[1]:w[1] + j.src_h + 16,
                        w[2]:w[2] + j.src_w + 16].to(torch.int32)
                   for w, j in zip(rsm.store_windows(pic, jobs, dev, True),
                                   jobs)]
        plain = lambda: [rsm.resample_plain(w, *c[2:])
                         for w, c in zip(windows, cases3)]
        dense = [dense_resample(torch, c, dev) for c in cases3]
        library = lambda: [d(w) for d, w in zip(dense, windows)]
        kernel()
        want = b"".join(p.to(torch.uint8).cpu().numpy().tobytes()
                        for p in plain())
        torch.cuda.synchronize()
        if buf.cpu().numpy().tobytes() != want or data != want or \
                ring != want:
            raise AssertionError("%s: the per-picture call differs from "
                                 "the plain version" % name)
        from xvc_tpu_torch import kernels
        kernels.reset_launches()
        ors.resample_pic(YuvPicture(1, size[0], size[1], 8, True), pic, dev,
                         True)
        torch.cuda.synchronize()
        if kernels.LAUNCHES["resample"] != 1:
            raise AssertionError("the alternative picture took %d launches"
                                 % kernels.LAUNCHES["resample"])
        alt_t0 = time.perf_counter()
        for _ in range(10):
            alt = YuvPicture(1, size[0], size[1], 8, True)
            ors.resample_pic(alt, pic, dev, True)
        torch.cuda.synchronize()
        alt_ms = (time.perf_counter() - alt_t0) * 100
        flat_recon.release_slot(alt)
        per_plane = time_resample_planes(torch, {name: inputs[name]})[name]
        if per_plane.pop("sha256") != hashlib.sha256(want).hexdigest():
            raise AssertionError("%s: the per-plane calls differ" % name)
        pictures[name] = dict(
            shape="%dx%d -> %dx%d 4:2:0, 8 bit, picture %d of %s" % (
                pic.width[0], pic.height[0], size[0], size[1], index,
                stream),
            ms=cuda_ms(torch, kernel),
            device_ms=device_ms(torch, kernel, "resample_picture"),
            plain_ms=cuda_ms(torch, plain, 5),
            library_ms=cuda_ms(torch, library, 10),
            call_ms=call_ms, spans_ms=spans, ring_call_ms=ring_ms,
            ring_spans_ms=ring_spans, alternative_call_ms=alt_ms,
            per_plane_calls=per_plane,
            sha256=hashlib.sha256(want).hexdigest(),
            **picture_bound([(c, 1) for c in cases3]))
        flat_recon.release_slot(pic)
    if parent is not None:
        for name, times in time_of_tree(torch, parent,
                                        "time_resample_planes", inputs):
            if times.pop("sha256") != pictures[name]["sha256"]:
                raise AssertionError("%s: %s's per-plane calls give other "
                                     "bytes" % (name, parent))
            pictures[name]["parent_per_plane_calls"] = times
    row = pictures[RESAMPLE_TIMED]
    res["resample"] = dict(
        max_abs_err=0, shape=row["shape"] + ": int16 windows from the "
        "frame store -> packed uint8 output, one launch", per_plane=planes,
        per_picture=pictures, synthetic_cases=checked,
        **{k: row[k] for k in ("ms", "device_ms", "plain_ms", "library_ms",
                               "bound_ms", "bound_by", "bound_bytes",
                               "bound_ops")})
    log("phase 2: resample per picture (one launch, the frame store in, the "
        "packed output bytes out): %s" % json.dumps(pictures))


def me_case(rng, w, h, bd, n):
    """A padded 1280x720 luma plane (880 x 1440), a box origin in it, an
    h x w block and n offsets into the 192 x 192 window at that origin
    (the window's four corners first), samples of ``bd`` bits with a run
    of extremes."""
    import numpy as np
    plane = rng.randint(0, 1 << bd, (880, 1440)).astype(np.int32)
    oy, ox = rng.randint(0, 880 - 192 + 1), rng.randint(0, 1440 - 192 + 1)
    orig = rng.randint(0, 1 << bd, (h, w)).astype(np.int32)
    plane[oy:oy + h, ox:ox + w] = (1 << bd) - 1
    orig[::3] = 0
    ys = rng.randint(0, 192 - h + 1, n)
    xs = rng.randint(0, 192 - w + 1, n)
    corners = [(0, 0), (0, 192 - w), (192 - h, 0), (192 - h, 192 - w)]
    for j, (y, x) in enumerate(corners[:n]):
        ys[j], xs[j] = y, x
    return plane, oy, ox, orig, np.stack([ys, xs]).astype(np.int32)


def me_sad_bound(plane_shape, oy, ox, orig, cands, fast, bd):
    """me_sad's work on one sweep: the plane samples the candidates'
    blocks cover (each counted once; the even rows alone for SAD_FAST) at
    the resident plane's element size, the block's summed rows at the
    same size, the offsets as int32, read once, and the int32 sums
    written once; three operations (difference, |.|, add) a sample of a
    candidate's block, and the doubling and shift a candidate.  (bytes,
    operations)."""
    import numpy as np
    h, w = orig.shape
    n = cands.shape[1]
    rows = np.arange(0, h, 2 if fast else 1)
    ys, xs = cands[0] + oy, cands[1] + ox
    covered = np.zeros((int(ys.max()) + h - oy, int(xs.max()) + w - ox),
                       bool) if n else np.zeros((0, 0), bool)
    for y, x in zip(ys - oy, xs - ox):
        covered[y + rows, x:x + w] = True
    elem = 2 if bd <= 15 else 4
    nbytes = (int(covered.sum()) + len(rows) * w) * elem + 8 * n + 4 * n
    return nbytes, n * (3 * len(rows) * w + 2)


def phase_me_sad_kernel(torch, dev, res):
    """The motion search's SAD sweep (me_sad) against its plain version on
    the card, bit for bit, through the per-prefetch call
    (``gpu/me.sad_sweep``: the plane resident on the card, the block and
    the offsets in mapped staging, one launch, the SADs in mapped
    memory): every CU shape from 4x4 to 64x64 with SAD and SAD_FAST, at
    8, 10, 12 and 16 bit (int16 and int32 planes) and 1, 44, 86 and 754
    candidates, the window's corners among them, in a padded 1280x720
    plane; the plane's four corners; and through ``DeviceSadTable`` on a
    reference picture whose border was never padded (its buffer's old
    samples) and on a recycled picture (``PictureEncoder.init_pic``, new
    content), each against the CPU device.  me_sad is timed on the
    sweeps of phase 9's qcif_me encode (``phase_me_sad_timing``)."""
    import numpy as np
    from xvc_tpu_torch import segment as seg
    from xvc_tpu_torch.codec.picture_encoder import PictureEncoder
    from xvc_tpu_torch.codec.yuv import YuvPicture
    from xvc_tpu_torch.gpu import me
    from xvc_tpu_torch.ops import metrics as met
    from xvc_tpu_torch.restrictions import Restrictions
    rng = np.random.RandomState(SEED + 29)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    cases = 0

    def check(plane, oy, ox, orig, cands, fast, bd, what):
        res_plane = T(plane).to(me.packed_dtype(bd)).to(dev)
        got = me.sad_sweep(res_plane, oy, ox, orig, cands, fast, bd)
        want = me.sad_sweep_plain(T(plane), oy, ox, T(orig), T(cands), fast,
                                  bd).numpy()
        if not np.array_equal(got, want):
            raise AssertionError("me_sad differs from its plain version at "
                                 "%r" % (what,))

    i = 0
    for w in ME_SIZES:
        for h in ME_SIZES:
            for fast in (False, True):
                bd = ME_BITDEPTHS[i % 4]
                n = ME_COUNTS[(i // 4) % 4]
                i += 1
                check(*me_case(rng, w, h, bd, n), fast, bd,
                      (w, h, fast, bd, n))
                cases += 1
    # the plane's four corners, from its origin
    for w, h, bd in ((16, 16, 8), (64, 32, 16), (4, 8, 10)):
        plane, _, _, orig, _ = me_case(rng, w, h, bd, 1)
        cands = np.array([[0, 0, 880 - h, 880 - h],
                          [0, 1440 - w, 0, 1440 - w]], np.int32)
        for fast in (False, True):
            check(plane, 0, 0, orig, cands, fast, bd, ("corners", w, h, bd))
            cases += 1

    class Cu:
        def __init__(self, x, y, w, h):
            self.x, self.y, self.width, self.height = x, y, w, h

        def pos(self, comp):
            return self.x, self.y

    class Qp:
        distortion_weight = [1.0, 1.0, 1.0]

    def tables(pics, orig, metric, sweeps):
        """Each sweep (CU x, y, w, h and its vectors) through a table on
        the card and on the CPU device (a copy of the picture each), the
        caches held equal; returns the card's caches."""
        caches = []
        for x, y, w, h, mvs in sweeps:
            tabs = [me.DeviceSadTable(None, Cu(x, y, w, h), metric, p,
                                      orig[:h, :w], d)
                    for p, d in zip(pics, (dev, "cpu"))]
            for t in tabs:
                t.prefetch(Qp(), mvs)
            if not tabs[0].cache or tabs[0].cache != tabs[1].cache:
                raise AssertionError("me_sad through DeviceSadTable differs "
                                     "from the CPU device at %r" % (
                                         (x, y, w, h),))
            caches.append(tabs[0].cache)
        return caches

    # sweeps that read the border: top-left, bottom-right, top
    sweeps = [(0, 0, 16, 16, me.tz_initial_candidates((-8, -8), 64)),
              (1264, 704, 16, 16, [(dx, dy) for dx in range(-96, 81, 11)
                                   for dy in range(-96, 81, 16)]),
              (600, 40, 32, 32, me.tz_initial_candidates((0, -40), 64))]
    # a reference whose border was never padded: its buffer's old samples
    pics = [YuvPicture(1, 1280, 720, 10) for _ in range(2)]
    old = rng.randint(0, 1024, pics[0].planes[0].shape)
    new = rng.randint(0, 1024, (720, 1280))
    orig = rng.randint(0, 1024, (64, 64)).astype(np.int32)
    for p in pics:
        p.planes[0][:] = old
        p.plane_view(0)[:] = new
    metric = met.SampleMetric(10, met.MetricType.SAD)
    me.reset_stats()
    tables(pics, orig, metric, sweeps)
    cases += len(sweeps)
    if me.STATS["reference_uploads"] != 2:
        raise AssertionError("the unpadded reference was copied %d times"
                             % me.STATS["reference_uploads"])
    # a recycled picture: the encoder's buffer with new content
    encs = [PictureEncoder(1, 1280, 720, 10) for _ in range(2)]
    for e in encs:
        e.rec_pic.planes[0][:] = old
        e.rec_pic.pad_border()
    pics = [e.rec_pic for e in encs]
    before = tables(pics, orig, metric, sweeps)
    segment = seg.SegmentHeader(soc=0, max_sub_gop_length=1,
                                low_delay=True, num_ref_pics=1)
    for e in encs:
        e.init_pic(segment, 1, 1, 0, False, Restrictions())
        e.rec_pic.plane_view(0)[:] = new
        e.rec_pic.pad_border()
    after = tables(pics, orig, metric, sweeps)
    cases += 2 * len(sweeps)
    if me.STATS["reference_uploads"] != 6 or before == after:
        raise AssertionError("the recycled picture's sweeps read its old "
                             "content (%d reference copies)"
                             % me.STATS["reference_uploads"])
    res["me_sad"] = dict(max_abs_err=0, cases=cases)
    log("phase 2: me_sad bit-exact over %d cases (every CU shape, SAD and "
        "SAD_FAST, 8-16 bit, 1-754 candidates in a padded 1280x720 plane "
        "resident on the card, its four corners, a never-padded and a "
        "recycled reference through DeviceSadTable, through the "
        "per-prefetch call)" % cases)


def record_sweeps(me, sweeps, refs):
    """Wrap ``me.sad_sweep`` so that every device sweep's inputs (the
    resident plane, the origin, the block, the offsets), its SADs and its
    host ms are kept in ``sweeps``, and ``me.reference_luma`` so that
    ``refs`` gathers the (picture, generation) pairs the sweeps read;
    returns the function that undoes both."""
    real_sweep, real_ref = me.sad_sweep, me.reference_luma

    def recorded(plane, oy, ox, orig, cands, fast, bitdepth):
        t0 = time.perf_counter()
        sads = real_sweep(plane, oy, ox, orig, cands, fast, bitdepth)
        ms = (time.perf_counter() - t0) * 1e3
        if sweeps is not None:
            sweeps.append(dict(plane=plane, oy=oy, ox=ox, orig=orig.copy(),
                               cands=cands.copy(), fast=fast,
                               bitdepth=bitdepth, sads=sads, ms=ms))
        return sads

    def ref_recorded(ref_pic, device):
        refs.add((id(ref_pic), ref_pic.luma_generation))
        return real_ref(ref_pic, device)

    me.sad_sweep, me.reference_luma = recorded, ref_recorded

    def undo():
        me.sad_sweep, me.reference_luma = real_sweep, real_ref
    return undo


def sweep_inputs(torch, sweeps):
    """Recorded sweeps as the inputs of a child process
    (``time_prefetch_calls``): the distinct planes, on the CPU as int32,
    and each sweep with its plane's index."""
    planes, index, rows = [], {}, []
    for s in sweeps:
        key = id(s["plane"])
        if key not in index:
            index[key] = len(planes)
            planes.append(s["plane"].cpu().to(torch.int32))
        rows.append(dict(
            plane=index[key], oy=s["oy"], ox=s["ox"],
            orig=torch.from_numpy(s["orig"]),
            cands=torch.from_numpy(s["cands"]), fast=s["fast"],
            bitdepth=s["bitdepth"], sads=torch.from_numpy(s["sads"])))
    return dict(planes=planes, sweeps=rows)


def time_prefetch_calls(torch, inputs, passes=5):
    """The per-prefetch call of the package that is imported, on recorded
    sweeps (``sweep_inputs``), for a child process (``time_of_tree``):
    mean host ms a call over ``passes`` passes over every sweep, whether
    every SAD equals the recorded one, and the device operations of the
    call on the sweep of median candidate count.  A package with
    ``reference_luma`` takes the plane resident on the card
    (``sad_sweep``); one without it (the packed call it replaced) cuts
    the candidates' box from the host plane and packs, uploads and
    downloads it a call (``device_sads``), as its
    ``DeviceSadTable.prefetch`` did."""
    import numpy as np
    from xvc_tpu_torch.gpu import me
    dev = torch.device("cuda", 0)
    sweeps = inputs["sweeps"]
    if hasattr(me, "reference_luma"):
        planes = [p.to(me.packed_dtype(sweeps[0]["bitdepth"])).to(dev)
                  for p in inputs["planes"]]

        def call(s):
            return me.sad_sweep(planes[s["plane"]], s["oy"], s["ox"],
                                s["orig"].numpy(), s["cands"].numpy(),
                                s["fast"], s["bitdepth"])
    else:
        planes = [p.numpy() for p in inputs["planes"]]

        def call(s):
            c = s["cands"].numpy()
            h, w = s["orig"].shape
            oy, ox = s["oy"], s["ox"]
            win = planes[s["plane"]][oy:oy + int(c[0].max()) + h,
                                     ox:ox + int(c[1].max()) + w]
            return me.device_sads(win, s["orig"].numpy(), c, s["fast"],
                                  s["bitdepth"], dev)
    equal = all(np.array_equal(call(s), s["sads"].numpy()) for s in sweeps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(passes):
        for s in sweeps:
            call(s)
    ms = (time.perf_counter() - t0) * 1e3 / (passes * len(sweeps))
    order = sorted(sweeps, key=lambda s: s["cands"].shape[1])
    mid = order[len(order) // 2]
    return {"host_ms": ms, "equal": equal,
            "device_operations": device_ops(torch, lambda: call(mid))}


def copy_staged_call(torch, me, plane, oy, ox, orig, cands, fast, bd,
                     staging, buf):
    """The per-prefetch call as two device operations (variant b, timed
    beside ``me.sad_sweep``): the block and the offsets staged in mapped
    memory as ``sad_sweep`` stages them, one H2D copy of them into the
    device buffer ``buf``, the launch reading them there, the SADs
    written to mapped memory, one event wait."""
    n = cands.shape[1]
    nbytes = me.stage_sweep(staging.inp, orig, cands, bd)
    buf[:nbytes].copy_(torch.from_numpy(staging.inp[:nbytes]),
                       non_blocking=True)
    me._launch(plane, oy, ox, buf.data_ptr(), orig.shape[0], orig.shape[1],
               n, fast, bd, staging.out_dev)
    staging.done.record(torch.cuda.current_stream(plane.device))
    staging.done.synchronize()
    return staging.out[:n].copy()


def me_call_parts(torch, me, sweeps, work):
    """The per-prefetch call (``me.sad_sweep``) taken apart, each sweep
    after ``work`` seconds of host work: the median host ms of the
    staging fill, of the launch call, of the wait on the event, of the
    whole, and the device ms from an event recorded before the launch to
    one after it (the launch's queueing and the kernel)."""
    import numpy as np
    parts = {"fill": [], "launch": [], "wait": [], "call": [], "device": []}
    st = me._Staging(me.staging_bytes(64, 64, 4096, 16), 4096)
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for s in sweeps:
        until = time.perf_counter() + work
        while time.perf_counter() < until:
            pass
        orig, cands, bd = s["orig"], s["cands"], s["bitdepth"]
        stream = torch.cuda.current_stream(s["plane"].device)
        t0 = time.perf_counter()
        me.stage_sweep(st.inp, orig, cands, bd)
        t1 = time.perf_counter()
        ev0.record(stream)
        me._launch(s["plane"], s["oy"], s["ox"], st.in_dev, orig.shape[0],
                   orig.shape[1], cands.shape[1], s["fast"], bd, st.out_dev)
        ev1.record(stream)
        t2 = time.perf_counter()
        ev1.synchronize()
        t3 = time.perf_counter()
        if not np.array_equal(st.out[:cands.shape[1]], s["sads"]):
            raise AssertionError("me_sad differs from the encode's SADs")
        for key, v in (("fill", t1 - t0), ("launch", t2 - t1),
                       ("wait", t3 - t2), ("call", t3 - t0)):
            parts[key].append(v * 1e3)
        parts["device"].append(ev0.elapsed_time(ev1))
    st.free()
    return {k: sorted(v)[len(v) // 2] for k, v in parts.items()}


def phase_me_sad_timing(torch, dev, res, sweeps, parent):
    """me_sad on the device sweeps of phase 9's qcif_me encode, as its TZ
    search gave them (the resident plane, the origin, the block, the
    offsets), held to its plain version and to the SADs the encode got.
    Means over the sweeps: the kernel's time launched back to back from
    mapped staging (CUDA events, and device time from torch.profiler), its
    time with the staging in device memory, the plain version's, the
    library yardstick's (``torch.cdist`` p=1 in float32 on the
    candidates' blocks gathered beforehand, then the doubling and shift:
    exact below 2^24, checked), and the bound (``me_sad_bound``).  The
    per-prefetch call over every sweep: variant (a) ``me.sad_sweep``
    (one device operation) and (b) ``copy_staged_call`` (two) in turns,
    a, b, b, a; the same calls under torch.profiler, as the encode is,
    and taken apart back to back and after 20 ms of host work each
    (``me_call_parts``), which the encode's own call times are set
    beside; this tree's call and, with ``parent``, the parent's call on
    the same sweeps in child processes (``time_prefetch_calls``, with
    their device operations).  Then the same on a 720p reference
    (``me_720p_case``)."""
    import numpy as np
    from xvc_tpu_torch import kernels
    from xvc_tpu_torch.gpu import me
    k = len(sweeps)
    # each sweep staged twice: in mapped memory of its own (as the main
    # path stages it) and in device memory
    staged, nbytes, ops, err = [], 0, 0, 0
    for s in sweeps:
        orig, cands, bd, fast = s["orig"], s["cands"], s["bitdepth"], \
            s["fast"]
        h, w = orig.shape
        n = cands.shape[1]
        st = me._Staging(me.staging_bytes(h, w, n, bd), n)
        size = me.stage_sweep(st.inp, orig, cands, bd)
        dbuf = torch.from_numpy(st.inp[:size].copy()).to(dev)
        dout = torch.empty(n, dtype=torch.int32, device=dev)
        args = (s["plane"], s["oy"], s["ox"])
        staged.append((st, dbuf, dout, args, h, w, n, fast, bd))
        want = me.sad_sweep_plain(*args, torch.from_numpy(orig).to(dev),
                                  torch.from_numpy(cands).to(dev), fast,
                                  bd).cpu().numpy()
        me._launch(*args, st.in_dev, h, w, n, fast, bd, st.out_dev)
        me._launch(*args, dbuf.data_ptr(), h, w, n, fast, bd,
                   dout.data_ptr())
        torch.cuda.synchronize()
        for got in (st.out[:n], dout.cpu().numpy()):
            err = max(err, int(np.abs(got.astype(np.int64) - want).max()))
            if not np.array_equal(got, s["sads"]):
                raise AssertionError("me_sad differs from the SADs of the "
                                     "encode on a %dx%d sweep" % (w, h))
        b, o = me_sad_bound(s["plane"].shape, s["oy"], s["ox"], orig,
                            cands, fast, bd)
        nbytes += b
        ops += o
    if err:
        raise AssertionError("me_sad differs from its plain version on "
                             "%s's sweeps" % ME_SWEEPS_CLIP)
    mapped = lambda: [me._launch(*a, st.in_dev, h, w, n, fast, bd,
                                 st.out_dev)
                      for st, _, _, a, h, w, n, fast, bd in staged]
    devmem = lambda: [me._launch(*a, dbuf.data_ptr(), h, w, n, fast, bd,
                                 dout.data_ptr())
                      for _, dbuf, dout, a, h, w, n, fast, bd in staged]
    plain_in = [(s["plane"], s["oy"], s["ox"],
                 torch.from_numpy(s["orig"]).to(dev),
                 torch.from_numpy(s["cands"]).to(dev), s["fast"],
                 s["bitdepth"]) for s in sweeps]
    plain = lambda: [me.sad_sweep_plain(*a) for a in plain_in]
    # the library yardstick: the candidates' blocks gathered beforehand
    lib_in = []
    for s, a in zip(sweeps, plain_in):
        plane, oy, ox, orig, cands, fast, bd = a
        h, w = orig.shape
        rows = torch.arange(0, h, 2 if fast else 1, device=dev)
        cols = torch.arange(w, device=dev)
        y = cands[0].long() + oy
        x = cands[1].long() + ox
        blocks = plane[(y[:, None, None] + rows[None, :, None]),
                       (x[:, None, None] + cols[None, None, :])]
        lib_in.append((orig[rows].reshape(1, -1).float(),
                       blocks.reshape(blocks.shape[0], -1).float(),
                       2.0 if fast else 1.0, bd - 8, s["sads"]))

    def library():
        return [torch.cdist(o, b, p=1)[0] * m for o, b, m, _, _ in lib_in]
    for (_, _, m, shift, sads), d in zip(lib_in, library()):
        if float(d.max()) >= 1 << 24 or not np.array_equal(
                (d.to(torch.int64) >> shift).cpu().numpy(), sads):
            raise AssertionError("torch.cdist differs from the encode's "
                                 "SADs")
    dev_ms = device_ms(torch, mapped, "sad", 3)
    dev_ms_devmem = device_ms(torch, devmem, "sad", 3)
    # the per-prefetch call, (a) and (b) in turns over every sweep
    spare = me._Staging(me.staging_bytes(64, 64, 4096, 16), 4096)
    bufs = torch.empty(spare.in_bytes, dtype=torch.uint8, device=dev)
    call_a = lambda s: me.sad_sweep(s["plane"], s["oy"], s["ox"],
                                    s["orig"], s["cands"], s["fast"],
                                    s["bitdepth"])
    call_b = lambda s: copy_staged_call(
        torch, me, s["plane"], s["oy"], s["ox"], s["orig"], s["cands"],
        s["fast"], s["bitdepth"], spare, bufs)
    for call in (call_a, call_b):
        for s in sweeps:
            if not np.array_equal(call(s), s["sads"]):
                raise AssertionError("a per-prefetch call differs from the "
                                     "encode's SADs")
    turns = {"a": [], "b": []}
    for name in "abba":
        call = call_a if name == "a" else call_b
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            for s in sweeps:
                call(s)
        turns[name].append((time.perf_counter() - t0) * 1e3 / (3 * k))
    # why a call takes longer in the encode than back to back: the same
    # calls under torch.profiler (the encode above is traced), and each
    # after 20 ms of host work (the card idles between the encode's
    # sweeps while the host searches)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in sweeps:
            call_a(s)
        traced = (time.perf_counter() - t0) * 1e3 / k
    spaced = {work: me_call_parts(torch, me, sweeps[:40], work)
              for work in (0.0, 0.02)}
    inputs = sweep_inputs(torch, sweeps)
    trees = {"this tree": dict(time_of_tree(
        torch, ROOT, "time_prefetch_calls", inputs))}
    if parent:
        trees["parent"] = dict(time_of_tree(
            torch, parent, "time_prefetch_calls", inputs))
    for tree, r in trees.items():
        if not r["equal"]:
            raise AssertionError("%s's per-prefetch call differs from the "
                                 "encode's SADs" % tree)
    in_encode = sorted(s["ms"] for s in sweeps)
    counts = [s["cands"].shape[1] for s in sweeps]
    res["me_sad"].update(
        max_abs_err=err, sweeps=k,
        shape="%s's %d device sweeps: %d-%d candidates (mean %.1f), "
        "blocks %s, %s, 8 bit, the reference's padded luma resident on "
        "the card" % (
            ME_SWEEPS_CLIP, k, min(counts), max(counts), sum(counts) / k,
            sorted({"%dx%d" % s["orig"].shape[::-1] for s in sweeps}),
            sorted({"SAD_FAST" if s["fast"] else "SAD" for s in sweeps})),
        **bound(nbytes / k, ops / k),
        ms=cuda_ms(torch, mapped, 5) / k,
        device_ms=None if dev_ms is None else dev_ms / k,
        device_staging_ms=cuda_ms(torch, devmem, 5) / k,
        device_staging_device_ms=None if dev_ms_devmem is None else
        dev_ms_devmem / k,
        plain_ms=cuda_ms(torch, plain, 3) / k,
        library_ms=cuda_ms(torch, library, 5) / k,
        per_prefetch_call=dict(
            mapped_staging_ms=turns["a"], copy_staging_ms=turns["b"],
            host_ms=sum(turns["a"]) / 2,
            in_encode_ms=dict(mean=sum(in_encode) / k,
                              median=in_encode[k // 2],
                              p90=in_encode[int(0.9 * k)]),
            traced_ms=traced,
            back_to_back_parts=spaced[0.0],
            after_host_work_parts=spaced[0.02],
            trees=trees,
            device_operations=trees["this tree"]["device_operations"]))
    for st, *_ in staged:
        st.free()
    spare.free()
    r = res["me_sad"]
    c = r["per_prefetch_call"]
    log("phase 9: me_sad on %s: kernel %.5f ms a sweep from mapped staging "
        "(device %s ms; %.5f ms with the staging in device memory, device "
        "%s ms), plain "
        "%.4f ms, torch.cdist %.4f ms, bound %.7f ms (%s; %d bytes, %d "
        "operations a sweep), bit-exact to its plain version and to the "
        "encode's SADs; the per-prefetch call over every sweep: (a) mapped "
        "staging %s ms, (b) one copy %s ms (turns a, b, b, a), in the "
        "encode %.4f ms mean (median %.4f, p90 %.4f), under torch.profiler "
        "%.4f ms; its parts (median ms) back to back %s, after 20 ms of "
        "host work %s; in child processes %s" % (
            r["shape"], r["ms"], r["device_ms"], r["device_staging_ms"],
            r["device_staging_device_ms"],
            r["plain_ms"], r["library_ms"], r["bound_ms"], r["bound_by"],
            r["bound_bytes"], r["bound_ops"],
            ["%.4f" % t for t in c["mapped_staging_ms"]],
            ["%.4f" % t for t in c["copy_staging_ms"]],
            c["in_encode_ms"]["mean"], c["in_encode_ms"]["median"],
            c["in_encode_ms"]["p90"], c["traced_ms"],
            {k: "%.4f" % v for k, v in c["back_to_back_parts"].items()},
            {k: "%.4f" % v for k, v in c["after_host_work_parts"].items()},
            {t: "%.4f ms, %s device operations" % (
                v["host_ms"], v["device_operations"])
             for t, v in trees.items()}))
    me_720p_case(torch, dev, res, parent)


def me_720p_case(torch, dev, res, parent):
    """The per-prefetch call at a real size: hd720_ld's decoded picture 0,
    padded, as the resident reference, picture 1's luma as the original;
    one DeviceSadTable prefetch per 16x16 CU of the 1280x720 picture on
    ``tz_initial_candidates((0, 0), 64)`` with the reference's routing
    (CUs whose window leaves the padded plane go to the host).  Every
    device sweep held to a CPU-device table of the same picture; host ms
    a prefetch, a device call, and in child processes the call of this
    tree and of ``parent`` on the same sweeps, with device operations."""
    import numpy as np
    from xvc_tpu_torch.codec.decoder import decode_stream
    from xvc_tpu_torch.codec.yuv import YuvPicture
    from xvc_tpu_torch.gpu import me
    from xvc_tpu_torch.ops import metrics as met
    with open(os.path.join(DATA, "bench", "hd720_ld.xvc"), "rb") as f:
        pics = decode_stream(f.read(), device=dev)[:2]
    luma = [np.frombuffer(p.bytes, np.uint8)[:1280 * 720].reshape(720, 1280)
            for p in pics]
    refs = []
    for _ in range(2):
        ref = YuvPicture(1, 1280, 720, 8)
        ref.plane_view(0)[:] = luma[0]
        ref.pad_border()
        refs.append(ref)
    orig = luma[1].astype(np.int32)
    metric = met.SampleMetric(8, met.MetricType.SAD)
    mvs = me.tz_initial_candidates((0, 0), 64)

    class Cu:
        width = height = 16

        def __init__(self, x, y):
            self.x, self.y = x, y

        def pos(self, comp):
            return self.x, self.y

    class Qp:
        distortion_weight = [1.0, 1.0, 1.0]

    cus = [(x, y) for y in range(0, 720, 16) for x in range(0, 1280, 16)]
    sweeps = []
    undo = record_sweeps(me, sweeps, set())
    try:
        me.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tabs = []
        for x, y in cus:
            t = me.DeviceSadTable(None, Cu(x, y), metric, refs[0],
                                  orig[y:y + 16, x:x + 16], dev)
            t.prefetch(Qp(), mvs)
            tabs.append(t)
        seconds = time.perf_counter() - t0
        stats = dict(me.STATS)
    finally:
        undo()
    for (x, y), t in zip(cus, tabs):
        c = me.DeviceSadTable(None, Cu(x, y), metric, refs[1],
                              orig[y:y + 16, x:x + 16], "cpu")
        c.prefetch(Qp(), mvs)
        if c.cache != t.cache:
            raise AssertionError("the 720p sweep of CU (%d, %d) differs from "
                                 "the CPU device" % (x, y))
    inputs = sweep_inputs(torch, sweeps)
    trees = {"this tree": dict(time_of_tree(
        torch, ROOT, "time_prefetch_calls", inputs))}
    if parent:
        trees["parent"] = dict(time_of_tree(
            torch, parent, "time_prefetch_calls", inputs))
    for tree, r in trees.items():
        if not r["equal"]:
            raise AssertionError("%s's per-prefetch call differs on the "
                                 "720p sweeps" % tree)
    calls = stats["device_calls"]
    row = dict(cus=len(cus), device_calls=calls,
               host_routed=stats["host_routed"],
               reference_uploads=stats["reference_uploads"],
               candidates_per_call=stats["device_candidates"] / calls,
               ms_a_prefetch=seconds * 1e3 / len(cus),
               ms_a_device_call=sum(s["ms"] for s in sweeps) / calls,
               trees=trees)
    if calls != len(sweeps) or stats["reference_uploads"] != 1:
        raise AssertionError("720p: %r" % (stats,))
    res["me_sad"]["hd720"] = row
    log("phase 9: me_sad at 720p (hd720_ld picture 1 against picture 0, "
        "one prefetch a 16x16 CU, range 64): %d of %d prefetches on the "
        "card (%d host-routed), %.1f candidates a call, %d reference "
        "upload; %.4f ms a prefetch, %.4f ms a device call; in child "
        "processes %s; every sweep equal to the CPU device" % (
            calls, len(cus), row["host_routed"],
            row["candidates_per_call"], row["reference_uploads"],
            row["ms_a_prefetch"], row["ms_a_device_call"],
            {t: "%.4f ms, %s device operations" % (
                v["host_ms"], v["device_operations"])
             for t, v in trees.items()}))


def read_hashes(path):
    """(sha256 per picture, conforming per picture) of a hash list."""
    with open(path) as f:
        rows = [line.split() for line in f if line.strip()]
    return [r[0] for r in rows], ["checksum-mismatch" not in r for r in rows]


def session_decode(data, params, threads=0):
    """Every picture of ``data`` through DecoderSession on the default
    device (the card), drained with the blocking pull."""
    from xvc_tpu_torch import api
    from xvc_tpu_torch.nal import split_nal_units
    ses = api.DecoderSession(api.DecoderParameters(threads=threads,
                                                   **params))
    pics = []
    for nal in split_nal_units(data):
        ses.decode_nal(nal)
        while (pic := ses.get_picture()) is not None:
            pics.append(pic)
    ses.flush()
    while (pic := ses.get_picture()) is not None:
        pics.append(pic)
    return pics


def check_hashes(name, pics, hashes, flags):
    got = [hashlib.sha256(p.bytes).hexdigest() for p in pics]
    if got != hashes or [p.conforming for p in pics] != flags:
        raise AssertionError(
            "%s: %d pictures, %d recorded; differing pictures %s, "
            "conformance %s recorded %s" % (
                name, len(pics), len(hashes),
                [i for i, (a, b) in enumerate(zip(got, hashes)) if a != b],
                [p.conforming for p in pics], flags))


def timed_session(torch, name, data, params, threads=0):
    """One decode through DecoderSession with the launch counts set to 0
    just before it and read just after, held to the hash list ``name``:
    (pictures, seconds, launches)."""
    from xvc_tpu_torch import kernels
    hashes, flags = read_hashes(os.path.join(DATA, "bench",
                                             name + "_dec.sha256"))
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    pics = session_decode(data, params, threads)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    check_hashes(name, pics, hashes, flags)
    return pics, dt, launches


def gop_profile_encode(multihost_gop, frames=MESH_GOP_PICTURES):
    """ra720_s3's first ``frames`` pictures at speed 3 under the GOP
    pipeline's restriction profile through ``encode_stream`` on the card,
    with ``multihost_gop`` set or not: (NAL bytes, seconds)."""
    from xvc_tpu_torch.codec.encoder import encode_stream
    from xvc_tpu_torch.codec.encoder_settings import EncoderSettings
    W, H = RA720_S3["width"], RA720_S3["height"]
    s = EncoderSettings()
    s.initialize_speed(3)
    s.explicit_restrictions = GOP_PIPELINE_PROFILE
    s.multihost_gop = multihost_gop
    yuv = make_ra720_s3()[:frames * W * H * 3 // 2]
    t0 = time.perf_counter()
    nals = encode_stream(yuv, W, H, frames, qp=RA720_S3["qp"], settings=s,
                         sub_gop_length=RA720_S3["sub_gop_length"],
                         checksum_mode=1)
    return b"".join(nals), time.perf_counter() - t0


def multihost_worker(rank, port, outdir):
    """One process of phase 13's gloo group (``chip_smoke.py
    --multihost-rank RANK PORT DIR``): the lookahead over the global mesh
    (one slot of the card a process) on ``DIR/luma.npy``, then the
    multihost_gop encode; its maps, stream and times go to DIR."""
    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    from xvc_tpu_torch import engine
    from xvc_tpu_torch.codec import picture_encoder
    from xvc_tpu_torch.gpu.lookahead import frame_intra_lookahead
    from xvc_tpu_torch.parallel import multihost
    from xvc_tpu_torch.restrictions import Restrictions
    if not multihost.init("127.0.0.1:%s" % port, 2, rank):
        raise AssertionError("no group formed")
    luma = np.load(os.path.join(outdir, "luma.npy"))
    mesh = multihost.global_mesh()
    engine.set_mesh(mesh)
    try:
        frame_intra_lookahead(luma[:64, :64], 8, Restrictions())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        maps = frame_intra_lookahead(luma, 8, Restrictions())
        torch.cuda.synchronize()
        lookahead_s = time.perf_counter() - t0
    finally:
        engine.set_mesh(None)
    np.savez(os.path.join(outdir, "maps%d.npz" % rank),
             **{str(n): maps[n] for n in maps})
    coded = []
    encode = picture_encoder.PictureEncoder.encode

    def counted(self, *args):
        coded.append(self.pic_data.poc)
        return encode(self, *args)

    picture_encoder.PictureEncoder.encode = counted
    data, encode_s = gop_profile_encode(1)
    with open(os.path.join(outdir, "gop%d.bin" % rank), "wb") as f:
        f.write(data)
    with open(os.path.join(outdir, "rank%d.json" % rank), "w") as f:
        json.dump(dict(slots=mesh.size, lookahead_seconds=lookahead_s,
                       encode_seconds=encode_s, coded_pocs=coded), f)
    # both ranks are done before either tears the group down
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def multihost_pair(torch, luma):
    """Run the two processes of the gloo group, each bounded by
    MESH_WORKER_S, while this process encodes the same pictures alone;
    returns (the ranks' results, the maps and streams, the one-process
    stream and seconds).  Every process started is ended."""
    import shutil
    import socket
    import numpy as np
    outdir = os.path.join(ROOT, "build", "multihost")
    shutil.rmtree(outdir, ignore_errors=True)
    os.makedirs(outdir)
    np.save(os.path.join(outdir, "luma.npy"), luma)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--multihost-rank",
         str(rank), port, outdir], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    try:
        single, single_s = gop_profile_encode(0)
        logs = []
        for rank, proc in enumerate(procs):
            try:
                logs.append(proc.communicate(timeout=MESH_WORKER_S)[0])
            except subprocess.TimeoutExpired:
                raise AssertionError("multihost rank %d ran past %d s"
                                     % (rank, MESH_WORKER_S))
            if proc.returncode != 0:
                raise AssertionError("multihost rank %d exited %d:\n%s" % (
                    rank, proc.returncode, logs[-1][-3000:]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ranks, maps, streams = [], [], []
    for rank in range(2):
        with open(os.path.join(outdir, "rank%d.json" % rank)) as f:
            ranks.append(json.load(f))
        with np.load(os.path.join(outdir, "maps%d.npz" % rank)) as z:
            maps.append({int(n): z[n] for n in z.files})
        with open(os.path.join(outdir, "gop%d.bin" % rank), "rb") as f:
            streams.append(f.read())
    return ranks, maps, streams, single, single_s


def phase_mesh(torch, dev, pic0, threads):
    """Phase 13: multi-device execution on the card's slots
    (parallel/mesh.py), every path through its entry points with the
    launch counts set to 0 just before and read just after: the 1280x720
    lookahead of phase 5 over MESH_SLOTS slots equal to the unsharded
    maps (one intra_satd launch a slot a size; the n = 4 step unsharded,
    sharded and one shard timed); ra720_s3 with THREADS picture threads
    pinned to MESH_SLOTS slots, its stream and reconstructions those of
    phase 10 (``threads``), ms a picture beside phase 10's; hd720_ld and
    fhd1080_ra with 4 picture threads pinned to MESH_DECODE_SLOTS slots,
    to their hash lists, in turns with unmeshed decodes, the reference
    moves between the slots and their bytes; MESH_REPLAY_STREAM's replay
    pictures through the block-sharded dispatch (a mesh, no pin), planes
    equal to the unsharded dispatch's; two processes of a gloo group:
    the lookahead over the global mesh equal to the unsharded maps, and a
    multihost_gop encode of ra720_s3's first pictures equal to the same
    settings in one process; the device bench; a trace of hd720_ld's
    first TRACE_PICTURES pictures naming the picture kernels."""
    import numpy as np
    from xvc_tpu_torch import api, engine, kernels, profiling
    from xvc_tpu_torch.codec import picture_encoder
    from xvc_tpu_torch.codec.decoder import decode_stream
    from xvc_tpu_torch.gpu import analysis, device_bench, intra_satd
    from xvc_tpu_torch.gpu import recon
    from xvc_tpu_torch.gpu.lookahead import SIZES, frame_intra_lookahead
    from xvc_tpu_torch.nal import write_nal_units
    from xvc_tpu_torch.parallel import mesh as mesh_mod
    from xvc_tpu_torch.restrictions import Restrictions
    out = {}
    H, W = 720, 1280
    luma = np.frombuffer(pic0.bytes, np.uint8, count=H * W).reshape(H, W)
    restr = Restrictions()

    def meshed(slots, fn):
        engine.set_mesh(mesh_mod.make_mesh([dev] * slots))
        try:
            return fn()
        finally:
            engine.set_mesh(None)

    def timed(fn):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, dict(kernels.LAUNCHES)

    # the lookahead
    ref, plain_s, _ = timed(lambda: frame_intra_lookahead(luma, 8, restr))
    got, mesh_s, launches = timed(lambda: meshed(
        MESH_SLOTS, lambda: frame_intra_lookahead(luma, 8, restr)))
    if sorted(got) != list(SIZES) or any(
            not np.array_equal(got[n], ref[n]) for n in SIZES):
        raise AssertionError("phase 13: the sharded lookahead's maps differ "
                             "from the unsharded")
    if launches["intra_satd"] != MESH_SLOTS * len(SIZES):
        raise AssertionError("phase 13: intra_satd launched %d times over %d "
                             "slots and %d sizes" % (launches["intra_satd"],
                                                     MESH_SLOTS, len(SIZES)))
    args = [torch.from_numpy(a).to(dev)
            for a in analysis.extract_blocks(luma, 4, 8, restr)]
    blocks = args[0].shape[0]
    per = blocks // MESH_SLOTS
    unsharded = analysis.make_intra_satd_fn(4, 8)
    mesh = mesh_mod.make_mesh([dev] * MESH_SLOTS)
    sharded = mesh_mod.make_sharded_intra_satd_fn(mesh, 4, 8)
    if not torch.equal(sharded(*args), unsharded(*args)):
        raise AssertionError("phase 13: the sharded n = 4 step differs")
    shard = [a[:per] for a in args]
    steps = dict(
        unsharded_ms=cuda_ms(torch, lambda: unsharded(*args), 5),
        sharded_ms=cuda_ms(torch, lambda: sharded(*args), 5),
        shard_ms=cuda_ms(torch, lambda: intra_satd.intra_satd(
            *shard, 4, 8, 1), 5),
        blocks=blocks, shard_blocks=per)
    steps.update({"shard_" + k: v for k, v in
                  intra_satd_bound(per, 4, 67).items()})
    steps.update({"unsharded_" + k: v for k, v in
                  intra_satd_bound(blocks, 4, 67).items()})
    del args, shard
    out["lookahead"] = dict(unsharded_ms=plain_s * 1e3, mesh_ms=mesh_s * 1e3,
                            slots=MESH_SLOTS,
                            intra_satd_launches=launches["intra_satd"],
                            step_n4=steps)
    log("phase 13: lookahead 1280x720 over %d slots of the card: maps equal "
        "the unsharded call's; %.1f ms (unsharded %.1f ms), intra_satd "
        "launches %d (%d a size); the n = 4 step (%d blocks): unsharded "
        "%.4f ms, over the slots %.4f ms, one shard of %d blocks %.4f ms "
        "(its bound %.6f ms by %s)" % (
            MESH_SLOTS, mesh_s * 1e3, plain_s * 1e3, launches["intra_satd"],
            MESH_SLOTS, blocks, steps["unsharded_ms"], steps["sharded_ms"],
            per, steps["shard_ms"], steps["shard_bound_ms"],
            steps["shard_bound_by"]))

    # the pinned encode: ra720_s3 on THREADS workers over MESH_SLOTS slots
    Wr, Hr, N = RA720_S3["width"], RA720_S3["height"], RA720_S3["frames"]
    fs = Wr * Hr * 3 // 2
    yuv = make_ra720_s3()
    pins = []
    orig_encode = picture_encoder.PictureEncoder.encode

    def pinned(self, *a):
        pins.append(engine.get_pin_device())
        return orig_encode(self, *a)

    def encode():
        ses = api.EncoderSession(ra720_s3_params(api, THREADS))
        nals = []
        for i in range(N):
            nals += ses.encode(yuv[i * fs:(i + 1) * fs])
        return nals + ses.flush(), ses.rec_pictures

    picture_encoder.PictureEncoder.encode = pinned
    try:
        (nals, rec), enc_s, launches = timed(
            lambda: meshed(MESH_SLOTS, encode))
    finally:
        picture_encoder.PictureEncoder.encode = orig_encode
    data = write_nal_units(nals)
    if hashlib.sha256(data).hexdigest() != threads["stream_sha256"] or \
            hashlib.sha256(b"".join(rec)).hexdigest() != \
            threads["rec_sha256"]:
        raise AssertionError("phase 13: ra720_s3 pinned to slots gives "
                             "another stream or reconstruction than phase 10")
    worker_pins = [p for p in pins if p is not None]
    if len({p.index for p in worker_pins}) < 2:
        raise AssertionError("phase 13: the pinned encode used slots %r"
                             % sorted({p.index for p in worker_pins}))
    for name in ENCODE_KERNELS:
        if launches[name] <= 0:
            raise AssertionError("phase 13: the pinned encode launched no "
                                 "%s" % name)
    out["pinned_encode"] = dict(
        threads=THREADS, slots=MESH_SLOTS, ms_per_picture=enc_s * 1e3 / N,
        phase10_ms_per_picture=threads["threads%d" % THREADS][
            "ms_per_picture"],
        pictures_on_workers=len(worker_pins),
        slots_used=sorted({p.index for p in worker_pins}),
        launches={k: v for k, v in launches.items() if v})
    log("phase 13: ra720_s3 on %d picture threads pinned to %d slots: the "
        "stream and reconstructions of phase 10 (%s the JAX package's); "
        "%.1f ms/picture, phase 10's unmeshed %.1f (under torch.profiler); "
        "slots used %s; launches %s" % (
            THREADS, MESH_SLOTS, "equal to" if threads["equal"]
            else "inside the carve-out of", out["pinned_encode"][
                "ms_per_picture"], out["pinned_encode"][
                "phase10_ms_per_picture"], out["pinned_encode"]["slots_used"],
            out["pinned_encode"]["launches"]))

    # the pinned decodes, in turns with unmeshed ones
    for name, nthreads in THREADED_STREAMS:
        with open(os.path.join(DATA, "bench", name + ".xvc"), "rb") as f:
            stream = f.read()
        runs = {"mesh": [], "plain": []}
        moves = []
        for kind in ("mesh", "plain", "plain", "mesh"):
            before = [profiling.counted(n)
                      for n in ("xfer.move", "xfer.move.bytes")]
            if kind == "mesh":
                pics, dt, launches = meshed(
                    MESH_DECODE_SLOTS, lambda: timed_session(
                        torch, name, stream, {}, nthreads))
                moves.append(tuple(
                    profiling.counted(n) - b for n, b in
                    zip(("xfer.move", "xfer.move.bytes"), before)))
            else:
                pics, dt, launches = timed_session(torch, name, stream, {},
                                                   nthreads)
            runs[kind].append(dt * 1e3 / len(pics))
        if not all(m > 0 for m, _ in moves):
            raise AssertionError("phase 13: %s moved no reference between "
                                 "the slots: %r" % (name, moves))
        for kernel in DECODE_KERNELS:
            if launches[kernel] <= 0:
                raise AssertionError("phase 13: %s launched no %s pinned"
                                     % (name, kernel))
        out[name + "_pinned"] = dict(
            threads=nthreads, slots=MESH_DECODE_SLOTS,
            ms_per_picture=runs["mesh"],
            unmeshed_ms_per_picture=runs["plain"],
            moves=[m for m, _ in moves], move_bytes=[b for _, b in moves])
        log("phase 13: %s with %d picture threads pinned to %d slots: %d "
            "pictures equal to its hash list; ms/picture %s, unmeshed %s (in "
            "turns); reference moves between the slots %s, bytes %s" % (
                name, nthreads, MESH_DECODE_SLOTS, len(pics), runs["mesh"],
                runs["plain"], out[name + "_pinned"]["moves"],
                out[name + "_pinned"]["move_bytes"]))

    # the block-sharded replay dispatch
    orig_half = recon.Reconstructor._device_half
    halves = []

    def twice(self, leaves, lmeta, cmeta):
        orig_half(self, leaves, lmeta, cmeta)
        want = [None if t is None else t.clone() for t in
                (self.plane_l, self.rpad_l, self.plane_c, self.rpad_c)]
        kernels.reset_launches()
        meshed(MESH_SLOTS, lambda: orig_half(self, leaves, lmeta, cmeta))
        got = (self.plane_l, self.rpad_l, self.plane_c, self.rpad_c)
        if any((w is None) != (g is None) or
               (w is not None and not torch.equal(w, g))
               for w, g in zip(want, got)):
            raise AssertionError("phase 13: the sharded dispatch of %s poc "
                                 "%d differs" % (MESH_REPLAY_STREAM,
                                                 self.pd.poc))
        halves.append((kernels.LAUNCHES["itx_picture"],
                       kernels.LAUNCHES["mc_picture"]))

    with open(os.path.join(DATA, "bench", MESH_REPLAY_STREAM + ".xvc"),
              "rb") as f:
        stream = f.read()
    recon.Reconstructor._device_half = twice
    try:
        pics = decode_stream(stream, device=dev)
    finally:
        recon.Reconstructor._device_half = orig_half
    check_hashes(MESH_REPLAY_STREAM, pics, *read_hashes(os.path.join(
        DATA, "bench", MESH_REPLAY_STREAM + "_dec.sha256")))
    if not halves or any(itx != MESH_SLOTS for itx, _ in halves):
        raise AssertionError("phase 13: itx_picture launches a sharded "
                             "dispatch: %r" % (halves,))
    out["sharded_replay"] = dict(pictures=len(halves), slots=MESH_SLOTS,
                                 launches_per_picture=halves)
    log("phase 13: %s: %d replay pictures through the block-sharded "
        "dispatch over %d slots, planes equal to the unsharded dispatch's, "
        "the decode equal to its hash list; (itx_picture, mc_picture) "
        "launches a picture %s" % (MESH_REPLAY_STREAM, len(halves),
                                   MESH_SLOTS, halves))

    # two processes of a gloo group
    ranks, maps, streams, single, single_s = multihost_pair(torch, luma)
    for rank in range(2):
        if sorted(maps[rank]) != list(SIZES) or any(
                not np.array_equal(maps[rank][n], ref[n]) for n in SIZES):
            raise AssertionError("phase 13: rank %d's lookahead over the "
                                 "global mesh differs" % rank)
        if streams[rank] != single:
            raise AssertionError("phase 13: rank %d's multihost_gop stream "
                                 "differs from the one-process encode"
                                 % rank)
    coded = [r["coded_pocs"] for r in ranks]
    if not all(coded) or sorted(coded[0] + coded[1]) != \
            list(range(MESH_GOP_PICTURES)):
        raise AssertionError("phase 13: the ranks coded pictures %r"
                             % (coded,))
    out["multihost"] = dict(
        global_slots=ranks[0]["slots"],
        lookahead_ms=[r["lookahead_seconds"] * 1e3 for r in ranks],
        encode_seconds=[r["encode_seconds"] for r in ranks],
        one_process_encode_seconds=single_s, coded_pocs=coded,
        bytes=len(single))
    log("phase 13: two processes of a gloo group on the card: the lookahead "
        "over the global mesh (%d slots) equal to the unsharded maps, %s ms "
        "a rank; a multihost_gop encode of ra720_s3's first %d pictures "
        "(speed 3, the GOP pipeline profile) %d bytes in both ranks, equal "
        "to the one-process encode; POCs coded by each rank %s; seconds %s "
        "(one process alone: %.1f s, run beside them)" % (
            ranks[0]["slots"], [round(v, 1) for v in
                                out["multihost"]["lookahead_ms"]],
            MESH_GOP_PICTURES, len(single), coded,
            [round(v, 1) for v in out["multihost"]["encode_seconds"]],
            single_s))

    # the device bench
    out["device_bench"] = dict(mc=device_bench.mc_device_bench(),
                               itx=device_bench.itx_device_bench())
    log("phase 13: device bench %s" % json.dumps(out["device_bench"]))

    # a trace of hd720_ld's first pictures
    with open(os.path.join(DATA, "bench", "hd720_ld.xvc"), "rb") as f:
        stream = f.read()
    decode_stream(stream, max_pics=TRACE_PICTURES)
    profiling.start_trace(os.path.join(ROOT, "build", "trace"))
    try:
        decode_stream(stream, max_pics=TRACE_PICTURES)
        torch.cuda.synchronize()
    finally:
        path = profiling.stop_trace()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {ev.get("name", "") for ev in events}
    found = sorted(n for n in names if "picture_kernel" in n)
    spans = sorted(n for n in names if n.startswith("decode."))
    if not any("itx_picture_kernel" in n for n in found) or \
            not any("mc_picture_kernel" in n for n in found):
        raise AssertionError("phase 13: the trace names no picture kernel: "
                             "%r" % found)
    out["trace"] = dict(events=len(events), bytes=os.path.getsize(path),
                        picture_kernels=found, spans=spans)
    log("phase 13: trace of hd720_ld's first %d pictures: %d events, %d "
        "bytes, kernels %s, spans %s" % (TRACE_PICTURES, len(events),
                                         out["trace"]["bytes"], found, spans))
    return out


def phase_resampling(torch):
    """Phase 7: the decoder paths that resample, through the default
    entry points (no device argument: the card).  The splice
    hd720_fhd1080_splice (its resample launches split into those of the
    alternative reconstruction and those of the output), the output
    resizing of RESIZED_STREAMS, each held to its hash list; then the
    threaded decodes of THREADED_STREAMS (4 workers) beside sequential
    ones in turns, held to their _dec.sha256."""
    from xvc_tpu_torch import kernels, profiling
    from xvc_tpu_torch.codec import output, picture_decoder
    from xvc_tpu_torch.codec.decoder import decode_stream
    from xvc_tpu_torch.gpu import flat_recon
    from xvc_tpu_torch.parallel import pipeline
    pipeline.WAIT_SECONDS = 120.0
    out = {}
    with open(os.path.join(DATA, "bench", SPLICE + ".xvc"), "rb") as f:
        data = f.read()
    alt = [0]
    resized = [0]
    uploaded = [0]
    generate = picture_decoder.PictureDecoder.generate_alternative_rec_pic
    convert = output.convert_to
    ensure = flat_recon._ensure_slot

    def spy(self, *args, **kw):
        before = kernels.LAUNCHES["resample"]
        made = generate(self, *args, **kw)
        alt[0] += kernels.LAUNCHES["resample"] - before
        return made

    def convert_spy(pic, fmt, *args):
        resized[0] += (fmt["width"], fmt["height"]) != (
            pic.get_display_width(0), pic.get_display_height(0))
        return convert(pic, fmt, *args)

    def ensure_spy(rec_pic, device):
        before = profiling.counted("xfer.htod")
        slot = ensure(rec_pic, device)
        uploaded[0] += profiling.counted("xfer.htod") - before
        return slot

    picture_decoder.PictureDecoder.generate_alternative_rec_pic = spy
    output.convert_to = convert_spy
    flat_recon._ensure_slot = ensure_spy
    try:
        _, _, split = timed_session(torch, SPLICE, data, {})
    finally:
        picture_decoder.PictureDecoder.generate_alternative_rec_pic = \
            generate
        output.convert_to = convert
        flat_recon._ensure_slot = ensure
    output_launches = split["resample"] - alt[0]
    # one launch a resized picture and one an alternative picture; the
    # alternative picture is written to its store slot, so no reference
    # slot is uploaded from the host
    if alt[0] != 1 or output_launches != resized[0] or uploaded[0]:
        raise AssertionError("%s: resample launched %d times for the "
                             "alternative picture, %d for the output of %d "
                             "resized pictures; %d reference uploads" % (
                                 SPLICE, alt[0], output_launches,
                                 resized[0], uploaded[0]))
    pics, dt, launches = timed_session(torch, SPLICE, data, {})
    if launches["resample"] != split["resample"] or \
            launches["itx_picture"] != len(pics):
        raise AssertionError("%s launches %r" % (SPLICE, launches))
    report, profiled_s, _ = profiling.profile_decode(data, warmup=0)
    traced_s, busy_s, ops = device_busy(torch, lambda: decode_stream(data))
    post = report.get("decode.post", {}).get("seconds", 0.0)
    out[SPLICE] = dict(
        pictures=len(pics), conforming=sum(p.conforming for p in pics),
        seconds=dt, ms_per_picture=dt * 1e3 / len(pics), launches=launches,
        resample_alternative=alt[0], resample_output=output_launches,
        profiled_seconds=profiled_s, spans=report,
        post_share=post / profiled_s, traced_decode_seconds=traced_s,
        device_busy_seconds=busy_s, device_operations=ops,
        device_idle_share=None if busy_s is None else 1 - busy_s / traced_s)
    log("phase 7: %s (1280x720, then 1920x1080 from picture 8; output at "
        "1280x720) %d pictures equal to the recorded host decode, %d "
        "conforming as recorded; %.2f ms/picture; resample launches %d "
        "(alternative picture %d, output %d); profiled %.3f s, decode.post "
        "%.3f s (%.1f%%); under torch.profiler %.3f s, device busy %s s "
        "(idle share %s); spans (s): %s" % (
            SPLICE, len(pics), out[SPLICE]["conforming"],
            out[SPLICE]["ms_per_picture"], launches["resample"], alt[0],
            output_launches, profiled_s, post, 100 * post / profiled_s,
            traced_s, busy_s, out[SPLICE]["device_idle_share"],
            {n: v["seconds"] for n, v in report.items()}))
    for name, (stream, params) in RESIZED_STREAMS.items():
        with open(os.path.join(DATA, "bench", stream + ".xvc"), "rb") as f:
            data = f.read()
        timed_session(torch, name, data, params)  # the first-use costs
        # resized and at its own size, in turns (own, resized, resized,
        # own), each held to its hash list
        runs = {name: [], stream: []}
        for key in (stream, name, name, stream):
            pics, dt, got = timed_session(torch, key, data,
                                          params if key == name else {})
            runs[key].append(dt * 1e3 / len(pics))
            if key == name:
                launches = got
                if launches["resample"] != len(pics):
                    raise AssertionError(
                        "%s: resample launched %d times for %d pictures"
                        % (name, launches["resample"], len(pics)))
        out[name] = dict(pictures=len(pics), ms_per_picture=runs[name],
                         own_size_ms_per_picture=runs[stream],
                         launches=launches)
        log("phase 7: %s: %d pictures equal to the recorded host decode, "
            "conforming; ms/picture %s, at its own size %s (in turns); "
            "resample launches %d" % (name, len(pics), runs[name],
                                      runs[stream], launches["resample"]))
    for name, threads in THREADED_STREAMS:
        with open(os.path.join(DATA, "bench", name + ".xvc"), "rb") as f:
            data = f.read()
        runs = {0: [], threads: []}
        for n in (0, threads, threads, 0):
            pics, dt, _ = timed_session(torch, name, data, {}, n)
            runs[n].append(dt * 1e3 / len(pics))
        traced_s, busy_s, _ = device_busy(
            torch, lambda: session_decode(data, {}, threads))
        out[name + "_threads"] = dict(
            pictures=len(pics), threads=threads,
            ms_per_picture=runs[threads], sequential_ms_per_picture=runs[0],
            traced_decode_seconds=traced_s, device_busy_seconds=busy_s,
            device_idle_share=None if busy_s is None
            else 1 - busy_s / traced_s)
        log("phase 7: %s with %d picture threads: %d pictures equal to its "
            "_dec.sha256 (as the sequential decodes); ms/picture %s, "
            "sequential %s (in turns, one call); threaded under "
            "torch.profiler %.3f s, device busy %s s (idle share %s)" % (
                name, threads, len(pics), runs[threads], runs[0], traced_s,
                busy_s, out[name + "_threads"]["device_idle_share"]))
    return out


def scan_statuses(torch, data, dev):
    """Decode ``data`` once with every scan launch's status words read
    back right after it (a synchronise each): per kernel, how many
    plane launches took each schedule (wavefront / decode-order tickets
    / ordered) and the largest breach flags seen; and per picture of the
    replay path (gpu/recon.py) the blocks of its host tail, in decode
    order (key ``tail_blocks``)."""
    from xvc_tpu_torch.codec.decoder import decode_stream
    from xvc_tpu_torch.gpu import intra_scan as scan
    from xvc_tpu_torch.gpu import recon
    seen = {"intra_luma": [], "intra_chroma": []}
    orig = scan.intra_scan, scan.intra_chroma_scan
    tails = []
    recon_run = recon.Reconstructor.run

    def run(self):
        out = recon_run(self)
        tails.append((self.pd.poc, recon.LAST_TAIL_BLOCKS))
        return out

    def read(name):
        torch.cuda.synchronize()
        seen[name] += scan.last_status(name).cpu().tolist()

    def luma(*a):
        orig[0](*a)
        read("intra_luma")

    def chroma(*a):
        orig[1](*a)
        read("intra_chroma")

    scan.intra_scan, scan.intra_chroma_scan = luma, chroma
    recon.Reconstructor.run = run
    try:
        decode_stream(data, device=dev)
    finally:
        scan.intra_scan, scan.intra_chroma_scan = orig
        recon.Reconstructor.run = recon_run
    out = {}
    for name, words in seen.items():
        kinds = {}
        for sched, rows, breach, warps, wave in words:
            kind = "ordered" if sched == scan.ORDERED else (
                "wavefront" if wave else "decode-order tickets")
            kinds[kind] = kinds.get(kind, 0) + 1
        out[name] = dict(planes=kinds,
                         breach=max([w[2] for w in words], default=0),
                         rows=sum(w[1] for w in words))
    out["tail_blocks"] = tails
    return out


def decode_bench(torch, dev, name, count):
    """One bench stream on the card: a decode reading the scans' status
    words, then a timed decode with the launch counts set to 0 just before
    it and read just after; every picture conforming and equal to the
    recorded host decode."""
    from xvc_tpu_torch import kernels
    from xvc_tpu_torch.codec.decoder import decode_stream
    with open(os.path.join(DATA, "bench", name + ".xvc"), "rb") as f:
        data = f.read()
    with open(os.path.join(DATA, "bench", name + "_dec.sha256")) as f:
        want = [line.split()[0] for line in f if line.strip()]
    statuses = scan_statuses(torch, data, dev)  # also the warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()  # frame stores and the like
    kernels.reset_launches()
    t0 = time.perf_counter()
    pics = decode_stream(data, device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if len(pics) != count or len(want) != count:
        raise AssertionError("%s: %d pictures decoded, %d recorded, %d "
                             "expected" % (name, len(pics), len(want), count))
    for pic, sha in zip(pics, want):
        if not pic.conforming:
            raise AssertionError("%s poc %d not conforming" % (name, pic.poc))
        if hashlib.sha256(pic.bytes).hexdigest() != sha:
            raise AssertionError("%s poc %d differs from the recorded host "
                                 "decode" % (name, pic.poc))
    for kernel in OFF_DECODE_KERNELS:
        if launches[kernel]:
            raise AssertionError("%s: the group kernel %s ran on the decode "
                                 "path" % (name, kernel))
    if launches["itx_picture"] != count:
        raise AssertionError("%s: itx_picture launched %d times for %d "
                             "pictures" % (name, launches["itx_picture"],
                                           count))
    w, h = pics[0].width, pics[0].height
    out = dict(pictures=count, width=w, height=h, bitdepth=pics[0].bitdepth,
               seconds=dt, ms_per_picture=dt * 1e3 / count,
               mpix_per_s=w * h * count / dt / 1e6,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               memory_allocated_before=resident, launches=launches,
               scan_status=statuses)
    log("phase 3: %s (%dx%d, %d bit) %d/%d conforming, equal to the "
        "recorded host decode; %.2f ms/picture, %.3f Mpix/s, peak %d bytes "
        "(%d resident before the decode), launches %s; scans: %s" % (
            name, w, h, out["bitdepth"], count, count, out["ms_per_picture"],
            out["mpix_per_s"], out["max_memory_allocated"], resident,
            launches, statuses))
    return out, pics


def phase_decode(torch, dev):
    """The bench streams; hd720_ld first, the flat path's main stream,
    then hd720_lic, the replay path's: the launches of each must cover
    every kernel of DECODE_KERNELS, and hd720_lic's inter pictures must
    all take the replay path's host tail."""
    out = {}
    for name, count in BENCH:
        out[name], pics = decode_bench(torch, dev, name, count)
        if name == "hd720_ld":
            pic0 = pics[0]
        if name == RECON_STREAM:
            tails = out[name]["scan_status"]["tail_blocks"]
            if len(tails) != count - 1 or min(t for _, t in tails) <= 0:
                raise AssertionError("%s: host tail blocks per replayed "
                                     "picture %r" % (name, tails))
        if name in ("hd720_ld", RECON_STREAM):
            for kernel in DECODE_KERNELS:
                if out[name]["launches"][kernel] <= 0:
                    raise AssertionError("kernel %s was not launched"
                                         % kernel)
            if out[name]["launches"]["mc_picture"] != count - 1:
                raise AssertionError("mc_picture launched %d times for %d "
                                     "inter pictures" % (
                                         out[name]["launches"]["mc_picture"],
                                         count - 1))
    return out, pic0


def device_busy(torch, fn):
    """torch.profiler over one call of fn (a decode or an encode): the
    seconds it took on the host's clock (profiler on), the seconds of
    device work in it (the durations of the profiler's device events,
    kernels and copies, summed) and the number of device operations; the
    last two None where the profiler recorded no device time.  The raw
    events are read directly: ``key_averages()`` counts each kernel's time
    twice (under its own name and as the self device time of the operator
    that launched it), and its parse of the 10^6 events of an encode takes
    minutes."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    busy_ns, ops = 0, 0
    for ev in prof.profiler.kineto_results.events():
        if str(ev.device_type()).endswith("CUDA"):
            busy_ns += ev.duration_ns()
            ops += 1
    return (seconds, busy_ns / 1e9, ops) if ops else (seconds, None, None)


def phase_stage_profile(torch, name):
    """Where a decode of the bench stream ``name`` goes: one decode with
    synchronising spans, and one under torch.profiler for the device's
    busy and idle share of that same decode."""
    from xvc_tpu_torch import profiling
    with open(os.path.join(DATA, "bench", name + ".xvc"), "rb") as f:
        data = f.read()
    report, profiled_s, _ = profiling.profile_decode(data, warmup=0)
    from xvc_tpu_torch.codec.decoder import decode_stream
    traced_s, busy_s, ops = device_busy(torch, lambda: decode_stream(data))
    out = dict(profiled_seconds=profiled_s, spans=report,
               traced_decode_seconds=traced_s, device_busy_seconds=busy_s,
               device_operations=ops,
               device_idle_share=None if busy_s is None
               else 1.0 - busy_s / traced_s)
    log("phase 3: %s stage profile: %.3f s with synchronising spans; under "
        "torch.profiler %.3f s, device busy %s s in %s operations (idle "
        "share %s); spans (s): %s" % (
            name, profiled_s, traced_s, busy_s, ops,
            out["device_idle_share"],
            {n: v["seconds"] for n, v in report.items()}))
    return out


def phase_goldens(dev):
    """Every golden on the card, held to its _dec.yuv and its picture
    count, and the HASHED streams to their _dec.sha256; the flat and the
    replay path both, with the launch counts of the replay path's
    kernels over all of them."""
    from xvc_tpu_torch import kernels
    from xvc_tpu_torch.codec.decoder import decode_stream
    from xvc_tpu_torch.gpu import recon
    replayed = [0]
    recon_run = recon.Reconstructor.run

    def run(self):
        replayed[0] += 1
        return recon_run(self)

    recon.Reconstructor.run = run
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        for name, count in sorted(GOLDENS.items()) + list(HASHED):
            with open(os.path.join(DATA, name + ".xvc"), "rb") as f:
                pics = decode_stream(f.read(), device=dev)
            if name in GOLDENS:
                with open(os.path.join(DATA, name + "_dec.yuv"), "rb") as f:
                    same = b"".join(p.bytes for p in pics) == f.read()
            else:
                with open(os.path.join(DATA, name + "_dec.sha256")) as f:
                    want = [line.split()[0] for line in f if line.strip()]
                same = [hashlib.sha256(p.bytes).hexdigest()
                        for p in pics] == want
            if len(pics) != count or not same or \
                    not all(p.conforming for p in pics):
                raise AssertionError("golden %s differs (%d pictures, %d "
                                     "expected)" % (name, len(pics), count))
    finally:
        recon.Reconstructor.run = recon_run
    launches = dict(kernels.LAUNCHES)
    for kernel in ("itx_picture", "mc_picture", "deblock_edges",
                   "deblock_luma", "deblock_chroma"):
        if launches[kernel] <= 0:
            raise AssertionError("kernel %s was not launched" % kernel)
    log("phase 4: %d goldens equal their _dec.yuv and %d streams their "
        "_dec.sha256, every picture conforming, in %.2f s; %d pictures on "
        "the replay path; launches %s" % (
            len(GOLDENS), len(HASHED), time.perf_counter() - t0,
            replayed[0], launches))
    return dict(goldens=len(GOLDENS), hashed=len(HASHED),
                replayed_pictures=replayed[0], launches=launches)


def phase_lookahead(torch, dev, pic):
    """The lookahead slice at full width on the luma plane of a decoded
    1280x720 8-bit picture."""
    import numpy as np
    from xvc_tpu_torch import kernels
    from xvc_tpu_torch.gpu import analysis, intra_batch, intra_satd
    from xvc_tpu_torch.gpu.lookahead import SIZES, frame_intra_lookahead
    from xvc_tpu_torch.restrictions import Restrictions
    H, W = 720, 1280
    luma = np.frombuffer(pic.bytes, np.uint8, count=H * W).reshape(H, W)
    restr = Restrictions()
    frame_intra_lookahead(luma[:64, :64], 8, restr)  # first-use costs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    kernels.reset_launches()
    t0 = time.perf_counter()
    maps = frame_intra_lookahead(luma, 8, restr, stats=stats)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for name in LOOKAHEAD_KERNELS:
        if launches[name] <= 0:
            raise AssertionError("kernel %s was not launched" % name)
    t0 = time.perf_counter()
    want = frame_intra_lookahead(luma, 8, restr, device="cpu")
    cpu_s = time.perf_counter() - t0
    if sorted(maps) != list(SIZES):
        raise AssertionError("lookahead sizes %r" % sorted(maps))
    for n in SIZES:
        if maps[n].shape != (H // n, W // n, 67) or \
                maps[n].dtype != np.int32 or \
                not np.array_equal(maps[n], want[n]) or maps[n].min() < 0:
            raise AssertionError("lookahead map n=%d differs from the CPU "
                                 "device's" % n)
    # the device step alone (the intra_satd kernel), and the batched
    # predictor the parent's step ran before its SATD, on the same inputs
    # (tensors resident, CUDA events)
    step_ms, predict_ms = {}, {}
    for n in SIZES:
        args = [torch.from_numpy(a).to(dev)
                for a in analysis.extract_blocks(luma, n, 8, restr)]
        fn = analysis.make_intra_satd_fn(n, 8)
        step_ms[n] = cuda_ms(torch, lambda: fn(*args), 5)
        weights = intra_satd.weights_on(n, 1, dev)
        predict_ms[n] = cuda_ms(torch, lambda: intra_batch.predict_all_modes(
            n, args[1], args[2], weights, 8, n <= 16), 5)
        del args
    out = dict(
        seconds=dt, launches=launches, max_memory_allocated=peak,
        extract_ms={n: stats[n]["extract_s"] * 1e3 for n in SIZES},
        device_ms={n: stats[n]["device_s"] * 1e3 for n in SIZES},
        step_ms=step_ms, predict_ms=predict_ms, blocks={n: stats[n]["blocks"] for n in SIZES},
        cpu_device_seconds=cpu_s)
    log("phase 5: lookahead 1280x720, sizes %s, 67 modes: maps equal the "
        "CPU device's; %.1f ms in all, host extraction %.1f ms, device "
        "(upload + step + download) %.1f ms, device step alone %s ms (the "
        "parent's batched predictor alone %s ms), peak %d bytes, "
        "intra_satd launches %d (the same call on the CPU device %.1f s)" % (
            list(SIZES), dt * 1e3, sum(out["extract_ms"].values()),
            sum(out["device_ms"].values()),
            {n: round(t, 3) for n, t in step_ms.items()},
            {n: round(t, 3) for n, t in predict_ms.items()}, peak,
            launches["intra_satd"], cpu_s))
    return out


def stage_device(torch, fn, iters=5):
    """torch.profiler over ``iters`` calls of fn (after one warm-up
    call): the device milliseconds and the device operations per call;
    None where the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us, ops = 0.0, 0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0)
        if t > 0:
            us += t
            ops += ev.count
    return (us / 1e3 / iters, ops / iters) if ops else (None, None)


def encode_stage_rows(torch, dev):
    """The encode path's device stages alone, at hd720_s3's shapes
    (picture 1, inter, against picture 0): the split DP's zero-MV SADs
    and its DP (PyTorch, no kernel: each call as the picture encoder
    makes it, uploads and downloads included, CUDA events; device time
    and operations per call from torch.profiler) and the SATD kernel at
    the prepass's largest shape (the fused entry, [57600, 67, 4, 4])
    beside its plain version, each with its bound."""
    import numpy as np
    from xvc_tpu_torch.gpu import intra_batch, intra_satd, satd
    from xvc_tpu_torch.gpu import txrd_prepass as tx
    from xvc_tpu_torch.gpu import wavefront_rdo as wf
    from xvc_tpu_torch.gpu.lookahead import frame_intra_lookahead
    from xvc_tpu_torch.restrictions import Restrictions
    W, H = HD720_S3["width"], HD720_S3["height"]
    fs = W * H * 3 // 2
    yuv = make_hd720_s3()
    luma = [np.frombuffer(yuv, np.uint8, count=W * H, offset=t * fs)
            .reshape(H, W) for t in (0, 1)]
    rows = {}
    sad = lambda: wf.frame_zero_mv_sad(luma[1], [luma[0]], 8,
                                       sizes=(16, 32, 64), device=dev)
    dev_ms, ops = stage_device(torch, sad)
    # orig and the reference read once (int32, as uploaded), |d|, the
    # box sums and the minimum: some 3 operations a sample; the three
    # maps written
    out_bytes = sum((H // n) * (W // n) * 4 for n in (16, 32, 64))
    rows["zero_mv_sad"] = dict(
        ms=cuda_ms(torch, sad, 10), device_ms=dev_ms, device_ops=ops,
        **bound(2 * W * H * 4 + out_bytes, 3 * W * H))
    maps = frame_intra_lookahead(luma[1], 8, Restrictions(), sizes=(16, 32),
                                 mode_step=4, device=dev)
    maps.update(frame_intra_lookahead(luma[1], 8, Restrictions(),
                                      sizes=(64,), mode_step=8, device=dev))
    sads = sad()
    # lambda_sqrt of picture 1 (an inter picture at qp 34, lambda 87.04)
    dp = lambda: wf.split_dp_from_lookahead(maps, 87.04 ** 0.5, sads,
                                            allow_force_split=False,
                                            device=dev)
    dev_ms, ops = stage_device(torch, dp)
    in_bytes = sum(m.nbytes for m in maps.values()) + \
        sum(v.nbytes for v in sads.values())
    rows["split_dp"] = dict(
        ms=cuda_ms(torch, dp, 10), device_ms=dev_ms, device_ops=ops,
        **bound(in_bytes + out_bytes // 4,
                sum(m.size for m in maps.values()) * 2))
    orig, top, left = (torch.from_numpy(a).to(dev)
                       for a in tx._extract_grid_fast(
                           np.asarray(luma[0], np.int32), 4))
    preds = intra_batch.predict_all_modes(
        4, top, left, intra_satd.weights_on(4, 1, dev), 8, True)
    rows["satd_prepass"] = dict(
        shape="fused, orig [57600, 4, 4], preds [57600, 67, 4, 4] int32",
        ms=cuda_ms(torch, lambda: satd.satd_pred(orig, preds, 8)),
        plain_ms=cuda_ms(torch, lambda: satd.satd_plain(
            orig[:, None] - preds, 8), 5),
        **bound(preds.numel() * 4 + orig.numel() * 4 +
                preds.shape[0] * 67 * 4, preds.numel() * 6))
    log("phase 6: the encode's device stages at hd720_s3's shapes: %s" % (
        {n: {k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in r.items() if k not in ("bound_bytes", "bound_ops")}
         for n, r in rows.items()}))
    return rows


def prepass_ops(torch, dev):
    """One prepass call of picture 0 of hd720_s3 on the card (after one
    warm-up call): the profiler's operator list (name -> calls, device
    ms), which must hold no aten::sort, and the dtypes every operation
    was given (a dispatch mode), of which none may be float64: no float64
    matmul or transform is left."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode
    from xvc_tpu_torch.gpu import txrd_prepass as tx
    from xvc_tpu_torch.ops.quant import Qp
    W, H = HD720_S3["width"], HD720_S3["height"]
    luma = np.frombuffer(make_hd720_s3(), np.uint8, count=W * H).reshape(H, W)
    qp = Qp(HD720_S3["qp"], 1, 8, 0.57 * 2 ** ((HD720_S3["qp"] - 12) / 3))
    call = lambda: tx.frame_txrd_prepass(luma, 8, qp, True, keep=2,
                                         device=dev)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    ops = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0)
        ops[ev.key] = dict(calls=ev.count, device_ms=round(t / 1e3, 4))
    float64 = []

    class Dtypes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            flat = list(args) + list((kwargs or {}).values())
            if any(isinstance(a, torch.Tensor) and a.dtype == torch.float64
                   for a in flat):
                float64.append(str(func))
            return func(*args, **(kwargs or {}))

    with Dtypes():
        call()
    torch.cuda.synchronize()
    sorts = [k for k in ops if "sort" in k]
    log("phase 6: one prepass call of picture 0 on the card, PyTorch "
        "operators and the hand-written kernels (calls, device ms): %s; "
        "sort operators %s, operations on float64 tensors %s" % (
            {k: (v["calls"], v["device_ms"]) for k, v in ops.items()
             if k.startswith("aten::") or "txrd" in k or "satd" in k},
            sorts, float64))
    if sorts or float64:
        raise AssertionError("the prepass still sorts or runs float64: %r "
                             "%r" % (sorts, float64))
    return dict(operators=ops, sorts=sorts, float64_ops=float64)


def phase_encode(torch, dev):
    """hd720_s3 through xvc_tpu_torch.api.EncoderSession on the card, at
    speed 3 and with the split DP alone: each stream held to the JAX
    package's (tests/data/bench/hd720_s3_enc.json; the split-DP stream
    must equal it, the speed-3 stream equal it or stay inside the
    carve-out), the prepass's candidates of each picture counted against
    hd720_s3_cands.npz and the txrd kernel against its plain version
    on every call, both streams decoded on the card to the encoder's
    reconstruction; then ms per picture with the launch counts set to 0
    just before each timed encode and read just after, the stage profile
    and the device's busy share of an encode."""
    import numpy as np
    from xvc_tpu_torch import api, kernels, profiling
    from xvc_tpu_torch.codec.decoder import decode_stream
    from xvc_tpu_torch.gpu import txrd_prepass
    from xvc_tpu_torch.nal import write_nal_units
    N = HD720_S3["frames"]
    yuv = make_hd720_s3()
    with open(os.path.join(DATA, "bench", "hd720_s3_enc.json")) as f:
        refs = json.load(f)
    with np.load(os.path.join(DATA, "bench", "hd720_s3_cands.npz")) as z:
        cands_ref = z["cands"]

    # the timed speed-3 encode is also the checked one: every txrd call
    # beside its plain version (some ms a picture of the card's time),
    # every picture's packed candidates against the JAX package's
    fn, pack = txrd_prepass.txrd, txrd_prepass.pack_intra_cands
    differ = [0]
    pictures = []

    def txrd_spy(*args):
        out = fn(*args)
        plain = txrd_prepass.txrd_plain(*args)
        differ[0] += int((out != plain).any(1).sum())
        return out

    def pack_spy(*args, **kw):
        buf = pack(*args, **kw)
        ref = cands_ref[len(pictures)]
        pictures.append(dict(
            blocks=int((ref >= 0).sum()),
            unlike_jax=int((buf != ref).sum()),
            kernel_vs_plain=differ[0]))
        differ[0] = 0
        return buf

    out = dict(prepass_pictures=pictures)
    for key, prepass in (("split_dp", False), ("speed3", True)):
        ses = hd720_s3_session(api, prepass, dev)
        if prepass:
            txrd_prepass.txrd = txrd_spy
            txrd_prepass.pack_intra_cands = pack_spy
        try:
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            nals = session_encode(ses, yuv, N)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            txrd_prepass.txrd, txrd_prepass.pack_intra_cands = fn, pack
        launches = dict(kernels.LAUNCHES)
        if prepass:
            checked = nals
            if len(pictures) != N or \
                    any(p["kernel_vs_plain"] for p in pictures):
                raise AssertionError("txrd kernel and plain version differ "
                                     "on the encode: %r" % (pictures,))
            log("phase 6: hd720_s3 prepass blocks per picture unlike the "
                "JAX package's / kernel unlike plain: %s" % (
                    ["%d / %d of %d" % (p["unlike_jax"],
                                        p["kernel_vs_plain"], p["blocks"])
                     for p in pictures]))
        data = write_nal_units(nals)
        ref = refs[key]
        psnr = [list(map(float, n.psnr)) for n in ses.nal_stats
                if n.nal_unit_type != SEGMENT_HEADER]
        row = dict(seconds=dt, ms_per_picture=dt * 1e3 / N,
                   bytes=len(data), jax_bytes=ref["bytes"],
                   equal=hashlib.sha256(data).hexdigest() == ref["sha256"],
                   psnr=psnr, launches=launches)
        # the split DP alone launches no prepass kernel (satd, txrd)
        for name in ENCODE_KERNELS if prepass else ("intra_satd",):
            if launches[name] <= 0:
                raise AssertionError("kernel %s was not launched by the %s "
                                     "encode" % (name, key))
        if not row["equal"]:
            row.update(carve_out("phase 6: " + key, nals, psnr, ref,
                                 pictures if prepass else None))
        # both streams decode on the card to the encoder's reconstruction
        pics = decode_stream(data, device=dev)
        if len(pics) != N or not all(p.conforming for p in pics) or \
                [p.bytes for p in pics] != ses.rec_pictures:
            raise AssertionError("%s stream: the card's decode differs from "
                                 "the encoder's reconstruction" % key)
        out[key] = row
        log("phase 6: %s encode of hd720_s3 (1280x720, %d pictures) on the "
            "card: %.1f ms/picture, %d bytes, %s the JAX package's stream; "
            "decoded on the card, conforming and equal to the encoder's "
            "reconstruction; launches %s" % (
                key, N, row["ms_per_picture"], len(data),
                "equal to" if row["equal"] else "unlike", {
                    n: launches[n] for n in launches if launches[n]}))

    profiling.reset()
    profiling.enable(sync=True)
    fs = HD720_S3["width"] * HD720_S3["height"] * 3 // 2
    split, seen, profiled_nals = [], {}, []
    try:
        ses = hd720_s3_session(api, True, dev)
        t0 = time.perf_counter()
        # low delay, sub-GOP 1: a picture a call
        for i in range(PROFILED_ENCODE_PICTURES):
            profiled_nals += ses.encode(yuv[i * fs:(i + 1) * fs])
            now = {n: v["seconds"] for n, v in profiling.report().items()
                   if n.startswith("encode.txrd_prepass")}
            split.append({n: round(v - seen.get(n, 0.0), 4)
                          for n, v in now.items()})
            seen = now
        profiled_nals += ses.flush()
        profiled_s = time.perf_counter() - t0
        spans = profiling.report()
    finally:
        profiling.enable(False)
        profiling.reset()
    # low delay: the first pictures' NALs do not depend on later ones
    if profiled_nals != checked[:len(profiled_nals)]:
        raise AssertionError("two speed-3 encodes on the card differ")
    traced_s, busy_s, ops = device_busy(torch, lambda: session_encode(
        hd720_s3_session(api, True, dev), yuv, PROFILED_ENCODE_PICTURES))
    out["stages"] = encode_stage_rows(torch, dev)
    out["prepass_ops"] = prepass_ops(torch, dev)
    out["stage_profile"] = dict(
        pictures=PROFILED_ENCODE_PICTURES,
        profiled_seconds=profiled_s, spans=spans, prepass_split=split,
        traced_encode_seconds=traced_s, device_busy_seconds=busy_s,
        device_operations=ops,
        device_idle_share=None if busy_s is None else 1.0 - busy_s / traced_s)
    log("phase 6: speed-3 encode stage profile of the first %d pictures: "
        "%.3f s with synchronising spans; under torch.profiler %.3f s, "
        "device busy %s s in %s operations (idle share %s); spans (s): %s"
        % (PROFILED_ENCODE_PICTURES, profiled_s, traced_s, busy_s, ops,
            out["stage_profile"]["device_idle_share"],
            {n: v["seconds"] for n, v in spans.items()}))
    log("phase 6: the prepass per picture (s, synchronising spans): %s"
        % (split,))
    return out


def carve_out(label, nals, psnr, ref, pictures):
    """A speed-3 stream unlike the JAX package's (``ref``: its bytes,
    NAL hashes and PSNR) stays inside the carve-out of the prepass's float
    arithmetic or raises: fewer than CARVE_OUT_BLOCKS of the prepass
    blocks of ``pictures`` (None: no prepass ran, no carve-out) unlike the
    JAX package's candidates, bytes within CARVE_OUT_BYTES and every
    picture's PSNR within CARVE_OUT_DB.  Returns the differences."""
    from xvc_tpu_torch.nal import write_nal_units
    size = len(write_nal_units(nals))
    dpsnr = max(abs(a - b) for p, q in zip(psnr, ref["psnr"])
                for a, b in zip(p, q))
    row = dict(max_psnr_delta_db=dpsnr, bytes_delta=size - ref["bytes"],
               nal_equal=[hashlib.sha256(n).hexdigest() == h
                          for n, h in zip(nals, ref["nal_sha256"])])
    log("%s stream differs from the JAX package's: %d bytes against %d "
        "(%+d), PSNR per picture %s against %s (largest difference %.4f "
        "dB), NALs equal %s" % (label, size, ref["bytes"],
                                row["bytes_delta"], psnr, ref["psnr"], dpsnr,
                                row["nal_equal"]))
    if pictures is None:
        raise AssertionError("%s stream unlike the JAX package's" % label)
    unlike = sum(p["unlike_jax"] for p in pictures)
    total = sum(p["blocks"] for p in pictures)
    if unlike >= CARVE_OUT_BLOCKS * total or \
            abs(row["bytes_delta"]) > CARVE_OUT_BYTES * ref["bytes"] or \
            dpsnr > CARVE_OUT_DB:
        raise AssertionError("%s stream outside its limits" % label)
    return row


def phase_python_cu(torch, dev):
    """The Python CU encoder on the card (PYTHON_CU): crops of the first
    pictures of hd720_ld as the card decodes them (their hashes checked)
    through xvc_tpu_torch.api.EncoderSession, each clip under its
    environment; each stream held to the JAX package's
    (tests/data/bench/python_cu_enc.json) and decoded on the card to the
    encoder's reconstruction; ms per picture, the launches of the encode
    (set to 0 just before it, read just after) split into the lookahead's
    and the per-CU pre-pass's intra_satd launches (no satd launch), their
    seconds (spans encode.intra_lookahead.device, encode.intra_prepass),
    ms a per-CU call, the deblock launches, and the device's idle share
    and operations under torch.profiler, of that encode or of a second
    one of the first picture (PYTHON_CU_TRACED_APART)."""
    from xvc_tpu_torch import api, kernels, profiling
    from xvc_tpu_torch.codec.decoder import decode_stream
    from xvc_tpu_torch.nal import write_nal_units
    stream, src_w, src_h = PYTHON_CU_SOURCE
    with open(os.path.join(DATA, "bench", stream + ".xvc"), "rb") as f:
        decoded = decode_stream(f.read(), device=dev)
    hashes, _ = read_hashes(os.path.join(DATA, "bench",
                                         stream + "_dec.sha256"))
    need = max(c["pictures"] for c in PYTHON_CU.values())
    if [hashlib.sha256(p.bytes).hexdigest() for p in decoded[:need]] != \
            hashes[:need]:
        raise AssertionError("%s: the card's decode differs from its hash "
                             "list" % stream)
    with open(os.path.join(DATA, "bench", "python_cu_enc.json")) as f:
        refs = json.load(f)
    out = {}
    for name, clip in PYTHON_CU.items():
        w, h, n = clip["width"], clip["height"], clip["pictures"]
        yuv = crop_pictures([p.bytes for p in decoded[:n]], src_w, src_h,
                            w, h)
        fs = w * h * 3 // 2

        def encode(pictures=n):
            ses = api.EncoderSession(python_cu_params(api, name),
                                     device=dev)
            nals = []
            for i in range(pictures):
                nals += ses.encode(yuv[i * fs:(i + 1) * fs])
            return ses, nals + ses.flush()

        saved = {k: os.environ.get(k) for k in clip["env"]}
        os.environ.update(clip["env"])
        apart = name in PYTHON_CU_TRACED_APART
        traced_pictures = 1 if apart else n
        try:
            profiling.reset()
            profiling.enable()
            torch.cuda.synchronize()
            kernels.reset_launches()
            result = []
            t0 = time.perf_counter()
            if apart:
                result.append(encode())
            else:
                traced_s, busy_s, ops = device_busy(
                    torch, lambda: result.append(encode()))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            spans = profiling.report()
            traced_calls = spans.get("encode.intra_prepass",
                                     {"calls": 0})["calls"]
            if apart:
                profiling.reset()
                traced_s, busy_s, ops = device_busy(
                    torch, lambda: encode(traced_pictures))
                traced_calls = profiling.report().get(
                    "encode.intra_prepass", {"calls": 0})["calls"]
            profiling.enable(False)
        finally:
            profiling.enable(False)
            profiling.reset()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        ses, nals = result[0]
        data = write_nal_units(nals)
        if hashlib.sha256(data).hexdigest() != refs[name]["sha256"]:
            raise AssertionError("%s: the stream differs from the JAX "
                                 "package's (%d bytes against %d)" % (
                                     name, len(data), refs[name]["bytes"]))
        for k in PYTHON_CU_KERNELS:
            if launches[k] <= 0:
                raise AssertionError("kernel %s was not launched by the %s "
                                     "encode" % (k, name))
        pics = decode_stream(data, device=dev)
        if len(pics) != n or not all(p.conforming for p in pics) or \
                [p.bytes for p in pics] != ses.rec_pictures:
            raise AssertionError("%s: the card's decode differs from the "
                                 "encoder's reconstruction" % name)

        def span_of(key):
            row = spans.get(key, {"seconds": 0.0, "calls": 0})
            return row["seconds"], row["calls"]

        pre_s, pre_calls = span_of("encode.intra_prepass")
        look_dev_s, look_calls = span_of("encode.intra_lookahead.device")
        look_s, _ = span_of("encode.intra_lookahead")
        row = dict(
            width=w, height=h, pictures=n, seconds=dt,
            ms_per_picture=dt * 1e3 / n, bytes=len(data), equal=True,
            launches={k: v for k, v in launches.items() if v},
            per_picture=dict(
                lookahead_launches=look_calls / n,
                lookahead_seconds=look_s / n,
                lookahead_device_seconds=look_dev_s / n,
                prepass_calls=pre_calls / n,
                prepass_seconds=pre_s / n,
                deblock_launches={k: launches[k] / n for k in
                                  PYTHON_CU_KERNELS[1:]}),
            prepass_ms_a_call=pre_s * 1e3 / pre_calls if pre_calls else None,
            device_operations_a_prepass_call=ops / traced_calls
            if traced_calls and ops else None,
            intra_satd_launches_unattributed=launches["intra_satd"] -
            pre_calls - look_calls,
            spans=spans, traced_apart=apart, traced_pictures=traced_pictures,
            traced_encode_seconds=traced_s,
            device_busy_seconds=busy_s, device_operations=ops,
            device_idle_share=None if busy_s is None else
            1.0 - busy_s / traced_s)
        if row["intra_satd_launches_unattributed"] or launches["satd"]:
            raise AssertionError("%s: intra_satd launches outside the "
                                 "lookahead and the per-CU pre-pass, or satd "
                                 "launches: %r" % (name, launches))
        out[name] = row
        log("phase 8: %s (%dx%d, %d picture(s), the Python CU encoder on "
            "the card): %.1f ms/picture, %d bytes equal to the JAX "
            "package's stream; decoded on the card, conforming and equal "
            "to the encoder's reconstruction; per picture: lookahead %d "
            "intra_satd launches, %.4f s (device %.4f s), per-CU pre-pass "
            "%d calls (one intra_satd launch each), %.4f s (%s ms a call, "
            "%s device operations of the traced encode a call), deblock "
            "launches %s; idle share %s (%s encode under torch.profiler: "
            "%.3f s, device busy %s s in %s operations); spans (s): %s" % (
                name, w, h, n, row["ms_per_picture"], len(data),
                look_calls / n, look_s / n, look_dev_s / n, pre_calls / n,
                pre_s / n, row["prepass_ms_a_call"],
                row["device_operations_a_prepass_call"],
                row["per_picture"]["deblock_launches"],
                row["device_idle_share"],
                "a second, of its first picture," if apart else "this",
                traced_s, busy_s, ops,
                {k: v["seconds"] for k, v in spans.items()}))
    return out


def phase_python_cu_inter(torch, dev):
    """The Python CU encoder's inter half on the card (PYTHON_CU_INTER,
    XVC_ME=jax): qcif_me from crops of the first pictures of hd720_ld as
    the card decodes them (their hashes checked), ra64x48_me from
    tests/data/ra64x48_in.yuv, through xvc_tpu_torch.api.EncoderSession;
    each stream held to the JAX package's
    (tests/data/bench/python_cu_inter.json), its TZ search's prefetches and
    device sweeps to the JAX package's counts there, me_sad's launches
    (set to 0 just before the encode, read just after) to the device
    sweeps (gpu/me.STATS), and the stream decoded on the card to the
    encoder's reconstruction.  Prints ms per picture, the prefetches per
    picture and their device and host shares, candidates per device call,
    the seconds and ms a call of the device route (span
    encode.me_prefetch), and the device's operations and idle share of the
    encode under torch.profiler.  Returns the rows and the device sweeps
    of ME_SWEEPS_CLIP's encode (``record_sweeps``), on which me_sad is
    timed."""
    from xvc_tpu_torch import api, kernels, profiling
    from xvc_tpu_torch.codec.decoder import decode_stream
    from xvc_tpu_torch.gpu import me
    from xvc_tpu_torch.nal import write_nal_units
    stream = "bench/hd720_ld.xvc"
    with open(os.path.join(DATA, stream), "rb") as f:
        decoded = decode_stream(f.read(), device=dev)
    hashes, _ = read_hashes(os.path.join(DATA, "bench",
                                         "hd720_ld_dec.sha256"))
    with open(os.path.join(DATA, "bench", "python_cu_inter.json")) as f:
        refs = json.load(f)
    out, sweeps = {}, []
    for name, clip in PYTHON_CU_INTER.items():
        w, h, n = clip["width"], clip["height"], clip["pictures"]
        fs = w * h * 3 // 2
        if clip["source"] == stream:
            if [hashlib.sha256(p.bytes).hexdigest()
                    for p in decoded[:n]] != hashes[:n]:
                raise AssertionError("hd720_ld: the card's decode differs "
                                     "from its hash list")
            yuv = crop_pictures([p.bytes for p in decoded[:n]], 1280, 720,
                                w, h)
        else:
            with open(os.path.join(DATA, clip["source"]), "rb") as f:
                yuv = f.read()[:n * fs]

        def encode():
            ses = api.EncoderSession(python_cu_inter_params(api, name),
                                     device=dev)
            nals = []
            for i in range(n):
                nals += ses.encode(yuv[i * fs:(i + 1) * fs])
            return ses, nals + ses.flush()

        saved = {k: os.environ.get(k) for k in clip["env"]}
        os.environ.update(clip["env"])
        read = set()
        undo = record_sweeps(me, sweeps if name == ME_SWEEPS_CLIP else None,
                             read)
        try:
            profiling.reset()
            profiling.enable()
            torch.cuda.synchronize()
            me.reset_stats()
            kernels.reset_launches()
            result = []
            t0 = time.perf_counter()
            traced_s, busy_s, ops = device_busy(
                torch, lambda: result.append(encode()))
            dt = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            stats = dict(me.STATS)
            spans = profiling.report()
        finally:
            undo()
            profiling.enable(False)
            profiling.reset()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        ses, nals = result[0]
        data = write_nal_units(nals)
        ref = refs[name]
        if hashlib.sha256(data).hexdigest() != ref["sha256"]:
            raise AssertionError("%s: the stream differs from the JAX "
                                 "package's (%d bytes against %d)" % (
                                     name, len(data), ref["bytes"]))
        for k in PYTHON_CU_INTER_KERNELS:
            if launches[k] <= 0:
                raise AssertionError("kernel %s was not launched by the %s "
                                     "encode" % (k, name))
        if launches["me_sad"] != stats["device_calls"] or any(
                stats[k] != v for k, v in ref["me"].items()):
            raise AssertionError(
                "%s: me_sad launches %d, device sweeps %r, the JAX "
                "package's %r" % (name, launches["me_sad"], stats,
                                  ref["me"]))
        if not 1 <= stats["reference_uploads"] <= len(read):
            raise AssertionError(
                "%s: %d reference uploads for the %d reference pictures "
                "the sweeps read" % (name, stats["reference_uploads"],
                                     len(read)))
        pics = decode_stream(data, device=dev)
        if len(pics) != n or not all(p.conforming for p in pics) or \
                [p.bytes for p in pics] != ses.rec_pictures:
            raise AssertionError("%s: the card's decode differs from the "
                                 "encoder's reconstruction" % name)
        pre = spans.get("encode.me_prefetch", {"seconds": 0.0, "calls": 0})
        upl = spans.get("encode.me_reference", {"seconds": 0.0, "calls": 0})
        calls = stats["device_calls"]
        row = dict(
            width=w, height=h, pictures=n, seconds=dt,
            ms_per_picture=dt * 1e3 / n, bytes=len(data), equal=True,
            launches={k: v for k, v in launches.items() if v},
            me=stats, prefetches_per_picture=stats["prefetches"] / n,
            device_share=calls / stats["prefetches"],
            host_routed_share=stats["host_routed"] / stats["prefetches"],
            planned_device_share=PYTHON_CU_INTER_PLANNED_DEVICE_SHARE[name],
            candidates_per_device_call=stats["device_candidates"] / calls,
            device_route_seconds=pre["seconds"],
            reference_uploads=stats["reference_uploads"],
            reference_pictures_read=len(read),
            reference_upload_seconds=upl["seconds"],
            device_route_ms_a_call=pre["seconds"] * 1e3 / pre["calls"]
            if pre["calls"] else None,
            device_operations_a_device_call=ops / calls if ops else None,
            spans=spans, traced_encode_seconds=traced_s,
            device_busy_seconds=busy_s, device_operations=ops,
            device_idle_share=None if busy_s is None else
            1.0 - busy_s / traced_s)
        out[name] = row
        log("phase 9: %s (%dx%d, %d pictures, the Python CU encoder's inter "
            "half on the card, XVC_ME=jax): %.1f ms/picture, %d bytes equal "
            "to the JAX package's stream; decoded on the card, conforming "
            "and equal to the encoder's reconstruction; %.1f prefetches a "
            "picture, %.4f of them on the device (%d me_sad launches; the "
            "plan measured %.3f), %.4f routed to the host, %.1f candidates "
            "a device call; the device route %.4f s, %s ms a call, %d "
            "reference uploads (%.4f s) for %d reference pictures read; %s "
            "device operations in the encode (%s a device call, deblock's "
            "included); idle share %s (traced encode %.3f s, device busy "
            "%s s); spans (s): %s" % (
                name, w, h, n, row["ms_per_picture"], len(data),
                row["prefetches_per_picture"], row["device_share"],
                launches["me_sad"], row["planned_device_share"],
                row["host_routed_share"],
                row["candidates_per_device_call"], pre["seconds"],
                row["device_route_ms_a_call"], stats["reference_uploads"],
                upl["seconds"], len(read), ops,
                row["device_operations_a_device_call"],
                row["device_idle_share"], traced_s, busy_s,
                {k: v["seconds"] for k, v in spans.items()}))
    return out, sweeps


def in_flight_counter(pictures=None):
    """Wrap PictureEncoder.encode to count the pictures being coded at
    once and, into ``pictures`` (a dict), each picture's POC -> (seconds
    of its encode, the POCs it predicts from); returns (the most in
    flight, a list; undo)."""
    import threading
    from xvc_tpu_torch.codec import picture_encoder
    cls = picture_encoder.PictureEncoder
    orig, lock, now, most = cls.encode, threading.Lock(), [0], [0]

    def counted(self, *args):
        rpl = self.pic_data.ref_pic_lists
        refs = sorted({rpl.get_ref_poc(lst, i) for lst in range(2)
                       for i in range(rpl.get_num_ref_pics(lst))}) \
            if rpl is not None and not self.pic_data.is_intra_pic() else []
        with lock:
            now[0] += 1
            most[0] = max(most[0], now[0])
        t0 = time.perf_counter()
        try:
            return orig(self, *args)
        finally:
            with lock:
                now[0] -= 1
            if pictures is not None:
                pictures[self.pic_data.poc] = (time.perf_counter() - t0,
                                               refs)

    cls.encode = counted
    return most, lambda: setattr(cls, "encode", orig)


def critical_path(pictures):
    """The least time picture threads could take for the encode whose
    pictures (POC -> (seconds, reference POCs), coding order) were timed
    one at a time: the longest chain of pictures, each after its
    references."""
    done = {}
    for poc, (sec, refs) in pictures.items():
        done[poc] = sec + max((done[r] for r in refs if r in done),
                              default=0.0)
    return max(done.values())


def threaded_session_check(ses, most, label):
    """The session ran its pictures on the pipeline, more than one at
    once; returns the worker count."""
    pipe = ses._enc.pipeline
    if pipe is None:
        raise AssertionError("%s: the encode fell back to the sequential "
                             "path" % label)
    if most[0] < 2:
        raise AssertionError("%s: never more than one picture in flight"
                             % label)
    return pipe.executor._max_workers


def phase_threads(torch, dev):
    """Picture-threaded encoding on the card (parallel/pipeline.py
    EncodePipeline) through xvc_tpu_torch.api.EncoderSession: ra720_s3 with
    no picture threads and with THREADS, each timed under torch.profiler
    (its idle share) with the launch counts set to 0 just before and read
    just after; the txrd kernel held to its plain version on every call of
    both, the sequential encode's prepass candidates counted against
    ra720_s3_cands.npz; the two streams and reconstructions equal byte for
    byte, the stream held to the JAX package's
    (tests/data/bench/ra720_s3_enc.json, equal or inside the carve-out),
    decoded on the card to the encoder's reconstruction; the pipeline in
    use with more than one picture in flight.  Then THREADED_INTER_CLIP
    with THREADS under XVC_ME=jax (the Python CU encoder's both halves)
    held to its sha256 and prefetch counts in python_cu_inter.json, its
    me_sad launches to its device sweeps, decoded on the card.  Then the
    apps: ``python -m xvc_tpu_torch.cli.xvcenc`` with ``-threads`` THREADS
    on the first APP_PICTURES pictures of ra720_s3 as y4m, and
    ``xvcdec -threads`` THREADS, whose output must be the app encoder's
    reconstruction."""
    import shutil
    import threading
    import numpy as np
    from xvc_tpu_torch import api, kernels
    from xvc_tpu_torch.codec.decoder import decode_stream
    from xvc_tpu_torch.gpu import me, txrd_prepass
    from xvc_tpu_torch.nal import write_nal_units
    W, H, N = RA720_S3["width"], RA720_S3["height"], RA720_S3["frames"]
    fs = W * H * 3 // 2
    yuv = make_ra720_s3()
    with open(os.path.join(DATA, "bench", "ra720_s3_enc.json")) as f:
        ref = json.load(f)
    with np.load(os.path.join(DATA, "bench", "ra720_s3_cands.npz")) as z:
        cands_ref = z["cands"]

    fn, pack = txrd_prepass.txrd, txrd_prepass.pack_intra_cands
    lock, differ, pictures = threading.Lock(), [0], []

    def txrd_spy(*args):
        out = fn(*args)
        plain = txrd_prepass.txrd_plain(*args)
        with lock:
            differ[0] += int((out != plain).any(1).sum())
        return out

    def pack_spy(*args, **kw):
        # the sequential encode's candidates, in coding order
        buf = pack(*args, **kw)
        ref_buf = cands_ref[len(pictures)]
        pictures.append(dict(blocks=int((ref_buf >= 0).sum()),
                             unlike_jax=int((buf != ref_buf).sum())))
        return buf

    out, streams = {}, {}
    for threads in (0, THREADS):
        key = "threads%d" % threads
        per_picture = {}
        most, undo = in_flight_counter(per_picture)
        txrd_prepass.txrd = txrd_spy
        if not threads:
            txrd_prepass.pack_intra_cands = pack_spy
        result = []
        try:
            ses = api.EncoderSession(ra720_s3_params(api, threads),
                                     device=dev)

            def encode():
                nals = []
                for i in range(N):
                    nals += ses.encode(yuv[i * fs:(i + 1) * fs])
                result.append(nals + ses.flush())

            kernels.reset_launches()
            traced_s, busy_s, ops = device_busy(torch, encode)
            launches = dict(kernels.LAUNCHES)
        finally:
            txrd_prepass.txrd, txrd_prepass.pack_intra_cands = fn, pack
            undo()
        nals = result[0]
        if differ[0]:
            raise AssertionError("%s: txrd and its plain version differ on "
                                 "%d blocks" % (key, differ[0]))
        for name in ENCODE_KERNELS:
            if launches[name] <= 0:
                raise AssertionError("kernel %s was not launched by the "
                                     "ra720_s3 %s encode" % (name, key))
        row = dict(threads=threads, seconds=traced_s,
                   ms_per_picture=traced_s * 1e3 / N,
                   launches={k: v for k, v in launches.items() if v},
                   most_in_flight=most[0],
                   picture_seconds={p: round(v[0], 4)
                                    for p, v in per_picture.items()},
                   device_busy_seconds=busy_s,
                   device_operations=ops,
                   device_idle_share=None if busy_s is None else
                   1.0 - busy_s / traced_s)
        if threads:
            row["workers"] = threaded_session_check(ses, most,
                                                    "ra720_s3 " + key)
        else:
            # what the threads could gain at best: the longest chain of
            # dependent pictures, timed one at a time
            row["critical_path_seconds"] = critical_path(per_picture)
            row["references"] = {p: v[1] for p, v in per_picture.items()}
        streams[threads] = (nals, ses.rec_pictures,
                            [list(map(float, n.psnr)) for n in ses.nal_stats
                             if n.nal_unit_type != SEGMENT_HEADER])
        out[key] = row
    (nals, rec, psnr), (tnals, trec, _) = streams[0], streams[THREADS]
    if tnals != nals or trec != rec or len(rec) != N:
        raise AssertionError(
            "ra720_s3: the threaded stream or reconstructions differ from "
            "the sequential: NALs equal %s, reconstructions equal %s (%d "
            "and %d)" % ([a == b for a, b in zip(tnals, nals)],
                         [a == b for a, b in zip(trec, rec)], len(trec),
                         len(rec)))
    seq, thr = out["threads0"], out["threads%d" % THREADS]
    for name in ("txrd", "intra_satd", "satd"):
        if seq["launches"][name] != thr["launches"][name]:
            raise AssertionError("ra720_s3: %s launched %d times threaded, "
                                 "%d sequential" % (
                                     name, thr["launches"][name],
                                     seq["launches"][name]))
    data = write_nal_units(nals)
    equal = hashlib.sha256(data).hexdigest() == ref["sha256"]
    out.update(bytes=len(data), jax_bytes=ref["bytes"], equal=equal,
               prepass_pictures=pictures,
               stream_sha256=hashlib.sha256(data).hexdigest(),
               rec_sha256=hashlib.sha256(b"".join(rec)).hexdigest())
    if not equal:
        out.update(carve_out("phase 10: ra720_s3", nals, psnr, ref,
                             pictures))
    elif hashlib.sha256(b"".join(rec)).hexdigest() != ref["rec_sha256"]:
        raise AssertionError("ra720_s3: the reconstructions differ from "
                             "the JAX package's")
    pics = decode_stream(data, device=dev)
    if len(pics) != N or not all(p.conforming for p in pics) or \
            [p.bytes for p in pics] != rec:
        raise AssertionError("ra720_s3: the card's decode differs from the "
                             "encoder's reconstruction")
    out["threaded_over_sequential"] = thr["seconds"] / seq["seconds"]
    out["critical_path_over_sequential"] = \
        seq["critical_path_seconds"] / seq["seconds"]
    log("phase 10: ra720_s3 (1280x720, %d pictures, random access, sub-GOP "
        "%d, speed 3) on the card: %.1f ms/picture with no picture threads, "
        "%.1f with %d workers (%.3f of the sequential time, where the "
        "longest chain of dependent pictures is %.3f of it; at most %d "
        "pictures in flight; seconds a picture by POC, sequential %s, "
        "threaded %s); the two streams and reconstructions equal, "
        "%d bytes %s the JAX package's stream (prepass blocks unlike its "
        "candidates per picture: %s); decoded on the card, conforming and "
        "equal to the reconstruction; launches sequential %s, threaded %s; "
        "idle share sequential %s, threaded %s (device busy %s / %s s)" % (
            N, RA720_S3["sub_gop_length"], seq["ms_per_picture"],
            thr["ms_per_picture"], thr["workers"],
            out["threaded_over_sequential"],
            out["critical_path_over_sequential"], thr["most_in_flight"],
            seq["picture_seconds"], thr["picture_seconds"],
            len(data), "equal to" if equal else "unlike",
            ["%d of %d" % (p["unlike_jax"], p["blocks"]) for p in pictures],
            seq["launches"], thr["launches"], seq["device_idle_share"],
            thr["device_idle_share"], seq["device_busy_seconds"],
            thr["device_busy_seconds"]))

    # the Python CU encoder's both halves on picture threads
    name = THREADED_INTER_CLIP
    clip = PYTHON_CU_INTER[name]
    w, h, n = clip["width"], clip["height"], clip["pictures"]
    cfs = w * h * 3 // 2
    with open(os.path.join(DATA, clip["source"]), "rb") as f:
        cyuv = f.read()[:n * cfs]
    with open(os.path.join(DATA, "bench", "python_cu_inter.json")) as f:
        iref = json.load(f)[name]
    saved = {k: os.environ.get(k) for k in clip["env"]}
    os.environ.update(clip["env"])
    most, undo = in_flight_counter()
    try:
        ses = api.EncoderSession(python_cu_inter_params(api, name, THREADS),
                                 device=dev)
        torch.cuda.synchronize()
        me.reset_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        nals = []
        for i in range(n):
            nals += ses.encode(cyuv[i * cfs:(i + 1) * cfs])
        nals += ses.flush()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches, stats = dict(kernels.LAUNCHES), dict(me.STATS)
    finally:
        undo()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    workers = threaded_session_check(ses, most, name)
    data = write_nal_units(nals)
    if hashlib.sha256(data).hexdigest() != iref["sha256"]:
        raise AssertionError("%s with %d threads: the stream differs from "
                             "the JAX package's" % (name, THREADS))
    if launches["me_sad"] != stats["device_calls"] or any(
            stats[k] != v for k, v in iref["me"].items()):
        raise AssertionError("%s with %d threads: me_sad launches %d, "
                             "device sweeps %r, the JAX package's %r" % (
                                 name, THREADS, launches["me_sad"], stats,
                                 iref["me"]))
    pics = decode_stream(data, device=dev)
    if len(pics) != n or not all(p.conforming for p in pics) or \
            [p.bytes for p in pics][:len(ses.rec_pictures)] != \
            ses.rec_pictures or not ses.rec_pictures:
        raise AssertionError("%s with %d threads: the card's decode differs "
                             "from the encoder's reconstruction" % (
                                 name, THREADS))
    out[name] = dict(threads=THREADS, workers=workers, seconds=dt,
                     ms_per_picture=dt * 1e3 / n, most_in_flight=most[0],
                     me=stats, launches={k: v for k, v in launches.items()
                                         if v})
    log("phase 10: %s with %d workers (XVC_ME=jax, the Python CU encoder): "
        "%.1f ms/picture, at most %d pictures in flight, the JAX package's "
        "stream and prefetch counts (%d prefetches, %d device sweeps = "
        "me_sad launches, summed over the workers); decoded on the card" % (
            name, workers, out[name]["ms_per_picture"], most[0],
            stats["prefetches"], stats["device_calls"]))

    # the apps, as a user runs them, on the first pictures as y4m
    work = os.path.join(ROOT, "build", "phase10_apps")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        src, bs, rec_path, dec = (os.path.join(work, f) for f in (
            "in.y4m", "out.xvc", "rec.yuv", "dec.yuv"))
        with open(src, "wb") as f:
            f.write(b"YUV4MPEG2 W%d H%d F60:1 Ip C420 \n" % (W, H))
            for i in range(APP_PICTURES):
                f.write(b"FRAME\n" + yuv[i * fs:(i + 1) * fs])
        runs = {}
        for app, args in (
                ("xvcenc", ["-input-file", src, "-output-file", bs,
                            "-rec-file", rec_path, "-qp", "32",
                            "-speed-mode", "3", "-sub-gop-length",
                            str(RA720_S3["sub_gop_length"]),
                            "-checksum-mode", "1", "-threads",
                            str(THREADS)]),
                ("xvcdec", ["-bitstream-file", bs, "-output-file", dec,
                            "-threads", str(THREADS)])):
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", "xvc_tpu_torch.cli." + app] + args,
                capture_output=True, text=True, timeout=600, cwd=ROOT)
            runs[app] = time.perf_counter() - t0
            if res.returncode != 0:
                raise AssertionError("%s exited with %d: %s" % (
                    app, res.returncode, res.stderr[-2000:]))
            runs[app + "_report"] = (res.stdout + res.stderr).strip()
        with open(rec_path, "rb") as f1, open(dec, "rb") as f2:
            rec_bytes, dec_bytes = f1.read(), f2.read()
        app_bytes = os.path.getsize(bs)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if rec_bytes != dec_bytes or len(rec_bytes) != APP_PICTURES * fs:
        raise AssertionError("the apps: xvcdec's output differs from "
                             "xvcenc's reconstruction")
    out["apps"] = dict(pictures=APP_PICTURES, bytes=app_bytes,
                       xvcenc_seconds=runs["xvcenc"],
                       xvcdec_seconds=runs["xvcdec"])
    log("phase 10: xvcenc -threads %d on the first %d pictures of ra720_s3 "
        "as y4m (%d bytes, %.1f s with the process start) and xvcdec "
        "-threads %d (%.1f s): the decode equals the encoder's "
        "reconstruction; xvcenc says %r" % (
            THREADS, APP_PICTURES, app_bytes, runs["xvcenc"], THREADS,
            runs["xvcdec"], runs["xvcenc_report"]))
    return out


def decode_tiles(torch, dev, name, flat):
    """A tile stream through DecoderSession on the card: a decode that
    records the pictures the replay path took (none where ``flat``, some
    otherwise), then a timed one held to its hash list, the picture
    kernels launched and the group kernels not."""
    with open(os.path.join(DATA, "bench", name + ".xvc"), "rb") as f:
        data = f.read()
    count = TILE_STREAMS[name]
    statuses = scan_statuses(torch, data, dev)  # also the warm-up
    tails = statuses["tail_blocks"]
    if bool(tails) == flat:
        raise AssertionError("%s: the pictures the replay path took %r" % (
            name, tails))
    pics, dt, launches = timed_session(torch, name, data, {})
    kernels_run = DECODE_KERNELS if flat else ("itx_picture", "mc_picture")
    if len(pics) != count or any(launches[k] <= 0 for k in kernels_run) \
            or any(launches[k] for k in OFF_DECODE_KERNELS) or \
            launches["itx_picture"] != count:
        raise AssertionError("%s: %d pictures, launches %r" % (
            name, len(pics), launches))
    return data, pics, dt, launches, statuses


def phase_tiles(torch, dev):
    """CTU tile rows on the card: hd720_tiles4 on the flat path (hash
    list, kernels, no replayed picture), in turns with hd720_ld, its stage
    profile with the tiles parsed, its idle share, with 4 picture threads;
    tiles64x128_lic on the replay path; qcif_tiles through the Python CU
    encoder, held to the JAX package's stream, reconstruction and counts
    (tests/data/bench/python_cu_tiles.json) and decoded back."""
    from xvc_tpu_torch import api, kernels, profiling
    from xvc_tpu_torch.codec.decoder import decode_stream
    from xvc_tpu_torch.gpu import me
    from xvc_tpu_torch.native import pic as native_pic
    from xvc_tpu_torch.nal import write_nal_units
    out = {}
    data, pics, dt, launches, statuses = decode_tiles(torch, dev,
                                                      TILES_STREAM, True)
    n = len(pics)
    with open(os.path.join(DATA, "bench", "hd720_ld.xvc"), "rb") as f:
        ld = f.read()
    turns = {TILES_STREAM: [], "hd720_ld": []}
    for _ in range(TILES_TURNS):
        for name, d, count in ((TILES_STREAM, data, n), ("hd720_ld", ld, 8)):
            _, s, _ = timed_session(torch, name, d, {})
            turns[name].append(s * 1e3 / count)
    tiles = []
    real_parse = native_pic.parse_picture

    def parse(pic_decoder, *args, **kw):
        ok = real_parse(pic_decoder, *args, **kw)
        tiles.append(pic_decoder.pic_data.tile_rows)
        return ok

    native_pic.parse_picture = parse
    try:
        report, profiled_s, _ = profiling.profile_decode(data, warmup=0)
    finally:
        native_pic.parse_picture = real_parse
    traced_s, busy_s, ops = device_busy(torch, lambda: decode_stream(data))
    tpics, tdt, tlaunches = timed_session(torch, TILES_STREAM, data, {},
                                          threads=THREADS)
    if [p.bytes for p in tpics] != [p.bytes for p in pics]:
        raise AssertionError("%s: the threaded decode differs from the "
                             "sequential one" % TILES_STREAM)
    parse_span = report["decode.parse"]
    out[TILES_STREAM] = dict(
        pictures=n, seconds=dt, ms_per_picture=dt * 1e3 / n,
        launches=launches, scan_status=statuses,
        ms_per_picture_in_turns=turns, tiles_parsed=sum(tiles),
        tiles_per_picture=tiles, parse_seconds=parse_span["seconds"],
        parse_calls=parse_span["calls"], profiled_seconds=profiled_s,
        spans=report, traced_decode_seconds=traced_s,
        device_busy_seconds=busy_s, device_operations=ops,
        device_idle_share=None if busy_s is None else 1.0 - busy_s / traced_s,
        threaded_ms_per_picture=tdt * 1e3 / n, threaded_launches=tlaunches)
    row = out[TILES_STREAM]
    log("phase 11: %s (1280x720, %d pictures, %s tiles a picture) on the "
        "flat path, no replayed picture (0 host tail blocks), conforming "
        "and equal to its hash list; %.2f ms/picture; in turns %s ms/picture "
        "against hd720_ld %s; launches %s; scans %s; decode.parse %.4f s in "
        "%d calls, %d tiles parsed; idle share %s (traced %.3f s, busy %s s, "
        "%s operations); 4 threads %.2f ms/picture, equal to the sequential "
        "decode; spans (s): %s" % (
            TILES_STREAM, n, tiles, row["ms_per_picture"],
            turns[TILES_STREAM], turns["hd720_ld"], launches,
            {k: v for k, v in statuses.items() if k != "tail_blocks"},
            parse_span["seconds"], parse_span["calls"], sum(tiles),
            row["device_idle_share"], traced_s, busy_s, ops,
            row["threaded_ms_per_picture"],
            {k: v["seconds"] for k, v in report.items()}))
    _, rpics, rdt, rlaunches, rstat = decode_tiles(
        torch, dev, TILES_REPLAY_STREAM, False)
    out[TILES_REPLAY_STREAM] = dict(
        pictures=len(rpics), ms_per_picture=rdt * 1e3 / len(rpics),
        launches=rlaunches, tail_blocks=rstat["tail_blocks"])
    log("phase 11: %s (64x128, 2 tiles, LIC on) conforming and equal to its "
        "hash list; replayed pictures and their host tail blocks %r; "
        "launches %s" % (TILES_REPLAY_STREAM, rstat["tail_blocks"],
                         rlaunches))

    name = "qcif_tiles"
    clip = PYTHON_CU_TILES[name]
    w, h, count = clip["width"], clip["height"], clip["pictures"]
    hashes, _ = read_hashes(os.path.join(DATA, "bench",
                                         "hd720_ld_dec.sha256"))
    decoded = decode_stream(ld, device=dev)[:count]
    if [hashlib.sha256(p.bytes).hexdigest() for p in decoded] != \
            hashes[:count]:
        raise AssertionError("hd720_ld: the card's decode differs from its "
                             "hash list")
    yuv = crop_pictures([p.bytes for p in decoded], 1280, 720, w, h)
    with open(os.path.join(DATA, "bench", "python_cu_tiles.json")) as f:
        ref = json.load(f)[name]
    fs = w * h * 3 // 2
    saved = {k: os.environ.get(k) for k in clip["env"]}
    os.environ.update(clip["env"])
    try:
        torch.cuda.synchronize()
        me.reset_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        ses = api.EncoderSession(python_cu_tiles_params(api), device=dev)
        nals = []
        for i in range(count):
            nals += ses.encode(yuv[i * fs:(i + 1) * fs])
        nals += ses.flush()
        torch.cuda.synchronize()
        edt = time.perf_counter() - t0
        elaunches = dict(kernels.LAUNCHES)
        stats = dict(me.STATS)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    stream = write_nal_units(nals)
    rec = hashlib.sha256(b"".join(ses.rec_pictures)).hexdigest()
    if hashlib.sha256(stream).hexdigest() != ref["sha256"] or \
            rec != ref["rec_sha256"]:
        raise AssertionError("%s: the stream or the reconstruction differs "
                             "from the JAX package's (%d bytes against %d)"
                             % (name, len(stream), ref["bytes"]))
    if any(elaunches[k] <= 0 for k in PYTHON_CU_TILES_KERNELS) or \
            elaunches["me_sad"] != stats["device_calls"] or \
            any(stats[k] != v for k, v in ref["me"].items()):
        raise AssertionError("%s: launches %r, device sweeps %r, the JAX "
                             "package's %r" % (name, elaunches, stats,
                                               ref["me"]))
    back = decode_stream(stream, device=dev)
    if len(back) != count or not all(p.conforming for p in back) or \
            [p.bytes for p in back] != ses.rec_pictures:
        raise AssertionError("%s: the card's decode differs from the "
                             "encoder's reconstruction" % name)
    out[name] = dict(width=w, height=h, pictures=count, seconds=edt,
                     ms_per_picture=edt * 1e3 / count, bytes=len(stream),
                     equal=True,
                     launches={k: v for k, v in elaunches.items() if v},
                     me=stats)
    log("phase 11: %s (%dx%d, %d pictures, 3 tiles, the Python CU encoder, "
        "XVC_ME=jax and XVC_INTRA_PREPASS=jax): %.1f ms/picture, %d bytes "
        "and the reconstruction equal to the JAX package's; decoded on the "
        "card, conforming and equal to the reconstruction; launches %s; "
        "prefetches and device sweeps %s" % (
            name, w, h, count, out[name]["ms_per_picture"], len(stream),
            out[name]["launches"], stats))
    return out


def b15_kernel_rows(torch, dev, data, launches):
    """The kernels of the 15-bit decode path against their plain versions
    at 15 bit: the picture kernels on every picture of ``data`` (parsed on
    the CPU by the Python parse) and on synthetic 15-bit tables
    (flat_cases.b15_picture: DC-only blocks, 32x32 transform skip;
    synthetic_picture at 15 bit: the full int16 levels, whose dequant
    product takes 64 bits); the deblock kernels and the scans on what the
    decode of ``data`` on the card gave them (the scans of picture 0, the
    edges and planes of pictures 0 and 1) and on synthetic 15-bit cases.
    Each timed on the real inputs beside its plain version and its bound.
    Returns {kernel: row}."""
    import numpy as np
    from xvc_tpu_torch.gpu import deblock, flat_cases, itx, mc
    from xvc_tpu_torch.gpu import deblock_cases as dcases
    from xvc_tpu_torch.gpu import intra_scan as scan
    from xvc_tpu_torch.gpu import scan_cases as scases
    T = lambda a: torch.from_numpy(np.array(a)).to(dev)  # a copy
    err = dict.fromkeys(B15_KERNELS, 0)

    def same(kernel, got, want, what):
        torch.cuda.synchronize()
        e = max_err(torch, got, want)
        err[kernel] = max(err[kernel], e)
        if e:
            raise AssertionError("%s at 15 bit differs from its plain "
                                 "version by %d: %s" % (kernel, e, what))

    real = flat_cases.parse_pictures(data, set(range(B15_PICTURES)))
    tables = list(real.values()) + \
        [flat_cases.b15_picture(s) for s in (3, 4, 5, 6)] + \
        [flat_cases.synthetic_picture(s, bitdepth=15) for s in (3, 4)]
    for n, pic in enumerate(tables):
        a, a2 = flat_cases.itx_args(pic, dev), flat_cases.itx_args(pic, dev)
        itx.itx_picture(*a)
        itx.itx_picture_plain(*a2)
        for g, w in zip(a[:2], a2[:2]):
            same("itx_picture", g, w, "table %d" % n)
        if pic["inter"]:
            b, b2 = (flat_cases.mc_args(pic, dev, 11) for _ in (0, 1))
            mc.mc_picture(*b)
            mc.mc_picture_plain(*b2)
            for g, w in zip(b[:4], b2[:4]):
                if g is not None:
                    same("mc_picture", g, w, "table %d" % n)
    per = {"itx_picture": [], "mc_picture": []}
    for n, pic in sorted(real.items()):
        a = flat_cases.itx_args(pic, dev)
        ib = itx_picture_bound(pic)
        per["itx_picture"].append(dict(
            bytes=ib["nbytes"], operations=ib["ops"],
            ms=cuda_ms(torch, lambda: itx.itx_picture(*a)),
            plain_ms=cuda_ms(torch, lambda: itx.itx_picture_plain(*a), 2)))
        if pic["inter"]:
            b = flat_cases.mc_args(pic, dev, 11)
            mb = mc_picture_bound(pic)
            per["mc_picture"].append(dict(
                bytes=mb["nbytes"], operations=mb["ops"],
                ms=cuda_ms(torch, lambda: mc.mc_picture(*b)),
                plain_ms=cuda_ms(torch, lambda: mc.mc_picture_plain(*b), 2)))
    rows = {}
    for kernel, rs in per.items():
        mean = lambda key: sum(r[key] for r in rs) / len(rs)  # noqa: E731
        rows[kernel] = dict(bound(mean("bytes"), mean("operations")),
                            ms=mean("ms"), plain_ms=mean("plain_ms"),
                            shape="%s, the mean over its %d %spictures" % (
                                B15_STREAM, len(rs), "inter "
                                if kernel == "mc_picture" else ""))

    got = capture_inputs(data, scan_pictures=(0,))
    # the scans: synthetic 15-bit cases, then picture 0
    for kind in ("luma", "chroma"):
        name = "intra_" + kind
        cs = [scases.corner_case(kind, 15), scases.tiled_case(kind, 15)]
        for c in cs:
            luma = None if c["luma"] is None else T(c["luma"])
            args = (T(c["resi"]), T(c["meta"]), 15) if kind == "luma" else \
                (T(c["resi"]), luma, T(c["meta"]), 15)
            plane = T(c["plane"])
            fn, plain = (scan.intra_scan, scan.intra_scan_plain) \
                if kind == "luma" else (scan.intra_chroma_scan,
                                        scan.intra_chroma_scan_plain)
            same(name, fn(plane.clone(), *args), plain(plane.clone(), *args),
                 "synthetic %s" % kind)
        calls = got["scans"][0][kind]
        plane, args = calls[0], calls[1:]
        fn(plane.clone(), *args)
        _, _, steps, _ = scan_schedule(torch, scan, kind,
                                       args[-2].cpu().numpy(),
                                       tuple(plane.shape))
        same(name, fn(plane.clone(), *args), plain(plane.clone(), *args),
             "%s picture 0" % B15_STREAM)
        rows[name] = dict(
            scan_bound(kind, args[-2].cpu().numpy(), steps),
            ms=cuda_ms(torch, lambda q: fn(q, *args), 3, fresh=plane.clone),
            plain_ms=cuda_ms(torch, lambda q: plain(q, *args), 1,
                             fresh=plane.clone),
            shape="%s picture 0: %d rows" % (B15_STREAM, len(args[-2])))
    scan._DEV.clear()

    # the deblock kernels: edges of pictures 0 and 1, the passes on
    # synthetic 15-bit cases and on picture 0's planes
    derived = []
    for n, pic in enumerate(got["pictures"]):
        if pic is None or pic["bitdepth"] != 15:
            raise AssertionError("no 15-bit deblock inputs of picture %d"
                                 % n)
        for args in pic["edges"]:
            g = deblock.edge_params(*args)
            for x, y in zip(g, deblock.edge_params_plain(*args)):
                same("deblock_edges", x, y, "picture %d" % n)
            if n == 0:
                derived.append((args[2], g[1]))
    for kind in dcases.LUMA_KINDS:
        for direction in (0, 1):
            case = dcases.luma_case(kind, 15, direction, SEED, (200, 328))
            outs = []
            for fn in (deblock.luma_pass, deblock.luma_pass_plain):
                pl, *a = [T(x) for x in case]
                fn(pl, *a, 15, (False,) * 5, direction)
                outs.append(pl)
            same("deblock_luma", outs[0], outs[1], (kind, direction))
    for direction in (0, 1):
        case = dcases.chroma_case(15, direction, SEED, (360, 640))
        outs = []
        for fn in (deblock.chroma_pass, deblock.chroma_pass_plain):
            pl, *a = [T(x) for x in case]
            fn(pl, *a, 15, direction)
            outs.append(pl)
        same("deblock_chroma", outs[0], outs[1], direction)
    pic0 = got["pictures"][0]
    attrs0, n0, lay0 = pic0["edges"][0][:3]
    rest0 = pic0["edges"][0][3:]
    map0, params0 = deblock.edge_params(attrs0, n0, lay0, *rest0)
    rows["deblock_edges"] = dict(
        edges_bound(*(t.cpu().numpy() for t in (attrs0, map0, params0))),
        ms=cuda_ms(torch, lambda: deblock.edge_params(attrs0, n0, lay0,
                                                      *rest0)),
        plain_ms=cuda_ms(torch, lambda: deblock.edge_params_plain(
            attrs0, n0, lay0, *rest0), 2),
        shape="%s picture 0, primary tree: %d CUs" % (B15_STREAM, n0))
    lay_l, par_l = derived[0]
    flags = pic0["flags"]
    src = pic0["planes"][0]
    xs, mask, tc, beta = deblock.luma_tensors(par_l, lay_l, 0)
    g = src.clone()
    deblock.luma_filter(g, par_l, lay_l, 0, 15, flags)
    w = src.clone()
    deblock.luma_pass_plain(w, xs, mask, tc, beta, 15, flags, 0)
    same("deblock_luma", g, w, "picture 0")
    rows["deblock_luma"] = dict(
        luma_deblock_bound(src.cpu().numpy(), mask.cpu().numpy(),
                           lay_l.nx[0] * lay_l.ny[0] * 4),
        ms=cuda_ms(torch, lambda q: deblock.luma_filter(
            q, par_l, lay_l, 0, 15, flags), fresh=src.clone),
        plain_ms=cuda_ms(torch, lambda q: deblock.luma_pass_plain(
            q, xs, mask, tc, beta, 15, flags, 0), 1, fresh=src.clone),
        shape="%s picture 0, across columns" % B15_STREAM)
    lay_c, par_c = derived[-1]
    uv = [pic0["planes"][1], pic0["planes"][2]]
    edges, apply, ctc = deblock.chroma_tensors(par_c, lay_c, 0)
    g = [q.clone() for q in uv]
    deblock.chroma_filter(g, par_c, lay_c, 0, 15)
    for c in (0, 1):
        w = uv[c].clone()
        deblock.chroma_pass_plain(w, edges, apply, ctc, 15, 0)
        same("deblock_chroma", g[c], w, "picture 0 plane %d" % (c + 1))
    rows["deblock_chroma"] = dict(
        chroma_deblock_bound([q.cpu().numpy() for q in uv],
                             apply.cpu().numpy(),
                             lay_c.nce[0] * lay_c.ny[0] * 4),
        ms=cuda_ms(torch, lambda qs: deblock.chroma_filter(
            qs, par_c, lay_c, 0, 15), fresh=lambda: [q.clone() for q in uv]),
        plain_ms=cuda_ms(torch, lambda qs: [deblock.chroma_pass_plain(
            q, edges, apply, ctc, 15, 0) for q in qs], 1,
            fresh=lambda: [q.clone() for q in uv]),
        shape="%s picture 0, U and V across columns" % B15_STREAM)
    for kernel, row in rows.items():
        row.update(max_abs_err=err[kernel], launches=launches[kernel])
    return rows


def phase_b15(torch, dev):
    """Bit depth 15 and the Python parse on the card: hd720_b15 through
    DecoderSession, every picture through the Python parse and the replay
    path, conforming and equal to its hash list, the kernels of the path
    launched and the group kernels not, its stage profile and idle share;
    the first PYTHON_PARSE_PICTURES pictures of hd720_ld with the native
    parse switched off (XVC_PIC_NATIVE=0) in turns with the native route,
    both equal to its hash list; then the kernels at 15 bit
    (``b15_kernel_rows``)."""
    from xvc_tpu_torch import profiling
    from xvc_tpu_torch.codec import picture_decoder
    from xvc_tpu_torch.codec.decoder import decode_stream
    from xvc_tpu_torch.native import pic as native_pic
    out = {}
    with open(os.path.join(DATA, "bench", B15_STREAM + ".xvc"), "rb") as f:
        data = f.read()
    routes = {"python": 0, "native": 0}
    real_python = picture_decoder.PictureDecoder._python_parse
    real_native = native_pic.parse_picture

    def python(self, *args):
        routes["python"] += 1
        return real_python(self, *args)

    def native(*args, **kw):
        routes["native"] += 1
        return real_native(*args, **kw)

    picture_decoder.PictureDecoder._python_parse = python
    native_pic.parse_picture = native
    try:
        decode_stream(data)  # the warm-up
        pics, dt, launches = timed_session(torch, B15_STREAM, data, {})
    finally:
        picture_decoder.PictureDecoder._python_parse = real_python
        native_pic.parse_picture = real_native
    n = len(pics)
    if routes != {"python": 2 * n, "native": 0} or n != B15_PICTURES or \
            launches["itx_picture"] != n or \
            any(launches[k] <= 0 for k in B15_KERNELS) or \
            any(launches[k] for k in OFF_DECODE_KERNELS):
        raise AssertionError("%s: %d pictures, parses %r, launches %r" % (
            B15_STREAM, n, routes, launches))
    report, profiled_s, _ = profiling.profile_decode(data, warmup=0)
    traced_s, busy_s, ops = device_busy(torch, lambda: decode_stream(data))
    spans = {k: v for k, v in report.items()
             if k.startswith(("decode.", "recon.", "deblock."))}
    out[B15_STREAM] = dict(
        pictures=n, seconds=dt, ms_per_picture=dt * 1e3 / n,
        launches={k: v for k, v in launches.items() if v}, spans=spans,
        profiled_seconds=profiled_s, traced_decode_seconds=traced_s,
        device_busy_seconds=busy_s, device_operations=ops,
        device_idle_share=None if busy_s is None else 1.0 - busy_s / traced_s)
    log("phase 12: %s (1280x720, 15 bit, %d pictures) through the Python "
        "parse and the replay path, conforming and equal to its hash list: "
        "%.2f ms/picture; launches %s; idle share %s (traced %.3f s, busy "
        "%s s, %s operations); spans (s, calls): %s" % (
            B15_STREAM, n, out[B15_STREAM]["ms_per_picture"],
            out[B15_STREAM]["launches"],
            out[B15_STREAM]["device_idle_share"], traced_s, busy_s, ops,
            {k: (round(v["seconds"], 4), v["calls"])
             for k, v in spans.items()}))

    with open(os.path.join(DATA, "bench", "hd720_ld.xvc"), "rb") as f:
        ld = f.read()
    hashes, _ = read_hashes(os.path.join(DATA, "bench",
                                         "hd720_ld_dec.sha256"))
    count = PYTHON_PARSE_PICTURES
    turns = {"native": [], "python": []}
    saved = os.environ.get("XVC_PIC_NATIVE")
    try:
        for _ in range(B15_TURNS):
            for route in ("native", "python"):
                os.environ["XVC_PIC_NATIVE"] = "0" if route == "python" \
                    else "1"
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = decode_stream(ld, max_pics=count)
                torch.cuda.synchronize()
                turns[route].append((time.perf_counter() - t0) * 1e3 / count)
                if [hashlib.sha256(p.bytes).hexdigest() for p in got] != \
                        hashes[:count] or not all(p.conforming for p in got):
                    raise AssertionError("hd720_ld through the %s parse "
                                         "differs from its hash list" % route)
    finally:
        if saved is None:
            os.environ.pop("XVC_PIC_NATIVE", None)
        else:
            os.environ["XVC_PIC_NATIVE"] = saved
    out["hd720_ld_python_parse"] = dict(pictures=count,
                                        ms_per_picture_in_turns=turns)
    log("phase 12: hd720_ld pictures 0-%d with XVC_PIC_NATIVE=0 equal to the "
        "native route and its hash list; ms/picture in turns: Python parse "
        "%s, native parse %s" % (count - 1, turns["python"],
                                 turns["native"]))

    rows = b15_kernel_rows(torch, dev, data, launches)
    out["kernels"] = rows
    for kernel, r in rows.items():
        log("phase 12: %s at 15 bit bit-exact against its plain version; "
            "%s: kernel %.4f ms, plain %.4f ms, bound %.6f ms (%s); %d "
            "launches a %s decode" % (
                kernel, r["shape"], r["ms"], r["plain_ms"], r["bound_ms"],
                r["bound_by"], r["launches"], B15_STREAM))
    return out


def main():
    args = sys.argv[1:]
    if args[:1] == ["--multihost-rank"] and len(args) == 4:
        return multihost_worker(int(args[1]), args[2], args[3])
    if args and (len(args) != 2 or args[0] != "--parent"):
        print("usage: chip_smoke.py [--parent TREE]", file=sys.stderr)
        return 2
    parent = os.path.abspath(args[1]) if args else None
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import xvc_tpu_torch  # noqa: F401  (fails outside a checkout)
    from xvc_tpu_torch import native
    from xvc_tpu_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    log("phase 0: %s | torch %s cuda %s | python %s" % (
        name, torch.__version__, torch.version.cuda, sys.version.split()[0]))

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    # nvcc (one process per source) and g++ side by side
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futs = [pool.submit(timed, build.lib), pool.submit(timed, native.lib)]
        build_s, native_s = [f.result() for f in futs]
    log("phase 1: kernels built and loaded in %.2f s, native parse library "
        "in %.2f s (side by side)" % (build_s, native_s))
    for line in build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "smem" in line or \
                "Compiling entry function" in line:
            log("  ptxas: " + line.strip())

    phase_seconds = {"1": max(build_s, native_s)}

    def phase(key, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_seconds[key] = time.perf_counter() - t0
        return out

    res = phase("2", phase_kernels, torch, dev, parent)
    dec, pic0 = phase("3", phase_decode, torch, dev)
    stages = phase("3 stage profiles", lambda: {
        name: phase_stage_profile(torch, name) for name in PROFILED})
    goldens = phase("4", phase_goldens, dev)
    look = phase("5", phase_lookahead, torch, dev, pic0)
    enc = phase("6", phase_encode, torch, dev)
    resampling = phase("7", phase_resampling, torch)
    python_cu = phase("8", phase_python_cu, torch, dev)
    python_cu_inter, sweeps = phase("9", phase_python_cu_inter, torch, dev)
    phase("9 me_sad", phase_me_sad_timing, torch, dev, res, sweeps, parent)
    threads = phase("10", phase_threads, torch, dev)
    tiles = phase("11", phase_tiles, torch, dev)
    b15 = phase("12", phase_b15, torch, dev)
    mesh = phase("13", phase_mesh, torch, dev, pic0, threads)
    log("phase seconds: %s" % (
        {k: round(v, 1) for k, v in phase_seconds.items()},))
    for module in ("jax", "xvc_tpu"):
        if module in sys.modules:
            raise AssertionError("%s was imported" % module)

    log(json.dumps({"build_seconds": build_s,
                    "phase_seconds": phase_seconds,
                    "native_build_seconds": native_s, "decode": dec,
                    "picture_kernels": {
                        n: dict(per_picture=res[n]["per_picture"],
                                mean_device_ms=res[n]["device_ms"],
                                recon=res[n]["recon"])
                        for n in ("itx_picture", "mc_picture")},
                    "goldens": goldens, "resampling": resampling,
                    "resample": {k: res["resample"][k] for k in (
                        "per_plane", "per_picture", "synthetic_cases")},
                    "lookahead": look, "encode": enc,
                    "python_cu": python_cu,
                    "python_cu_inter": python_cu_inter,
                    "threads": threads, "tiles": tiles, "mesh": mesh,
                    "b15": {k: v for k, v in b15.items() if k != "kernels"},
                    "me_sad": {k: res["me_sad"][k] for k in (
                        "cases", "sweeps", "device_ms", "device_staging_ms",
                        "library_ms", "per_prefetch_call", "hd720")},
                    "txrd": {k: res["txrd"][k] for k in (
                        "per_size", "synthetic_cases",
                        "log2_cpu_card_differ", "log2_table_card_differ")},
                    "satd_fused_ms": res["satd"]["fused_ms"],
                    "satd_per_cu": res["satd"]["per_cu"],
                    "intra_satd": {k: res["intra_satd"][k] for k in (
                        "per_shape", "per_cu_call", "cases")},
                    "timed_shapes": {n: r["shape"] for n, r in res.items()},
                    "bounds": {n: {"bytes": r["bound_bytes"],
                                   "operations": r["bound_ops"]}
                               for n, r in res.items()},
                    "scan_ref_samples_read": {
                        n: res[n]["ref_samples_read"]
                        for n in ("intra_luma", "intra_chroma")},
                    "scans": {
                        n: {k: res[n][k] for k in (
                            "chain_steps", "us_per_step", "ticket_steps",
                            "us_per_ticket_step", "picture3_ms",
                            "picture3_steps", "interleaved_ms",
                            "parent_ms")}
                        for n in ("intra_luma", "intra_chroma")},
                    "chain_estimate_ms": {
                        n: res[n]["chain_estimate_ms"]
                        for n in ("intra_luma", "intra_chroma",
                                  "deblock_luma")},
                    "deblock_across_rows": {
                        n: res[n]["across_rows"]
                        for n in ("deblock_luma", "deblock_chroma")},
                    "deblock_luma_chain_steps":
                        res["deblock_luma"]["chain_steps"],
                    "deblock_luma_every_position_on_ms":
                        res["deblock_luma"]["every_position_on_ms"]}))
    stages[SPLICE] = resampling[SPLICE]["spans"]
    stages[TILES_STREAM] = tiles[TILES_STREAM]["spans"]
    stages[B15_STREAM] = b15[B15_STREAM]["spans"]
    log(json.dumps({"stage_profile": stages}))
    log(json.dumps({"kernels_at_15_bit": [
        dict(name=n, launches=r["launches"], max_abs_err=r["max_abs_err"],
             ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
             bound_by=r["bound_by"], shape=r["shape"])
        for n, r in b15["kernels"].items()]}))
    launches = {n: dec["hd720_ld"]["launches"][n]
                for n in DECODE_KERNELS + OFF_DECODE_KERNELS}
    launches.update({n: look["launches"][n] for n in LOOKAHEAD_KERNELS})
    # satd's path is now the speed-3 encode's transform-RD prepass
    launches["satd"] = enc["speed3"]["launches"]["satd"]
    launches["txrd"] = enc["speed3"]["launches"]["txrd"]
    launches["resample"] = resampling[SPLICE]["launches"]["resample"]
    launches["me_sad"] = \
        python_cu_inter[ME_SWEEPS_CLIP]["launches"]["me_sad"]
    # library_ms: no single PyTorch call computes any of these functions
    # on CUDA (gather + wrapped int16 filters, int32 transform with
    # per-block bases, the jobs of a picture derived from its parse
    # records, table-driven edge decisions over a painted
    # map, the sequential edge walk, the gated two-sample chroma update,
    # Hadamard + |.| sum, every intra mode predicted with its SATD summed,
    # the sequential intra scans, a top-8 screen with
    # a per-block integer transform, quantization and a rate proxy summed
    # per candidate with a keep-best selection); but resample's, the JAX
    # formulation as two float64 torch.matmul calls on dense tap matrices
    # with the shifts and clips (dense_resample), and me_sad's,
    # torch.cdist p=1 in float32 on the candidates' blocks gathered
    # beforehand, with the doubling and shift (exact below 2^24)
    log(json.dumps({"kernels": [
        dict(name=n, route="cuda", source=KERNELS[n][0],
             replaces=KERNELS[n][1], launches=launches[n],
             max_abs_err=res[n]["max_abs_err"], ms=res[n]["ms"],
             plain_ms=res[n]["plain_ms"], bound_ms=res[n]["bound_ms"],
             bound_by=res[n]["bound_by"],
             library_ms=res[n].get("library_ms"))
        for n in KERNELS]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
