"""Native picture parse: the Python side of the call.

Wires ``xvcn_parse_picture`` (``csrc/xvcn_pic.inc``) into the session
layer: one call per picture runs the whole CABAC parse and MV derivation
in C++ and exports a flat record table, a coefficient arena and the
picture's motion field (the sequential host tail feeding the batched
device stages; ref: src/xvc_dec_lib/cu_decoder.cc:60-100).

Cross-picture TMVP state is carried by a per-4x4 "motion field" exported
after each picture and attached to the picture's PictureData; reference
pictures pass their fields back in.

Copy of the parse half of ``xvc_tpu/native/pic.py``, with its CU-tree
replay (``_fast_split``, ``_replay_tree``; the replay path of
``gpu/recon.py`` reads the tree); the whole-picture host decode and the
host postprocess are not here.
"""
import ctypes as c

import numpy as np

from .. import constants as k
from ..cabac.contexts import FAMILIES, OFFSETS, CabacContexts
from ..ops.transform import _TABLES
from ..profiling import span
from ..restrictions import ALL_FLAGS
from . import family_offsets, lib


class XvcnRefPic(c.Structure):
    _fields_ = [
        ("plane", c.c_int64 * 3),
        ("stride", c.c_int64 * 3),
        ("mvfield", c.c_int64),
        ("mf_stride", c.c_int32),
        ("poc", c.c_int32),
        ("pic_type", c.c_int32),
        ("width", c.c_int32),
        ("height", c.c_int32),
        ("pad_", c.c_int32),
        ("plane16", c.c_int64 * 3),
    ]


class XvcnPicParams(c.Structure):
    _fields_ = [
        ("bitstream", c.c_int64),
        ("bs_len", c.c_int64),
        ("bs_pos", c.c_int64),
        ("ctx_state", c.c_int64),
        ("fam41", c.c_int64),
        ("fam18", c.c_int64),
        ("restr", c.c_int64),
        ("tx_blob", c.c_int64),
        ("tx_offsets", c.c_int64),
        ("rec_plane", c.c_int64 * 3),
        ("rec_stride", c.c_int64 * 3),
        ("out_mvfield", c.c_int64),
        ("out_mf_stride", c.c_int32),
        ("width", c.c_int32),
        ("height", c.c_int32),
        ("bitdepth", c.c_int32),
        ("chroma_fmt", c.c_int32),
        ("pic_qp", c.c_int32),
        ("pred_type", c.c_int32),
        ("adaptive_qp", c.c_int32),
        ("lic_active", c.c_int32),
        ("tmvp_valid", c.c_int32),
        ("tmvp_ref_list", c.c_int32),
        ("tmvp_ref_idx", c.c_int32),
        ("force_l1_mvd_zero", c.c_int32),
        ("max_binary_split_depth", c.c_int32),
        ("chroma_qp_offset_table", c.c_int32),
        ("chroma_qp_offset_u", c.c_int32),
        ("chroma_qp_offset_v", c.c_int32),
        ("deblock", c.c_int32),
        ("beta_offset", c.c_int32),
        ("tc_offset", c.c_int32),
        ("poc", c.c_int32),
        ("num_ref", c.c_int32 * 2),
        ("pad_", c.c_int32),
        ("refs", (XvcnRefPic * 5) * 2),
        ("out_bs_pos", c.c_int64),
        ("parse_ns", c.c_int64),
        ("recon_ns", c.c_int64),
        ("deblock_ns", c.c_int64),
        ("mc_ns", c.c_int64),
        ("intra_ns", c.c_int64),
        ("itx_ns", c.c_int64),
        ("coeff_ns", c.c_int64),
        ("status", c.c_int32),
        ("profile", c.c_int32),
        ("tile_rows", c.c_int32),
        ("num_ctx", c.c_int32),
    ]


_TX_CACHE = None     # (blob, offsets) int32 arrays, kept alive
_FAM41 = None
_FAM18 = None


def _tx_tables():
    """Flatten the transform basis matrices into one blob + offset index.

    Index layout: [family][log2size] with families
    0=dct2 1=dct2lo 2=dct5 3=dct8 4=dst1 5=dst7 (see get_tx_matrix).
    """
    global _TX_CACHE
    if _TX_CACHE is not None:
        return _TX_CACHE
    fams = ["dct2", "dct2lo", "dct5", "dct8", "dst1", "dst7"]
    offsets = np.full(6 * 7, -1, dtype=np.int32)
    chunks = []
    pos = 0
    for fi, fam in enumerate(fams):
        for l2 in range(1, 7):
            size = 1 << l2
            key = f"{fam}_{size}"
            if key not in _TABLES:
                continue
            m = np.ascontiguousarray(_TABLES[key], dtype=np.int32)
            offsets[fi * 7 + l2] = pos
            chunks.append(m.reshape(-1))
            pos += m.size
    blob = np.ascontiguousarray(np.concatenate(chunks), dtype=np.int32)
    _TX_CACHE = (blob, offsets)
    return _TX_CACHE


def _restr_vec(restrictions):
    vec = getattr(restrictions, "_xvcn_vec", None)
    if vec is None:
        vec = np.array([1 if getattr(restrictions, name) else 0
                        for name in ALL_FLAGS], dtype=np.uint8)
        try:
            restrictions._xvcn_vec = vec
        except AttributeError:
            pass
    return vec


def _fam_arrays():
    global _FAM41, _FAM18
    if _FAM18 is None:
        # _FAM18 last: a worker that finds it set finds both
        _FAM41 = np.array([OFFSETS[name] for name, _ in FAMILIES],
                          dtype=np.int32)
        _FAM18 = family_offsets()
    return _FAM41, _FAM18


def mvfield_shape(width, height):
    num_cu_x = (width + k.MAX_BLOCK_SIZE - 1) // k.MIN_BLOCK_SIZE
    num_cu_y = (height + k.MAX_BLOCK_SIZE - 1) // k.MIN_BLOCK_SIZE
    return num_cu_y + 1, num_cu_x + 1


PARSE_REC_STRIDE = 72  # must match kNParseRecStride in xvcn_pic.inc


def _fast_split(cu, split):
    """do_split of the reference CU (same child geometry and order,
    ref: coding_unit.cc Split) with the picture's CU factory."""
    cu.split = split
    pic = cu.pic
    tree = cu.cu_tree
    x, y, w, h = cu.pos_x, cu.pos_y, cu.width, cu.height
    sw, sh = w >> 1, h >> 1
    if split == 1:  # QUAD
        d = cu.depth + 1
        cu.sub_cus = [pic.create_cu(tree, d, x, y, sw, sh),
                      pic.create_cu(tree, d, x + sw, y, sw, sh),
                      pic.create_cu(tree, d, x, y + sh, sw, sh),
                      pic.create_cu(tree, d, x + sw, y + sh, sw, sh)]
    elif split == 2:  # HORIZONTAL
        cu.sub_cus = [pic.create_cu(tree, cu.depth, x, y, w, sh),
                      pic.create_cu(tree, cu.depth, x, y + sh, w, sh)]
    else:  # VERTICAL
        cu.sub_cus = [pic.create_cu(tree, cu.depth, x, y, sw, h),
                      pic.create_cu(tree, cu.depth, x + sw, y, sw, h)]


def _replay_tree(pd, rec, roots):
    """Rebuild the CU tree from the exported parse records (record index
    == native pool slot; child indices are absolute).  Availability marks
    are not set here: the reconstructor clears and re-marks them in its
    own decode-order walk."""
    stack = []
    for rsaddr in range(pd.get_number_of_ctus()):
        stack.append((pd.get_ctu(k.CuTree.PRIMARY, rsaddr),
                      int(roots[2 * rsaddr])))
        r1 = int(roots[2 * rsaddr + 1])
        if r1 >= 0:
            stack.append((pd.get_ctu(k.CuTree.SECONDARY, rsaddr), r1))
    # raw python ints in the hot loop (IntEnum members compare equal to
    # them); fresh CUs carry the defaults, so only differing fields are
    # stored
    rl = rec.tolist()
    while stack:
        cu, i = stack.pop()
        r = rl[i]
        split = r[6]
        if split:
            _fast_split(cu, split)
            for j, sub in enumerate(cu.sub_cus):
                if sub is not None:
                    stack.append((sub, r[7 + j]))
            continue
        cu.split = 0
        if r[21] or r[22] or r[23]:
            cu.cbf = [r[21] != 0, r[22] != 0, r[23] != 0]
        if r[11]:  # inter: final (derived) MVs
            cu.pred_mode = 1
            cu.inter_dir = r[16]
            if r[18]:
                cu.use_affine = True
            if r[19]:
                cu.use_lic = True
            if r[35] or r[36]:
                cu.ref_idx = [r[35], r[36]]
            cu.mv = [[(r[41], r[42]), (r[43], r[44]),
                      (r[45], r[46]), (r[47], r[48])],
                     [(r[49], r[50]), (r[51], r[52]),
                      (r[53], r[54]), (r[55], r[56])]]
        else:
            cu.intra_mode_luma = r[39]
            cu.intra_mode_chroma = r[40]


def parse_picture(pic_decoder, segment, bit_reader, qp, replay=False):
    """Native parse + MV derivation: fills ``pd._parse_records`` (the
    flat record table), ``pd._parse_coeff`` (the coefficient arena) and
    the picture's motion field for the record-driven device path
    (gpu/flat_recon.py).  With ``replay`` it also rebuilds the CU tree
    of ``pd`` (initialised with ``tree=True``) from the records, in the
    span ``decode.parse.replay``, for the replay path (gpu/recon.py).
    A segment with two or more tile rows is parsed as the JAX package's
    ``_decode_tiles`` parses it: one 32-bit size a tile (the split of
    ``PictureData.set_tiles``), then each tile's substream with fresh
    contexts and every lookup above the tile's top unavailable; the
    reader ends after the last payload.

    Returns conformance success; raises ValueError on parse errors."""
    pd = pic_decoder.pic_data
    restr = segment.restrictions
    fam41, fam18 = _fam_arrays()
    tx_blob, tx_offsets = _tx_tables()
    restr_vec = _restr_vec(restr)

    ctx = CabacContexts(restr)
    ctx.reset_states(qp.get_qp_raw(0), pd.get_prediction_type())

    p = XvcnPicParams()
    buf = bit_reader.buf
    buf_arr = np.frombuffer(buf, dtype=np.uint8)
    p.bitstream = buf_arr.ctypes.data
    p.bs_len = len(buf)
    p.bs_pos = bit_reader.pos
    p.ctx_state = ctx.state.ctypes.data
    p.fam41 = fam41.ctypes.data
    p.fam18 = fam18.ctypes.data
    p.restr = restr_vec.ctypes.data
    p.tx_blob = tx_blob.ctypes.data
    p.tx_offsets = tx_offsets.ctypes.data
    for comp in range(3):
        p.rec_plane[comp] = 0   # parse touches no pixels
        p.rec_stride[comp] = 0
    rows, cols = mvfield_shape(pd.width, pd.height)
    mvfield = getattr(pic_decoder, "_mvfield_buf", None)
    if mvfield is None or mvfield.size != rows * cols * 8:
        mvfield = np.empty(rows * cols * 8, dtype=np.int32)
        pic_decoder._mvfield_buf = mvfield
    p.out_mvfield = mvfield.ctypes.data
    p.out_mf_stride = cols
    p.width = pd.width
    p.height = pd.height
    p.bitdepth = pd.bitdepth
    p.chroma_fmt = int(pd.chroma_format)
    p.pic_qp = pic_decoder.pic_qp
    p.pred_type = int(pd.get_prediction_type())
    p.adaptive_qp = pd.adaptive_qp
    p.lic_active = 1 if pd.lic_active else 0
    p.tmvp_valid = 1 if pd.tmvp_valid else 0
    p.tmvp_ref_list = pd.tmvp_ref_list
    p.tmvp_ref_idx = pd.tmvp_ref_idx
    p.force_l1_mvd_zero = 1 if pd.force_bipred_l1_mvd_zero else 0
    p.max_binary_split_depth = segment.max_binary_split_depth
    p.chroma_qp_offset_table = segment.chroma_qp_offset_table
    p.chroma_qp_offset_u = segment.chroma_qp_offset_u
    p.chroma_qp_offset_v = segment.chroma_qp_offset_v
    p.deblock = 0  # parse only; the device path deblocks
    p.beta_offset = pd.beta_offset
    p.tc_offset = pd.tc_offset
    p.poc = pd.poc
    p.profile = 0
    p.tile_rows = segment.tile_rows if segment.tile_rows >= 2 else 0
    p.num_ctx = ctx.state.size
    keep_alive = [buf_arr, mvfield, ctx.state, fam41, fam18, tx_blob,
                  tx_offsets, restr_vec]
    rpl = pd.ref_pic_lists
    for lst in range(2):
        n = min(rpl.get_num_ref_pics(lst), 5)
        p.num_ref[lst] = n
        for i in range(n):
            entry = rpl.entries[lst][i]
            rp = p.refs[lst][i]
            rp.poc = entry.poc
            rp.pic_type = int(entry.pic_data.get_prediction_type())
            rp.width = entry.rec_pic.width[0]
            rp.height = entry.rec_pic.height[0]
            for comp in range(3):
                rp.plane16[comp] = 0  # MV derivation reads no samples
                rp.plane[comp] = 0
                rp.stride[comp] = 0
            mf = getattr(entry.pic_data, "_xvcn_mvfield", None)
            if mf is not None:
                rp.mvfield = mf.ctypes.data
                rp.mf_stride = getattr(entry.pic_data, "_xvcn_mf_stride", 0)
                keep_alive.append(mf)
            else:
                rp.mvfield = 0
                rp.mf_stride = 0

    LIB = lib()
    coeff = np.empty(3 * pd.width * pd.height, dtype=np.int32)
    ncoeff = c.c_int64(0)
    nrec = c.c_int32(0)
    status = LIB.xvcn_parse_picture(c.byref(p), coeff.ctypes.data,
                                    coeff.size, c.byref(ncoeff),
                                    c.byref(nrec))
    del keep_alive
    if status not in (0, 3):
        raise ValueError("corrupt bitstream (native parse status %d)"
                         % status)
    rec = np.empty((int(nrec.value), PARSE_REC_STRIDE), dtype=np.int32)
    roots = np.empty(2 * pd.ctu_num_x * pd.ctu_num_y, dtype=np.int32)
    LIB.xvcn_export_parse(rec.ctypes.data, PARSE_REC_STRIDE,
                          roots.ctypes.data)
    if replay:
        with span("decode.parse.replay"):
            _replay_tree(pd, rec, roots)
    bit_reader.pos = p.out_bs_pos
    bit_reader.bit_mask = 0x80
    pd._xvcn_mvfield = mvfield
    pd._xvcn_mf_stride = cols
    # the record table feeds the device reconstruction
    # (gpu/flat_recon.py) and the deblock CU maps (ops/deblock.py)
    pd._parse_records = rec
    pd._parse_coeff = coeff[:int(ncoeff.value)]
    return status == 0
