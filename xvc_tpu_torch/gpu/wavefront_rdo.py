"""Bottom-up batched CU split RDO from device cost maps.

Port of ``xvc_tpu/tpu/wavefront_rdo.py``, the split-decision stage of the
encoder's speed mode 3.  The reference decides the CU tree by top-down
mutate-and-backtrack recursion, fully coding every node at every level
(ref: src/xvc_enc_lib/cu_encoder.cc:123-273).  Here:

  * the open-loop SATD cost maps of every aligned square block of the
    picture come from the lookahead (``gpu/lookahead.py``, one batched
    device step per block size),
  * for inter pictures, open-loop zero-MV SAD maps against the reference
    pictures' original planes add the inter leaf costs
    (``frame_zero_mv_sad``),
  * the split tree is then settled by a vectorized bottom-up dynamic
    program on the device (``split_dp_from_lookahead``): leaf vs binary
    (hor/ver, shared-mode rectangle estimates) vs quad at every node.

Because the costs are open-loop proxies, the DP only FORCES a decision
where the margin is decisive; ambiguous nodes keep the native encoder's
full search (``native/csrc/xvcn_enc.inc`` force_lookup reads the packed
maps).  FORCE_LEAF only disables the quad arm; FORCE_SPLIT disables the
leaf and binary arms and is only emitted when quad beats the best
non-quad arrangement decisively.

Cost model (integer, like the encoder's SATD pre-pass
ref: src/xvc_enc_lib/intra_search.cc:189-250):

  leaf(n)   = min(min_mode satd[n], zero_mv_sad[n]) + mode_cost
  rect(n)   = shared-mode pair of two n/2 squares + mode_cost
  hor/ver   = two rects + split_cost
  quad(n)   = sum of 4 best(n/2) + split_cost
  best(n)   = min(leaf, hor, ver, quad)

force split where quad * MARGIN_NUM < nonquad * MARGIN_DEN,
force leaf  where nonquad * MARGIN_NUM < quad * MARGIN_DEN.

Both device stages are int32 PyTorch, a few launches each on maps of at
most 45x80 entries at 720p, and exact: every sum, product and minimum is
int32 arithmetic that wraps where the JAX package's int32 arithmetic
wraps (the ``1 << 30`` fill of a missing SAD map, times 21).
"""
import numpy as np
import torch

from ..engine import resolve_device

# decisive-margin ratio (5%): force only when one side wins by this.
# Near-ties satisfy neither inequality and stay UNDECIDED.
MARGIN_NUM, MARGIN_DEN = 21, 20
# signaling-bit estimates at sqrt-lambda (coarse; absorbed by margin)
MODE_BITS = 5.0
SPLIT_BITS = 2.0

FORCE_SPLIT = 1
FORCE_LEAF = -1
UNDECIDED = 0


def _dp(maps, sads, mode_cost, split_cost, max_binary_size,
        allow_force_split):
    """The bottom-up split DP over int32 tensors on one device.

    maps: {n: [bh, bw, modes] int32}; sads: None or {n: [bh', bw']
    int32}.  Returns {n: force [bh, bw] int8 tensor} for every n whose
    half size has a map."""
    sizes = sorted(maps)
    best, nonquad, quad = {}, {}, {}
    for n in sizes:
        m = maps[n]
        bh, bw = m.shape[0], m.shape[1]
        if sads is not None:
            # common full-block grid across intra/inter maps
            bh = min(bh, sads[n].shape[0])
            bw = min(bw, sads[n].shape[1])
        m = m[:bh, :bw]
        sq_min = m.amin(dim=-1)
        if sads is not None:
            sq_min = torch.minimum(sq_min, sads[n][:bh, :bw])
        leaf = sq_min + mode_cost
        half = n // 2
        if half not in maps:
            nonquad[n] = leaf
            best[n] = leaf
            continue
        m2 = maps[half]
        bh2 = min(m2.shape[0], 2 * bh)
        bw2 = min(m2.shape[1], 2 * bw)
        # crop child grids to the parent-covered region (frames not
        # multiples of n leave partial children outside any parent)
        m2 = m2[:bh2, :bw2]
        # shared-mode rectangle estimates from per-mode child maps: an
        # (n x n/2) rect = two n/2 squares side by side with ONE intra
        # mode; an (n/2 x n) rect = two stacked squares
        rh = (m2[:, 0::2, :] + m2[:, 1::2, :]).amin(dim=-1)   # (bh2, pw)
        rv = (m2[0::2, :, :] + m2[1::2, :, :]).amin(dim=-1)   # (ph, bw2)
        if sads is not None:
            s2 = sads[half][:bh2, :bw2]
            rh = torch.minimum(rh, s2[:, 0::2] + s2[:, 1::2])
            rv = torch.minimum(rv, s2[0::2, :] + s2[1::2, :])
        rh = rh + mode_cost
        rv = rv + mode_cost
        hor = (rh[0::2, :] + rh[1::2, :])[:bh, :bw] + split_cost
        ver = (rv[:, 0::2] + rv[:, 1::2])[:bh, :bw] + split_cost
        ch = best[half][:bh2, :bw2]
        qd = (ch[0::2, 0::2] + ch[0::2, 1::2] + ch[1::2, 0::2] +
              ch[1::2, 1::2])[:bh, :bw] + split_cost
        if n <= max_binary_size:
            nq = torch.minimum(leaf, torch.minimum(hor, ver))
        else:
            # binary splits are illegal at this size
            # (is_binary_split_valid: width/height <= max size), so the
            # only alternative to quad is the plain leaf
            nq = leaf
        nonquad[n] = nq
        quad[n] = qd
        best[n] = torch.minimum(nq, qd)

    out = {}
    for n in sizes:
        if n not in quad:
            continue
        nq, qd = nonquad[n], quad[n]
        f = torch.zeros(nq.shape, dtype=torch.int8, device=nq.device)
        if allow_force_split:
            # FORCE_SPLIT only on intra pictures: the open-loop inter
            # model is zero-MV SAD, blind to true motion that a single
            # merge/skip MV at this node would capture, so "detail ->
            # must split" is unsound for inter content.
            f = torch.where(qd * MARGIN_NUM < nq * MARGIN_DEN,
                            torch.full_like(f, FORCE_SPLIT), f)
        f = torch.where(nq * MARGIN_NUM < qd * MARGIN_DEN,
                        torch.full_like(f, FORCE_LEAF), f)
        out[n] = f
    return out


def frame_zero_mv_sad(orig_luma, ref_planes, bitdepth, sizes=(8, 16, 32,
                                                              64),
                      device=None):
    """Open-loop inter leaf costs on ``device`` (the card when None):
    per-block zero-MV SAD against each reference picture's ORIGINAL
    luma, minimum over references, for every aligned square block size.

    orig_luma: (H, W) int array; ref_planes: list of (H, W) arrays.
    Returns {n: np.ndarray (H//n, W//n) int32} over the grid of the
    largest size, or None without references or room for one block of
    it.  The SAD is scaled to the SATD cost domain like the reference's
    uni-prediction estimate (SATD ~ 2x SAD on typical residuals; the
    decisive margin absorbs the approximation)."""
    if not ref_planes:
        return None
    dev = resolve_device(device)
    h, w = orig_luma.shape
    hh = min(h, min(r.shape[0] for r in ref_planes))
    ww = min(w, min(r.shape[1] for r in ref_planes))
    hh -= hh % max(sizes)
    ww -= ww % max(sizes)
    if hh <= 0 or ww <= 0:
        return None
    orig = torch.from_numpy(np.ascontiguousarray(
        orig_luma[:hh, :ww], np.int32)).to(dev)
    refs = torch.from_numpy(np.stack([np.ascontiguousarray(
        r[:hh, :ww], np.int32) for r in ref_planes])).to(dev)
    d = (refs - orig[None]).abs()               # (R, H, W)
    outs = {}
    base = None
    prev = 1
    for n in sorted(sizes):
        f = n // prev
        src = d if base is None else base
        base = src.reshape(src.shape[0], src.shape[1] // f, f,
                           src.shape[2] // f, f).sum(dim=(2, 4),
                                                     dtype=torch.int32)
        # min over refs; SAD -> SATD-domain scale (x2), matching the
        # intra map cost domain
        outs[n] = 2 * base.amin(dim=0)
        prev = n
    return {n: o.cpu().numpy() for n, o in outs.items()}


def split_dp_from_lookahead(maps, lambda_sqrt, inter_sad=None,
                            max_binary_size=32, binary_depth_ok=True,
                            allow_force_split=True, device=None):
    """maps: {n: costs[bh, bw, modes] int32} from frame_intra_lookahead;
    inter_sad: optional {n: [bh, bw] int32} from frame_zero_mv_sad.
    max_binary_size / binary_depth_ok mirror the encoder's binary-split
    legality (primary tree) so nonquad only includes arms the search
    would actually take.  Runs on ``device`` (the card when None).
    Returns {n: force[bh, bw] int8 numpy} for every n that has a child
    map."""
    dev = resolve_device(device)
    mode_cost = int(round(MODE_BITS * lambda_sqrt))
    split_cost = int(round(SPLIT_BITS * lambda_sqrt))
    sizes = sorted(maps)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    tmaps = {n: up(maps[n]) for n in sizes}
    sads = None
    if inter_sad is not None:
        sads = {n: up(inter_sad.get(
            n, np.full(np.shape(maps[n])[:2], (1 << 30), np.int32)))
            for n in sizes}
    force = _dp(tmaps, sads, mode_cost, split_cost,
                max_binary_size if binary_depth_ok else 0,
                allow_force_split)
    return {n: f.cpu().numpy() for n, f in force.items()}


def decision_for(force_maps, pos_x, pos_y, width, height):
    """The DP decision for a square CU at (pos_x, pos_y): FORCE_SPLIT /
    FORCE_LEAF / UNDECIDED.  Non-square or unmapped nodes are
    UNDECIDED."""
    if force_maps is None or width != height:
        return UNDECIDED
    f = force_maps.get(width)
    if f is None or pos_x % width or pos_y % width:
        return UNDECIDED
    by, bx = pos_y // width, pos_x // width
    if by >= f.shape[0] or bx >= f.shape[1]:
        return UNDECIDED
    return int(f[by, bx])


def pack_force_maps(force_maps, width, height, sizes=(8, 16, 32, 64)):
    """Flatten force maps into the single int8 buffer consumed by the
    native encoder (native/csrc/xvcn_enc.inc force_lookup): for each n
    in `sizes` in order, a ceil(height/n) x ceil(width/n) grid,
    UNDECIDED where the map has no entry."""
    bufs = []
    for n in sizes:
        gh = -(-height // n)
        gw = -(-width // n)
        g = np.zeros((gh, gw), np.int8)
        f = None if force_maps is None else force_maps.get(n)
        if f is not None:
            g[:f.shape[0], :f.shape[1]] = f[:gh, :gw]
        bufs.append(g.reshape(-1))
    return np.ascontiguousarray(np.concatenate(bufs))
