"""Meshes of slots, and the mesh-sharded intra analysis.

Port of ``xvc_tpu/parallel/mesh.py``.  A JAX mesh is a set of devices; a
mesh here is a list of **slots**.  A slot is one placement: a
``torch.device``, a CUDA stream of its own (None on the CPU) and a frame
store of its own (``gpu/flat_recon.get_store`` keys the stores by the
slot a thread is pinned to).  Several slots may name one device, as the
JAX tests' eight virtual devices share one CPU, so the multi-device
logic (the pins, the moves of reference planes between stores, the
per-slot launches and the gathers) runs unchanged on the CPU with slots
of ``"cpu"``, on one card with several slots of ``cuda:0``, and on a
machine with several cards, where keying by slot is keying by device.

The axis shards two things: the encoder's whole-frame intra lookahead
(``make_sharded_intra_satd_fn``: each slot's contiguous range of the
block batch is one ``intra_satd`` launch on its device and stream) and
the replay path's ITX and MC jobs (``gpu/flat_recon.py``).  Every stage
is an exact integer computation, so sharded and unsharded runs give the
same bytes.  A mesh spanning processes (``multihost.global_mesh``) holds
every process's slots; a process launches on its own (``local_slots``)
and ``torch.distributed.all_gather`` joins the shards.
"""
import contextlib

import torch


class Slot:
    """One placement of a mesh: its ``index`` on the mesh, ``device``
    (None for a slot of another process), its own CUDA ``stream`` (None
    on the CPU and for another process's slot) and ``key``, which names
    its frame store."""

    def __init__(self, index, device, local=True):
        self.index = index
        self.device = torch.device(device) if local else None
        if self.device is not None and self.device.type == "cuda" and \
                self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.stream = torch.cuda.Stream(self.device) \
            if self.device is not None and self.device.type == "cuda" \
            else None
        self.key = "%s#%d" % (self.device, index)

    def __repr__(self):
        return "Slot(%d, %s)" % (self.index, self.device)


class Mesh:
    """A 1-axis mesh of slots (``axis`` names it, as the JAX mesh's axis
    does).  ``local_slots``: the slots of this process, in mesh order."""

    def __init__(self, slots, axis="blk"):
        if not slots:
            raise ValueError("a mesh needs at least one slot")
        self.slots = list(slots)
        self.axis = axis
        self.local_slots = [s for s in self.slots if s.device is not None]
        types = {s.device.type for s in self.local_slots}
        if len(types) != 1:
            raise ValueError("a mesh's slots are of one device type, got "
                             "%r" % sorted(types))
        self.device_type = types.pop()
        self.multiprocess = len(self.local_slots) != len(self.slots)

    @property
    def size(self):
        return len(self.slots)


def make_mesh(devices=None, axis="blk"):
    """A 1-axis mesh of one slot a device of ``devices`` (default: every
    visible card; a device may repeat, each repeat another slot).  With
    no card and no ``devices`` it raises: a mesh never falls back to the
    CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() takes every visible card and "
                               "torch.cuda.is_available() is False")
        devices = ["cuda:%d" % i for i in range(torch.cuda.device_count())]
    return Mesh([Slot(i, d) for i, d in enumerate(devices)], axis)


def shard_count(mesh):
    return mesh.size


@contextlib.contextmanager
def placed(slot):
    """Run the body on ``slot``: on a card, its device is the current
    device and its stream the current stream (``kernels/build.stream_of``
    launches on the current stream of the current device)."""
    if slot.stream is None:
        yield
        return
    with torch.cuda.device(slot.device), torch.cuda.stream(slot.stream):
        yield


def current_stream(device):
    """The current CUDA stream of ``device``, None on the CPU."""
    device = torch.device(device)
    return torch.cuda.current_stream(device) if device.type == "cuda" \
        else None


def wait_for(slot, stream):
    """``slot``'s stream waits for the work enqueued so far on
    ``stream`` (the caller's; None on the CPU)."""
    if slot.stream is not None and stream is not None:
        slot.stream.wait_stream(stream)


def join(tensor, slot, stream):
    """Make ``tensor``, written on ``slot``'s stream, safe to read on the
    caller's ``stream``: the caller waits for the slot, and the caching
    allocator keeps the memory until the caller's work on it is done."""
    if slot.stream is not None and stream is not None:
        stream.wait_stream(slot.stream)
        if tensor.device.type == "cuda":
            tensor.record_stream(stream)
    return tensor


def shard_bounds(n, shards):
    """The contiguous [lo, hi) range of each of ``shards`` shards of n
    rows, as even as can be, in order."""
    base, extra = divmod(n, shards)
    out, lo = [], 0
    for i in range(shards):
        hi = lo + base + (1 if i < extra else 0)
        out.append((lo, hi))
        lo = hi
    return out


def make_sharded_intra_satd_fn(mesh, n, bitdepth, mode_step=1):
    """Mesh-sharded twin of ``gpu/analysis.make_intra_satd_fn``: returns
    fn(orig [B,n,n], top [B,2n+1], left [B,2n]) -> [B,M] int32 on the
    device of its arguments, B a multiple of the mesh's slot count.
    Each slot takes one contiguous shard, copied to its device on its
    stream, and launches ``intra_satd`` once there; the rows are gathered
    in order.  On a mesh spanning processes every process holds the
    whole input, computes its own slots' shards, and
    ``torch.distributed.all_gather`` joins them (every process holds the
    same number of slots).  Bit-identical to the unsharded function."""
    from ..gpu import intra_satd

    def fn(orig, top, left):
        dev = orig.device
        b = orig.shape[0]
        if b % mesh.size:
            raise ValueError("the block batch (%d) is not a multiple of the "
                             "mesh's %d slots" % (b, mesh.size))
        per = b // mesh.size
        caller = current_stream(dev)
        outs = []
        for slot in mesh.local_slots:
            lo = slot.index * per
            wait_for(slot, caller)
            with placed(slot):
                parts = [t[lo:lo + per].to(slot.device)
                         for t in (orig, top, left)]
                out = intra_satd.intra_satd(*parts, n, bitdepth, mode_step)
            outs.append(join(out, slot, caller).to(dev))
        local = torch.cat(outs)
        if not mesh.multiprocess:
            return local
        import torch.distributed as dist
        host = local.cpu()
        got = [torch.empty_like(host) for _ in range(dist.get_world_size())]
        dist.all_gather(got, host)
        return torch.cat(got).to(dev)

    return fn
