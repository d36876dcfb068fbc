"""Multi-process scale-out over ``torch.distributed``.

Port of ``xvc_tpu/parallel/multihost.py``.  The reference is a
single-process codec; its scale ceiling is one host's threads (ref:
src/xvc_enc_lib/thread_encoder.cc:29-159).  This module carries the
codec's two scale-out axes across processes:

* **block-batch sharding** (the encoder's lookahead): ``global_mesh``
  is a mesh (``parallel/mesh.py``) of every process's slots; each
  process launches its own slots' shards and ``all_gather`` joins them.
  Every stage is an exact integer computation, so the maps equal the
  single-process ones.
* **GOP pipelining** (encode, ``multihost_gop``): the pictures of a
  sub-GOP are split over the processes by DOC.  Every process runs the
  whole session logic, but only a picture's owner codes it; the owner
  then broadcasts its NAL bytes and its final reconstruction planes, and
  the others install them, so that later pictures predict from them
  exactly as in one process.  The TMVP motion fields stay in the
  process that coded them, so the mode needs the signaled restrictions
  ``GOP_PIPELINE_PROFILE``; within that profile the stream is the
  single-process stream, byte for byte.

The data exchanged is host data (NAL bytes and host planes), so the
group is a gloo group: it also forms between processes that share one
card, which NCCL refuses.  Usage, once in each process:

    from xvc_tpu_torch.parallel import multihost
    multihost.init()                  # JAX_COORDINATOR_ADDRESS, ...
    from xvc_tpu_torch import engine
    engine.set_mesh(multihost.global_mesh())
"""
import os

import numpy as np
import torch

from .mesh import Mesh, Slot

GOP_PIPELINE_PROFILE = ("disable_inter_tmvp_mvp",
                        "disable_inter_tmvp_merge",
                        "disable_inter_tmvp_ref_list_derivation")

_local_device_ids = None


def init(coordinator_address=None, num_processes=None, process_id=None,
         local_device_ids=None):
    """Join this process to a gloo group at ``coordinator_address``
    ("host:port") of ``num_processes`` processes as rank ``process_id``.
    The arguments default to the environment variables the JAX package
    reads (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``), so one launcher drives both packages; with no
    address or count this is a no-op and the codec stays in one process.
    ``local_device_ids``: the cards (indices) this process's slots of
    ``global_mesh`` take.  Returns True if a group was formed."""
    global _local_device_ids
    coordinator_address = coordinator_address or \
        os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "0")) or None
    if process_id is None:
        pid = os.environ.get("JAX_PROCESS_ID")
        process_id = int(pid) if pid is not None else None
    if not coordinator_address or not num_processes:
        return False
    if process_id is None:
        raise ValueError("multihost.init: no process id (JAX_PROCESS_ID)")
    import torch.distributed as dist
    dist.init_process_group("gloo",
                            init_method="tcp://" + coordinator_address,
                            world_size=num_processes, rank=process_id)
    _local_device_ids = local_device_ids
    return True


def process_count():
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index():
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def is_multiprocess():
    return process_count() > 1


def global_mesh(axis="blk", devices=None):
    """A 1-axis mesh of every process's slots, in rank order: this
    process's slots are one a device of ``devices`` (default: the cards
    of ``init``'s ``local_device_ids``, else every visible card; a device
    may repeat), the others' stand for their slots.  Every process must
    give the same number of slots.  The axis name is the one the
    single-process paths use, so ``engine.set_mesh(global_mesh())``
    spreads the lookahead and the GOP pipeline over the processes."""
    if devices is None:
        if _local_device_ids is not None:
            devices = ["cuda:%d" % i for i in _local_device_ids]
        elif torch.cuda.is_available():
            devices = ["cuda:%d" % i
                       for i in range(torch.cuda.device_count())]
        else:
            raise RuntimeError("global_mesh() takes this process's cards "
                               "and torch.cuda.is_available() is False")
    n = len(devices)
    world, rank = process_count(), process_index()
    if world > 1:
        import torch.distributed as dist
        counts = [None] * world
        dist.all_gather_object(counts, n)
        if len(set(counts)) != 1:
            raise ValueError("the processes give %r slots: a global mesh "
                             "needs as many in every process" % (counts,))
    return Mesh([Slot(r * n + i, devices[i], local=r == rank)
                 for r in range(world) for i in range(n)], axis)


def _bcast(arr, owner):
    """OWNER's numpy ``arr`` on every process: every process calls this
    with the same shape and dtype, and the others' data is ignored (the
    JAX package's psum over the global mesh, ``xvc_tpu/parallel/
    multihost.py:104``, as a ``torch.distributed.broadcast``).  With no
    group the one process is the owner, and gets its own array back."""
    import torch.distributed as dist
    t = torch.from_numpy(np.array(arr, copy=True))
    if dist.is_initialized():
        dist.broadcast(t, src=owner)
    return t.numpy()


def exchange_picture(pic_enc, nal_bytes, owner):
    """Broadcast one finished picture from its owner: the NAL bytes, then
    the final (deblocked) reconstruction planes.  The other processes
    install the planes into their picture's reconstruction surface (the
    write a local encode would have made), pad its border, and drop what
    the buffer's earlier picture left on a device (frame-store slots, the
    motion search's resident luma).  Returns the NAL bytes."""
    from .. import constants as k
    from ..gpu import flat_recon
    me = process_index()
    size = _bcast(np.array([len(nal_bytes) if me == owner else 0],
                           np.int64), owner)
    buf = np.zeros(int(size[0]), np.uint8)
    if me == owner:
        buf[:] = np.frombuffer(nal_bytes, np.uint8)
    buf = _bcast(buf, owner)
    if me != owner:
        nal_bytes = buf.tobytes()
    rec = pic_enc.rec_pic
    ncomp = 1 if rec.chroma_format == k.ChromaFormat.MONOCHROME else 3
    got = []
    for comp in range(ncomp):
        send = np.ascontiguousarray(rec.plane_view(comp), np.int32) \
            if me == owner else \
            np.zeros((rec.height[comp], rec.width[comp]), np.int32)
        got.append(_bcast(send, owner))
    if me != owner:
        rec.begin_native16()  # the received planes are the surface
        for comp, plane in enumerate(got):
            px, py = rec.pad_x[comp], rec.pad_y[comp]
            h, w = plane.shape
            rec.shadow16(comp)[py:py + h, px:px + w] = plane
        rec.pad_border()  # drops the resident luma too
        flat_recon.release_slot(rec)
    return nal_bytes


def encode_or_receive(session, pic_enc, segment_header, owner):
    """One picture of the GOP pipeline across processes: the owner codes
    it, every other process receives it (``Encoder._encode_one_picture``
    calls this when the session has ``multihost_gop``)."""
    nal_bytes = None
    if process_index() == owner:
        nal_bytes = pic_enc.encode(
            segment_header, session.segment_qp,
            1 if pic_enc.buffer_flag else 0, session.settings)
    return exchange_picture(pic_enc, nal_bytes, owner)
