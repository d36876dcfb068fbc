"""Meshes of slots in the port (``xvc_tpu_torch/parallel/mesh.py``): what
a mesh computes equals what one device computes, on the CPU device.

The contract of tests/test_sharding.py (sharded == unsharded, the
reference's determinism contract, ref: test/xvc_test/simd_test.cc:
149-176, lifted to the mesh) for the port, its mesh being eight slots of
``"cpu"`` and the JAX package's its eight virtual CPU devices
(tests/conftest.py):
- the lookahead sharded over the mesh (96x128, 8 slots) equals the
  unsharded one and the JAX package's sharded one, block for block;
- (the encodes with a mesh are in tests/test_torch_mesh_encode.py and
  tests/test_torch_mesh_pipeline{,_jax}.py;)
- a decode with a mesh pins each picture to a slot: sequential and with
  4 picture threads it equals the unmeshed decode and the golden (the
  reference's decode, which the JAX package's decode gives meshed or
  not); the threaded decode moves references between the slots' stores
  and the sequential one never does; so does a stream of CTU tile rows;
- the replay path's block-sharded dispatch (a mesh and no pin) gives the
  planes of the unsharded dispatch on LIC pictures (ld64x48) and on
  pictures with affine CUs (ra96x64pl), and the decode its golden;
- ``make_mesh()`` without a card raises, and a mesh of another device
  type than the session's raises.
"""
import jax
import numpy as np
import pytest
import torch

from xvc_tpu import engine as jengine
from xvc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from xvc_tpu.restrictions import Restrictions as JaxRestrictions
from xvc_tpu.tpu.lookahead import frame_intra_lookahead as jax_lookahead
from xvc_tpu_torch import engine, profiling
from xvc_tpu_torch.codec.decoder import decode_stream
from xvc_tpu_torch.gpu import flat_recon, recon
from xvc_tpu_torch.gpu.lookahead import frame_intra_lookahead
from xvc_tpu_torch.gpu.records import C_AFFINE, C_LIC, C_PRED
from xvc_tpu_torch.parallel import mesh as mesh_mod
from xvc_tpu_torch.parallel import pipeline
from xvc_tpu_torch.restrictions import Restrictions

from .util import read_data

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _no_mesh_left(monkeypatch):
    monkeypatch.setenv("XVC_THREADS_NO_CLAMP", "1")
    monkeypatch.setattr(pipeline, "WAIT_SECONDS", 120.0)
    yield
    engine.set_mesh(None)
    jengine.set_mesh(None)


def _meshed(slots=8):
    engine.set_mesh(mesh_mod.make_mesh(["cpu"] * slots))


def test_sharded_lookahead_equals_unsharded_and_the_jax_package():
    rng = np.random.RandomState(11)
    frame = rng.randint(0, 256, size=(96, 128)).astype(np.int32)
    ref = frame_intra_lookahead(frame, 8, Restrictions(), device="cpu")
    _meshed()
    sharded = frame_intra_lookahead(frame, 8, Restrictions(), device="cpu")
    engine.set_mesh(None)
    jengine.set_mesh(jax_make_mesh(jax.devices()[:8]))
    jax_sharded = jax_lookahead(frame, 8, JaxRestrictions())
    jengine.set_mesh(None)
    assert set(ref) == set(sharded) == set(jax_sharded) == {4, 8, 16, 32}
    for n in ref:
        np.testing.assert_array_equal(sharded[n], ref[n])
        np.testing.assert_array_equal(sharded[n], jax_sharded[n])


def test_the_mesh_launches_once_a_slot_and_pads_the_batch(monkeypatch):
    """Every slot takes one contiguous shard of the padded batch, in
    order: 3 blocks of 16 over 8 slots are 5 zero blocks more."""
    from xvc_tpu_torch.gpu import intra_satd
    seen = []
    orig = intra_satd.intra_satd

    def spy(o, t, l, *args):
        seen.append(o.clone())
        return orig(o, t, l, *args)

    monkeypatch.setattr(intra_satd, "intra_satd", spy)
    rng = np.random.RandomState(3)
    frame = rng.randint(0, 256, size=(16, 48)).astype(np.int32)
    ref = frame_intra_lookahead(frame, 8, Restrictions(), sizes=(16,),
                                device="cpu")
    seen.clear()
    _meshed()
    got = frame_intra_lookahead(frame, 8, Restrictions(), sizes=(16,),
                                device="cpu")
    np.testing.assert_array_equal(got[16], ref[16])
    assert [s.shape[0] for s in seen] == [1] * 8
    for i, s in enumerate(seen):
        want = frame[:, 16 * i:16 * i + 16] if i < 3 else 0
        np.testing.assert_array_equal(s[0].numpy(), want)


def _decode(name, threads=0, slots=None):
    """(bytes of every picture, conformance flags, moves, move bytes)."""
    if slots:
        engine.set_mesh(mesh_mod.make_mesh(["cpu"] * slots))
    before = [profiling.counted(n) for n in ("xfer.move", "xfer.move.bytes")]
    try:
        pics = decode_stream(read_data(name), device="cpu",
                             num_threads=threads)
    finally:
        engine.set_mesh(None)
    return ([p.bytes for p in pics], [p.conforming for p in pics],
            profiling.counted("xfer.move") - before[0],
            profiling.counted("xfer.move.bytes") - before[1])


@pytest.mark.parametrize("name", ["ld64x48", "ra64x48"])
def test_pinned_decode_equals_the_unmeshed_decode(name):
    ref, flags, moves, _ = _decode(name + ".xvc")
    assert moves == 0
    assert b"".join(ref) == read_data(name + "_dec.yuv")
    seq, seq_flags, seq_moves, _ = _decode(name + ".xvc", 0, 8)
    assert seq == ref and seq_flags == flags
    assert seq_moves == 0  # a sequential session keeps one slot
    piped, piped_flags, piped_moves, nbytes = _decode(name + ".xvc", 4, 8)
    assert piped == ref and piped_flags == flags
    # pairs of pictures rotate over the slots: references move, a padded
    # luma and two chroma planes (int16) each
    assert piped_moves > 0 and piped_moves % 3 == 0
    assert nbytes > 0 and nbytes % 2 == 0


def test_pinned_decode_of_tile_rows():
    ref, flags, _, _ = _decode("bench/tiles64x256.xvc")
    for threads in (0, 4):
        got, got_flags, _, _ = _decode("bench/tiles64x256.xvc", threads, 4)
        assert got == ref and got_flags == flags and all(flags)


def test_pinned_stores_are_the_slots(monkeypatch):
    """A pinned picture is stored in its slot's frame store (keyed by the
    slot), and the slot's store is the one its reads take."""
    placed = []
    orig = flat_recon.frame_store_put

    def spy(rec_pic, dev_planes, device):
        slot = orig(rec_pic, dev_planes, device)
        placed.append(flat_recon.place_key(device))
        return slot

    monkeypatch.setattr(flat_recon, "frame_store_put", spy)
    _decode("ra64x48.xvc", 4, 8)
    assert set(placed) <= {"cpu#%d" % i for i in range(8)}
    assert len(set(placed)) > 1


def _sharded_dispatch(name, monkeypatch):
    """Decode ``name`` unmeshed; on every picture of the replay path run
    the device half twice, without a mesh and with 8 slots and no pin,
    and keep both results.  The decode goes on from the sharded one."""
    orig = recon.Reconstructor._device_half
    out = []

    def twice(self, leaves, lmeta, cmeta):
        orig(self, leaves, lmeta, cmeta)
        ref = [None if t is None else t.clone() for t in
               (self.plane_l, self.rpad_l, self.plane_c, self.rpad_c)]
        _meshed()
        try:
            assert engine.get_pin_device() is None
            orig(self, leaves, lmeta, cmeta)
        finally:
            engine.set_mesh(None)
        got = [self.plane_l, self.rpad_l, self.plane_c, self.rpad_c]
        inter = leaves[:, C_PRED] == 1
        out.append((ref, got, int((inter & (leaves[:, C_LIC] != 0)).sum()),
                    int((inter & (leaves[:, C_AFFINE] != 0)).sum())))

    monkeypatch.setattr(recon.Reconstructor, "_device_half", twice)
    pics = decode_stream(read_data(name + ".xvc"), device="cpu")
    return out, b"".join(p.bytes for p in pics)


@pytest.mark.parametrize("name,kind", [("ld64x48", "lic"),
                                       ("ra96x64pl", "affine")])
def test_sharded_replay_dispatch_equals_the_unsharded(name, kind,
                                                     monkeypatch):
    out, decoded = _sharded_dispatch(name, monkeypatch)
    assert decoded == read_data(name + "_dec.yuv")
    assert out
    for ref, got, _, _ in out:
        for r, g in zip(ref, got):
            if r is None:
                assert g is None
            else:
                assert torch.equal(r, g)
    lic = sum(o[2] for o in out)
    affine = sum(o[3] for o in out)
    assert (lic if kind == "lic" else affine) > 0


def test_shard_bounds_cover_the_rows_in_order():
    for n in range(0, 20):
        for shards in range(1, 9):
            b = mesh_mod.shard_bounds(n, shards)
            assert len(b) == shards and b[0][0] == 0 and b[-1][1] == n
            assert all(lo <= hi for lo, hi in b)
            assert all(b[i][1] == b[i + 1][0] for i in range(shards - 1))
            assert max(hi - lo for lo, hi in b) - \
                min(hi - lo for lo, hi in b) <= 1


def test_make_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        mesh_mod.make_mesh()


def test_a_mesh_of_another_device_type_raises():
    engine.set_mesh(mesh_mod.make_mesh(["meta"] * 2))
    with pytest.raises(RuntimeError, match="meta devices"):
        decode_stream(read_data("ai64x48.xvc"), device="cpu")
    with pytest.raises(RuntimeError, match="meta devices"):
        frame_intra_lookahead(np.zeros((16, 16), np.int32), 8,
                              Restrictions(), device="cpu")
    engine.set_mesh(mesh_mod.make_mesh(["cpu"] * 2))
    with pytest.raises(RuntimeError, match="cpu devices"):
        engine.mesh_for(torch.device("cuda", 0))


def test_moves_under_contention():
    """Sixteen threads, four pinned to each of four slots, ask at once for
    a picture stored on slot 0 (the switch interval cut short): each
    other slot's store gets it once, three planes a move, equal to the
    source."""
    import sys
    import threading
    from xvc_tpu_torch.codec.yuv import YuvPicture
    mesh = mesh_mod.make_mesh(["cpu"] * 4)
    pic = YuvPicture(1, 64, 48, 8)
    rng = np.random.RandomState(9)
    planes = {c: torch.from_numpy(rng.randint(
        0, 256, flat_recon.padded_shape(*pic._plane_shapes[c])).astype(
            np.int16)) for c in range(3)}
    engine.set_pin_device(mesh.slots[0])
    try:
        flat_recon.frame_store_put(pic, planes, CPU)
    finally:
        engine.set_pin_device(None)
    before = profiling.counted("xfer.move")
    slots, barrier = [], threading.Barrier(16)

    def ask(slot):
        engine.set_pin_device(slot)
        try:
            barrier.wait(30)
            slots.append((slot.key, flat_recon.ensure_slot(pic, CPU)))
        finally:
            engine.set_pin_device(None)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask, args=(mesh.slots[i % 4],))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and len(slots) == 16
    assert profiling.counted("xfer.move") - before == 3 * 3
    assert len(set(slots)) == 4  # one slot a store, the same for all asks
    for key, (store, slot, _) in pic._torch_slots.items():
        luma, chroma = store.stacks()
        assert torch.equal(luma[slot], planes[0])
        assert torch.equal(chroma[2 * slot], planes[1])
        assert torch.equal(chroma[2 * slot + 1], planes[2])
