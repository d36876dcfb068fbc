"""The port's Python parse (``codec/cu_decoder.CuDecoder.decode_ctu`` over
``syntax/reader.SyntaxReader``) and the record table it builds
(``gpu/tree_records.build``), on the CPU, tolerance 0.

- the record table and the coefficient arena of every picture equal the
  native parse's (``native/pic.parse_picture``) row for row, on an
  intra, a random-access, a 4:2:2 and a tile-row stream, on the native
  arithmetic decoder and (``XVC_NATIVE=0``) on the pure-Python one;
- ``XVC_PIC_NATIVE=0`` decodes goldens to their ``_dec.yuv`` on
  ``device="cpu"``, every picture conforming, through the replay path
  and never the flat one;
- ``engine.use_native_pic_decode`` reads the switch;
- the pure-Python arithmetic decoder reads the bins the native one
  reads.
"""
import numpy as np
import pytest

from xvc_tpu_torch import engine
from xvc_tpu_torch.bitio import BitReader
from xvc_tpu_torch.cabac.contexts import CabacContexts
from xvc_tpu_torch.cabac.entropy_decoder import EntropyDecoder
from xvc_tpu_torch.codec import picture_decoder
from xvc_tpu_torch.codec.decoder import decode_stream
from xvc_tpu_torch.gpu import flat_recon, recon
from xvc_tpu_torch.native import engines
from xvc_tpu_torch.native import pic as native_pic
from xvc_tpu_torch.restrictions import Restrictions

from .util import read_data

STREAMS = ["ai64x48", "ra64x48", "c422_ra64x48", "bench/tiles64x256"]
GOLDENS = ["ai64x48", "ra64x48", "ld64x48", "cf_c444", "ai64x48b10"]


def _tables(name, monkeypatch, python):
    """The (records, arena) of every picture of stream ``name``, from the
    Python parse (``python``) or the native one."""
    got = []
    if python:
        real = picture_decoder.PictureDecoder._python_parse

        def spy(self, segment, bit_reader, qp):
            ok = real(self, segment, bit_reader, qp)
            got.append((self.pic_data._parse_records.copy(),
                        self.pic_data._parse_coeff.copy()))
            return ok

        monkeypatch.setattr(picture_decoder.PictureDecoder, "_python_parse",
                            spy)
        monkeypatch.setenv("XVC_PIC_NATIVE", "0")
    else:
        real = native_pic.parse_picture

        def spy(pic_decoder, segment, bit_reader, qp, replay=False):
            ok = real(pic_decoder, segment, bit_reader, qp, replay)
            pd = pic_decoder.pic_data
            got.append((pd._parse_records.copy(), pd._parse_coeff.copy()))
            return ok

        monkeypatch.setattr(picture_decoder.native_pic, "parse_picture", spy)
        monkeypatch.setenv("XVC_PIC_NATIVE", "1")
    pics = decode_stream(read_data(name + ".xvc"), device="cpu")
    assert all(p.conforming for p in pics)
    monkeypatch.undo()
    return got


@pytest.mark.parametrize("name,engine_name",
                         [(name, "native") for name in STREAMS] +
                         [("ra64x48", "python")])
def test_records_equal_the_native_parse(name, engine_name, monkeypatch):
    if engine_name == "python":
        monkeypatch.setenv("XVC_NATIVE", "0")
    python = _tables(name, monkeypatch, True)
    native = _tables(name, monkeypatch, False)
    assert len(python) == len(native) > 0
    for n, ((rec_p, arena_p), (rec_n, arena_n)) in enumerate(
            zip(python, native)):
        assert rec_p.shape == rec_n.shape, n
        rows = np.nonzero((rec_p != rec_n).any(1))[0]
        assert not len(rows), "picture %d row %d: %r != %r" % (
            n, rows[0], rec_p[rows[0]].tolist(), rec_n[rows[0]].tolist())
        np.testing.assert_array_equal(arena_p, arena_n)


@pytest.mark.parametrize("name", GOLDENS)
def test_python_parse_decodes_goldens(name, monkeypatch):
    monkeypatch.setenv("XVC_PIC_NATIVE", "0")
    routes = []
    real = recon.Reconstructor.run

    def spy(self):
        routes.append(self.STAGE)
        return real(self)

    monkeypatch.setattr(recon.Reconstructor, "run", spy)
    monkeypatch.setattr(flat_recon.FlatReconstructor, "run",
                        lambda self: pytest.fail("flat path taken"))
    pics = decode_stream(read_data(name + ".xvc"), device="cpu")
    assert all(p.conforming for p in pics)
    assert b"".join(p.bytes for p in pics) == read_data(name + "_dec.yuv")
    assert routes == ["recon"] * len(pics)


def test_the_switch(monkeypatch):
    monkeypatch.delenv("XVC_PIC_NATIVE", raising=False)
    assert engine.use_native_pic_decode()
    monkeypatch.setenv("XVC_PIC_NATIVE", "0")
    assert not engine.use_native_pic_decode()
    monkeypatch.setenv("XVC_PIC_NATIVE", "1")
    assert engine.use_native_pic_decode()


def test_python_arithmetic_decoder_equals_the_native_one():
    """Context bins, bypass bins, runs of bypass bins and terminating
    bins over seeded bytes: the same values and context states."""
    rng = np.random.RandomState(3)
    data = rng.randint(0, 256, 4096).astype(np.uint8).tobytes()
    readers = []
    for cls in (EntropyDecoder, engines.NativeEntropyDecoder):
        ctx = CabacContexts(Restrictions())
        ctx.reset_states(32, 1)
        br = BitReader(data)
        br.read_bits(8)
        dec = cls(br, ctx.state)
        dec.start()
        readers.append((dec, ctx))
    ops = rng.randint(0, 4, 3000)
    args = rng.randint(0, 100, 3000)
    for op, a in zip(ops, args):
        vals = []
        for dec, _ in readers:
            if op == 0:
                vals.append(dec.decode_bin(int(a)))
            elif op == 1:
                vals.append(dec.decode_bypass())
            elif op == 2:
                vals.append(dec.decode_bypass_bins(1 + int(a) % 16))
            elif a < 3:
                vals.append(dec.decode_bin_trm())
        assert vals[:1] == vals[1:]
    np.testing.assert_array_equal(readers[0][1].state, readers[1][1].state)
