"""Two processes of a gloo group, importing only the port
(``xvc_tpu_torch/parallel/multihost.py``), on the CPU device.

The contracts of tests/test_multihost.py for the port, which runs them
in Tier-1 (each subprocess has its own timeout, so a hang fails the
test instead of stalling the suite; the test fails, it does not skip,
unless this torch has no gloo):
- the lookahead over the global mesh (two ``"cpu"`` slots a process,
  four in all: each process launches its own shards and ``all_gather``
  joins them) equals the single-process maps of the port and of the JAX
  package;
- a ``multihost_gop`` encode of a 32x24 clip (6 pictures, sub-GOP 4, one
  reference, speed 2, ``GOP_PIPELINE_PROFILE``), its pictures split
  over the two processes by DOC and each picture's NAL bytes and
  reconstruction broadcast by its owner, gives in both processes the
  bytes of the single-process encode of the same settings, and of the
  JAX package's ``encode_stream``.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300

_PRELUDE = r"""
import sys
port, pid, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
import numpy as np
from xvc_tpu_torch.parallel import multihost
assert multihost.init(coordinator_address='127.0.0.1:' + port,
                      num_processes=2, process_id=pid)
assert multihost.is_multiprocess() and multihost.process_index() == pid
assert 'jax' not in sys.modules and 'xvc_tpu' not in sys.modules
"""

# both ranks are done before either tears the group down (rank 0 holds
# its store)
_EPILOGUE = r"""
import torch.distributed as dist
dist.barrier()
dist.destroy_process_group()
print('WORKER_OK', pid)
"""

LOOKAHEAD = _PRELUDE + r"""
from xvc_tpu_torch import engine
from xvc_tpu_torch.gpu.lookahead import frame_intra_lookahead
from xvc_tpu_torch.restrictions import Restrictions
rng = np.random.RandomState(21)
frame = rng.randint(0, 256, size=(64, 96)).astype(np.int32)
mesh = multihost.global_mesh(devices=['cpu', 'cpu'])
assert mesh.size == 4 and [s.index for s in mesh.local_slots] == \
    [2 * pid, 2 * pid + 1]
engine.set_mesh(mesh)
maps = frame_intra_lookahead(frame, 8, Restrictions(), device='cpu')
np.savez(out % pid, **{str(n): maps[n] for n in maps})
""" + _EPILOGUE

GOP = _PRELUDE + r"""
from xvc_tpu_torch.codec.encoder import encode_stream
from xvc_tpu_torch.codec.encoder_settings import EncoderSettings
W, H, F = 32, 24, 6
rng = np.random.RandomState(5)
frames = []
for f in range(F):
    y = ((np.arange(H)[:, None] * 3 + np.arange(W)[None, :] * 5 + f * 7)
         % 220 + rng.randint(0, 30, (H, W))).astype(np.uint8)
    u = np.full((H // 2, W // 2), 90 + f, np.uint8)
    v = np.full((H // 2, W // 2), 150 - f, np.uint8)
    frames += [y.tobytes(), u.tobytes(), v.tobytes()]
yuv = b''.join(frames)

def run(mh):
    s = EncoderSettings()
    s.initialize_speed(2)
    s.explicit_restrictions = multihost.GOP_PIPELINE_PROFILE
    s.multihost_gop = mh
    return b''.join(encode_stream(yuv, W, H, F, qp=30, settings=s,
                                  sub_gop_length=4, num_ref_pics=1,
                                  device='cpu'))

from xvc_tpu_torch.codec import picture_encoder
coded = []
encode = picture_encoder.PictureEncoder.encode
def counted(self, *args):
    coded.append(self.pic_data.doc)
    return encode(self, *args)
picture_encoder.PictureEncoder.encode = counted
single = run(0)   # every process codes every picture
docs = sorted(coded)
assert len(docs) == F, docs
coded.clear()
multi = run(1)    # pictures split over the processes in coding order
assert 0 < len(coded) < F and set(coded) < set(docs), coded
assert multi == single, (len(multi), len(single))
open(out % pid, 'wb').write(multi)
""" + _EPILOGUE


def _run_pair(script, out):
    """Run ``script`` as ranks 0 and 1 of a gloo group on a free local
    port; fail on a nonzero exit or a worker that outlasts TIMEOUT."""
    if not torch.distributed.is_gloo_available():
        pytest.skip("this torch has no gloo backend")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, port, str(i), out], env=env,
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    try:
        for i, p in enumerate(procs):
            try:
                o, e = p.communicate(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                pytest.fail("rank %d ran past %d s" % (i, TIMEOUT))
            assert p.returncode == 0, e[-3000:]
            assert "WORKER_OK %d" % i in o
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_lookahead_over_the_global_mesh_equals_one_process(tmp_path):
    from xvc_tpu.restrictions import Restrictions as JaxRestrictions
    from xvc_tpu.tpu.lookahead import frame_intra_lookahead as jax_lookahead
    from xvc_tpu_torch.gpu.lookahead import frame_intra_lookahead
    from xvc_tpu_torch.restrictions import Restrictions
    out = str(tmp_path / "maps%d.npz")
    _run_pair(LOOKAHEAD, out)
    rng = np.random.RandomState(21)
    frame = rng.randint(0, 256, size=(64, 96)).astype(np.int32)
    ref = frame_intra_lookahead(frame, 8, Restrictions(), device="cpu")
    jax_ref = jax_lookahead(frame, 8, JaxRestrictions())
    for pid in range(2):
        got = np.load(out % pid)
        assert set(got.files) == {str(n) for n in ref} == \
            {str(n) for n in jax_ref}
        for n in ref:
            np.testing.assert_array_equal(got[str(n)], ref[n])
            np.testing.assert_array_equal(got[str(n)], jax_ref[n])


def test_multihost_gop_encode_equals_one_process_and_the_jax_package(
        tmp_path):
    from xvc_tpu.codec.encoder import encode_stream
    from xvc_tpu.codec.encoder_settings import EncoderSettings
    from xvc_tpu.parallel.multihost import GOP_PIPELINE_PROFILE
    out = str(tmp_path / "gop%d.bin")
    _run_pair(GOP, out)
    W, H, F = 32, 24, 6
    rng = np.random.RandomState(5)
    frames = []
    for f in range(F):
        y = ((np.arange(H)[:, None] * 3 + np.arange(W)[None, :] * 5 + f * 7)
             % 220 + rng.randint(0, 30, (H, W))).astype(np.uint8)
        u = np.full((H // 2, W // 2), 90 + f, np.uint8)
        v = np.full((H // 2, W // 2), 150 - f, np.uint8)
        frames += [y.tobytes(), u.tobytes(), v.tobytes()]
    s = EncoderSettings()
    s.initialize_speed(2)
    s.explicit_restrictions = GOP_PIPELINE_PROFILE
    jax_bytes = b"".join(encode_stream(b"".join(frames), W, H, F, qp=30,
                                       settings=s, sub_gop_length=4,
                                       num_ref_pics=1))
    for pid in range(2):
        with open(out % pid, "rb") as f:
            assert f.read() == jax_bytes
