"""Fixtures of the benchmark's tests.  ``card`` skips a test where no
CUDA card is visible; it decides when the test runs, never at import."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the benchmark runs on the card)")


def tiny_config():
    """A configuration over the 64x48 low-delay golden stream."""
    return {"stream_path": os.path.join(DATA, "ld64x48.xvc"),
            "hashes_path": os.path.join(DATA, "ld64x48_dec.sha256"),
            "work_path": os.path.join(DATA, "ld64x48_work.json"),
            "pictures": 8, "coding": {"sub_gop_length": 1}}


def tiny_traffic(loop):
    """Two clients; the open loop at 5 pictures a second."""
    base = {"loop": loop, "clients": 2, "threads": 0}
    if loop == "closed":
        base["stagger_s"] = 0.1
    else:
        base.update(rate=5, jitter=0.2, lead_s=0.05)
    return base
