"""The plain reference decoder against the recorded host decodes, and
the work its parse counts against the recorded work files."""
import json

import pytest

from portbench import harness, spec
from portbench.reference import work

from .conftest import tiny_config


def check(cfg):
    """The reference's decode of the configuration's stream: every
    picture's sha256 and conformance flag as the hash list records them,
    and every picture's work as the work file records it."""
    with open(cfg["stream_path"], "rb") as f:
        ref = work.decode(f.read())
    hashes, flags = harness.read_hashes(cfg["hashes_path"])
    assert [work.digest(p) for p in ref] == hashes
    assert [p["conforming"] for p in ref] == flags
    assert len(ref) == cfg["pictures"]
    with open(cfg["work_path"]) as f:
        assert work.work_file(ref) == json.load(f)


@pytest.mark.parametrize("config", ["hd720_ld", "fhd1080_ra"])
def test_reference_reproduces_hash_list_and_work(config):
    check(spec.load_config(config))


def test_reference_reproduces_tiny_golden():
    check(tiny_config())


def test_control_breaks_exactness():
    """Leaving the deblocking filter out changes the pictures and fails
    their checksums."""
    with open(tiny_config()["stream_path"], "rb") as f:
        data = f.read()
    ref = work.decode(data)
    ctrl = work.decode(data, skip_deblocking=True)
    assert len(ctrl) == len(ref)
    assert sum(a["bytes"] != b["bytes"] for a, b in zip(ref, ctrl)) >= 4
    assert not all(p["conforming"] for p in ctrl)
