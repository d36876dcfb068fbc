"""Picture-threaded encoding on the Python CU encoder's inter half
(``XVC_ME=jax``), on the CPU device: ``ra64x48_me4`` (the first four
pictures of tests/data/ra64x48_in.yuv, random access with sub-GOP 4 and
two references; pictures 1 and 3 predict from the same two references
and are coded at once) with 4 workers equals the JAX package's stream and
reconstructions, recorded in tests/data/bench/python_cu_inter_more.json
by tests/encode_clips.py ``make_python_cu_inter_refs``, so that only the
port's encode runs here.  The motion search's prefetch counts, summed
over the workers, equal the JAX package's sequential counts.  A file of
its own: the encode takes about a minute.
"""
from .test_torch_encode_threads import _bounded  # noqa: F401  (autouse)
from .test_torch_encode_threads import in_flight
from .test_torch_python_cu_inter_formats import encode_inter_clip


def test_threaded_ra64x48_me4_equals_the_jax_package(monkeypatch, _bounded):
    most = in_flight(monkeypatch)
    ses = encode_inter_clip("ra64x48_me4", 4, monkeypatch)
    assert ses._enc.pipeline is not None and len(_bounded) == 4
    assert most[0] == 2
