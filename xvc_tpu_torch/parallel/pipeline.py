"""Dependency-aware picture-parallel decode pipeline.

Copy of ``PictureJob``, ``DecodePipeline`` and ``_pool_size`` of
``xvc_tpu/parallel/pipeline.py``, the behavioral equivalent of the
reference thread pool (ref: src/xvc_dec_lib/thread_decoder.cc:29-176):
pictures decode concurrently on worker threads once their reference
pictures have finished reconstruction; the checksum and the output
conversion also run on the worker, after the picture has woken its
dependents.  The native CABAC parse (ctypes) releases the GIL.

Every worker issues its device work on PyTorch's current stream, which
is the same default stream in every thread: a dependent picture starts
only when its references' ``recon_done`` is set, after their device work
has been issued on that stream and their planes downloaded, so the
stream orders its reads after their writes.  The module state that the
workers share is guarded or keyed per stream (``PERF.md``, "shared
state").

Threaded and unthreaded decodes are bit-identical by construction: every
picture sees exactly the reference pictures the sequential decoder would
have used (``tests/test_torch_threads.py``).  Unlike the JAX package,
the session harvests with a blocking pull only, and every wait here is
bounded by ``WAIT_SECONDS``.
"""
import os
from concurrent.futures import ThreadPoolExecutor

# the longest a worker waits for a reference picture, and the session for
# a picture's job, before it raises TimeoutError
WAIT_SECONDS = 600.0


def _pool_size(num_threads):
    """Clamp workers to hardware concurrency: Python workers pay GIL
    hand-offs around every native call, so on a loaded or small host
    extra workers only add contention.  Output is identical for any
    worker count by construction.  XVC_THREADS_NO_CLAMP=1 disables the
    clamp so the pipeline machinery itself stays testable on small hosts
    (the session routes a clamped pool of 1 to the sequential path)."""
    if os.environ.get("XVC_THREADS_NO_CLAMP"):
        return max(1, num_threads)
    hw = os.cpu_count() or num_threads
    return max(1, min(num_threads, hw))


class PictureJob:
    """One in-flight picture decode (ref: thread_decoder.h work item)."""

    __slots__ = ("pic_dec", "deps", "future")

    def __init__(self, pic_dec, deps):
        self.pic_dec = pic_dec
        self.deps = deps
        self.future = None


class DecodePipeline:
    """Executes picture decodes with inter-prediction dependencies.
    ``parse_errors``: the exceptions that make a picture non-conforming
    instead of ending the session (the session's own tuple)."""

    def __init__(self, num_threads, parse_errors):
        self.parse_errors = parse_errors
        self.executor = ThreadPoolExecutor(
            max_workers=_pool_size(num_threads),
            thread_name_prefix="xvc-dec")

    def submit(self, pic_dec, deps, segment_header, prev_segment_header,
               bit_reader):
        pic_dec.recon_done.clear()
        job = PictureJob(pic_dec, deps)

        def work():
            for dep in deps:
                if not dep.recon_done.wait(WAIT_SECONDS):
                    pic_dec.recon_done.set()
                    raise TimeoutError("reference poc %d not reconstructed "
                                       "in %.0f s" % (dep.pic_data.poc,
                                                      WAIT_SECONDS))
            try:
                # dependents only need the reconstruction: wake them
                # before the checksum and the output conversion
                # (ref: thread_decoder.cc:152-170)
                return pic_dec.decode(segment_header, prev_segment_header,
                                      bit_reader,
                                      on_recon=pic_dec.recon_done.set)
            except self.parse_errors:
                return False
            finally:
                pic_dec.recon_done.set()

        job.future = self.executor.submit(work)
        return job
