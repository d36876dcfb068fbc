"""Dependency-aware picture-parallel decode and encode pipelines.

Copy of ``PictureJob``, ``DecodePipeline``, ``EncodePipeline`` and
``_pool_size`` of ``xvc_tpu/parallel/pipeline.py``, the behavioral
equivalents of the reference thread pools (ref:
src/xvc_dec_lib/thread_decoder.cc:29-176,
src/xvc_enc_lib/thread_encoder.cc:29-159): pictures decode or encode
concurrently on worker threads once their reference pictures have
finished reconstruction.  A decode's checksum and output conversion also
run on the worker, after the picture has woken its dependents.  The
native CABAC parse and the native CTU search (ctypes) release the GIL.

With no mesh, every worker issues its device work on PyTorch's current
stream, the same default stream in every thread.  With a mesh installed
(``engine.set_mesh``) each picture is pinned to a slot
(``parallel/mesh.py``: the decoder's ``PictureDecoder.decode`` takes
slot ``(doc // 2) % n`` for the pictures this pipeline marks
``_pipelined``, the encoder's ``submit(..., device=slot)`` the slot the
session gives it), and its pinned stages run on that slot's device and
stream.  What orders a reference's writes before a dependent picture's
reads is, in both cases, the host: a picture starts only when its
references' ``recon_done`` is set, which comes after their planes were
downloaded, a copy that waits for every write enqueued before it on the
writer's stream.  A dependent pinned to another slot then copies the
reference out of that slot's frame store on its own stream
(``flat_recon.ensure_slot``), and the caching allocator keeps the source
until that copy has run.  The module state that the workers share is
guarded or keyed per stream (``PERF.md``, "shared state").

Threaded and unthreaded runs are bit-identical by construction: every
picture sees exactly the reference pictures the sequential session would
have used (``tests/test_torch_threads.py``,
``tests/test_torch_encode_threads.py``, ``tests/test_torch_mesh.py``).
Unlike the JAX package, the decoder harvests with a blocking pull only,
and every wait here is bounded by ``WAIT_SECONDS``.
"""
import os
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import wait as wait_all

from .. import engine

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
        pic_dec._pipelined = True  # the mesh pin rotates over the slots
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


class EncodePipeline:
    """Picture-parallel encoding within a sub-GOP burst
    (ref: src/xvc_enc_lib/thread_encoder.cc:29-159): a picture's encode
    starts once every reference picture it predicts from has finished
    reconstruction; the session harvests the NALs in DOC order on its own
    thread (``harvest``), so the stream is byte-identical to the
    sequential encode.  A picture that raises surfaces at harvest as that
    exception; its dependents wake and raise at once instead of coding
    from it.  ``device``: the mesh slot the picture's worker is pinned to
    (``engine.set_pin_device``), or None."""

    def __init__(self, num_threads):
        self.executor = ThreadPoolExecutor(
            max_workers=_pool_size(num_threads),
            thread_name_prefix="xvc-enc")

    def submit(self, pic_enc, deps, segment_header, segment_qp, buffer_flag,
               settings, device=None):
        pic_enc.recon_done.clear()
        pic_enc.encode_error = None
        job = PictureJob(pic_enc, deps)

        def work():
            try:
                for dep in deps:
                    if not dep.recon_done.wait(WAIT_SECONDS):
                        raise TimeoutError(
                            "reference poc %d not reconstructed in %.0f s"
                            % (dep.pic_data.poc, WAIT_SECONDS))
                    if dep.encode_error is not None:
                        raise RuntimeError(
                            "reference poc %d failed to encode"
                            % dep.pic_data.poc) from dep.encode_error
                engine.set_pin_device(device)
                return pic_enc.encode(segment_header, segment_qp,
                                      buffer_flag, settings)
            except BaseException as exc:
                pic_enc.encode_error = exc
                raise
            finally:
                engine.set_pin_device(None)
                pic_enc.recon_done.set()

        job.future = self.executor.submit(work)
        return job

    @staticmethod
    def harvest(jobs):
        """The NAL bytes of ``jobs`` in their order, each waited for at
        most WAIT_SECONDS.  If one raises, the rest are waited for (its
        dependents end at once) before its exception goes on, so that no
        picture is still being coded when the caller sees it."""
        out = []
        try:
            for job in jobs:
                out.append(job.future.result(WAIT_SECONDS))
        except BaseException:
            wait_all([job.future for job in jobs], WAIT_SECONDS)
            raise
        return out
