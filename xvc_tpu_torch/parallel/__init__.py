"""Picture-level parallelism on one device: the decoder's dependency-aware
worker threads (``pipeline.py``).  The JAX package's mesh and multi-host
modules (``xvc_tpu/parallel/mesh.py``, ``multihost.py``) and its encode
pipeline are not ported yet."""
