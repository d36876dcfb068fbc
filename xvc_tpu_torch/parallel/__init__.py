"""Picture-level and multi-device parallelism: the decoder's and the
encoder's dependency-aware worker threads (``pipeline.py``), meshes of
slots and the sharded lookahead (``mesh.py``), and the processes of a
``torch.distributed`` group (``multihost.py``).

The mesh and multi-process names are exported lazily, as in
``xvc_tpu/parallel/__init__.py``: ``from xvc_tpu_torch import parallel;
parallel.make_mesh(...)``.
"""


def __getattr__(name):
    if name in ("make_mesh", "make_sharded_intra_satd_fn", "shard_count"):
        from . import mesh
        return getattr(mesh, name)
    if name in ("init", "global_mesh", "is_multiprocess"):
        from . import multihost
        return getattr(multihost, name)
    raise AttributeError(name)
