"""xvc_tpu_torch: the xvc decoder's device path in PyTorch and CUDA.

A second package beside ``xvc_tpu``.  It reuses the JAX-free layers of
``xvc_tpu`` by import (native CABAC parse, ``codec/``, ``ops/``,
``cabac/``, ``nal``, ``segment``) and decodes real xvc streams through
the flat, record-driven reconstruction path on an explicit
``torch.device``.  On ``cuda`` the motion compensation, inverse
transform and luma deblock stages run as hand-written Hopper kernels
(``kernels/csrc``); every other stage is plain PyTorch.

This package never imports jax.  Its integer stages are exact, so the
float paths that could round silently (TF32 matmul and convolution) are
switched off here once, for every caller.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
