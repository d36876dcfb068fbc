"""xvc_tpu_torch: the xvc codec's device path in PyTorch and CUDA.

A second package beside ``xvc_tpu`` that stands on its own: it imports
``torch`` and numpy, never ``jax`` and nothing of ``xvc_tpu``.  What it
needs of that package's JAX-free layers (the native CABAC parse,
``codec/``, ``ops/``, ``cabac/``, ``nal``, ``segment``) it keeps as its
own trimmed copies under the same names.

- Decode: real xvc streams through the flat, record-driven
  reconstruction path (``codec.decoder.decode_stream``,
  ``api.DecoderSession``).  Motion compensation, inverse transform, the
  intra scans and the deblock stage (edge decisions, luma walk, chroma
  pass) run as hand-written Hopper kernels (``kernels/csrc``).
- Encoder lookahead: whole-frame open-loop intra SATD cost maps
  (``gpu.lookahead.frame_intra_lookahead``), with the Hadamard SATD as a
  hand-written kernel.
- Encode: ``codec.encoder.encode_stream``, ``api.EncoderSession``; the
  native CTU search codes every picture, and at speed mode 3 the
  device stages feed it: the split DP (``gpu.wavefront_rdo``) and the
  transform-RD intra prepass (``gpu.txrd_prepass``), whose ranking stage
  is a hand-written kernel.

Every entry point runs on the card unless the caller names another
device.  The integer stages are exact, so the float paths that could
round silently (TF32 matmul and convolution) are switched off here once,
for every caller.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
