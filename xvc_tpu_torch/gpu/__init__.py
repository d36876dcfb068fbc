"""PyTorch device path: one module for each ported module of
``xvc_tpu/tpu/``.  Kernel wrappers launch the hand-written CUDA kernels
for tensors on the card and run their plain PyTorch versions for tensors
on the CPU."""
