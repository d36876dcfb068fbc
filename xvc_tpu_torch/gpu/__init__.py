"""PyTorch device path of the decoder: one module for each module of
``xvc_tpu/tpu/`` on the flat decode path.  Kernel wrappers launch the
hand-written CUDA kernels for tensors on the card and run their plain
PyTorch versions for tensors on the CPU."""
