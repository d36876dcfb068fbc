"""Decoder entry points of the PyTorch device path (subclasses of the
``xvc_tpu.codec`` session and picture decoder)."""
