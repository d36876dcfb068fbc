"""Decoder session, picture decoder and their host-side helpers (frame
store, checksum, output conversion, reference lists) of the PyTorch
device path."""
