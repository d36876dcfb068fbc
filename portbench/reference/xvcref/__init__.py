"""A plain host decoder of xvc streams: NumPy and Python, one picture at a
time, CTU by CTU.  A frozen copy of the host decode of the JAX package
beside the port, with its device, native and threaded routes taken out,
so that the benchmark judges the port by a decoder that shares none of
its code and that no change to the program moves.
"""
