"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the
full power limit of 700 W)."""
HBM_BYTES_PER_S = 3.35e12
