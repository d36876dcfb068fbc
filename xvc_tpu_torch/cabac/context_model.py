"""CABAC context state initialization (ref:
src/xvc_common_lib/context_model.cc).  Copy of ``init_state`` of
``xvc_tpu/cabac/context_model.py``; the state machine tables live in the
native parse.
"""


def init_state(qp: int, init_value: int) -> int:
    """Map (qp, 8-bit init value) -> context state byte.

    (ref: context_model.cc:30-37)
    """
    slope = (init_value >> 4) * 5 - 45
    offset = ((init_value & 15) << 3) - 16
    st = min(max(1, ((slope * qp) >> 4) + offset), 126)
    mps = 1 if st >= 64 else 0
    return (((st - 64) if mps else (63 - st)) << 1) + mps
