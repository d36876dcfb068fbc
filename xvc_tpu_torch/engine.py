"""Device selection for the PyTorch decode path.

Counterpart of ``xvc_tpu/engine.py``, without its environment switches:
the caller names the device, and a device that is not there is an
error, never a silent move to the CPU.
"""
import torch


def resolve_device(device):
    """Return the ``torch.device`` for ``device`` ("cpu", "cuda",
    "cuda:N" or a ``torch.device``).  Raises if CUDA is asked for and no
    card is visible, or for any other device type."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device %r requested but torch.cuda.is_available() is "
                "False" % (str(device),))
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError("unsupported device %r (cpu or cuda only)" % (dev,))
