"""Device selection for the PyTorch device path.

Counterpart of ``xvc_tpu/engine.py``, without its environment switches:
every entry point runs on the card unless the caller names another
device, and a device that is not there is an error, never a silent move
to the CPU.
"""
import torch


def resolve_device(device):
    """Return the ``torch.device`` for ``device`` (None for the card,
    "cpu", "cuda", "cuda:N" or a ``torch.device``).  Raises if CUDA is
    asked for and no card is visible, or for any other device type."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device %r requested but torch.cuda.is_available() is "
                "False" % (str(dev),))
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError("unsupported device %r (cpu or cuda only)" % (dev,))
