"""Device selection for the PyTorch device path.

Counterpart of ``xvc_tpu/engine.py``: every entry point runs on the card
unless the caller names another device, and a device that is not there
is an error, never a silent move to the CPU.  Of that module's switches
it keeps ``XVC_ME`` (``use_device_me``), ``XVC_INTRA_PREPASS``
(``use_jax_intra_prepass``) and ``XVC_PIC_NATIVE``
(``use_native_pic_decode``); the encoder's other routing switches are
read where they route (``native/enc.usable_for``).  It also keeps the
installed mesh (``set_mesh``, module-wide) and the thread's pin
(``set_pin_device``, thread-local), from ``xvc_tpu/engine.py:42-73``:
both are slots of ``parallel/mesh.py``, not devices.
"""
import os
import threading

import torch

_mesh = None
_tls = threading.local()


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


def use_device_me():
    """``XVC_ME=jax`` runs the fullpel SAD sweeps of the Python CU
    encoder's TZ search on the encoder's device (``gpu/me.py``, kernel
    ``me_sad.cu`` on the card); the value is ``jax`` for parity with the
    JAX package's switch of the same name (``xvc_tpu/engine.py``
    ``use_jax_me``), and the streams are the same bytes either way."""
    return os.environ.get("XVC_ME", "").lower() == "jax"


def use_jax_intra_prepass():
    """``XVC_INTRA_PREPASS=jax``, the JAX package's switch of its per-CU
    device SATD pre-pass: it routes a session to the Python CU encoder
    (``native/enc.usable_for``), and in a picture of CTU tile rows the
    pre-pass then reads the above row across the tile top, as the JAX
    package's device pre-pass does (``codec/intra_search.py``)."""
    return os.environ.get("XVC_INTRA_PREPASS", "").lower() == "jax"


def use_native_pic_decode():
    """The native parse of a picture (``native/pic.parse_picture``), on
    by default.  ``XVC_PIC_NATIVE=0``, the JAX package's switch of the
    same name (``xvc_tpu/engine.py``), parses every picture with the
    Python parse (``codec/cu_decoder.py``, ``syntax/reader.py``), as a
    picture above 14 bit always is; the reconstruction then takes the
    replay path on the device."""
    return os.environ.get("XVC_PIC_NATIVE", "1") != "0"


def set_mesh(mesh):
    """Install a ``parallel.mesh.Mesh`` (None removes it): with no pin,
    the lookahead shards its block batches over the mesh's slots and the
    replay path its ITX and MC jobs; a decode pins each picture to a
    slot, and a threaded encode each in-flight picture."""
    global _mesh
    _mesh = mesh


def get_mesh():
    return _mesh


def set_pin_device(slot):
    """Pin this thread's device stages to one slot of the mesh (None
    removes the pin).  The GOP-across-devices pipelines (the mesh analog
    of the reference's picture-level thread pools, ref:
    src/xvc_enc_lib/thread_encoder.cc:99-158) give each in-flight picture
    a slot; its stages then run on the slot's device and stream and read
    and write the slot's frame store.  Thread-local, so workers carry
    their own pins.  A pin takes precedence over block-level sharding:
    with pictures in flight, the picture is the shard."""
    _tls.slot = slot


def get_pin_device():
    return getattr(_tls, "slot", None)


def mesh_for(device):
    """The installed mesh for a session on ``device``, or None.  Raises
    RuntimeError (which no decoder takes for a damaged picture) if the
    mesh's slots are of another device type than ``device``."""
    mesh = _mesh
    if mesh is not None and mesh.device_type != torch.device(device).type:
        raise RuntimeError(
            "the mesh's slots are %s devices but the session runs on %s"
            % (mesh.device_type, torch.device(device)))
    return mesh


def pin_for(device):
    """This thread's pin for a session on ``device``, or None.  Raises
    if the pin is a slot of another device type than ``device``."""
    pin = get_pin_device()
    if pin is not None and pin.device.type != torch.device(device).type:
        raise RuntimeError("the pinned slot is on %s but the session runs "
                           "on %s" % (pin.device, torch.device(device)))
    return pin
