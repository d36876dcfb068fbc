"""The port's command-line apps, copies of ``cli/``'s on this package:

    python -m xvc_tpu_torch.cli.xvcenc -input-file in.yuv ... -threads 4
    python -m xvc_tpu_torch.cli.xvcdec -bitstream-file out.xvc ...

They take the reference apps' arguments (those of ``cli/xvcenc.py`` and
``cli/xvcdec.py``) and ``-device`` (default: the card; ``cpu`` runs the
device stages' plain versions).
"""
