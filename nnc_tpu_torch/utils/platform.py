"""The device a command line tool runs on, chosen from the environment.

Counterpart of ``nnc_tpu/utils/platform.py``. There the environment names
the JAX platform; what that means for the port is the choice of device:
``NNC_TPU_TORCH_DEVICE`` names it (``cpu`` runs the kernels' plain
versions), else the first CUDA device, which must exist. The port's CLI
(``compress_nerf.py``) and its tools call :func:`device_from_env`; the
library takes an explicit ``device`` and reads no environment.
"""
from __future__ import annotations

import os

import torch

from .device import resolve_device

DEVICE_ENV = "NNC_TPU_TORCH_DEVICE"


def device_from_env() -> torch.device:
    """The device ``NNC_TPU_TORCH_DEVICE`` names, else ``require_cuda()``."""
    return resolve_device(os.environ.get(DEVICE_ENV) or None)
