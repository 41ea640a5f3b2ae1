"""The device a command line tool runs on, chosen from the environment.

Counterpart of ``nnc_tpu/utils/platform.py``. There the environment names
the JAX platform; what that means for the port is the choice of device:
``NNC_TPU_TORCH_DEVICE`` names it (``cpu`` runs the kernels' plain
versions), else the first CUDA device, which must exist. The port's CLI
(``compress_nerf.py``) and its tools call :func:`device_from_env`; the
library takes an explicit ``device`` and reads no environment. The tools
print :func:`card_line` beside the numbers they measure.
"""
from __future__ import annotations

import os
import subprocess

import torch

from .device import resolve_device

DEVICE_ENV = "NNC_TPU_TORCH_DEVICE"


def device_from_env() -> torch.device:
    """The device ``NNC_TPU_TORCH_DEVICE`` names, else ``require_cuda()``."""
    return resolve_device(os.environ.get(DEVICE_ENV) or None)


def card_line(device=None) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them (one line a card);
    ``device: cpu`` where ``device`` is not a CUDA device."""
    if device is not None and torch.device(device).type != "cuda":
        return f"device: {device}"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
