"""Device selection. The port's main path runs on an NVIDIA GPU."""
from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """The first CUDA device; raises when PyTorch sees none."""
    if not torch.cuda.is_available():
        raise RuntimeError("nnc_tpu_torch needs a CUDA device and PyTorch "
                           "sees none (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means :func:`require_cuda`."""
    return require_cuda() if device is None else torch.device(device)
