"""Positional encoding (NeRF frequency embedding).

Counterpart of ``nnc_tpu/ops/posenc.py``, with the same channel layout
``[x, sin(x*f0), cos(x*f0), sin(x*f1), cos(x*f1), ...]``, ``f_i = 2**i``:
multires=10 -> 63 channels for xyz, multires_views=4 -> 27 for view dirs.
"""
from __future__ import annotations

import torch


def positional_encoding(x: torch.Tensor, multires: int,
                        include_input: bool = True) -> torch.Tensor:
    """Encode the last axis. x: (..., D) -> (..., D*(include+2*multires))."""
    if multires == 0:
        return x
    freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]                  # (..., F, D)
    enc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)
    enc = enc.reshape(*x.shape[:-1], -1)                   # (..., F*2*D)
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc
