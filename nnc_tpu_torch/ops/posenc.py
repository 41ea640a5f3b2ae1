"""Positional encoding (NeRF frequency embedding).

Counterpart of ``nnc_tpu/ops/posenc.py``, with the same channel layout
``[x, sin(x*f0), cos(x*f0), sin(x*f1), cos(x*f1), ...]``, ``f_i = 2**i``:
multires=10 -> 63 channels for xyz, multires_views=4 -> 27 for view dirs.

:func:`integrated_positional_encoding` is mip-NeRF's encoding of a conical
frustum's Gaussian (no counterpart in ``nnc_tpu``), in the same
frequency-by-frequency order.
"""
from __future__ import annotations

import math

import torch

IPE_DEGREES = 16   # mip-NeRF's max_deg_point (min_deg_point 0)
SAFE_SIN_PERIOD = 100 * math.pi


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


def safe_sin(x: torch.Tensor) -> torch.Tensor:
    """sin(x), of ``x % (100 pi)`` where |x| reaches 100 pi, as mip-NeRF's
    ``math.safe_sin`` takes it (``torch.remainder`` has the divisor's sign,
    as jnp's ``%``)."""
    t = SAFE_SIN_PERIOD
    return torch.sin(torch.where(torch.abs(x) < t, x,
                                 torch.remainder(x, t)))


def integrated_positional_encoding(means: torch.Tensor, covs: torch.Tensor,
                                   degrees: int = IPE_DEGREES
                                   ) -> torch.Tensor:
    """mip-NeRF's integrated positional encoding (``mip.integrated_pos_enc``
    with diagonal covariances, no identity): means, covs (..., 3) ->
    (..., 6 * degrees), frequency l's six channels ``[w sin(y), w sin(y +
    pi / 2)]`` of the three coordinates, y = 2^l mean, w = exp(-4^l cov /
    2). mip-NeRF orders the same channels frequency-major, all sines first
    (``models.nerf.IPE_FROM_MIP`` maps one order to the other)."""
    scales = 2.0 ** torch.arange(degrees, dtype=means.dtype,
                                 device=means.device)
    y = means[..., None, :] * scales[:, None]               # (..., L, 3)
    w = torch.exp(-0.5 * (covs[..., None, :] * scales[:, None] ** 2))
    enc = torch.stack([w * safe_sin(y), w * safe_sin(y + 0.5 * math.pi)],
                      dim=-2)                               # (..., L, 2, 3)
    return enc.reshape(*means.shape[:-1], -1)
