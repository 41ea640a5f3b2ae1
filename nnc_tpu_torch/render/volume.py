"""Volume rendering: raw MLP outputs -> composited rgb/disp/acc/depth maps.

Counterpart of ``nnc_tpu/render/volume.py`` (reference semantics:
framework/nerf_model/run_nerf.py:285-345 raw2outputs), including its
``1 - alpha + 1e-10`` cumprod.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def raw2outputs(raw, z_vals, rays_d, raw_noise_std: float = 0.0,
                white_bkgd: bool = False,
                noise: Optional[torch.Tensor] = None, dists=None):
    """Composite raw predictions along rays.

    raw: (R, S, 4); z_vals: (R, S); rays_d: (R, 3). ``noise`` (R, S) is the
    standard-normal sigma noise, scaled by ``raw_noise_std`` and added only
    when given (the reference adds it only to training renders). ``dists``
    overrides the per-sample integration span.
    Returns dict(rgb_map, disp_map, acc_map, weights, depth_map)."""
    if dists is None:
        dists = z_vals[..., 1:] - z_vals[..., :-1]
        dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], -1)
    dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)

    rgb = torch.sigmoid(raw[..., :3])
    sigma = raw[..., 3]
    if raw_noise_std > 0.0 and noise is not None:
        sigma = sigma + raw_noise_std * noise

    alpha = 1.0 - torch.exp(-F.relu(sigma) * dists)              # (R, S)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]),
                   1.0 - alpha + 1e-10], -1), -1)[..., :-1]
    weights = alpha * trans

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    disp_map = 1.0 / torch.clamp(
        depth_map / torch.clamp(acc_map, min=1e-10), min=1e-10)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])

    return {"rgb_map": rgb_map, "disp_map": disp_map, "acc_map": acc_map,
            "weights": weights, "depth_map": depth_map}
