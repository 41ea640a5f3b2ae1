"""Ray generation and NDC warping.

Counterpart of ``nnc_tpu/render/rays.py`` (reference semantics:
framework/nerf_model/run_nerf_helpers.py:71-115). OpenGL-style camera:
x right, y up, z backwards (rays look along -z).
"""
from __future__ import annotations

import numpy as np
import torch


def get_rays(H: int, W: int, K, c2w, device=None):
    """Rays for every pixel. K: (3, 3) intrinsics; c2w: (3, 4) pose.
    Returns (rays_o, rays_d), each (H, W, 3) float32 on ``device``."""
    K = torch.as_tensor(np.asarray(K, np.float32), device=device)
    c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=device)
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=device),
        torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    dirs = torch.stack([(i - K[0, 2]) / K[0, 0],
                        -(j - K[1, 2]) / K[1, 1],
                        -torch.ones_like(i)], dim=-1)
    rays_d = torch.sum(dirs[..., None, :] * c2w[:3, :3], dim=-1)
    rays_o = c2w[:3, -1].expand(rays_d.shape).contiguous()
    return rays_o, rays_d


def get_rays_np(H: int, W: int, K, c2w):
    """numpy twin of :func:`get_rays` (host-side ray pools)."""
    K = np.asarray(K)
    c2w = np.asarray(c2w)
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    dirs = np.stack([(i - K[0, 2]) / K[0, 0],
                     -(j - K[1, 2]) / K[1, 1],
                     -np.ones_like(i)], axis=-1)
    rays_d = np.sum(dirs[..., None, :] * c2w[:3, :3], axis=-1)
    rays_o = np.broadcast_to(c2w[:3, -1], rays_d.shape).copy()
    return rays_o, rays_d


def ndc_rays(H: int, W: int, focal: float, near: float, rays_o, rays_d):
    """Shift rays to the near plane and warp them to normalized device
    coordinates (forward-facing LLFF scenes). Tensors in, tensors out."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * focal)) * \
        (rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (H / (2.0 * focal)) * \
        (rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]

    return torch.stack([o0, o1, o2], dim=-1), torch.stack([d0, d1, d2], dim=-1)
