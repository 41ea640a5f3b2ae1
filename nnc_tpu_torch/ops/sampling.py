"""Ray sampling: stratified coarse samples + inverse-CDF importance sampling.

Counterpart of ``nnc_tpu/ops/sampling.py`` (reference semantics:
framework/nerf_model/run_nerf.py:378-408 stratified;
run_nerf_helpers.py:119-163 sample_pdf). The random draws are arguments:
pass ``t_rand`` / ``u`` to reproduce a given draw, or a ``generator``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _linspace01(n: int, device=None) -> torch.Tensor:
    """linspace(0, 1, n) in float32, rounded as the reference's (numpy's and
    XLA's) linspace rounds it; torch.linspace differs in the last bit."""
    return torch.from_numpy(np.linspace(np.float32(0.0), np.float32(1.0), n,
                                        dtype=np.float32)).to(device)


def _cumsum_f32(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right running float32 sum over the last axis, as the
    reference rounds it. (torch.cumsum accumulates in float64 on the CPU:
    sample_pdf's ``denom < 1e-5`` test flips on such last-bit differences
    and moves whole samples.)"""
    acc = x[..., 0]
    out = [acc]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
        out.append(acc)
    return torch.stack(out, dim=-1)


def stratified_samples(near, far, n_samples: int, n_rays: int,
                       perturb: bool, lindisp: bool = False,
                       t_rand: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       device=None):
    """z_vals: (n_rays, n_samples). near/far: scalars or (n_rays, 1).
    ``t_rand`` (n_rays, n_samples) in [0, 1) is the stratified jitter."""
    t_vals = _linspace01(n_samples, device)
    near = torch.as_tensor(near, dtype=torch.float32,
                           device=device).expand(n_rays, 1)
    far = torch.as_tensor(far, dtype=torch.float32,
                          device=device).expand(n_rays, 1)
    if lindisp:
        z_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    else:
        z_vals = near * (1.0 - t_vals) + far * t_vals
    if perturb:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], -1)
        lower = torch.cat([z_vals[..., :1], mids], -1)
        if t_rand is None:
            t_rand = torch.rand(z_vals.shape, generator=generator,
                                device=device)
        z_vals = lower + (upper - lower) * t_rand
    return z_vals


def sample_pdf(bins, weights, n_samples: int, det: bool,
               u: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
    """Inverse-CDF sampling of ``n_samples`` new z values per ray.

    bins: (R, B+1) bin edges, weights: (R, B). ``u`` (R, n_samples) overrides
    the uniform draw (``det`` uses ``linspace(0, 1)``). Returns
    (R, n_samples)."""
    weights = weights + 1e-5
    pdf = weights / _cumsum_f32(weights)[..., -1:]
    cdf = _cumsum_f32(pdf)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)  # (R, B+1)

    shape = cdf.shape[:-1] + (n_samples,)
    if u is None:
        if det:
            u = _linspace01(n_samples, cdf.device).expand(shape)
        else:
            u = torch.rand(shape, generator=generator, device=cdf.device)
    u = u.contiguous()

    # index of the last cdf entry <= u, and the next one (clamped at the
    # ends): the bracketing values of the comparison form in the reference
    idx = torch.searchsorted(cdf, u, right=True)
    below = torch.clamp(idx - 1, min=0)
    above = torch.clamp(idx, max=cdf.shape[-1] - 1)
    cdf_g0 = torch.gather(cdf, -1, below)
    cdf_g1 = torch.gather(cdf, -1, above)
    bins_g0 = torch.gather(bins, -1, below)
    bins_g1 = torch.gather(bins, -1, above)

    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_g0) / denom
    return bins_g0 + t * (bins_g1 - bins_g0)
