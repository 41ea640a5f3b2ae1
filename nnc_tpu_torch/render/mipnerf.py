"""mip-NeRF's renderer: cone casting, the conical frustum's Gaussian, the
blurred resample, compositing and the two-level loss, around one MLP that
serves both levels through K-B1's IPE instantiation.

No counterpart in ``nnc_tpu``: it follows mip-NeRF's published code
(Barron et al., ICCV 2021; github.com/google/mip-nerf ``internal/mip.py``,
``internal/math.py``, ``internal/models.py`` and ``train.py``'s loss, with
``configs/blender.gin``), which ``tests/mipnerf_reference.py`` holds in
plain PyTorch. What differs from it here, and why the results agree:

* the MLP is the port's ``NeRF`` module on ``nerf.MIPNERF``, its inputs in
  the port's channel and skip order (``nerf.from_mipnerf_params`` permutes
  a published tree's rows); on CUDA tensors it runs K-B1's IPE
  instantiation (``mlp_train_fused.fused_ipe_mlp_train``; test views its
  forward without the workspace, ``ipe_mlp_forward``), which embeds the
  frusta itself;
* a scene's rays share one radius, 2 / (sqrt(12) f): a pinhole camera's
  neighbouring rows of directions lie 1 / f apart (the published loader
  measures that distance per pixel);
* the inverse CDF finds each draw's interval with ``torch.searchsorted``
  where the published code takes the max and min over a mask of every
  (draw, edge) pair: the same interval, since the CDF and the bins are
  sorted;
* the random draws (``t_rand``, the stratified jitter, and ``u``, the
  resample's, both U(0, 1) of shape (rays, num_samples + 1)) come from a
  ``torch.Generator`` (:func:`step_draws`) or are given, as the port's
  other draws are.

While a torch profiler records, a level's phases are the spans
``nnc.mip.cast`` (sampling and the frusta's Gaussians), ``nnc.mip.resample``
(the blurred inverse CDF of the fine level) and ``nnc.mip.composite`` (the
activations and compositing); on the card a training step records them
where it runs eagerly (its first step) and at the graph's capture.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models import nerf
from ..ops import mlp_train_fused
from ..ops.posenc import integrated_positional_encoding, positional_encoding
from ..utils import profiling

EPS32 = float(np.finfo(np.float32).eps)
# configs/blender.gin and MipNerfModel's defaults, which the port runs as
# published: two levels, the IPE of degrees 0..16 (K-B1's IPE stage), posenc
# 4 of the view directions, the resample's padding, the density's bias, the
# colour's padding and the coarse level's weight in the loss
PUBLISHED = {"num_levels": 2, "min_deg_point": 0, "max_deg_point": 16,
             "deg_view": 4, "resample_padding": 0.01, "density_bias": -1.0,
             "rgb_padding": 0.001, "coarse_loss_mult": 0.1}
NUM_LEVELS = PUBLISHED["num_levels"]
RESAMPLE_PADDING = PUBLISHED["resample_padding"]
DENSITY_BIAS = PUBLISHED["density_bias"]
RGB_PADDING = PUBLISHED["rgb_padding"]
COARSE_LOSS_MULT = PUBLISHED["coarse_loss_mult"]


@dataclasses.dataclass(frozen=True)
class MipRenderConfig:
    """mip-NeRF's render settings: ``num_samples`` a level (128 published),
    ``pixel_radius`` the rays' base radius, 2 / (sqrt(12) f), ``chunk`` the
    rays a test view renders at once, ``use_fused_train`` the MLP through
    K-B1 on CUDA tensors."""
    mlp: nerf.NeRFConfig = nerf.MIPNERF
    num_samples: int = 128
    white_bkgd: bool = True
    pixel_radius: float = 2 / (math.sqrt(12) * 1111.1110311937682)
    chunk: int = 4096
    use_fused_train: bool = True

    def __post_init__(self):
        if self.mlp.input_ch != 96 or self.mlp.input_ch_views != 27:
            raise ValueError(f"mip-NeRF's MLP takes 96 + 27 input channels, "
                             f"not {self.mlp.input_ch} + "
                             f"{self.mlp.input_ch_views}")


def is_mip(rc) -> bool:
    return isinstance(rc, MipRenderConfig)


def make_render_config(scene: dict, mlp_config=None,
                       use_fused_mlp: bool = True) -> MipRenderConfig:
    """The configuration of a mip-NeRF scene (``scene["mip"]``: the config
    file's mip-NeRF keys, ``presets.load_scene_from_config``); a key of
    :data:`PUBLISHED` set to another value raises."""
    mip = dict(scene.get("mip", {}))
    for key, value in PUBLISHED.items():
        if key in mip and mip.pop(key) != value:
            raise ValueError(f"mip-NeRF's {key} runs as published ({value})")
    focal = float(np.asarray(scene["K"])[0][0])
    return MipRenderConfig(
        mlp=mlp_config or nerf.MIPNERF,
        white_bkgd=bool(scene.get("white_bkgd", True)),
        pixel_radius=2 / (math.sqrt(12) * focal),
        use_fused_train=use_fused_mlp, **mip)


# ------------------------------------------------------------------ cones
def conical_frustum_to_gaussian(d, t0, t1, base_radius):
    """(means along d, diagonal covariances) of the frusta between t0 and t1
    (the published stable form); d (R, 3), t0 / t1 (R, S)."""
    mu = (t0 + t1) / 2
    hw = (t1 - t0) / 2
    t_mean = mu + (2 * mu * hw ** 2) / (3 * mu ** 2 + hw ** 2)
    t_var = (hw ** 2) / 3 - (4 / 15) * ((hw ** 4 * (12 * mu ** 2 - hw ** 2))
                                        / (3 * mu ** 2 + hw ** 2) ** 2)
    r_var = base_radius ** 2 * ((mu ** 2) / 4 + (5 / 12) * hw ** 2
                                - 4 / 15 * (hw ** 4) / (3 * mu ** 2 + hw ** 2))
    mean = d[..., None, :] * t_mean[..., None]
    d_mag_sq = torch.clamp(torch.sum(d ** 2, -1, keepdim=True), min=1e-10)
    d_outer = d ** 2
    null_outer = 1 - d_outer / d_mag_sq
    cov = t_var[..., None] * d_outer[..., None, :] + \
        r_var[..., None] * null_outer[..., None, :]
    return mean, cov


def cast(t_vals, rays_o, rays_d, radius: float):
    """(means, covs) (R, S, 3) of the cones' frusta between consecutive
    ``t_vals`` (R, S + 1)."""
    means, covs = conical_frustum_to_gaussian(
        rays_d, t_vals[..., :-1], t_vals[..., 1:], radius)
    return means + rays_o[..., None, :], covs


def stratified(near, far, n_edges: int, n_rays: int, t_rand, device):
    """(R, n_edges) interval edges between near and far, jittered within
    their strata by ``t_rand`` (None: the deterministic sweep)."""
    t = torch.linspace(0., 1., n_edges, device=device)
    t = (near * (1. - t) + far * t).expand(n_rays, n_edges)
    if t_rand is None:
        return t
    mids = 0.5 * (t[..., 1:] + t[..., :-1])
    upper = torch.cat([mids, t[..., -1:]], -1)
    lower = torch.cat([t[..., :1], mids], -1)
    return lower + (upper - lower) * t_rand


def resample(t_vals, weights, u=None):
    """The fine level's edges (R, S + 1): the coarse weights blurred (max
    over neighbours, mean of neighbours) plus the padding, inverted as a
    piecewise-constant pdf over ``t_vals`` at S + 1 stratified draws
    (``u`` (R, S + 1) U(0, 1); None: evenly over [0, 1 - eps]). No
    gradient passes."""
    with torch.no_grad():
        wp = torch.cat([weights[..., :1], weights, weights[..., -1:]], -1)
        wmax = torch.maximum(wp[..., :-1], wp[..., 1:])
        w = 0.5 * (wmax[..., :-1] + wmax[..., 1:]) + RESAMPLE_PADDING
        eps = 1e-5
        w_sum = torch.sum(w, -1, keepdim=True)
        pad = torch.clamp(eps - w_sum, min=0)
        w = w + pad / w.shape[-1]
        pdf = w / (w_sum + pad)
        cdf = torch.clamp(torch.cumsum(pdf[..., :-1], -1), max=1)
        cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf,
                         torch.ones_like(cdf[..., :1])], -1)
        n = t_vals.shape[-1]
        if u is not None:
            s = 1 / n
            uu = torch.arange(n, dtype=cdf.dtype, device=cdf.device) * s
            uu = torch.clamp(uu + u * (s - EPS32), max=1. - EPS32)
        else:
            uu = torch.linspace(0., 1. - EPS32, n, device=cdf.device)
            uu = uu.expand(cdf.shape[0], n)
        # the last edge at or below each draw, and the first above it
        above = torch.searchsorted(cdf, uu.contiguous(), right=True)
        below = above - 1
        above = torch.clamp(above, max=cdf.shape[-1] - 1)
        c0, c1 = cdf.gather(-1, below), cdf.gather(-1, above)
        b0, b1 = t_vals.gather(-1, below), t_vals.gather(-1, above)
        t = torch.clamp(torch.nan_to_num((uu - c0) / (c1 - c0), 0), 0, 1)
        return b0 + t * (b1 - b0)


def composite(raw, t_vals, rays_d, rc: MipRenderConfig):
    """(rgb (R, 3), acc (R,), weights (R, S)) of raw (R, S, 4): mip-NeRF's
    activations (rgb padded, density softplus(raw - 1)) and its compositing
    (deltas t[i+1] - t[i] times |d|, transmittance exp(-cumsum))."""
    rgb = torch.sigmoid(raw[..., :3]) * (1 + 2 * RGB_PADDING) - RGB_PADDING
    density = F.softplus(raw[..., 3] + DENSITY_BIAS)
    delta = (t_vals[..., 1:] - t_vals[..., :-1]) * \
        torch.linalg.norm(rays_d[..., None, :], dim=-1)
    dd = density * delta
    alpha = 1 - torch.exp(-dd)
    trans = torch.exp(-torch.cat([torch.zeros_like(dd[..., :1]),
                                  torch.cumsum(dd[..., :-1], -1)], -1))
    w = alpha * trans
    comp = (w[..., None] * rgb).sum(-2)
    acc = w.sum(-1)
    if rc.white_bkgd:
        comp = comp + (1. - acc[..., None])
    return comp, acc, w


# ----------------------------------------------------------------- levels
def _query(model, means, covs, viewdirs, rc, train: bool):
    vd = viewdirs[:, None, :]
    if train and rc.use_fused_train:
        return mlp_train_fused.fused_ipe_mlp_train(model, means, covs, vd)
    if not train and rc.use_fused_train:
        return mlp_train_fused.ipe_mlp_forward(model, means, covs, vd)
    return nerf.apply_mlp(
        model, integrated_positional_encoding(means, covs),
        positional_encoding(torch.broadcast_to(vd, means.shape), 4),
        output_scaling=True)


def render_rays(model, rays_o, rays_d, viewdirs, near, far,
                rc: MipRenderConfig, t_rand=None, u=None,
                train: bool = True):
    """Both levels of mip-NeRF's render of (R,) rays through one MLP:
    [(rgb, acc, weights, t_vals)] coarse, then fine. ``t_rand`` / ``u``:
    the draws of a randomized render; None, None: the deterministic one."""
    out, t_vals, w = [], None, None
    R = rays_o.shape[0]
    for level in range(NUM_LEVELS):
        if level == 0:
            with profiling.span("nnc.mip.cast"):
                t_vals = stratified(near, far, rc.num_samples + 1, R, t_rand,
                                    rays_o.device)
                means, covs = cast(t_vals, rays_o, rays_d, rc.pixel_radius)
        else:
            with profiling.span("nnc.mip.resample"):
                t_vals = resample(t_vals, w.detach(), u)
                means, covs = cast(t_vals, rays_o, rays_d, rc.pixel_radius)
        raw = _query(model, means, covs, viewdirs, rc, train)
        with profiling.span("nnc.mip.composite"):
            rgb, acc, w = composite(raw, t_vals, rays_d, rc)
        out.append((rgb, acc, w, t_vals))
    return out


def step_draws(n_rays: int, rc: MipRenderConfig, generator: torch.Generator,
               device=None) -> dict:
    """The draws of one training render of ``n_rays`` rays, in the order
    :func:`mip_loss` takes them: ``t_rand``, then ``u``, each (rays,
    num_samples + 1) U(0, 1)."""
    shape = (n_rays, rc.num_samples + 1)
    return {k: torch.rand(shape, generator=generator, device=device)
            for k in ("t_rand", "u")}


def mip_loss(model, _model_fine, rays_o, rays_d, viewdirs, target, near,
             far, rc: MipRenderConfig, draws: Optional[dict] = None,
             generator: Optional[torch.Generator] = None):
    """mip-NeRF's training loss in ``lsa.double_mse_loss``'s signature (the
    second model is None: one MLP serves both levels): (loss, the fine
    level's). A level's loss is its squared error summed over the three
    channels and averaged over the rays (train.py, a mask of ones);
    loss = coarse_loss_mult * coarse + fine. ``draws``: ``t_rand`` / ``u``,
    the rest from ``generator``."""
    d = {k: v for k, v in (draws or {}).items() if v is not None}
    if "t_rand" not in d or "u" not in d:
        d = {**step_draws(rays_o.shape[0], rc, generator, rays_o.device), **d}
    if viewdirs is None:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    levels = render_rays(model, rays_o, rays_d, viewdirs, near, far, rc,
                         d["t_rand"], d["u"])
    losses = [((rgb - target) ** 2).sum(-1).mean() for rgb, *_ in levels]
    return COARSE_LOSS_MULT * sum(losses[:-1]) + losses[-1], losses[-1]


@torch.no_grad()
def render_image(model, rays_o, rays_d, near, far, rc: MipRenderConfig,
                 viewdirs=None, device=None):
    """The deterministic two-level render of (N, 3) or (H, W, 3) rays (numpy
    or tensors) in chunks of ``rc.chunk`` rays, the MLP through K-B1's IPE
    forward without its workspace on CUDA: {"rgb_map", "acc_map"} of the
    fine level on ``device`` (default: the model's), leading shape as the
    input's. A ``nnc.render.view`` request span while a profiler records."""
    device = torch.device(device) if device is not None else model.device
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32)
                                     if not torch.is_tensor(a) else a,
                                     dtype=torch.float32, device=device)
    lead = tuple(rays_o.shape[:-1])
    with profiling.request("nnc.render.view", rays=math.prod(lead)):
        ro = as_t(rays_o).reshape(-1, 3)
        rd = as_t(rays_d).reshape(-1, 3)
        vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True) \
            if viewdirs is None else as_t(viewdirs).reshape(-1, 3)
        rgbs, accs = [], []
        for s in range(0, ro.shape[0], rc.chunk):
            rgb, acc, _w, _t = render_rays(
                model, ro[s:s + rc.chunk], rd[s:s + rc.chunk],
                vd[s:s + rc.chunk], near, far, rc, train=False)[-1]
            rgbs.append(rgb)
            accs.append(acc)
        return {"rgb_map": torch.cat(rgbs).reshape(*lead, 3),
                "acc_map": torch.cat(accs).reshape(lead)}
