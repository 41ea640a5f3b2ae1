"""mip-NeRF 360's renderer: disparity-spaced intervals, proposal resampling
with dilated step functions, conical frusta warped by scene contraction and
lifted onto an icosahedron's directions, the integrated positional
encoding, opaque-background compositing and the three-term loss, around two
MLPs (``models/mipnerf360.py``) whose layers run as GEMMs and K-B7.

No counterpart in ``nnc_tpu``: it follows mip-NeRF 360's published code
(Barron et al., CVPR 2022; github.com/google-research/multinerf
``internal/models.py``, ``stepfun.py``, ``coord.py``, ``geopoly.py``,
``render.py`` and ``train_utils.py``, with ``configs/360.gin``), which
``benchmark/reference/mipnerf360.py`` holds in plain PyTorch. A ray's three
levels:

* distances s in [0, 1] map to t = 1 / (s / far + (1 - s) / near);
* level 0 (the proposal MLP) draws 64 intervals from the flat step function
  on [0, 1]; level 1 (the same MLP) dilates level 0's step function by
  0.0025 + 0.5 / 64 (``max_dilate_weights``: the pdf's max over the
  intervals that cover each point, renormalised, the first and last edge
  dropped) and draws 64; level 2 (the NeRF MLP) dilates by 0.0025 + 0.5 /
  4096 and draws 32. A draw takes n centres from the inverse CDF at
  j (1 - u_max) / (n - 1) plus one jitter a ray (:func:`sample_intervals`),
  the edges their midpoints, the first and last reflected and clipped to
  [0, 1]; no gradient passes through s;
* each interval's conical frustum (full 3 x 3 covariance) is warped by
  contract(x) = x inside the unit ball, ((2|x| - 1) / |x|^2) x outside, its
  covariance by J cov J^T applied as the published code's two Jacobian-
  vector passes (the expanded product loses every bit far out), projected
  onto the 21 directions of :func:`generate_basis` and encoded at degrees
  0..11 (504 channels);
* weights alpha_i T_i with the last interval's alpha 1 (opaque background);
  the loss is the Charbonnier data loss of the NeRF level, the interlevel
  loss of both proposal levels against it and 0.01 times its distortion.

Departures, all stated in ``benchmark/configs/mip360-garden.json``'s
``assumed``: a scene's rays share one radius, 2 / (sqrt(12) f), where the
published loader measures the distance between neighbouring directions per
pixel (equal for a pinhole camera); the basis projection and J cov J^T are
written as element-wise sums, so that no GEMM runs outside the MLPs; the
random draws, one U(0, 1) jitter a ray and level, come from a
``torch.Generator`` (:func:`step_draws`) or are given.

While a torch profiler records, a level's phases are the spans
``nnc.m360.dilate``, ``nnc.m360.resample``, ``nnc.m360.contract`` (casting,
contraction, the basis and the encoding), ``nnc.m360.mlp`` (counts
``level`` and ``points``) and ``nnc.m360.loss``; on the card a training step
records them where it runs eagerly (its first step) and at the graph's
capture.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models import mipnerf360 as m360
from ..utils import profiling

EPS32 = float(np.finfo(np.float32).eps)
# configs/360.gin and multinerf's Model / MLP / Config defaults, which the
# port runs as published
PUBLISHED = {"num_levels": 3, "num_prop_samples": 64, "num_nerf_samples": 32,
             "dilation_bias": 0.0025, "dilation_multiplier": 0.5,
             "resample_padding": 0.0, "min_deg_point": 0, "max_deg_point": 12,
             "deg_view": 4, "density_bias": -1.0, "rgb_padding": 0.001,
             "charb_padding": 0.001, "interlevel_loss_mult": 1.0,
             "distortion_loss_mult": 0.01, "basis_subdivisions": 2}
NUM_LEVELS = PUBLISHED["num_levels"]
DILATION_BIAS = PUBLISHED["dilation_bias"]
DILATION_MULTIPLIER = PUBLISHED["dilation_multiplier"]
RESAMPLE_PADDING = PUBLISHED["resample_padding"]
DENSITY_BIAS = PUBLISHED["density_bias"]
RGB_PADDING = PUBLISHED["rgb_padding"]
MIN_DEG_POINT = PUBLISHED["min_deg_point"]
DEG_VIEW = PUBLISHED["deg_view"]
CHARB_PADDING = PUBLISHED["charb_padding"]
INTERLEVEL_LOSS_MULT = PUBLISHED["interlevel_loss_mult"]
DISTORTION_LOSS_MULT = PUBLISHED["distortion_loss_mult"]


@dataclasses.dataclass(frozen=True)
class Mip360RenderConfig:
    """mip-NeRF 360's render settings: the two MLPs, the samples of a
    proposal level and of the NeRF level, the encoding's degrees
    [0, max_deg_point) over the basis, the rays' base radius 2 / (sqrt(12)
    f), ``chunk`` the rays a test view renders at once."""
    prop: m360.MLP360Config = m360.PROP_MLP
    nerf: m360.MLP360Config = m360.NERF_MLP
    num_prop_samples: int = 64
    num_nerf_samples: int = 32
    max_deg_point: int = 12
    pixel_radius: float = 2 / (math.sqrt(12) * 1000.0)
    chunk: int = 8192

    def __post_init__(self):
        ipe = 2 * len(BASIS) * (self.max_deg_point - MIN_DEG_POINT)
        views = 3 + 6 * DEG_VIEW
        for mlp in (self.prop, self.nerf):
            if mlp.input_ch != ipe:
                raise ValueError(f"an MLP of mip-NeRF 360 takes the {ipe} "
                                 f"encoded channels, not {mlp.input_ch}")
        if not self.nerf.rgb or self.prop.rgb or \
                self.nerf.views_ch != views:
            raise ValueError("mip-NeRF 360 has a density-only proposal MLP "
                             f"and a NeRF MLP with rgb on {views} view "
                             "channels")


def is_mip360(rc) -> bool:
    return isinstance(rc, Mip360RenderConfig)


def make_render_config(scene: dict, chunk: int = 8192) -> Mip360RenderConfig:
    """The configuration of a mip-NeRF 360 scene (``scene["mip360"]``: the
    config file's keys, ``presets.load_scene_from_config``); a key of
    :data:`PUBLISHED` set to another value raises."""
    keys = dict(scene.get("mip360", {}))
    for key, value in PUBLISHED.items():
        if key in keys and keys.pop(key) != value:
            raise ValueError(f"mip-NeRF 360's {key} runs as published "
                             f"({value})")
    if keys:
        raise ValueError(f"unknown mip-NeRF 360 keys {sorted(keys)}")
    if scene.get("ndc", False):
        raise ValueError("mip-NeRF 360 contracts unbounded scenes: no NDC "
                         "or forward-facing rays")
    focal = float(np.asarray(scene["K"])[0][0])
    return Mip360RenderConfig(pixel_radius=2 / (math.sqrt(12) * focal),
                              chunk=chunk)


# ------------------------------------------------------------------ basis
def generate_basis(subdivisions: int = 2) -> np.ndarray:
    """(21, 3) for 2 subdivisions: the unit vertices of an icosahedron whose
    faces are tessellated ``subdivisions`` to an edge, one of each antipodal
    pair, in geopoly.generate_basis's order (its ``verts[:, ::-1]``)."""
    a = (np.sqrt(5) + 1) / 2
    verts = np.array([(-1, 0, a), (1, 0, a), (-1, 0, -a), (1, 0, -a),
                      (0, a, 1), (0, a, -1), (0, -a, 1), (0, -a, -1),
                      (a, 1, 0), (-a, 1, 0), (a, -1, 0), (-a, -1, 0)]) \
        / np.sqrt(a + 2)
    faces = np.array([(0, 4, 1), (0, 9, 4), (9, 5, 4), (4, 5, 8), (4, 8, 1),
                      (8, 10, 1), (8, 3, 10), (5, 3, 8), (5, 2, 3),
                      (2, 7, 3), (7, 10, 3), (7, 6, 10), (7, 11, 6),
                      (11, 0, 6), (0, 1, 6), (6, 1, 10), (9, 0, 11),
                      (9, 11, 2), (9, 2, 5), (7, 2, 11)])
    v = subdivisions
    bary = np.array([(i, j, v - i - j) for i in range(v + 1)
                     for j in range(v + 1 - i)]) / v
    tess = []
    for face in faces:
        new = bary @ verts[face]
        tess.append(new / np.sqrt(np.sum(new ** 2, 1, keepdims=True)))
    tess = np.concatenate(tess, 0)

    def sq_dist(m0, m1):
        d = np.sum(m0 ** 2, 0)[:, None] + np.sum(m1 ** 2, 0)[None, :] \
            - 2 * m0.T @ m1
        return np.maximum(0, d)

    eps = 1e-4
    d = sq_dist(tess.T, tess.T)
    first = np.array([np.min(np.argwhere(row <= eps)) for row in d])
    tess = tess[np.unique(first)]
    match = sq_dist(tess.T, -tess.T) < eps
    tess = tess[np.any(np.triu(match), axis=-1)]
    return tess[:, ::-1].copy()


BASIS = generate_basis(PUBLISHED["basis_subdivisions"])
_BASES = {}


def _basis(device) -> torch.Tensor:
    """:data:`BASIS` on ``device``, copied there once (a step inside a CUDA
    graph may not copy from the host)."""
    key = torch.device(device)
    if key not in _BASES:
        _BASES[key] = torch.as_tensor(BASIS, dtype=torch.float32,
                                      device=key)
    return _BASES[key]


# ---------------------------------------------------------------- spacing
def s_to_t(s, near: float, far: float):
    """Metric distance of normalised distance s (Model.raydist_fn =
    reciprocal)."""
    return 1.0 / (s / far + (1.0 - s) / near)


def sorted_interp(x, xp, fp):
    """The piecewise-linear interpolation of (xp, fp) at x, each row's xp
    sorted (math.sorted_interp)."""
    idx = torch.searchsorted(xp.contiguous(), x.contiguous(), right=True)
    i1 = torch.clamp(idx, max=xp.shape[-1] - 1)
    i0 = torch.clamp(idx - 1, min=0)
    x0, x1 = xp.gather(-1, i0), xp.gather(-1, i1)
    f0, f1 = fp.gather(-1, i0), fp.gather(-1, i1)
    offset = torch.clamp((x - x0) / torch.clamp(x1 - x0, min=EPS32 ** 2),
                         0, 1)
    return f0 + offset * (f1 - f0)


def sample_intervals(sdist, weights, n: int, jitter=None):
    """(R, n + 1) edges drawn from the step function (sdist (R, K + 1),
    weights (R, K)) on [0, 1] (stepfun.sample_intervals with single_jitter
    and Model's logits at anneal 1): n centres of the inverse CDF at
    j (1 - u_max) / (n - 1) + ``jitter`` (R, 1) U(0, 1) times the largest
    jitter, or, with ``jitter`` None, at the deterministic centres; the
    edges the centres' midpoints, the first and last reflected about the
    end centres and clipped to [0, 1]."""
    logits = torch.where(sdist[..., 1:] > sdist[..., :-1],
                         torch.log(weights + RESAMPLE_PADDING),
                         torch.full_like(weights, -math.inf))
    w = torch.softmax(logits, -1)
    cw = torch.clamp(torch.cumsum(w[..., :-1], -1), max=1)
    cw = torch.cat([torch.zeros_like(w[..., :1]), cw,
                    torch.ones_like(w[..., :1])], -1)
    dev = sdist.device
    if jitter is None:
        pad = 1 / (2 * n)
        u = torch.linspace(pad, 1. - pad - EPS32, n, device=dev)
        u = u.expand(sdist.shape[0], n)
    else:
        u_max = EPS32 + (1 - EPS32) / n
        max_jitter = (1 - u_max) / (n - 1) - EPS32
        u = torch.linspace(0., 1. - u_max, n, device=dev) + jitter * max_jitter
    centers = sorted_interp(u, cw, sdist)
    mid = (centers[..., 1:] + centers[..., :-1]) / 2
    first = torch.clamp(2 * centers[..., :1] - mid[..., :1], min=0.)
    last = torch.clamp(2 * centers[..., -1:] - mid[..., -1:], max=1.)
    return torch.cat([first, mid, last], -1)


def max_dilate_weights(t, w, dilation: float):
    """(t_dilate (R, 3K + 1), w_dilate (R, 3K)) of the step function (t
    (R, K + 1), w (R, K)) on [0, 1] (stepfun.max_dilate_weights with
    renormalize): each interval widened by ``dilation`` on both sides, the
    pdf at a point the largest of the widened intervals' that cover it,
    turned back into weights that sum to one."""
    eps = EPS32 ** 2
    p = w / torch.clamp(t[..., 1:] - t[..., :-1], min=eps)
    t0 = t[..., :-1] - dilation
    t1 = t[..., 1:] + dilation
    td = torch.clamp(torch.sort(torch.cat([t, t0, t1], -1), -1)[0], 0., 1.)
    covers = (t0[..., None, :] <= td[..., :, None]) & \
        (t1[..., None, :] > td[..., :, None])
    pd = torch.amax(torch.where(covers, p[..., None, :], 0.), -1)[..., :-1]
    wd = pd * (td[..., 1:] - td[..., :-1])
    wd = wd / torch.clamp(torch.sum(wd, -1, keepdim=True), min=eps)
    return td, wd


# ------------------------------------------------------------- Gaussians
def cast(tdist, rays_o, rays_d, radius: float):
    """(means (R, S, 3), covs (R, S, 3, 3)) of the conical frusta between
    consecutive ``tdist`` (render.conical_frustum_to_gaussian, stable, with
    the full covariance)."""
    t0, t1 = tdist[..., :-1], tdist[..., 1:]
    mu = (t0 + t1) / 2
    hw = (t1 - t0) / 2
    denom = torch.clamp(3 * mu ** 2 + hw ** 2, min=EPS32)
    t_mean = mu + (2 * mu * hw ** 2) / denom
    t_var = hw ** 2 / 3 - (4 / 15) * hw ** 4 * (12 * mu ** 2 - hw ** 2) \
        / denom ** 2
    r_var = (mu ** 2 / 4 + (5 / 12) * hw ** 2 - (4 / 15) * hw ** 4 / denom) \
        * radius ** 2
    d = rays_d[..., None, :]
    means = d * t_mean[..., None] + rays_o[..., None, :]
    d_mag_sq = torch.clamp(torch.sum(rays_d ** 2, -1), min=1e-10)
    outer = rays_d[..., :, None] * rays_d[..., None, :]
    eye = torch.eye(3, device=rays_d.device)
    null = eye - outer / d_mag_sq[..., None, None]
    covs = t_var[..., None, None] * outer[..., None, :, :] + \
        r_var[..., None, None] * null[..., None, :, :]
    return means, covs


def contract(means, covs):
    """Scene contraction of Gaussians (coord.contract through
    coord.track_linearize): the means warped, the covariances J cov J^T,
    where J = a I + c x x^T, a = (2r - 1) / r^2, c = 2 (1 - r) / r^4 outside
    the unit ball and J = I inside. J is applied as the published code's
    linearisation applies it, to the columns of cov, then to the columns of
    the result's transpose: far out both terms of a column are ~2 / r and
    their sum ~1 / r^2, and the expanded a^2 cov + ... would lose it."""
    x = means
    m = torch.clamp(torch.sum(x ** 2, -1), min=EPS32)
    inside = m <= 1
    r = torch.sqrt(m)
    a = torch.where(inside, torch.ones_like(m), (2 * r - 1) / m)
    c = torch.where(inside, torch.zeros_like(m), 2 * (1 - r) / m ** 2)
    a3, c3 = a[..., None, None], c[..., None, None]

    def jvp_columns(cv):
        # column j: a cv[:, j] + c (x . cv[:, j]) x
        xc = torch.sum(x[..., :, None] * cv, -2)
        return a3 * cv + c3 * x[..., :, None] * xc[..., None, :]

    jc = jvp_columns(covs)
    return a[..., None] * x, jvp_columns(jc.transpose(-1, -2))


def lift(means, covs, basis: torch.Tensor):
    """(means (…, 21), variances (…, 21)) of the Gaussians projected onto
    ``basis`` (21, 3) (coord.lift_and_diagonalize), as element-wise sums."""
    mean = sum(means[..., d:d + 1] * basis[:, d] for d in range(3))
    var = sum(covs[..., d, e:e + 1] * (basis[:, d] * basis[:, e])
              for d in range(3) for e in range(3))
    return mean, var


def safe_sin(x):
    """sin of x, reduced modulo 100 pi where |x| >= 100 pi (math.safe_sin)."""
    t = 100 * math.pi
    return torch.sin(torch.where(torch.abs(x) < t, x, torch.remainder(x, t)))


def integrated_pos_enc(mean, var, min_deg: int, max_deg: int):
    """(…, 2 L D): [exp(-var 4^l / 2) sin(2^l mean), the same at + pi / 2]
    for l in [min_deg, max_deg), degree-major (coord.integrated_pos_enc)."""
    scales = 2.0 ** torch.arange(min_deg, max_deg, device=mean.device)
    shape = mean.shape[:-1] + (-1,)
    sm = (mean[..., None, :] * scales[:, None]).reshape(shape)
    sv = (var[..., None, :] * scales[:, None] ** 2).reshape(shape)
    return torch.exp(-0.5 * torch.cat([sv, sv], -1)) * \
        safe_sin(torch.cat([sm, sm + 0.5 * math.pi], -1))


def pos_enc(x, deg: int):
    """[x, sin(2^l x), sin(2^l x + pi / 2)] for l < ``deg`` (coord.pos_enc
    with the identity)."""
    scales = 2.0 ** torch.arange(0, deg, device=x.device)
    sx = (x[..., None, :] * scales[:, None]).reshape(x.shape[:-1] + (-1,))
    return torch.cat([x, torch.sin(torch.cat([sx, sx + 0.5 * math.pi], -1))],
                     -1)


def encode(tdist, rays_o, rays_d, rc: Mip360RenderConfig):
    """(R * S, 504) encodings of a level's contracted frusta."""
    means, covs = contract(*cast(tdist, rays_o, rays_d, rc.pixel_radius))
    mean, var = lift(means, covs, _basis(means.device))
    enc = integrated_pos_enc(mean, var, MIN_DEG_POINT, rc.max_deg_point)
    return enc.reshape(-1, enc.shape[-1])


def alpha_weights(density, tdist, rays_d):
    """Compositing weights alpha_i T_i, the last interval's alpha 1
    (render.compute_alpha_weights with opaque_background)."""
    delta = (tdist[..., 1:] - tdist[..., :-1]) * \
        torch.linalg.norm(rays_d[..., None, :], dim=-1)
    dd = density * delta
    dd = torch.cat([dd[..., :-1], torch.full_like(dd[..., -1:], math.inf)],
                   -1)
    alpha = 1 - torch.exp(-dd)
    trans = torch.exp(-torch.cat([torch.zeros_like(dd[..., :1]),
                                  torch.cumsum(dd[..., :-1], -1)], -1))
    return alpha * trans


# ----------------------------------------------------------------- levels
def render_rays(prop, nerf, rays_o, rays_d, viewdirs, near, far,
                rc: Mip360RenderConfig, jitter=None):
    """The three levels of (R,) rays: ([{"sdist", "weights"}] a level, the
    NeRF level's rgb (R, 3)). ``jitter`` (R, 3): each level's U(0, 1)
    draw; None renders deterministically."""
    R = rays_o.shape[0]
    sdist = torch.cat([torch.zeros_like(rays_o[:, :1]),
                       torch.ones_like(rays_o[:, :1])], -1)
    weights = torch.ones_like(rays_o[:, :1])
    views = pos_enc(viewdirs, DEG_VIEW)
    history, prod, rgb = [], 1, None
    for level in range(NUM_LEVELS):
        is_prop = level < NUM_LEVELS - 1
        n = rc.num_prop_samples if is_prop else rc.num_nerf_samples
        dilation = DILATION_BIAS + DILATION_MULTIPLIER / prod
        prod *= n
        with torch.no_grad():
            w = weights.detach()
            if level > 0:
                with profiling.span("nnc.m360.dilate"):
                    sdist, w = max_dilate_weights(sdist, w, dilation)
                    sdist, w = sdist[..., 1:-1], w[..., 1:-1]
            with profiling.span("nnc.m360.resample"):
                sdist = sample_intervals(
                    sdist, w, n,
                    None if jitter is None else jitter[:, level:level + 1])
            tdist = s_to_t(sdist, near, far)
            with profiling.span("nnc.m360.contract"):
                enc = encode(tdist, rays_o, rays_d, rc)
        mlp = prop if is_prop else nerf
        with profiling.span("nnc.m360.mlp", level=level, points=R * n):
            ve = None if is_prop else \
                views[:, None, :].expand(R, n, views.shape[-1]).reshape(
                    R * n, -1)
            raw_density, raw_rgb = mlp(enc, ve)
            del enc, ve
        density = F.softplus(raw_density.reshape(R, n) + DENSITY_BIAS)
        weights = alpha_weights(density, tdist, rays_d)
        history.append({"sdist": sdist, "weights": weights})
        if not is_prop:
            c = torch.sigmoid(raw_rgb.reshape(R, n, 3)) * \
                (1 + 2 * RGB_PADDING) - RGB_PADDING
            acc = weights.sum(-1, keepdim=True)
            rgb = (weights[..., None] * c).sum(-2) + torch.clamp(1 - acc,
                                                                 min=0)
    return history, rgb


# ------------------------------------------------------------------ losses
def _lookup(t, tq):
    """(lo, hi) indices of tq in each row of sorted t (stepfun.searchsorted:
    the last edge at or below, the first above, clamped)."""
    idx = torch.searchsorted(t.contiguous(), tq.contiguous(), right=True)
    return torch.clamp(idx - 1, min=0), torch.clamp(idx, max=t.shape[-1] - 1)


def interlevel_loss(history):
    """Sum over the proposal levels of mean(max(0, w - w_outer)^2 / (w +
    eps)), w the NeRF level's weights (no gradient), w_outer the proposal
    weights summed over its intervals that overlap each NeRF interval
    (stepfun.lossfun_outer)."""
    c = history[-1]["sdist"].detach()
    w = history[-1]["weights"].detach()
    total = 0.
    for level in history[:-1]:
        cp, wp = level["sdist"], level["weights"]
        cy = torch.cat([torch.zeros_like(wp[..., :1]),
                        torch.cumsum(wp, -1)], -1)
        lo, hi = _lookup(cp, c)
        outer = cy.gather(-1, hi[..., 1:]) - cy.gather(-1, lo[..., :-1])
        total = total + torch.mean(torch.clamp(w - outer, min=0) ** 2
                                   / (w + EPS32))
    return INTERLEVEL_LOSS_MULT * total


def distortion_loss(history):
    """0.01 times the mean over rays of sum_ij w_i w_j |m_i - m_j| + sum_i
    w_i^2 (s_{i+1} - s_i) / 3 on the NeRF level (stepfun.lossfun_distortion)."""
    s, w = history[-1]["sdist"], history[-1]["weights"]
    mid = (s[..., 1:] + s[..., :-1]) / 2
    dm = torch.abs(mid[..., :, None] - mid[..., None, :])
    inter = torch.sum(w * torch.sum(w[..., None, :] * dm, -1), -1)
    intra = torch.sum(w ** 2 * (s[..., 1:] - s[..., :-1]), -1) / 3
    return DISTORTION_LOSS_MULT * torch.mean(inter + intra)


def step_draws(n_rays: int, rc: Mip360RenderConfig,
               generator: torch.Generator, device=None) -> dict:
    """The draws of one training render of ``n_rays`` rays: ``jitter``
    (rays, 3) U(0, 1), one a level."""
    return {"jitter": torch.rand((n_rays, NUM_LEVELS), generator=generator,
                                 device=device)}


def m360_loss(prop, nerf, rays_o, rays_d, viewdirs, target, near, far,
              rc: Mip360RenderConfig, draws: Optional[dict] = None,
              generator: Optional[torch.Generator] = None):
    """mip-NeRF 360's training loss in ``lsa.double_mse_loss``'s signature
    (the proposal MLP as the coarse model, the NeRF MLP as the fine one):
    (Charbonnier data loss + interlevel loss + distortion loss, the NeRF
    level's mean squared error)."""
    d = {k: v for k, v in (draws or {}).items() if v is not None}
    if "jitter" not in d:
        d = {**step_draws(rays_o.shape[0], rc, generator, rays_o.device), **d}
    if viewdirs is None:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    history, rgb = render_rays(prop, nerf, rays_o, rays_d, viewdirs, near,
                               far, rc, d["jitter"])
    with profiling.span("nnc.m360.loss"):
        resid_sq = (rgb - target) ** 2
        data = torch.mean(torch.sqrt(resid_sq + CHARB_PADDING ** 2))
        loss = data + interlevel_loss(history) + distortion_loss(history)
    return loss, torch.mean(resid_sq)


@torch.no_grad()
def render_image(prop, nerf, rays_o, rays_d, near, far,
                 rc: Mip360RenderConfig, viewdirs=None, device=None):
    """The deterministic three-level render of (N, 3) or (H, W, 3) rays
    (numpy or tensors), level by level in chunks of ``rc.chunk`` rays, no
    early termination: {"rgb_map", "acc_map"} on ``device`` (default: the
    models'), leading shape as the input's. A ``nnc.render.view`` request
    span while a profiler records."""
    device = torch.device(device) if device is not None else nerf.device
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
            part = slice(s, s + rc.chunk)
            history, rgb = render_rays(prop, nerf, ro[part], rd[part],
                                       vd[part], near, far, rc)
            rgbs.append(rgb)
            accs.append(history[-1]["weights"].sum(-1))
        return {"rgb_map": torch.cat(rgbs).reshape(*lead, 3),
                "acc_map": torch.cat(accs).reshape(lead)}
