"""The plain reference of mip-NeRF 360 (Barron et al., "Mip-NeRF 360:
Unbounded Anti-Aliased Neural Radiance Fields", CVPR 2022) as its published
code has it (github.com/google-research/multinerf: ``internal/models.py``
``Model`` / ``MLP``, ``internal/stepfun.py``, ``internal/coord.py``,
``internal/geopoly.py``, ``internal/render.py``, ``internal/math.py``,
``internal/train_utils.py``'s losses, ``configs/360.gin``): distances
uniform in disparity, the proposal levels' dilated step functions and
interval resampling, conical frusta with full covariance warped by scene
contraction through its linearisation, the basis projection and the
integrated positional encoding, both MLPs in multinerf's own layer and
channel order, opaque-background compositing, the Charbonnier data loss, the
interlevel and distortion losses, LSA's per-channel output scales and Adam
on them.

Plain PyTorch in float32 with TF32 off (``torch.backends.cuda.matmul.
allow_tf32`` and ``torch.backends.cudnn.allow_tf32`` False inside every
entry point), on whatever device its inputs are on. It imports neither JAX
nor anything of ``nnc_tpu`` or ``nnc_tpu_torch``; the tests import it from
here.

Weights are multinerf's flax tree: ``{"prop_mlp": {"Dense_i": {"kernel":
(in, out), "bias": (out,)}}, "nerf_mlp": {...}}``, each MLP's ``Dense_i``
in the order it creates them (the trunk, the density; for the NeRF MLP
then the bottleneck, the view layer and the rgb head). Scales, where given,
have the tree's layout with (out,) leaves: LSA's ``y = (x @ kernel) * s +
bias``.

Departures from the published code:
  * the random draws are arguments: ``jitter`` (rays, 3), one U(0, 1) a
    ray and level (``single_jitter``), scaled to the level's largest jitter
    as ``random.uniform(maxval=max_jitter)`` scales its U(0, 1);
  * the sizes are arguments (:class:`Sizes`), so that the tests run it
    small; the published ones are the defaults;
  * the trained model is assumed: ``anneal`` is 1 (``train_frac`` 1);
  * the data loss is the Charbonnier loss, ``sqrt(resid^2 + 0.001^2)``
    averaged over rays and channels (``Config.data_loss_type = 'charb'``,
    the paper's choice; configs.py's default names 'mse');
  * the weights carry LSA's scales, which the published model has not;
  * ``tf32=True`` rounds every operand of the MLPs' products to TF32 (10
    mantissa bits, to nearest even) in the forward and the backward, the
    precision below float32 on the card: the control that the comparisons
    have to fail;
  * a step's rays may run in blocks (:func:`follow_lsa`): every term of the
    loss is a mean over rays, so a block's loss weighted by its share of
    the rays sums to the step's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

EPS32 = float(torch.finfo(torch.float32).eps)
# configs/360.gin and Model / MLP / Config defaults
NEAR, FAR = 0.2, 1e6
DILATION_BIAS, DILATION_MULTIPLIER = 0.0025, 0.5
RESAMPLE_PADDING = 0.0
DENSITY_BIAS = -1.0
RGB_PADDING = 0.001
CHARB_PADDING = 0.001
INTERLEVEL_LOSS_MULT = 1.0
DISTORTION_LOSS_MULT = 0.01
SKIP_LAYER = 4


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The published sizes, or smaller ones for the tests."""
    prop_depth: int = 4
    prop_width: int = 256
    nerf_depth: int = 8
    nerf_width: int = 1024
    bottleneck: int = 256
    view_width: int = 128
    num_prop_samples: int = 64
    num_nerf_samples: int = 32
    min_deg_point: int = 0
    max_deg_point: int = 12
    deg_view: int = 4


@contextlib.contextmanager
def fp32_matmul():
    """TF32 off for the block (cuBLAS and cuDNN), restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa, to nearest, ties
    to even (finite values)."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


class _TF32Matmul(torch.autograd.Function):
    """x @ w with every product of the forward and the backward on operands
    rounded to TF32, sums in float32."""

    @staticmethod
    def forward(ctx, x, w):
        x, w = round_tf32(x), round_tf32(w)
        ctx.save_for_backward(x, w)
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = round_tf32(g)
        return g @ w.t(), x.t() @ g


# ---------------------------------------------------------------- geopoly
def generate_basis(tesselation: int = 2, eps: float = 1e-4) -> np.ndarray:
    """geopoly.generate_basis('icosahedron', tesselation): (21, 3) for 2."""
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

    def compute_sq_dist(mat0, mat1=None):
        mat1 = mat0 if mat1 is None else mat1
        sq_dist = np.sum(mat0 ** 2, 0)[:, None] + \
            np.sum(mat1 ** 2, 0)[None, :] - 2 * mat0.T @ mat1
        return np.maximum(0, sq_dist)

    v = tesselation
    weights = np.array([(i, j, v - (i + j)) for i in range(v + 1)
                        for j in range(v + 1 - i)]) / v
    out = []
    for face in faces:
        new_verts = np.matmul(weights, verts[face, :])
        new_verts /= np.sqrt(np.sum(new_verts ** 2, 1, keepdims=True))
        out.append(new_verts)
    out = np.concatenate(out, 0)
    sq_dist = compute_sq_dist(out.T)
    assignment = np.array([np.min(np.argwhere(d <= eps)) for d in sq_dist])
    out = out[np.unique(assignment), :]
    match = compute_sq_dist(out.T, -out.T) < eps
    out = out[np.any(np.triu(match), axis=-1), :]
    return out[:, ::-1]


# ---------------------------------------------------------------- stepfun
def searchsorted(a, v):
    """stepfun.searchsorted: (idx_lo, idx_hi) of each v in each row of a,
    by the mask of every (v, a) pair."""
    i = torch.arange(a.shape[-1], device=a.device)
    v_ge_a = v[..., None, :] >= a[..., :, None]
    idx_lo = torch.amax(torch.where(v_ge_a, i[:, None], i[:1, None]), -2)
    idx_hi = torch.amin(torch.where(~v_ge_a, i[:, None], i[-1:, None]), -2)
    return idx_lo, idx_hi


def inner_outer(t0, t1, y1):
    cy1 = torch.cat([torch.zeros_like(y1[..., :1]), torch.cumsum(y1, -1)],
                    -1)
    idx_lo, idx_hi = searchsorted(t1, t0)
    cy1_lo = torch.gather(cy1, -1, idx_lo)
    cy1_hi = torch.gather(cy1, -1, idx_hi)
    y0_outer = cy1_hi[..., 1:] - cy1_lo[..., :-1]
    return y0_outer


def lossfun_outer(t, w, t_env, w_env):
    w_outer = inner_outer(t, t_env, w_env)
    return torch.clamp(w - w_outer, min=0) ** 2 / (w + EPS32)


def lossfun_distortion(t, w):
    ut = (t[..., 1:] + t[..., :-1]) / 2
    dut = torch.abs(ut[..., :, None] - ut[..., None, :])
    loss_inter = torch.sum(w * torch.sum(w[..., None, :] * dut, -1), -1)
    loss_intra = torch.sum(w ** 2 * (t[..., 1:] - t[..., :-1]), -1) / 3
    return loss_inter + loss_intra


def max_dilate(t, w, dilation, domain):
    t0 = t[..., :-1] - dilation
    t1 = t[..., 1:] + dilation
    t_dilate = torch.sort(torch.cat([t, t0, t1], -1), -1)[0]
    t_dilate = torch.clamp(t_dilate, *domain)
    w_dilate = torch.amax(torch.where(
        (t0[..., None, :] <= t_dilate[..., None])
        & (t1[..., None, :] > t_dilate[..., None]),
        w[..., None, :], torch.zeros_like(w[..., None, :])), -1)[..., :-1]
    return t_dilate, w_dilate


def max_dilate_weights(t, w, dilation, domain):
    eps = EPS32 ** 2
    p = w / torch.clamp(t[..., 1:] - t[..., :-1], min=eps)
    t_dilate, p_dilate = max_dilate(t, p, dilation, domain)
    w_dilate = p_dilate * (t_dilate[..., 1:] - t_dilate[..., :-1])
    w_dilate = w_dilate / torch.clamp(torch.sum(w_dilate, -1, keepdim=True),
                                      min=eps)
    return t_dilate, w_dilate


def sorted_interp(x, xp, fp):
    """math.sorted_interp (searchsorted on the right, clamped)."""
    idx = torch.searchsorted(xp.contiguous(), x.contiguous(), right=True)
    idx1 = torch.clamp(idx, max=xp.shape[-1] - 1)
    idx0 = torch.clamp(idx - 1, min=0)
    xp0, xp1 = torch.gather(xp, -1, idx0), torch.gather(xp, -1, idx1)
    fp0, fp1 = torch.gather(fp, -1, idx0), torch.gather(fp, -1, idx1)
    offset = torch.clamp((x - xp0) / torch.clamp(xp1 - xp0, min=EPS32 ** 2),
                         0, 1)
    return fp0 + offset * (fp1 - fp0)


def invert_cdf(u, t, w_logits):
    w = torch.softmax(w_logits, -1)
    cw = torch.clamp(torch.cumsum(w[..., :-1], -1), max=1)
    shape = cw.shape[:-1] + (1,)
    cw0 = torch.cat([torch.zeros(shape, device=cw.device), cw,
                     torch.ones(shape, device=cw.device)], -1)
    return sorted_interp(u, cw0, t)


def sample(jitter, t, w_logits, num_samples):
    """stepfun.sample with deterministic_center and single_jitter: u at
    ``jitter`` (rays, 1) times the largest jitter, or (None) the centres."""
    if jitter is None:
        pad = 1 / (2 * num_samples)
        u = torch.linspace(pad, 1. - pad - EPS32, num_samples,
                           device=t.device).expand(t.shape[0], num_samples)
    else:
        u_max = EPS32 + (1 - EPS32) / num_samples
        max_jitter = (1 - u_max) / (num_samples - 1) - EPS32
        u = torch.linspace(0, 1 - u_max, num_samples, device=t.device) + \
            jitter * max_jitter
    return invert_cdf(u, t, w_logits)


def sample_intervals(jitter, t, w_logits, num_samples, domain=(0., 1.)):
    centers = sample(jitter, t, w_logits, num_samples)
    mid = (centers[..., 1:] + centers[..., :-1]) / 2
    first = torch.clamp(2 * centers[..., :1] - mid[..., :1], min=domain[0])
    last = torch.clamp(2 * centers[..., -1:] - mid[..., -1:], max=domain[1])
    return torch.cat([first, mid, last], -1)


# ------------------------------------------------------------------ coord
def contract(x):
    x_mag_sq = torch.clamp(torch.sum(x ** 2, -1, keepdim=True), min=EPS32)
    return torch.where(x_mag_sq <= 1, x,
                       ((2 * torch.sqrt(x_mag_sq) - 1) / x_mag_sq) * x)


def contract_jvp(x, v):
    """The tangent of :func:`contract` at x along v (the linearisation
    ``jax.linearize`` makes): a v + (2 (1 - r) / r^4) (x . v) x outside the
    unit ball, v inside."""
    m = torch.clamp(torch.sum(x ** 2, -1, keepdim=True), min=EPS32)
    r = torch.sqrt(m)
    out = (2 * r - 1) / m * v + (2 * (1 - r) / m ** 2) * \
        torch.sum(x * v, -1, keepdim=True) * x
    return torch.where(m <= 1, v, out)


def track_linearize(mean, cov):
    """coord.track_linearize(contract, ...): the warped means and J cov J^T,
    J applied to the columns of cov, then to the columns of the result's
    transpose."""
    cols = lambda c: torch.stack([contract_jvp(mean, c[..., :, j])
                                  for j in range(3)], -1)
    fn_cov = cols(cov)
    fn_cov = cols(fn_cov.transpose(-1, -2))
    return contract(mean), fn_cov


def lift_and_diagonalize(mean, cov, basis):
    """basis: (3, 21)."""
    fn_mean = torch.matmul(mean, basis)
    fn_cov_diag = torch.sum(basis * torch.matmul(cov, basis), -2)
    return fn_mean, fn_cov_diag


def safe_sin(x):
    t = 100 * math.pi
    return torch.sin(torch.where(torch.abs(x) < t, x, torch.remainder(x, t)))


def integrated_pos_enc(mean, var, min_deg, max_deg):
    scales = 2.0 ** torch.arange(min_deg, max_deg, device=mean.device)
    shape = mean.shape[:-1] + (-1,)
    scaled_mean = (mean[..., None, :] * scales[:, None]).reshape(shape)
    scaled_var = (var[..., None, :] * scales[:, None] ** 2).reshape(shape)
    return torch.exp(-0.5 * torch.cat([scaled_var] * 2, -1)) * safe_sin(
        torch.cat([scaled_mean, scaled_mean + 0.5 * math.pi], -1))


def pos_enc(x, min_deg, max_deg):
    scales = 2.0 ** torch.arange(min_deg, max_deg, device=x.device)
    scaled_x = (x[..., None, :] * scales[:, None]).reshape(
        x.shape[:-1] + (-1,))
    four_feat = torch.sin(torch.cat([scaled_x, scaled_x + 0.5 * math.pi],
                                    -1))
    return torch.cat([x, four_feat], -1)


# ----------------------------------------------------------------- render
def conical_frustum_to_gaussian(d, t0, t1, base_radius):
    """The stable form with the full covariance (diag=False)."""
    mu = (t0 + t1) / 2
    hw = (t1 - t0) / 2
    denom = torch.clamp(3 * mu ** 2 + hw ** 2, min=EPS32)
    t_mean = mu + (2 * mu * hw ** 2) / denom
    t_var = hw ** 2 / 3 - (4 / 15) * hw ** 4 * (12 * mu ** 2 - hw ** 2) \
        / denom ** 2
    r_var = (mu ** 2) / 4 + (5 / 12) * hw ** 2 - (4 / 15) * hw ** 4 / denom
    r_var = r_var * base_radius ** 2
    mean = d[..., None, :] * t_mean[..., None]
    d_mag_sq = torch.clamp(torch.sum(d ** 2, -1, keepdim=True), min=1e-10)
    d_outer = d[..., :, None] * d[..., None, :]
    eye = torch.eye(3, device=d.device)
    null_outer = eye - d[..., :, None] * (d / d_mag_sq)[..., None, :]
    t_cov = t_var[..., None, None] * d_outer[..., None, :, :]
    xy_cov = r_var[..., None, None] * null_outer[..., None, :, :]
    return mean, t_cov + xy_cov


def cast_rays(tdist, origins, directions, radii):
    """radii: (rays, 1)."""
    mean, cov = conical_frustum_to_gaussian(
        directions, tdist[..., :-1], tdist[..., 1:], radii)
    return mean + origins[..., None, :], cov


def compute_alpha_weights(density, tdist, dirs):
    """render.compute_alpha_weights with opaque_background."""
    t_delta = tdist[..., 1:] - tdist[..., :-1]
    delta = t_delta * torch.linalg.norm(dirs[..., None, :], dim=-1)
    density_delta = density * delta
    density_delta = torch.cat([density_delta[..., :-1],
                               torch.full_like(density_delta[..., -1:],
                                               math.inf)], -1)
    alpha = 1 - torch.exp(-density_delta)
    trans = torch.exp(-torch.cat([
        torch.zeros_like(density_delta[..., :1]),
        torch.cumsum(density_delta[..., :-1], -1)], -1))
    return alpha * trans


# -------------------------------------------------------------------- MLP
def _dense(x, layer, scale, tf32):
    mm = _TF32Matmul.apply if tf32 else torch.matmul
    y = mm(x, layer["kernel"])
    if scale is not None:
        y = y * scale
    return y + layer["bias"]


def mlp(params, scales, gaussians, viewdirs, depth, tf32):
    """MLP.__call__ with disable_density_normals, warp_fn contract: (raw
    density (N,), raw rgb (N, 3) or None); ``params`` one MLP's tree, its
    Dense layers numbered in creation order; rgb where it has a Dense after
    the density's. ``gaussians``: (means (N, 3), covs (N, 3, 3), basis (3,
    21), min_deg, max_deg); ``viewdirs`` (N, 3) or None."""
    s = scales or {}
    dense = lambda h, i: _dense(h, params[f"Dense_{i}"], s.get(f"Dense_{i}"),
                                tf32)
    means, covs, basis, min_deg, max_deg = gaussians
    means, covs = track_linearize(means, covs)
    lifted_means, lifted_vars = lift_and_diagonalize(means, covs, basis)
    x = integrated_pos_enc(lifted_means, lifted_vars, min_deg, max_deg)
    inputs = x
    for i in range(depth):
        x = torch.relu(dense(x, i))
        if i % SKIP_LAYER == 0 and i > 0:
            x = torch.cat([x, inputs], -1)
    raw_density = dense(x, depth)[..., 0]
    if f"Dense_{depth + 1}" not in params:
        return raw_density, None
    bottleneck = dense(x, depth + 1)
    x = torch.relu(dense(torch.cat([bottleneck, viewdirs], -1), depth + 2))
    return raw_density, dense(x, depth + 3)


# ------------------------------------------------------------------ Model
def render_rays(params, rays, sizes: Sizes, jitter=None, scales=None,
                tf32=False, near=NEAR, far=FAR):
    """Model.__call__ over ``rays`` = (origins, directions, viewdirs, radii
    (rays, 1)): (ray_history [{"sdist", "weights"}], the NeRF level's rgb).
    ``jitter`` (rays, 3) or None (deterministic)."""
    origins, directions, viewdirs, radii = rays
    sc = scales or {}
    s_near, s_far = 1 / near, 1 / far
    s_to_t = lambda s: 1 / (s * s_far + (1 - s) * s_near)
    init_s_near, init_s_far = 0., 1.
    sdist = torch.cat([torch.full_like(radii, init_s_near),
                       torch.full_like(radii, init_s_far)], -1)
    weights = torch.ones_like(radii)
    prod_num_samples = 1
    basis = torch.as_tensor(np.ascontiguousarray(generate_basis(2).T),
                            dtype=torch.float32, device=origins.device)
    dir_enc = pos_enc(viewdirs, 0, sizes.deg_view)
    ray_history, rgb = [], None
    for i_level in range(3):
        is_prop = i_level < 2
        num_samples = sizes.num_prop_samples if is_prop \
            else sizes.num_nerf_samples
        dilation = DILATION_BIAS + DILATION_MULTIPLIER * (
            init_s_far - init_s_near) / prod_num_samples
        prod_num_samples *= num_samples
        if i_level > 0:
            sdist, weights = max_dilate_weights(
                sdist, weights, dilation, domain=(init_s_near, init_s_far))
            sdist = sdist[..., 1:-1]
            weights = weights[..., 1:-1]
        anneal = 1.
        logits_resample = torch.where(
            sdist[..., 1:] > sdist[..., :-1],
            anneal * torch.log(weights + RESAMPLE_PADDING),
            torch.full_like(weights, -math.inf))
        sdist = sample_intervals(
            None if jitter is None else jitter[:, i_level:i_level + 1],
            sdist, logits_resample, num_samples,
            domain=(init_s_near, init_s_far)).detach()
        tdist = s_to_t(sdist)
        means, covs = cast_rays(tdist, origins, directions, radii)
        R, S = means.shape[:2]
        key = "prop_mlp" if is_prop else "nerf_mlp"
        depth = sizes.prop_depth if is_prop else sizes.nerf_depth
        vd = None if is_prop else dir_enc[:, None, :].expand(
            R, S, dir_enc.shape[-1]).reshape(R * S, -1)
        raw_density, raw_rgb = mlp(
            params[key], sc.get(key),
            (means.reshape(-1, 3), covs.reshape(-1, 3, 3), basis,
             sizes.min_deg_point, sizes.max_deg_point), vd, depth, tf32)
        density = torch.nn.functional.softplus(raw_density.reshape(R, S)
                                               + DENSITY_BIAS)
        weights = compute_alpha_weights(density, tdist, directions)
        if not is_prop:
            rgb_s = torch.sigmoid(raw_rgb.reshape(R, S, 3))
            rgb_s = rgb_s * (1 + 2 * RGB_PADDING) - RGB_PADDING
            acc = weights.sum(-1)
            bg_w = torch.clamp(1 - acc[..., None], min=0)
            rgb = (weights[..., None] * rgb_s).sum(-2) + bg_w * 1.0
        ray_history.append({"sdist": sdist, "weights": weights})
        weights = weights.detach() if is_prop else weights
    return ray_history, rgb


def loss(params, rays, pixels, sizes: Sizes, jitter, scales=None,
         tf32=False, near=NEAR, far=FAR):
    """(loss, the NeRF level's mse) of one training step:
    train_utils.compute_data_loss (charb, the NeRF level only; the proposal
    levels' data_coarse_loss_mult is 0), interlevel_loss and
    distortion_loss."""
    history, rgb = render_rays(params, rays, sizes, jitter, scales, tf32,
                               near, far)
    resid_sq = (rgb - pixels[..., :3]) ** 2
    data = torch.mean(torch.sqrt(resid_sq + CHARB_PADDING ** 2))
    c = history[-1]["sdist"].detach()
    w = history[-1]["weights"].detach()
    interlevel = sum(torch.mean(lossfun_outer(c, w, h["sdist"], h["weights"]))
                     for h in history[:-1])
    distortion = torch.mean(lossfun_distortion(history[-1]["sdist"],
                                               history[-1]["weights"]))
    total = data + INTERLEVEL_LOSS_MULT * interlevel + \
        DISTORTION_LOSS_MULT * distortion
    return total, torch.mean(resid_sq)


# -------------------------------------------------------------------- LSA
def follow_lsa(params, batches, draws, sizes: Sizes, lr, tf32=False,
               betas=(0.9, 0.999), eps=1e-8, block_rays=None, near=NEAR,
               far=FAR):
    """LSA from scales of one: ``len(batches)`` steps of :func:`loss` and
    Adam on the scales of every layer of both MLPs. ``batches``: (rays,
    pixels), rays as :func:`render_rays` takes them; ``draws``: {"jitter"}
    a step. A step's gradient is summed over blocks of ``block_rays`` rays
    (all at once when None), each block's loss weighted by its share of the
    rays. Returns {"losses": per step, "grad1": {leaf: norm of the first
    gradient}, "change": {leaf: norm of the scales' change after the last
    step}}; a leaf is ``<mlp>.Dense_i``."""
    dev = batches[0][1].device
    leaves = {f"{key}.{name}": torch.ones(layer["kernel"].shape[1],
                                          device=dev, requires_grad=True)
              for key, tree in params.items()
              for name, layer in tree.items()}
    scales = {key: {name.split(".", 1)[1]: t for name, t in leaves.items()
                    if name.split(".", 1)[0] == key} for key in params}
    m = {k: torch.zeros_like(t) for k, t in leaves.items()}
    v = {k: torch.zeros_like(t) for k, t in leaves.items()}
    losses, grad1 = [], {}
    with fp32_matmul():
        for step, ((rays, pixels), d) in enumerate(zip(batches, draws),
                                                   start=1):
            n = pixels.shape[0]
            nb = block_rays or n
            grads = [torch.zeros_like(t) for t in leaves.values()]
            total = 0.0
            for s in range(0, n, nb):
                part = tuple(r[s:s + nb] for r in rays)
                share = part[0].shape[0] / n
                value, _mse = loss(params, part, pixels[s:s + nb], sizes,
                                   d["jitter"][s:s + nb], scales, tf32,
                                   near, far)
                for g, gb in zip(grads, torch.autograd.grad(
                        value * share, list(leaves.values()))):
                    g.add_(gb)
                total += float(value.detach()) * share
            losses.append(total)
            with torch.no_grad():
                for (k, t), g in zip(leaves.items(), grads):
                    if step == 1:
                        grad1[k] = float(torch.linalg.norm(g))
                    m[k].mul_(betas[0]).add_(g, alpha=1 - betas[0])
                    v[k].mul_(betas[1]).addcmul_(g, g, value=1 - betas[1])
                    mh = m[k] / (1 - betas[0] ** step)
                    vh = v[k] / (1 - betas[1] ** step)
                    t.sub_(lr * mh / (torch.sqrt(vh) + eps))
    change = {k: float(torch.linalg.norm(t.detach() - 1.0))
              for k, t in leaves.items()}
    return {"losses": losses, "grad1": grad1, "change": change}
