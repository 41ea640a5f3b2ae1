"""The plain reference of mip-NeRF (Barron et al., "Mip-NeRF: A Multiscale
Representation for Anti-Aliasing Neural Radiance Fields", ICCV 2021) as its
published code has it (github.com/google/mip-nerf: ``internal/mip.py``,
``internal/math.py``, ``internal/models.py`` ``MipNerfModel`` / ``MLP``,
``train.py``'s loss, ``configs/blender.gin``): cone casting, the stable
conical frustum's Gaussian, the integrated positional encoding, the MLP in
mip-NeRF's own channel and skip order, stratified sampling and the blurred
resample from given draws, compositing, the two-level loss, LSA's
per-channel output scales and Adam on them.

Plain PyTorch in float32 with TF32 off (``torch.backends.cuda.matmul.
allow_tf32`` and ``torch.backends.cudnn.allow_tf32`` False inside every
entry point), on whatever device its inputs are on. It imports neither JAX
nor anything of ``nnc_tpu`` or ``nnc_tpu_torch``. The benchmark keeps a
byte-for-byte copy of this file (``benchmark/reference/mipnerf.py``).

Weights are the flax tree of ``MipNerfModel``'s one MLP: ``{"Dense_i":
{"kernel": (in, out), "bias": (out,)}}`` for i = 0..11 (Dense_0..7 the
trunk, Dense_8 the density, Dense_9 the bottleneck, Dense_10 the view
layer, Dense_11 the rgb head). Scales, where given, are ``{"Dense_i":
(out,)}``, LSA's output scaling ``y = (x @ kernel) * s + bias``.

Departures from the published code:
  * the random draws are arguments: ``t_rand`` (rays, num_samples + 1) of
    the stratified jitter and ``u`` (rays, num_samples + 1) of the
    resample, both U(0, 1); the resample's jitter is ``u * (1 / n - eps)``,
    as ``random.uniform(maxval=s - eps)`` scales its U(0, 1);
  * the published Blender loader draws each batch's pixels with
    replacement; the program's batcher, and so the batches handed here,
    draws them without replacement (one random view a step,
    ``batching = single_image``);
  * the weights carry LSA's scales, which the published model has not;
  * ``tf32=True`` rounds every operand of the MLP's products to TF32 (10
    mantissa bits, to nearest even) in the forward and the backward, the
    precision below float32 on the card: the control that the comparisons
    have to fail;
  * the MLP runs in blocks of ``BLOCK_POINTS`` points where no gradient is
    taken (:func:`render_blocks`), so that a full view fits.
The loss is the published one: ``(mask * (rgb - pixels)**2).sum() /
mask.sum()`` with a mask of ones of shape (rays, 1), the squared error
summed over the three channels and averaged over the rays.
"""
from __future__ import annotations

import contextlib
import math

import torch

# configs/blender.gin and MipNerfModel's defaults
NUM_SAMPLES = 128
NUM_LEVELS = 2
RESAMPLE_PADDING = 0.01
MIN_DEG_POINT, MAX_DEG_POINT = 0, 16
DEG_VIEW = 4
DENSITY_BIAS = -1.0
RGB_PADDING = 0.001
COARSE_LOSS_MULT = 0.1
SKIP_LAYER = 4
NET_DEPTH = 8
EPS32 = float(torch.finfo(torch.float32).eps)
BLOCK_POINTS = 1 << 19


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


# --------------------------------------------------------------- the rays
def pixel_radii(directions: torch.Tensor) -> torch.Tensor:
    """(H, W, 1) radii of a view's (H, W, 3) ray directions: the distance
    from each direction to its neighbour in the next row (the last row
    repeats the one before), times 2 / sqrt(12) (datasets.py
    ``_generate_rays``)."""
    dx = torch.sqrt(torch.sum((directions[:-1] - directions[1:]) ** 2, -1))
    dx = torch.cat([dx, dx[-2:-1]], 0)
    return dx[..., None] * 2 / math.sqrt(12)


# ------------------------------------------------------------- mip.py
def lift_gaussian(d, t_mean, t_var, r_var):
    mean = d[..., None, :] * t_mean[..., None]
    d_mag_sq = torch.clamp(torch.sum(d ** 2, -1, keepdim=True), min=1e-10)
    d_outer_diag = d ** 2
    null_outer_diag = 1 - d_outer_diag / d_mag_sq
    t_cov_diag = t_var[..., None] * d_outer_diag[..., None, :]
    xy_cov_diag = r_var[..., None] * null_outer_diag[..., None, :]
    return mean, t_cov_diag + xy_cov_diag


def conical_frustum_to_gaussian(d, t0, t1, base_radius):
    """The stable form (``stable=True``) with a diagonal covariance."""
    mu = (t0 + t1) / 2
    hw = (t1 - t0) / 2
    t_mean = mu + (2 * mu * hw ** 2) / (3 * mu ** 2 + hw ** 2)
    t_var = (hw ** 2) / 3 - (4 / 15) * ((hw ** 4 * (12 * mu ** 2 - hw ** 2))
                                        / (3 * mu ** 2 + hw ** 2) ** 2)
    r_var = base_radius ** 2 * ((mu ** 2) / 4 + (5 / 12) * hw ** 2
                                - 4 / 15 * (hw ** 4) / (3 * mu ** 2 + hw ** 2))
    return lift_gaussian(d, t_mean, t_var, r_var)


def cast_rays(t_vals, origins, directions, radii):
    """(means, covs) (rays, samples, 3) of the cones' frusta between
    consecutive ``t_vals``; radii (rays, 1)."""
    t0, t1 = t_vals[..., :-1], t_vals[..., 1:]
    means, covs = conical_frustum_to_gaussian(directions, t0, t1, radii)
    return means + origins[..., None, :], covs


def sample_along_rays(origins, directions, radii, num_samples, near, far,
                      t_rand=None):
    """(t_vals (rays, num_samples + 1), (means, covs)); ``t_rand`` None is
    the deterministic sweep (``randomized=False``)."""
    t_vals = torch.linspace(0., 1., num_samples + 1, device=origins.device)
    t_vals = near * (1. - t_vals) + far * t_vals
    t_vals = t_vals.expand(origins.shape[0], num_samples + 1)
    if t_rand is not None:
        mids = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
        upper = torch.cat([mids, t_vals[..., -1:]], -1)
        lower = torch.cat([t_vals[..., :1], mids], -1)
        t_vals = lower + (upper - lower) * t_rand
    return t_vals, cast_rays(t_vals, origins, directions, radii)


def safe_sin(x):
    """math.safe_sin: sin of x, or of x % (100 pi) where |x| reaches it."""
    t = 100 * math.pi
    return torch.sin(torch.where(torch.abs(x) < t, x, torch.remainder(x, t)))


def integrated_pos_enc(means, covs, min_deg=MIN_DEG_POINT,
                       max_deg=MAX_DEG_POINT):
    """[exp(-var/2) sin(y) of every (frequency, coordinate), then the same
    of y + pi / 2], y = 2^l mean, var = 4^l cov (frequency-major)."""
    scales = torch.tensor([2 ** i for i in range(min_deg, max_deg)],
                          dtype=means.dtype, device=means.device)
    shape = list(means.shape[:-1]) + [-1]
    y = torch.reshape(means[..., None, :] * scales[:, None], shape)
    y_var = torch.reshape(covs[..., None, :] * scales[:, None] ** 2, shape)
    x = torch.cat([y, y + 0.5 * math.pi], -1)
    x_var = torch.cat([y_var, y_var], -1)
    return torch.exp(-0.5 * x_var) * safe_sin(x)


def pos_enc(x, min_deg=0, max_deg=DEG_VIEW):
    """[x, sin of every (frequency, coordinate), then of + pi / 2]."""
    scales = torch.tensor([2 ** i for i in range(min_deg, max_deg)],
                          dtype=x.dtype, device=x.device)
    xb = torch.reshape(x[..., None, :] * scales[:, None],
                       list(x.shape[:-1]) + [-1])
    four_feat = torch.sin(torch.cat([xb, xb + 0.5 * math.pi], -1))
    return torch.cat([x, four_feat], -1)


def sorted_piecewise_constant_pdf(bins, weights, num_samples, u=None):
    """math.sorted_piecewise_constant_pdf: ``u`` (rays, num_samples) the
    U(0, 1) draws of the randomized form, None the deterministic one."""
    eps = 1e-5
    weight_sum = torch.sum(weights, -1, keepdim=True)
    padding = torch.clamp(eps - weight_sum, min=0)
    weights = weights + padding / weights.shape[-1]
    weight_sum = weight_sum + padding
    pdf = weights / weight_sum
    cdf = torch.clamp(torch.cumsum(pdf[..., :-1], -1), max=1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf,
                     torch.ones_like(cdf[..., :1])], -1)
    if u is not None:
        s = 1 / num_samples
        uu = torch.arange(num_samples, dtype=cdf.dtype, device=cdf.device) * s
        uu = uu + u * (s - EPS32)
        uu = torch.clamp(uu, max=1. - EPS32)
    else:
        uu = torch.linspace(0., 1. - EPS32, num_samples, device=cdf.device)
        uu = uu.expand(list(cdf.shape[:-1]) + [num_samples])
    mask = uu[..., None, :] >= cdf[..., :, None]

    def find_interval(x):
        x0 = torch.amax(torch.where(mask, x[..., None], x[..., :1, None]), -2)
        x1 = torch.amin(torch.where(~mask, x[..., None], x[..., -1:, None]),
                        -2)
        return x0, x1

    bins_g0, bins_g1 = find_interval(bins)
    cdf_g0, cdf_g1 = find_interval(cdf)
    t = torch.clamp(torch.nan_to_num((uu - cdf_g0) / (cdf_g1 - cdf_g0), 0),
                    0, 1)
    return bins_g0 + t * (bins_g1 - bins_g0)


def resample_along_rays(origins, directions, radii, t_vals, weights, u=None,
                        resample_padding=RESAMPLE_PADDING):
    """The blurred resample (``stop_level_grad``): max over neighbours,
    mean of neighbours, plus the padding."""
    weights = weights.detach()
    weights_pad = torch.cat([weights[..., :1], weights, weights[..., -1:]],
                            -1)
    weights_max = torch.maximum(weights_pad[..., :-1], weights_pad[..., 1:])
    weights_blur = 0.5 * (weights_max[..., :-1] + weights_max[..., 1:])
    weights = weights_blur + resample_padding
    new_t_vals = sorted_piecewise_constant_pdf(
        t_vals.detach(), weights, t_vals.shape[-1], u).detach()
    return new_t_vals, cast_rays(new_t_vals, origins, directions, radii)


def volumetric_rendering(rgb, density, t_vals, dirs, white_bkgd):
    """(comp_rgb, acc, weights)."""
    t_dists = t_vals[..., 1:] - t_vals[..., :-1]
    delta = t_dists * torch.linalg.norm(dirs[..., None, :], dim=-1)
    density_delta = density[..., 0] * delta
    alpha = 1 - torch.exp(-density_delta)
    trans = torch.exp(-torch.cat([torch.zeros_like(density_delta[..., :1]),
                                  torch.cumsum(density_delta[..., :-1], -1)],
                                 -1))
    weights = alpha * trans
    comp_rgb = (weights[..., None] * rgb).sum(-2)
    acc = weights.sum(-1)
    if white_bkgd:
        comp_rgb = comp_rgb + (1. - acc[..., None])
    return comp_rgb, acc, weights


# ---------------------------------------------------------- models.py MLP
def _dense(x, layer, scale, tf32):
    mm = _TF32Matmul.apply if tf32 else torch.matmul
    y = mm(x, layer["kernel"])
    if scale is not None:
        y = y * scale
    return y + layer["bias"]


def mlp(params, x, condition, scales=None, tf32=False):
    """(raw_rgb, raw_density) of the encoded samples x (N, 96) and their
    rays' encoded view directions ``condition`` (N, 27): MLP.__call__ with
    net_depth 8, skip_layer 4, net_depth_condition 1, relu."""
    s = scales or {}
    dense = lambda h, i: _dense(h, params[f"Dense_{i}"], s.get(f"Dense_{i}"),
                                tf32)
    inputs = x
    for i in range(NET_DEPTH):
        x = torch.relu(dense(x, i))
        if i % SKIP_LAYER == 0 and i > 0:
            x = torch.cat([x, inputs], -1)
    raw_density = dense(x, 8)
    bottleneck = dense(x, 9)
    x = torch.relu(dense(torch.cat([bottleneck, condition], -1), 10))
    return dense(x, 11), raw_density


def _level(params, scales, samples, viewdirs, tf32):
    means, covs = samples
    R, S = means.shape[:2]
    enc = integrated_pos_enc(means, covs).reshape(R * S, -1)
    cond = pos_enc(viewdirs)[:, None, :].expand(R, S, -1).reshape(R * S, -1)
    raw_rgb, raw_density = mlp(params, enc, cond, scales, tf32)
    rgb = torch.sigmoid(raw_rgb.reshape(R, S, 3))
    rgb = rgb * (1 + 2 * RGB_PADDING) - RGB_PADDING
    density = torch.nn.functional.softplus(raw_density.reshape(R, S, 1)
                                           + DENSITY_BIAS)
    return rgb, density


def render_rays(params, rays, near, far, white_bkgd=True, draws=None,
                scales=None, tf32=False, num_samples=NUM_SAMPLES):
    """MipNerfModel.__call__ over ``rays`` = (origins, directions,
    viewdirs, radii (rays, 1)): [(comp_rgb, acc, weights, t_vals)] of the
    two levels. ``draws``: ``t_rand`` and ``u`` (randomized), or None
    (deterministic). ``num_samples``: the published 128, or fewer in the
    CPU tests."""
    origins, directions, viewdirs, radii = rays
    d = draws or {}
    out, t_vals, weights = [], None, None
    for level in range(NUM_LEVELS):
        if level == 0:
            t_vals, samples = sample_along_rays(
                origins, directions, radii, num_samples, near, far,
                d.get("t_rand"))
        else:
            t_vals, samples = resample_along_rays(
                origins, directions, radii, t_vals, weights, d.get("u"))
        rgb, density = _level(params, scales, samples, viewdirs, tf32)
        comp_rgb, acc, weights = volumetric_rendering(
            rgb, density, t_vals, directions, white_bkgd)
        out.append((comp_rgb, acc, weights, t_vals))
    return out


def loss(params, rays, pixels, near, far, draws, scales=None, tf32=False,
         white_bkgd=True, num_samples=NUM_SAMPLES):
    """(loss, fine loss) of one training step: 0.1 times the coarse level's
    loss plus the fine level's (train.py ``loss_fn``)."""
    mask = torch.ones_like(pixels[..., :1])
    levels = render_rays(params, rays, near, far, white_bkgd, draws, scales,
                         tf32, num_samples)
    losses = [(mask * (rgb - pixels[..., :3]) ** 2).sum() / mask.sum()
              for rgb, *_ in levels]
    return COARSE_LOSS_MULT * sum(losses[:-1]) + losses[-1], losses[-1]


def render_blocks(params, rays, near, far, white_bkgd=True, tf32=False,
                  block_rays=None, num_samples=NUM_SAMPLES):
    """The deterministic two-level render of (N,) rays without gradients,
    in blocks of rays whose samples fill ``BLOCK_POINTS``: (rgb, acc) of
    the fine level."""
    n = block_rays or max(1, BLOCK_POINTS // num_samples)
    rgbs, accs = [], []
    with fp32_matmul(), torch.no_grad():
        for s in range(0, rays[0].shape[0], n):
            part = tuple(r[s:s + n] for r in rays)
            rgb, acc, _w, _t = render_rays(params, part, near, far,
                                           white_bkgd, None, None, tf32,
                                           num_samples)[-1]
            rgbs.append(rgb)
            accs.append(acc)
    return torch.cat(rgbs), torch.cat(accs)


# ------------------------------------------------------------------- LSA
def follow_lsa(params, batches, draws, near, far, lr, tf32=False,
               white_bkgd=True, betas=(0.9, 0.999), eps=1e-8,
               block_rays=None, num_samples=NUM_SAMPLES):
    """LSA from scales of one: ``len(batches)`` steps of :func:`loss` and
    Adam on the scales of every layer of the one MLP. ``batches``: (rays,
    pixels) with rays as :func:`render_rays` takes them. The gradient of a
    step is summed over blocks of ``block_rays`` rays (all at once when
    None), each block's loss weighted by its share of the rays. Returns
    {"losses": per step, "grad1": {layer: norm of the first gradient},
    "change": {layer: norm of the scales' change after the last step}}."""
    dev = batches[0][1].device
    leaves = {name: torch.ones(layer["kernel"].shape[1], device=dev,
                               requires_grad=True)
              for name, layer in params.items()}
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
                dp = {k: x[s:s + nb] for k, x in d.items()}
                share = part[0].shape[0] / n
                value, _fine = loss(params, part, pixels[s:s + nb], near, far,
                                    dp, leaves, tf32, white_bkgd,
                                    num_samples)
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
