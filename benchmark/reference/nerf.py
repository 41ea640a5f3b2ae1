"""The plain reference of vanilla NeRF (Mildenhall et al., ECCV 2020, as
nerf-pytorch implements it): positional encoding, the 8x256 MLP with its
skip and view branch, stratified and inverse-CDF sampling, alpha
compositing, the double MSE loss of a training step, LSA's per-channel
weight scales and Adam on them; the deterministic render with the
program's early termination and empty-ray culling as stated below; and the
occupancy grid, its sample selection and a frame rendered on it.

Plain PyTorch in float32 with TF32 off, on whatever device its inputs are
on; it imports nothing of the program and takes nothing the program made.
``tf32=True`` computes every product of the MLP on operands rounded to TF32
(10-bit mantissa, to nearest), the precision below float32 on the card: that
is the control that the comparison has to fail.

Stated semantics that the program shares with the published reference:
  * early termination: samples are taken in blocks of ``block``; a block
    of a tile of ``ray_tile`` rays is skipped once the smallest optical
    depth (sum of sigma * dist before the block) among the tile's rays
    reaches ``-log(eps)``, every later block with it;
  * empty-ray culling: a chunk's rays are sorted stably, those whose coarse
    opacity exceeds ``empty_ray_eps`` first; the fine pass runs on the
    tiles of ``cull_tile`` sorted rays that hold such a ray, the others
    keep their coarse maps;
  * occupancy mode: the grid thresholds sigma at the voxel centres, tests
    its shell for leaking density (more than 2% occupied: open), and
    dilates with the 6-connected cross; a frame selects on the centre ray of
    each ``factor`` x ``factor`` pixel block ``n_candidates`` candidates in
    the ray's span through the grid's tight box (widened by two voxels),
    dilates the hits by one candidate along the ray (wrapping round) and
    keeps every ceil(m / budget)-th of the m hits, each integrating over
    that stride.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

BLOCK_POINTS = 1 << 19   # points an MLP block holds (activations ~0.7 GB)


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


def posenc(x, multires: int):
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(L-1) x), cos(2^(L-1) x)]."""
    out = [x]
    for k in range(multires):
        out += [torch.sin(x * 2.0 ** k), torch.cos(x * 2.0 ** k)]
    return torch.cat(out, -1)


class _TF32Linear(torch.autograd.Function):
    """x @ w^T with every product of the forward and the backward on
    operands rounded to TF32, sums in float32, as the card's TF32 mode
    computes a linear layer."""

    @staticmethod
    def forward(ctx, x, w):
        x, w = round_tf32(x), round_tf32(w)
        ctx.save_for_backward(x, w)
        return x @ w.t()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = round_tf32(g)
        return g @ w, g.t() @ x


def _linear(x, wb, scale, tf32):
    w, b = wb
    if scale is not None:
        w = w * scale
    if tf32:
        return _TF32Linear.apply(x, w) + b
    return x @ w.t() + b


def mlp(net, weights, pts, viewdirs, scales=None, tf32=False):
    """raw (N, 4) = (rgb logits, sigma) of points (N, 3) seen along
    viewdirs (N, 3); ``weights`` {layer: (w (out, in), b)}, ``scales``
    {layer: (out, 1)} LSA's per-channel weight scales or None."""
    s = scales or {}
    pe = posenc(pts, net["multires"])
    ve = posenc(viewdirs, net["multires_views"])
    h = pe
    for i in range(net["netdepth"]):
        name = f"pts_linears.{i}"
        h = F.relu(_linear(h, weights[name], s.get(name), tf32))
        if i in net["skips"]:
            h = torch.cat([pe, h], -1)
    alpha = _linear(h, weights["alpha_linear"], s.get("alpha_linear"), tf32)
    feat = _linear(h, weights["feature_linear"], s.get("feature_linear"),
                   tf32)
    h = F.relu(_linear(torch.cat([feat, ve], -1), weights["views_linears.0"],
                       s.get("views_linears.0"), tf32))
    rgb = _linear(h, weights["rgb_linear"], s.get("rgb_linear"), tf32)
    return torch.cat([rgb, alpha], -1)


def mlp_blocks(net, weights, pts, viewdirs, tf32=False):
    """:func:`mlp` without gradients, ``BLOCK_POINTS`` points at a time."""
    with torch.no_grad():
        return torch.cat([mlp(net, weights, pts[i:i + BLOCK_POINTS],
                              viewdirs[i:i + BLOCK_POINTS], tf32=tf32)
                          for i in range(0, pts.shape[0], BLOCK_POINTS)]) \
            if pts.shape[0] else pts.new_zeros((0, 4))


def linspace01(n: int, device):
    """linspace(0, 1, n) in float32 as numpy rounds it."""
    return torch.from_numpy(np.linspace(np.float32(0), np.float32(1), n,
                                        dtype=np.float32)).to(device)


def cumsum_seq(x):
    """Left-to-right float32 running sum over the last axis."""
    acc, out = x[..., 0], [x[..., 0]]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
        out.append(acc)
    return torch.stack(out, -1)


def stratified(near, far, n: int, n_rays: int, t_rand, device):
    t = linspace01(n, device)
    z = (near * (1.0 - t) + far * t).expand(n_rays, n)
    if t_rand is None:
        return z
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    upper = torch.cat([mids, z[..., -1:]], -1)
    lower = torch.cat([z[..., :1], mids], -1)
    return lower + (upper - lower) * t_rand


def sample_pdf(bins, weights, n: int, u=None):
    """Inverse-CDF samples of the piecewise-constant pdf ``weights`` over
    ``bins``; ``u`` None takes linspace(0, 1, n)."""
    weights = weights + 1e-5
    pdf = weights / cumsum_seq(weights)[..., -1:]
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]), cumsum_seq(pdf)], -1)
    if u is None:
        u = linspace01(n, cdf.device).expand(cdf.shape[0], n)
    u = u.contiguous()
    idx = torch.searchsorted(cdf, u, right=True)
    below = torch.clamp(idx - 1, min=0)
    above = torch.clamp(idx, max=cdf.shape[-1] - 1)
    c0, c1 = cdf.gather(-1, below), cdf.gather(-1, above)
    b0, b1 = bins.gather(-1, below), bins.gather(-1, above)
    denom = c1 - c0
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return b0 + (u - c0) / denom * (b1 - b0)


def _dists(z, rays_d):
    d = torch.cat([z[..., 1:] - z[..., :-1],
                   torch.full_like(z[..., :1], 1e10)], -1)
    return d * torch.linalg.norm(rays_d[..., None, :], dim=-1)


def raw2outputs(raw, z, rays_d, noise_std=0.0, noise=None, white=False):
    """Alpha compositing as the published training render takes it (the
    transmittance as a product of 1 - alpha + 1e-10)."""
    sigma = raw[..., 3]
    if noise is not None and noise_std > 0:
        sigma = sigma + noise_std * noise
    alpha = 1.0 - torch.exp(-F.relu(sigma) * _dists(z, rays_d))
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]),
                                     1.0 - alpha + 1e-10], -1), -1)[..., :-1]
    w = alpha * trans
    rgb = torch.sum(w[..., None] * torch.sigmoid(raw[..., :3]), -2)
    acc = w.sum(-1)
    if white:
        rgb = rgb + (1.0 - acc[..., None])
    return rgb, w


def _query(net, weights, scales, rays_o, rays_d, viewdirs, z, tf32):
    R, S = z.shape
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    vd = viewdirs[:, None, :].expand(R, S, 3)
    return mlp(net, weights, pts.reshape(-1, 3), vd.reshape(-1, 3), scales,
               tf32).reshape(R, S, 4)


def train_loss(net, render, nets, scales, batch, draws, tf32=False):
    """(loss, img_loss) of one training step: the coarse render on the
    stratified samples, the fine one on their union with ``sample_pdf``'s,
    loss = mse(fine) + mse(coarse). ``nets`` / ``scales``: (coarse, fine);
    ``batch``: (rays_o, rays_d, viewdirs, target) (N, 3) each; ``draws``:
    ``t_rand``, ``u`` and, with raw noise, ``noise0`` / ``noise1``."""
    ro, rd, vd, target = batch
    std = render["raw_noise_std"]
    z = stratified(render["near"], render["far"], render["N_samples"],
                   ro.shape[0], draws["t_rand"], ro.device)
    raw = _query(net, nets[0], scales[0], ro, rd, vd, z, tf32)
    rgb0, w0 = raw2outputs(raw, z, rd, std, draws.get("noise0"),
                           render["white_bkgd"])
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    zs = sample_pdf(mids, w0[..., 1:-1].detach(), render["N_importance"],
                    draws["u"]).detach()
    z_all, _ = torch.sort(torch.cat([z, zs], -1), -1)
    raw = _query(net, nets[1], scales[1], ro, rd, vd, z_all, tf32)
    rgb, _ = raw2outputs(raw, z_all, rd, std, draws.get("noise1"),
                         render["white_bkgd"])
    img_loss = torch.mean((rgb - target) ** 2)
    return img_loss + torch.mean((rgb0 - target) ** 2), img_loss


def follow_lsa(net, render, nets, batches, draws, lr, tf32=False,
               betas=(0.9, 0.999), eps=1e-8):
    """LSA from scales of one: ``len(batches)`` steps of :func:`train_loss`
    and Adam on the scales of every layer of both networks. Returns
    {"losses": per step, "grad1": {leaf: norm of the first gradient},
    "change": {leaf: norm of the scales' change after the last step}};
    a leaf is ``c.<layer>`` / ``f.<layer>``."""
    dev = batches[0][0].device
    leaves = {f"{tag}.{name}": torch.ones(w.shape[0], 1, device=dev,
                                          requires_grad=True)
              for tag, ws in zip("cf", nets) for name, (w, _b) in ws.items()}
    scales = tuple({name[2:]: t for name, t in leaves.items()
                    if name[0] == tag} for tag in "cf")
    m = {k: torch.zeros_like(t) for k, t in leaves.items()}
    v = {k: torch.zeros_like(t) for k, t in leaves.items()}
    losses, grad1 = [], {}
    with fp32_matmul():
        for step, (batch, d) in enumerate(zip(batches, draws), start=1):
            loss, _img = train_loss(net, render, nets, scales, batch, d, tf32)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            losses.append(float(loss.detach()))
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


# ---------------------------------------------------------------------------
# the deterministic render with early termination and culling
# ---------------------------------------------------------------------------
def composite_et(raw, z, dists, rays_d, term_csd, ray_tile, block, live,
                 white):
    """Maps of one pass with early termination. ``dists`` (R, S) before the
    ray's length; ``live`` (R,) bool. Returns (rgb, acc, weights, needed):
    ``needed`` (R,) the samples each ray takes before its own optical depth
    reaches ``term_csd``."""
    R, S = z.shape
    sd = F.relu(raw[..., 3]) * dists * torch.linalg.norm(rays_d, dim=-1,
                                                         keepdim=True)
    csd = torch.cumsum(F.pad(sd[:, :-1], (1, 0)), -1)   # before each sample
    w = (1.0 - torch.exp(-sd)) * torch.exp(-csd)
    nb = -(-S // block)
    starts = csd[:, ::block]                            # (R, nb)
    nt = -(-R // ray_tile)
    pad = nt * ray_tile - R
    tile_min = F.pad(starts, (0, 0, 0, pad), value=math.inf) \
        .reshape(nt, ray_tile, nb).amin(1)
    tile_live = F.pad(live, (0, pad)).reshape(nt, ray_tile).any(1)
    on = ((tile_min < term_csd) & tile_live[:, None]) \
        .repeat_interleave(ray_tile, 0)[:R]
    w = w * on.repeat_interleave(block, 1)[:, :S]
    rgb = torch.sum(w[..., None] * torch.sigmoid(raw[..., :3]), 1)
    acc = w.sum(1)
    if white:
        rgb = rgb + (1.0 - acc[:, None])
    return rgb, acc, w, (csd < term_csd).sum(1)


def render_view(net, render, nets, rays_o, rays_d, tf32=False):
    """The deterministic hierarchical render of a view's rays (N, 3) in
    chunks of ``render["chunk"]``, with early termination and culling.
    Returns (rgb (N, 3), acc (N,), needed points: the samples before early
    termination of every coarse ray and of every ray the culling keeps)."""
    term = -math.log(render["early_term_eps"])
    block, tile = render["sample_block"], render["ray_tile"]
    rgbs, accs, needed = [], [], 0
    with fp32_matmul():
        for s in range(0, rays_o.shape[0], render["chunk"]):
            ro = rays_o[s:s + render["chunk"]]
            rd = rays_d[s:s + render["chunk"]]
            vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
            R = ro.shape[0]
            z = stratified(render["near"], render["far"],
                           render["N_samples"], R, None, ro.device)
            raw = _query_blocks(net, nets[0], ro, rd, vd, z, tf32)
            rgb0, acc0, w0, n0 = composite_et(
                raw, z, _gaps(z), rd, term, tile, block,
                torch.ones(R, dtype=torch.bool, device=ro.device),
                render["white_bkgd"])
            zs = sample_pdf(0.5 * (z[:, 1:] + z[:, :-1]), w0[:, 1:-1],
                            render["N_importance"])
            z_all, _ = torch.sort(torch.cat([z, zs], -1), -1)
            active = acc0 > render["empty_ray_eps"]
            order = torch.argsort((~active).to(torch.uint8), stable=True)
            n_act = int(active.sum())
            cull = render["cull_tile"]
            n_live = min(R, -(-n_act // cull) * cull)
            keep = order[:n_live]
            rgb, acc = rgb0.clone(), acc0.clone()
            if n_live:
                raw = _query_blocks(net, nets[1], ro[keep], rd[keep],
                                    vd[keep], z_all[keep], tf32)
                rgb1, acc1, _w, n1 = composite_et(
                    raw, z_all[keep], _gaps(z_all[keep]), rd[keep], term,
                    tile, block, torch.ones_like(active[keep]),
                    render["white_bkgd"])
                rgb[keep], acc[keep] = rgb1, acc1
                # only the rays that culling keeps for themselves count
                needed += int((n1 * active[keep]).sum())
            needed += int(n0.sum())
            rgbs.append(rgb)
            accs.append(acc)
    return torch.cat(rgbs), torch.cat(accs), needed


def _gaps(z):
    return torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)],
                     -1)


def _query_blocks(net, weights, ro, rd, vd, z, tf32):
    R, S = z.shape
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
    return mlp_blocks(net, weights, pts.reshape(-1, 3),
                      vd[:, None, :].expand(R, S, 3).reshape(-1, 3),
                      tf32).reshape(R, S, 4)


# ---------------------------------------------------------------------------
# occupancy mode
# ---------------------------------------------------------------------------
def build_grid(net, weights, grid_cfg, device, tf32=False):
    """The occupancy grid of a network: {"occ" (res, res, res) bool, "lo",
    "hi", "box" (tight occupied box with one voxel's margin, or None),
    "open"}."""
    res, lo, hi = grid_cfg["res"], grid_cfg["lo"], grid_cfg["hi"]
    axes = [torch.tensor(l + (np.arange(res, dtype=np.float32) + 0.5)
                         * (h - l) / res, device=device)
            for l, h in zip(lo, hi)]
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
    pts = torch.stack([gx, gy, gz], -1).reshape(-1, 3)
    vd = torch.zeros_like(pts)
    vd[:, 2] = 1.0
    with fp32_matmul():
        sigma = F.relu(mlp_blocks(net, weights, pts, vd, tf32)[:, 3])
    occ = (sigma > grid_cfg["sigma_threshold"]).reshape(res, res, res)
    shell = torch.ones_like(occ)
    shell[1:-1, 1:-1, 1:-1] = False
    is_open = float(occ[shell].float().mean()) > 0.02
    for _ in range(grid_cfg["dilate"]):
        grown = occ.clone()
        for d in range(3):
            n = occ.shape[d]
            grown.narrow(d, 1, n - 1).logical_or_(occ.narrow(d, 0, n - 1))
            grown.narrow(d, 0, n - 1).logical_or_(occ.narrow(d, 1, n - 1))
        occ = grown
    box = None
    if bool(occ.any()):
        box_lo, box_hi = [], []
        for d, (l, h) in enumerate(zip(lo, hi)):
            nz = torch.nonzero(occ.any(dim=tuple(a for a in range(3)
                                                 if a != d))).flatten()
            vox = (h - l) / res
            box_lo.append(l + (int(nz[0]) - 1) * vox)
            box_hi.append(l + (int(nz[-1]) + 2) * vox)
        box = (box_lo, box_hi)
    return {"occ": occ, "lo": lo, "hi": hi, "box": box, "open": is_open}


def _occupied(grid, px, py, pz):
    res = grid["occ"].shape[0]
    idx, inside = [], None
    for p, l, h in zip((px, py, pz), grid["lo"], grid["hi"]):
        i = torch.floor((p - l) * (res / (h - l))).to(torch.int32)
        ok = (i >= 0) & (i < res)
        inside = ok if inside is None else inside & ok
        idx.append(torch.clamp(i, 0, res - 1).long())
    hit = grid["occ"].reshape(-1)[(idx[0] * res + idx[1]) * res + idx[2]]
    return hit | ~inside if grid["open"] else hit & inside


def select_frame(grid, rays_o, rays_d, near, far, occ_cfg):
    """(z, dists) (H * W, budget) of a frame's rays (H, W, 3): the
    selection of each pixel block's centre ray."""
    H, W, _ = rays_o.shape
    f = occ_cfg["subsample"]
    C, B = occ_cfg["n_candidates"], occ_cfg["budget"]
    ro = rays_o[f // 2::f, f // 2::f].reshape(-1, 3)
    rd = rays_d[f // 2::f, f // 2::f].reshape(-1, 3)
    t0 = torch.full((ro.shape[0],), float(near), device=ro.device)
    t1 = torch.full((ro.shape[0],), float(far), device=ro.device)
    if grid["box"] is not None and not grid["open"]:
        for d in range(3):
            o, dd = ro[:, d], rd[:, d]
            tiny = torch.where(dd < 0, -1e-9, 1e-9)
            safe = torch.where(torch.abs(dd) < 1e-9, tiny, dd)
            ta = (grid["box"][0][d] - o) / safe
            tb = (grid["box"][1][d] - o) / safe
            t0 = torch.maximum(t0, torch.minimum(ta, tb))
            t1 = torch.minimum(t1, torch.maximum(ta, tb))
    res = grid["occ"].shape[0]
    margin = 2.0 * max(h - l for l, h in zip(grid["lo"], grid["hi"])) / res
    t0 = torch.clamp(t0[:, None] - margin, min=float(near))
    t1 = torch.clamp(t1[:, None] + margin, max=float(far))
    span = torch.clamp_min(t1 - t0, 0.0)
    cand = (torch.arange(C, dtype=torch.float32, device=ro.device) + 0.5) / C
    z = t0 + span * cand
    occ = _occupied(grid, *(ro[:, d:d + 1] + rd[:, d:d + 1] * z
                            for d in range(3))) & (span > 0)
    occ = occ | torch.roll(occ, 1, 1) | torch.roll(occ, -1, 1)
    m = occ.sum(-1, keepdim=True)
    stride = torch.clamp_min((m + B - 1) // B, 1)
    rank = torch.cumsum(occ.long(), -1) - 1
    kept = occ & (rank % stride == 0)
    ci = torch.arange(C, device=ro.device).expand(occ.shape)
    key = torch.where(kept, 2 * C - ci, -ci)
    sel = torch.argsort(key, dim=-1, descending=True)[:, :B]
    mask = kept.gather(-1, sel)
    spacing = span / C
    z_sel = t0 + (sel.float() + 0.5) * spacing
    dists = torch.where(mask, spacing * stride.float(), 0.0)
    up = lambda a: a.reshape(H // f, W // f, B).repeat_interleave(f, 0) \
        .repeat_interleave(f, 1).reshape(H * W, B)
    return up(z_sel), up(dists)


def render_frame(net, weights, grid, rays_o, rays_d, near, far, occ_cfg,
                 white, tf32=False):
    """A frame (H, W, 3) rays in occupancy mode: (rgb (H * W, 3), acc
    (H * W,), filled sample slots)."""
    z, dists = select_frame(grid, rays_o, rays_d, near, far, occ_cfg)
    ro, rd = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    filled = dists > 0
    raw = torch.zeros(z.shape + (4,), device=z.device)
    rows, cols = torch.nonzero(filled, as_tuple=True)
    pts = ro[rows] + rd[rows] * z[rows, cols][:, None]
    with fp32_matmul():
        raw[rows, cols] = mlp_blocks(net, weights, pts, vd[rows], tf32)
    sd = F.relu(raw[..., 3]) * dists * torch.linalg.norm(rd, dim=-1,
                                                         keepdim=True)
    w = (1.0 - torch.exp(-sd)) * torch.exp(
        -torch.cumsum(F.pad(sd[:, :-1], (1, 0)), -1))
    rgb = torch.sum(w[..., None] * torch.sigmoid(raw[..., :3]), 1)
    acc = w.sum(1)
    if white:
        rgb = rgb + (1.0 - acc[:, None])
    return rgb, acc, int(filled.sum())
