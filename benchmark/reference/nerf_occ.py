"""The plain reference of LSA on an occupancy grid (the port's
``--occupancy_tuning``): each ray's samples selected on the grid, both
networks integrating the same selection, the double MSE loss, LSA's
per-channel weight scales and Adam on them.

It builds on ``reference/nerf.py``: the grid is that file's
:func:`build_grid` (sigma thresholded at the voxel centres, the shell
tested for leaking density before the 6-connected dilation), the lookup its
``_occupied``, the MLP its ``mlp``. The selection of an LSA step differs from
a frame's (``select_frame``): every ray selects for itself, in [near, far]
cut by the grid's tight box (not widened, and the whole [near, far] with an
open boundary), ``n_candidates`` candidates at the centres of equal steps,
no dilation along the ray; of the m occupied candidates every ceil(m /
budget)-th is kept, in ray order, each integrating over that stride; the
budget's empty slots integrate nothing. Compositing takes the selection's
spans as the distances (alpha = 1 - exp(-relu(sigma) * dist * |d|), the
transmittance a product of 1 - alpha + 1e-10), and loss = mse(fine) +
mse(coarse).

Plain PyTorch in float32 with TF32 off, on whatever device its inputs are
on; it imports nothing of the program. ``tf32=True`` computes every product
of the MLP on operands rounded to TF32: the control that the comparison has
to fail.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.nerf import _occupied, build_grid, fp32_matmul, mlp

__all__ = ["build_grid", "grid_from_occ", "select_rays", "train_loss",
           "follow_lsa"]


def grid_from_occ(occ, lo, hi, is_open: bool) -> dict:
    """A grid in :func:`build_grid`'s form from dilated occupancy bits (the
    program's, for instance): its tight occupied box with one voxel's
    margin, as build_grid finds it."""
    res = occ.shape[0]
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


def select_rays(grid, rays_o, rays_d, near, far, n_candidates: int,
                budget: int):
    """(z, dists) (R, budget) of an LSA step's rays (R, 3)."""
    C, B = n_candidates, budget
    t0 = torch.full((rays_o.shape[0],), float(near), device=rays_o.device)
    t1 = torch.full((rays_o.shape[0],), float(far), device=rays_o.device)
    if grid["box"] is not None and not grid["open"]:
        for d in range(3):
            o, dd = rays_o[:, d], rays_d[:, d]
            tiny = torch.where(dd < 0, -1e-9, 1e-9)
            safe = torch.where(torch.abs(dd) < 1e-9, tiny, dd)
            ta = (grid["box"][0][d] - o) / safe
            tb = (grid["box"][1][d] - o) / safe
            t0 = torch.maximum(t0, torch.minimum(ta, tb))
            t1 = torch.minimum(t1, torch.maximum(ta, tb))
    span = torch.clamp_min(t1 - t0, 0.0)[:, None]
    cand = (torch.arange(C, dtype=torch.float32, device=rays_o.device)
            + 0.5) / C
    z = t0[:, None] + span * cand
    occ = _occupied(grid, *(rays_o[:, d:d + 1] + rays_d[:, d:d + 1] * z
                            for d in range(3))) & (span > 0)
    m = occ.sum(-1, keepdim=True)
    stride = torch.clamp_min((m + B - 1) // B, 1)
    rank = torch.cumsum(occ.long(), -1) - 1
    kept = occ & (rank % stride == 0)
    ci = torch.arange(C, device=rays_o.device).expand(occ.shape)
    key = torch.where(kept, 2 * C - ci, -ci)
    sel = torch.argsort(key, dim=-1, descending=True)[:, :B]
    mask = kept.gather(-1, sel)
    spacing = span / C
    z_sel = t0[:, None] + (sel.float() + 0.5) * spacing
    dists = torch.where(mask, spacing * stride.float(), 0.0)
    return z_sel, dists


def _render(net, weights, scales, ro, rd, vd, z, dists, white, tf32):
    R, S = z.shape
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
    raw = mlp(net, weights, pts.reshape(-1, 3),
              vd[:, None, :].expand(R, S, 3).reshape(-1, 3), scales,
              tf32).reshape(R, S, 4)
    sd = F.relu(raw[..., 3]) * dists * torch.linalg.norm(rd, dim=-1,
                                                         keepdim=True)
    alpha = 1.0 - torch.exp(-sd)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]),
                                     1.0 - alpha + 1e-10], -1), -1)[..., :-1]
    w = alpha * trans
    rgb = torch.sum(w[..., None] * torch.sigmoid(raw[..., :3]), -2)
    if white:
        rgb = rgb + (1.0 - w.sum(-1)[..., None])
    return rgb


def train_loss(net, render, nets, scales, batch, grid, occ_cfg,
               tf32=False):
    """(loss, img_loss) of one occupancy LSA step: the rays' selection (no
    gradient), the fine network's mse plus the coarse one's on it.
    ``nets`` / ``scales``: (coarse, fine); ``batch``: (rays_o, rays_d,
    viewdirs, target) (N, 3) each."""
    ro, rd, vd, target = batch
    with torch.no_grad():
        z, dists = select_rays(grid, ro, rd, render["near"], render["far"],
                               occ_cfg["n_candidates"], occ_cfg["budget"])
    one = lambda i: _render(net, nets[i], scales[i], ro, rd, vd, z, dists,
                            render["white_bkgd"], tf32)
    img_loss = torch.mean((one(1) - target) ** 2)
    return img_loss + torch.mean((one(0) - target) ** 2), img_loss


def follow_lsa(net, render, nets, batches, grid, occ_cfg, lr, tf32=False,
               betas=(0.9, 0.999), eps=1e-8):
    """LSA from scales of one: ``len(batches)`` steps of :func:`train_loss`
    on ``grid`` and Adam on the scales of every layer of both networks.
    Returns {"losses": per step, "grad1": {leaf: norm of the first
    gradient}, "change": {leaf: norm of the scales' change after the last
    step}}; a leaf is ``c.<layer>`` / ``f.<layer>``."""
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
        for step, batch in enumerate(batches, start=1):
            loss, _img = train_loss(net, render, nets, scales, batch, grid,
                                    occ_cfg, tf32)
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
