"""The deterministic hierarchical render of ``reference/nerf.py`` with the
view directions given: a forward-facing scene's rays are warped to NDC, and
its view directions are taken before the warp, as nerf-pytorch takes them.
Built on ``reference/nerf.py``'s functions; plain PyTorch in float32 with
TF32 off, importing nothing of the program."""
from __future__ import annotations

import math

import torch

from benchmark.reference.nerf import (_gaps, _query_blocks, composite_et,
                                      fp32_matmul, sample_pdf, stratified)


def render_view(net, render, nets, rays_o, rays_d, viewdirs, tf32=False):
    """``reference.nerf.render_view`` of (N, 3) rays seen along
    ``viewdirs`` (N, 3): (rgb (N, 3), acc (N,), needed points: the samples
    before early termination of every coarse ray and of every ray the
    culling keeps)."""
    term = -math.log(render["early_term_eps"])
    block, tile = render["sample_block"], render["ray_tile"]
    rgbs, accs, needed = [], [], 0
    with fp32_matmul():
        for s in range(0, rays_o.shape[0], render["chunk"]):
            ro = rays_o[s:s + render["chunk"]]
            rd = rays_d[s:s + render["chunk"]]
            vd = viewdirs[s:s + render["chunk"]]
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
