"""Hierarchical NeRF renderer.

Counterpart of ``nnc_tpu/render/renderer.py`` (reference: run_nerf.py:31-78,
348-457): stratified sampling -> posenc -> coarse MLP -> compositing ->
inverse-CDF resampling -> fine MLP -> compositing, over chunks of rays.
PyTorch runs eagerly, so a chunk's tail is not padded to the chunk size.

Deterministic renders with ``use_fused_mlp`` take the port's kernels under
the reference's dispatch: full fusion (K-B2, ``ops/render_fused.py``) when
``use_fused_compositing`` is set and ``raw_noise_std == 0``, else the fused
MLP from points (K-B3, ``ops/mlp_fused.py``) + ``raw2outputs``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models import nerf
from ..ops import mlp_fused
from ..ops.posenc import positional_encoding
from ..ops.render_fused import fused_render_pass
from ..ops.sampling import sample_pdf, stratified_samples
from .volume import raw2outputs


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """The reference's fields and defaults (nnc_tpu RenderConfig).
    ``fusion_sample_block`` and the ``occ_*`` tiles are the TPU kernels'
    block sizes; the port's K-B2 walks samples in blocks of
    ``render_fused.SAMPLE_BLOCK``. ``fusion_ray_tile`` is the culling
    granularity of the fine pass."""
    mlp: nerf.NeRFConfig = dataclasses.field(default_factory=nerf.NeRFConfig)
    n_samples: int = 64
    n_importance: int = 128
    multires: int = 10
    multires_views: int = 4
    perturb: bool = True
    white_bkgd: bool = False
    raw_noise_std: float = 0.0
    lindisp: bool = False
    chunk: int = 1024 * 32
    use_fused_mlp: bool = False
    use_int8_mlp: bool = False
    use_fused_compositing: bool = False
    early_term_eps: float = 1e-4
    empty_ray_eps: float = 1e-3
    fusion_ray_tile: int = 64
    fusion_sample_block: int = 32
    use_fused_train: bool = False
    train_with_dw: bool = False
    use_occupancy_renders: bool = False
    use_occupancy_tuning: bool = False
    occ_ray_tile: int = 128
    occ_sample_block: int = 16


def check_supported(rc: RenderConfig, deterministic: bool = True) -> None:
    """Raise for the render options whose kernels are not ported yet."""
    missing = []
    if not deterministic and rc.use_fused_train:
        missing.append("training renders with use_fused_train (kernel "
                       "K-B1, ROADMAP queue B)")
    if rc.use_int8_mlp:
        missing.append("use_int8_mlp (kernel K-B4, ROADMAP queue B)")
    if rc.use_fused_mlp and (rc.multires, rc.multires_views) != (10, 4):
        missing.append("use_fused_mlp with multires != 10/4 (kernel K-B5, "
                       "ROADMAP queue B)")
    if rc.use_occupancy_renders or rc.use_occupancy_tuning:
        missing.append("occupancy mode (ROADMAP A4)")
    if missing:
        raise NotImplementedError("not ported to nnc_tpu_torch yet: "
                                  + ", ".join(missing))


def _query_mlp(model: nerf.NeRF, pts, viewdirs, rc: RenderConfig,
               allow_fused: bool = True):
    """posenc + MLP over (R, S, 3) points. Returns raw (R, S, 4)."""
    if allow_fused and rc.use_fused_mlp:
        return mlp_fused.fused_nerf_mlp_from_points(model, pts,
                                                    viewdirs[..., None, :])
    pts_emb = positional_encoding(pts, rc.multires)
    views_emb = None
    if rc.mlp.use_viewdirs:
        ve = positional_encoding(viewdirs, rc.multires_views)
        views_emb = ve[..., None, :].expand(*pts.shape[:-1], ve.shape[-1])
    return nerf.apply_mlp(model, pts_emb, views_emb)


def render_rays(model, model_fine, rays_o, rays_d, viewdirs, near, far,
                rc: RenderConfig, deterministic: bool = False, *,
                t_rand=None, u=None, noise0=None, noise1=None,
                generator: Optional[torch.Generator] = None):
    """Render a batch of rays. rays_o/d, viewdirs: (R, 3); near/far scalar
    or (R, 1). The random draws of a non-deterministic render can be given:
    ``t_rand`` (stratified jitter), ``u`` (``sample_pdf``), ``noise0`` /
    ``noise1`` (coarse / fine sigma noise); missing ones are drawn from
    ``generator``. Returns dict with rgb_map/disp_map/acc_map (+ rgb0/disp0/
    acc0/z_std when n_importance > 0)."""
    check_supported(rc, deterministic)
    n_rays = rays_o.shape[0]
    device = rays_o.device
    perturb = rc.perturb and not deterministic

    use_full_fusion = (rc.use_fused_compositing and rc.use_fused_mlp
                       and deterministic and rc.raw_noise_std == 0
                       and mlp_fused.supports(rc.mlp))

    def one_pass(m, z, noise, ro=rays_o, rd=rays_d, vd=viewdirs,
                 ray_flags=None, need_weights=True):
        if use_full_fusion:
            o = fused_render_pass(m, ro, rd, vd, z,
                                  early_term_eps=rc.early_term_eps,
                                  ray_flags=ray_flags,
                                  r_t=rc.fusion_ray_tile,
                                  return_weights=need_weights)
            if rc.white_bkgd:
                o["rgb_map"] = o["rgb_map"] + (1.0 - o["acc_map"][..., None])
            return o
        pts = ro[..., None, :] + rd[..., None, :] * z[..., :, None]
        raw = _query_mlp(m, pts, vd, rc, allow_fused=deterministic)
        if not deterministic and rc.raw_noise_std > 0 and noise is None:
            noise = torch.randn(z.shape, generator=generator, device=device)
        return raw2outputs(raw, z, rd, rc.raw_noise_std, rc.white_bkgd,
                           noise=None if deterministic else noise)

    z_vals = stratified_samples(near, far, rc.n_samples, n_rays, perturb,
                                rc.lindisp, t_rand=t_rand,
                                generator=generator, device=device)
    out = one_pass(model, z_vals, noise0)

    ret = {}
    if rc.n_importance > 0:
        ret["rgb0"] = out["rgb_map"]
        ret["disp0"] = out["disp_map"]
        ret["acc0"] = out["acc_map"]

        z_mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        z_samples = sample_pdf(z_mids, out["weights"][..., 1:-1],
                               rc.n_importance, det=not perturb, u=u,
                               generator=generator).detach()
        z_all, _ = torch.sort(torch.cat([z_vals, z_samples], -1), dim=-1)
        fine = model_fine if model_fine is not None else model
        if use_full_fusion and rc.empty_ray_eps > 0:
            r_t = rc.fusion_ray_tile
            # empty-ray culling: sort rays so inactive ones (coarse acc
            # below threshold) cluster into whole skippable ray tiles; the
            # coarse maps substitute for rays in skipped tiles
            active = out["acc_map"] > rc.empty_ray_eps
            order = torch.argsort((~active).to(torch.uint8), stable=True)
            inv = torch.argsort(order)
            out_f = one_pass(fine, z_all[order], noise1, ro=rays_o[order],
                             rd=rays_d[order], vd=viewdirs[order],
                             ray_flags=active[order], need_weights=False)
            n_tiles = -(-n_rays // r_t)
            tiles = F.pad(active[order], (0, n_tiles * r_t - n_rays)) \
                .reshape(n_tiles, r_t).any(dim=1)
            computed = tiles.repeat_interleave(r_t)[:n_rays][inv]
            out = {k: torch.where(
                       computed.reshape((-1,) + (1,) * (out_f[k].ndim - 1)),
                       out_f[k][inv], out[k])
                   for k in ("rgb_map", "disp_map", "acc_map")}
        else:
            out = one_pass(fine, z_all, noise1, need_weights=False)
        ret["z_std"] = torch.std(z_samples, dim=-1, unbiased=False)

    ret["rgb_map"] = out["rgb_map"]
    ret["disp_map"] = out["disp_map"]
    ret["acc_map"] = out["acc_map"]
    return ret


def render_chunk(model, model_fine, rays_o, rays_d, near, far,
                 rc: RenderConfig, deterministic: bool = True,
                 viewdirs=None, **draws):
    """One chunk; viewdirs derived from rays_d unless given (NDC rays pass
    pre-warp directions, run_nerf.py:119-133)."""
    if viewdirs is None:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    return render_rays(model, model_fine, rays_o, rays_d, viewdirs, near,
                       far, rc, deterministic, **draws)


@torch.no_grad()
def render_image(model, model_fine, rays_o, rays_d, near, far,
                 rc: RenderConfig, viewdirs=None, device=None):
    """Deterministic render of an arbitrary set of rays, by chunks.

    rays_o/d: (N, 3) or (H, W, 3), numpy or tensors, moved to ``device``
    (default: the model's). Returns dict of tensors (rgb_map, disp_map,
    acc_map) on that device, with leading shape matching the input."""
    device = torch.device(device) if device is not None else model.device
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32)
                                     if not torch.is_tensor(a) else a,
                                     dtype=torch.float32, device=device)
    lead_shape = tuple(rays_o.shape[:-1])
    ro = as_t(rays_o).reshape(-1, 3)
    rd = as_t(rays_d).reshape(-1, 3)
    vd = None if viewdirs is None else as_t(viewdirs).reshape(-1, 3)
    outs = []
    for start in range(0, ro.shape[0], rc.chunk):
        end = start + rc.chunk
        res = render_chunk(model, model_fine, ro[start:end], rd[start:end],
                           near, far, rc, True,
                           None if vd is None else vd[start:end])
        outs.append({k: res[k] for k in ("rgb_map", "disp_map", "acc_map")})
    return {k: torch.cat([o[k] for o in outs]).reshape(
                lead_shape + outs[0][k].shape[1:])
            for k in outs[0]}
