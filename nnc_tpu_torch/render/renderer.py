"""Hierarchical NeRF renderer.

Counterpart of ``nnc_tpu/render/renderer.py`` (reference: run_nerf.py:31-78,
348-457): stratified sampling -> posenc -> coarse MLP -> compositing ->
inverse-CDF resampling -> fine MLP -> compositing, over chunks of rays.
PyTorch runs eagerly, so a chunk's tail is not padded to the chunk size.

Deterministic renders with ``use_fused_mlp`` take the port's kernels under
the reference's dispatch: full fusion (K-B2, ``ops/render_fused.py``) when
``use_fused_compositing`` is set, ``raw_noise_std == 0`` and the posenc is
10/4; else ``raw2outputs`` on the fused MLP (``ops/mlp_fused.py``): from
points (K-B3, or K-B4 with ``use_int8_mlp``) when the posenc is 10/4, on
embeddings made here (K-B5 where the architecture has a kernel) when it is
not. Training
renders (``deterministic=False``) with ``use_fused_train`` run the MLP
through the differentiable kernel pair K-B1 (``ops/mlp_train_fused.py``),
else through the plain MLP in output-scaling form.

A model with ``config.compute_dtype == torch.bfloat16`` takes the bf16
variants of K-B2, K-B3 and K-B1 on the same routes, and the plain bf16 MLP
where no kernel is asked for. Its training renders keep the reference's two
bf16 forms apart: through K-B1 (``use_fused_train``) the unscaled weight is
rounded and u is scaled in float32 afterwards; through the plain MLP the
scale is folded into the weight before the rounding.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import parallel
from ..models import nerf
from ..ops import mlp_fused, mlp_train_fused
from ..ops.posenc import positional_encoding
from ..ops.render_fused import fused_render_pass
from ..ops.sampling import sample_pdf, stratified_samples
from ..utils import profiling
from .volume import raw2outputs


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """The reference's fields and defaults (nnc_tpu RenderConfig).
    ``fusion_sample_block`` and the ``occ_*`` tiles are the TPU kernels'
    block sizes; the port's K-B2 walks samples in blocks of
    ``render_fused.SAMPLE_BLOCK`` and occupancy mode culls at its ray tile.
    ``fusion_ray_tile`` is the culling granularity of the fine pass.
    ``use_occupancy_renders`` sends the executer's frame renders, and
    ``use_occupancy_tuning`` its LSA loss, through the occupancy grid
    (``render/occupancy.py``, ``train/lsa.double_mse_loss_occ``)."""
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


def _query_mlp(model: nerf.NeRF, pts, viewdirs, rc: RenderConfig,
               allow_fused: bool = True):
    """posenc + MLP over (R, S, 3) points. Returns raw (R, S, 4).

    allow_fused=False routes training: the differentiable kernel pair
    (use_fused_train, posenc 10/4) or the plain MLP in output-scaling form,
    which in bf16 is the reference's folded form (the inference kernels have
    no backward)."""
    posenc_10_4 = (rc.multires, rc.multires_views) == (10, 4)
    if not allow_fused and rc.use_fused_train and posenc_10_4:
        return mlp_train_fused.fused_nerf_mlp_train(
            model, pts, viewdirs[..., None, :], with_dw=rc.train_with_dw)
    if allow_fused and rc.use_fused_mlp and posenc_10_4:
        # posenc happens inside the kernel
        from_points = mlp_fused.fused_nerf_mlp_int8_from_points \
            if rc.use_int8_mlp else mlp_fused.fused_nerf_mlp_from_points
        return from_points(model, pts, viewdirs[..., None, :])
    pts_emb = positional_encoding(pts, rc.multires)
    views_emb = None
    if rc.mlp.use_viewdirs:
        # encoded once per ray, broadcast across its samples
        ve = positional_encoding(viewdirs, rc.multires_views)
        views_emb = ve[..., None, :].expand(*pts.shape[:-1], ve.shape[-1])
    if allow_fused and rc.use_fused_mlp:
        return mlp_fused.fused_nerf_mlp(model, pts_emb, views_emb)
    return nerf.apply_mlp(model, pts_emb, views_emb,
                          output_scaling=not allow_fused)


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
    n_rays = rays_o.shape[0]
    device = rays_o.device
    perturb = rc.perturb and not deterministic

    use_full_fusion = (rc.use_fused_compositing and rc.use_fused_mlp
                       and deterministic and rc.raw_noise_std == 0
                       and (rc.multires, rc.multires_views) == (10, 4)
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


def step_draws(n_rays: int, rc: RenderConfig, generator: torch.Generator,
               device=None) -> dict:
    """The random draws of one training render of ``n_rays`` rays, taken
    from ``generator`` in the order and shapes in which :func:`render_rays`
    takes them: ``t_rand``, ``noise0``, ``u``, ``noise1`` (each only where
    ``rc`` uses it). Drawn once for a batch, they can be split with its rays
    over a mesh."""
    rand = lambda *shape: torch.rand(shape, generator=generator,
                                     device=device)
    randn = lambda *shape: torch.randn(shape, generator=generator,
                                       device=device)
    noisy = rc.raw_noise_std > 0
    draws = {}
    if rc.perturb:
        draws["t_rand"] = rand(n_rays, rc.n_samples)
    if noisy:
        draws["noise0"] = randn(n_rays, rc.n_samples)
    if rc.n_importance > 0:
        if rc.perturb:
            draws["u"] = rand(n_rays, rc.n_importance)
        if noisy:
            draws["noise1"] = randn(n_rays, rc.n_samples + rc.n_importance)
    return draws


@torch.no_grad()
def render_image(model, model_fine, rays_o, rays_d, near, far,
                 rc: RenderConfig, viewdirs=None, device=None, mesh=None):
    """Deterministic render of an arbitrary set of rays, by chunks.

    rays_o/d: (N, 3) or (H, W, 3), numpy or tensors, moved to ``device``
    (default: the model's). Returns dict of tensors (rgb_map, disp_map,
    acc_map) on that device, with leading shape matching the input.

    With ``mesh`` each chunk (``rc.chunk`` rounded up to a multiple of the
    'data' size) is split in ray order into equal parts over the mesh's
    'data' devices, the last chunk's parts as even as its rays allow; every
    part is rendered on its device by that device's replica of the models,
    one part after the other on the device's current stream, and the
    results are joined in ray order on ``device``. Empty-ray culling and
    early termination group rays into tiles within a part, so a ray near a
    tile border may be culled or stopped in one render and not in the other:
    a mesh render equals the render without a mesh exactly where both are
    off, and else within the bound of a culled render against the exact one
    (5e-3 in the tests).

    While a torch profiler records, the call is an ``nnc.render.view``
    request span (``utils/profiling``) with an ``nnc.render.chunk`` span
    around each ``render_chunk``. With the rays on the device nothing here
    waits for it, so the view's span is the host's dispatch of the view."""
    with profiling.request("nnc.render.view",
                           rays=math.prod(rays_o.shape[:-1])):
        return _render_image(model, model_fine, rays_o, rays_d, near, far,
                             rc, viewdirs, device, mesh)


def _render_image(model, model_fine, rays_o, rays_d, near, far, rc,
                  viewdirs, device, mesh):
    device = torch.device(device) if device is not None else model.device
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32)
                                     if not torch.is_tensor(a) else a,
                                     dtype=torch.float32, device=device)
    lead_shape = tuple(rays_o.shape[:-1])
    ro = as_t(rays_o).reshape(-1, 3)
    rd = as_t(rays_d).reshape(-1, 3)
    vd = None if viewdirs is None else as_t(viewdirs).reshape(-1, 3)
    chunk = rc.chunk
    places = [(device, model, model_fine)]
    if mesh is not None:
        devices = parallel.data_devices(mesh)
        chunk = -(-chunk // len(devices)) * len(devices)
        rep_c = parallel.replicate_params(mesh, model)
        rep_f = None if model_fine is None else \
            parallel.replicate_params(mesh, model_fine)
        places = [(d, rep_c[d], None if rep_f is None else rep_f[d])
                  for d in devices]
    outs = []
    for start in range(0, ro.shape[0], chunk):
        end = min(start + chunk, ro.shape[0])
        part = -(-(end - start) // len(places))
        for i, (d, m_c, m_f) in enumerate(places):
            lo, hi = start + i * part, min(start + (i + 1) * part, end)
            if hi <= lo:
                break
            with profiling.span("nnc.render.chunk", rays=hi - lo):
                res = render_chunk(m_c, m_f, ro[lo:hi].to(d),
                                   rd[lo:hi].to(d), near, far, rc, True,
                                   None if vd is None else vd[lo:hi].to(d))
            outs.append({k: res[k].to(device)
                         for k in ("rgb_map", "disp_map", "acc_map")})
    return {k: torch.cat([o[k] for o in outs]).reshape(
                lead_shape + outs[0][k].shape[1:])
            for k in outs[0]}
