"""Fused deterministic render pass: kernel K-B2 and its plain version.

Counterpart of ``fused_render_pass`` in ``nnc_tpu/ops/render_pallas.py``:
posenc + the flagship MLP + alpha compositing with a running optical depth
T = exp(-sum sigma * dist) (not ``raw2outputs``' cumprod), with early ray
termination and skipping of culled ray tiles.

Tiling semantics, shared by the kernel (``csrc/render_pass.cu``) and the
plain version so that both skip the same work: rays are taken in tiles of
``RAY_TILE`` and samples in blocks of ``SAMPLE_BLOCK``. A block of a tile is
skipped once the smallest optical depth among the tile's rays reaches
-log(early_term_eps) (and every later block with it), which bounds each
map's error by early_term_eps. A tile none of whose rays is live outputs
zeros. The culling granularity ``r_t`` (the renderer's
``fusion_ray_tile``) is applied on top: a ray is live when any ray of its
``r_t``-tile is flagged, as in the reference.

A model with ``config.compute_dtype == torch.bfloat16`` takes the bf16
variant (``csrc/render_pass_bf16.cu``: the bf16 chain of
``csrc/nerf_mlp_bf16.cuh`` under the same float32 compositing), and
:func:`fused_render_pass_bf16_plain`. It decides early termination per ray
(``RAY_TILE_BF16`` = 1): its persistent CTAs fill each MLP tile's
``SLOTS_BF16`` slots of a sample block with the next blocks of rays taken
from a queue, so that a ray stops alone.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..models import nerf
from . import _build
from .mlp_fused import (PACKS, PARAMS_SIZE, _check, _check_bf16, _check_mma,
                        fused_nerf_mlp_from_points_bf16_plain,
                        fused_nerf_mlp_from_points_plain, pack_weights,
                        packed_bf16_for, packed_mma_for)

RAY_TILE = 2        # rays of a tile of the float32 kernel (64 points)
RAY_TILE_BF16 = 1   # rays that stop together in the bf16 kernel
SLOTS_BF16 = 4      # its MLP tile's sample blocks (128 points), one ray each
SAMPLE_BLOCK = 32


def fused_render_pass_plain(packed, rays_o, rays_d, viewdirs, z_vals, dists,
                            live, term_csd: float, want_weights: bool = True,
                            *, mlp_plain=fused_nerf_mlp_from_points_plain,
                            ray_tile: int = RAY_TILE):
    """Plain PyTorch version of K-B2. Returns (maps (R, 5) [rgb, acc,
    depth], weights (R, S) or None). ``mlp_plain(packed, pts, dirs)`` is the
    plain MLP from points and ``ray_tile`` the rays that stop together."""
    R, S = z_vals.shape
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    vd = viewdirs[:, None, :].expand(R, S, 3)
    raw = mlp_plain(packed, pts.reshape(-1, 3), vd.reshape(-1, 3)) \
        .reshape(R, S, 4)
    sd = F.relu(raw[..., 3]) * dists

    nb = -(-S // SAMPLE_BLOCK)
    sd_b = F.pad(sd, (0, nb * SAMPLE_BLOCK - S)).reshape(R, nb, SAMPLE_BLOCK)
    # exclusive cumsum within each block, taken on the shifted values (never
    # inclusive - x, which cancels at the 1e10 far sentinel)
    excl = torch.cumsum(F.pad(sd_b[..., :-1], (1, 0)), dim=-1)
    block_total = excl[..., -1] + sd_b[..., -1]
    csd_in = torch.cumsum(F.pad(block_total[:, :-1], (1, 0)), dim=-1)

    n_tiles = -(-R // ray_tile)
    pad_r = n_tiles * ray_tile - R
    tile_min = F.pad(csd_in, (0, 0, 0, pad_r), value=math.inf) \
        .reshape(n_tiles, ray_tile, nb).amin(dim=1)
    tile_live = F.pad(live != 0, (0, pad_r)).reshape(n_tiles, ray_tile) \
        .any(dim=1)
    on = ((tile_min < term_csd) & tile_live[:, None]) \
        .repeat_interleave(ray_tile, dim=0)[:R]

    trans = torch.exp(-(csd_in[..., None] + excl))
    w = (1.0 - torch.exp(-sd_b)) * trans * on[..., None]
    w = w.reshape(R, nb * SAMPLE_BLOCK)[:, :S]

    rgb = torch.sigmoid(raw[..., :3])
    maps = torch.cat([torch.sum(w[..., None] * rgb, dim=1),
                      torch.sum(w, dim=1, keepdim=True),
                      torch.sum(w * z_vals, dim=1, keepdim=True)], dim=-1)
    return maps, (w if want_weights else None)


def fused_render_pass_bf16_plain(packed_bf16, rays_o, rays_d, viewdirs,
                                 z_vals, dists, live, term_csd: float,
                                 want_weights: bool = True):
    """Plain PyTorch version of K-B2 in bf16: the bf16 plain MLP under the
    same float32 compositing, every ray stopping alone (``RAY_TILE_BF16``)."""
    return fused_render_pass_plain(
        packed_bf16, rays_o, rays_d, viewdirs, z_vals, dists, live, term_csd,
        want_weights, mlp_plain=fused_nerf_mlp_from_points_bf16_plain,
        ray_tile=RAY_TILE_BF16)


def _render_pass(name, plain, weights, kernel_weights, rays_o, rays_d,
                 viewdirs, z_vals, dists, live, term_csd, want_weights,
                 queue=False):
    """Shared body of the two K-B2 wrappers: the plain version (on
    ``weights``) for CPU tensors, the kernel ``nnc_<name>`` (on
    ``kernel_weights()``) for CUDA tensors; with ``queue`` the kernel takes
    a zeroed int32 counter for its ray queue after the weights."""
    R, S = z_vals.shape
    for label, t in (("rays_o", rays_o), ("rays_d", rays_d),
                     ("viewdirs", viewdirs)):
        _check(label, t, (R, 3))
    _check("z_vals", z_vals, (R, S))
    _check("dists", dists, (R, S))
    if live.dtype != torch.int32 or tuple(live.shape) != (R,) or \
            not live.is_contiguous():
        raise ValueError(f"live: expected contiguous int32 ({R},)")
    tensors = (weights, rays_o, rays_d, viewdirs, z_vals, dists, live)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name} inputs must be on one device")
    device = z_vals.device
    if device.type == "cpu":
        return plain(weights, rays_o, rays_d, viewdirs, z_vals, dists, live,
                     term_csd, want_weights)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    lib = _build.lib()
    kernel_weights = kernel_weights()
    maps = torch.empty((R, 5), dtype=torch.float32, device=device)
    out_w = torch.empty((R, S), dtype=torch.float32, device=device) \
        if want_weights else None
    counter = torch.zeros(1, dtype=torch.int32, device=device) \
        if queue else None
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.count_launch(name)
        _build.check(getattr(lib, "nnc_" + name)(
            kernel_weights.data_ptr(), rays_o.data_ptr(), rays_d.data_ptr(),
            viewdirs.data_ptr(), z_vals.data_ptr(), dists.data_ptr(),
            live.data_ptr(), float(term_csd), maps.data_ptr(),
            None if out_w is None else out_w.data_ptr(),
            *([] if counter is None else [counter.data_ptr()]), R, S,
            stream), name)
    return maps, out_w


def render_pass(packed, rays_o, rays_d, viewdirs, z_vals, dists, live,
                term_csd: float, want_weights: bool = True, packed_mma=None):
    """K-B2 wrapper. rays_*: (R, 3); z_vals, dists: (R, S) (dists already
    scaled by |rays_d|); live: (R,) int32. Returns (maps (R, 5), weights
    (R, S) or None).

    CUDA tensors launch the kernel, which reads ``packed_mma``
    (``mlp_fused.repack_mma`` of ``packed``, made here if not given); CPU
    tensors take the plain version on ``packed``."""
    _check("packed", packed, (PARAMS_SIZE,))
    return _render_pass("render_pass", fused_render_pass_plain, packed,
                        lambda: _check_mma(packed, packed_mma), rays_o,
                        rays_d, viewdirs, z_vals, dists, live, term_csd,
                        want_weights)


def render_pass_bf16(packed_bf16, rays_o, rays_d, viewdirs, z_vals, dists,
                     live, term_csd: float, want_weights: bool = True):
    """K-B2 wrapper, bf16: as :func:`render_pass` on the buffer of
    ``mlp_fused.pack_weights_bf16``, early termination per ray. CUDA tensors
    launch the kernel (on a ray queue whose counter is made here); CPU
    tensors take :func:`fused_render_pass_bf16_plain`."""
    _check_bf16(packed_bf16)
    return _render_pass("render_pass_bf16", fused_render_pass_bf16_plain,
                        packed_bf16, lambda: packed_bf16, rays_o, rays_d,
                        viewdirs, z_vals, dists, live, term_csd, want_weights,
                        queue=True)


def ray_tile(config: nerf.NeRFConfig) -> int:
    """The rays that stop together in K-B2 for ``config``'s compute type."""
    return RAY_TILE_BF16 if config.compute_dtype == torch.bfloat16 \
        else RAY_TILE


def unpack_maps(maps):
    """Split packed per-ray maps (R, 5) into the render output dict."""
    acc = maps[:, 3]
    depth = maps[:, 4]
    disp = 1.0 / torch.clamp(depth / torch.clamp(acc, min=1e-10), min=1e-10)
    return {"rgb_map": maps[:, 0:3], "acc_map": acc, "depth_map": depth,
            "disp_map": disp}


def fused_render_pass(model: nerf.NeRF, rays_o, rays_d, viewdirs, z_vals, *,
                      early_term_eps: float = 0.0, ray_flags=None,
                      r_t: int = 64, dists=None, return_weights: bool = True,
                      raw_maps: bool = False):
    """Fully fused deterministic render pass with early termination.

    rays_*: (R, 3); z_vals: (R, S), any S. ``ray_flags``: bool (R,) — rays
    whose ``r_t``-tile is all False are skipped (their outputs are 0; the
    caller substitutes). ``dists`` overrides the per-sample integration span
    (entries of 0 contribute nothing). Returns dict(rgb_map, acc_map,
    depth_map, disp_map[, weights]); with ``raw_maps`` the packed per-ray
    maps (R, 5) [rgb, acc, depth] under "maps" in place of the four maps,
    for callers that permute rays (one gather, then :func:`unpack_maps`).
    ``model.config.compute_dtype`` picks the float32 or the bf16 variant of
    K-B2."""
    bf16 = model.config.compute_dtype == torch.bfloat16
    tile = ray_tile(model.config)
    if r_t % tile:
        raise ValueError(f"r_t must be a multiple of {tile}: {r_t}")
    R, S = z_vals.shape
    dnorm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    if dists is None:
        dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                           torch.full_like(z_vals[:, :1], 1e10)], -1) * dnorm
    else:
        dists = dists * dnorm
    if ray_flags is None:
        live = torch.ones(R, dtype=torch.int32, device=z_vals.device)
    else:
        n_tiles = -(-R // r_t)
        tiles = F.pad(ray_flags.bool(), (0, n_tiles * r_t - R)) \
            .reshape(n_tiles, r_t).any(dim=1)
        live = tiles.repeat_interleave(r_t)[:R].to(torch.int32)
    term_csd = -math.log(early_term_eps) if early_term_eps > 0 else math.inf
    f32 = lambda t: t.float().contiguous()
    inputs = (f32(rays_o), f32(rays_d), f32(viewdirs), f32(z_vals),
              f32(dists), live.contiguous(), term_csd)
    if bf16:
        maps, weights = render_pass_bf16(packed_bf16_for(model), *inputs,
                                         want_weights=return_weights)
    else:
        maps, weights = render_pass(
            PACKS.get(model, "float32", pack_weights), *inputs,
            want_weights=return_weights,
            packed_mma=packed_mma_for(model, z_vals.device))
    out = {"maps": maps} if raw_maps else unpack_maps(maps)
    if return_weights:
        out["weights"] = weights
    return out
