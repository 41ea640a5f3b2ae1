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

Occupancy mode's compacted rows (float32, at most ``SAMPLE_BLOCK`` slots a
ray, rays ordered by non-increasing filled count) take the packed render
pass, :func:`fused_render_pass_packed` (``render_pass_kernel_packed`` in
``csrc/render_pass.cuh``): each 64-point MLP tile holds the filled slots
(dists > 0) of whole rays of one filled count k, floor(64 / k) of them, by
the plan :func:`packed_bounds` computes on the device; its plain version
:func:`fused_render_pass_packed_plain` composites each ray over its filled
slots in slot order.
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
PACKED_POINTS = 64  # a tile of the packed pass: the float32 chain's MLP tile


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


def _check_rays(name, weights, rays_o, rays_d, viewdirs, z_vals, dists,
                live):
    """The checks of K-B2's wrappers on their inputs; returns their one
    device."""
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
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def _render_pass(name, plain, weights, kernel_weights, rays_o, rays_d,
                 viewdirs, z_vals, dists, live, term_csd, want_weights,
                 queue=False):
    """Shared body of the two K-B2 wrappers: the plain version (on
    ``weights``) for CPU tensors, the kernel ``nnc_<name>`` (on
    ``kernel_weights()``) for CUDA tensors; with ``queue`` the kernel takes
    a zeroed int32 counter for its ray queue after the weights."""
    R, S = z_vals.shape
    device = _check_rays(name, weights, rays_o, rays_d, viewdirs, z_vals,
                         dists, live)
    if device.type == "cpu":
        return plain(weights, rays_o, rays_d, viewdirs, z_vals, dists, live,
                     term_csd, want_weights)
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


def packs(config: nerf.NeRFConfig, samples: int) -> bool:
    """Whether rows of ``samples`` compacted slots take the packed render
    pass: the float32 chain, and at most ``SAMPLE_BLOCK`` slots a ray."""
    return config.compute_dtype != torch.bfloat16 \
        and 1 <= samples <= SAMPLE_BLOCK


def filled_counts(dists, live, term_csd: float):
    """(R,) int32: each ray's filled slots (dists > 0), 0 for a culled ray
    (live == 0) and for every ray where term_csd <= 0 (no block runs)."""
    counts = (dists > 0).sum(dim=1, dtype=torch.int32) * (live != 0)
    return counts if term_csd > 0 else torch.zeros_like(counts)


def packed_bounds(counts, samples: int):
    """The packed pass's plan, from the filled counts of rays in
    non-increasing order: (samples + 1,) int32, entry k the rays with more
    than k filled slots, so that the rays of count k are [bounds[k],
    bounds[k - 1]). It is the cumulative histogram of the counts, taken as a
    binary search of the sorted counts on their device, with no host
    synchronisation."""
    queries = torch.arange(0, -samples - 1, -1, dtype=torch.int32,
                           device=counts.device)
    return torch.searchsorted(-counts, queries, out_int32=True)


def packed_plan(bounds) -> list:
    """The packed pass's tiles as its kernel derives them from ``bounds``:
    [(first ray, rays, filled count k)], runs of count S, S - 1, ..., 1 in
    turn, ``PACKED_POINTS // k`` whole rays a tile."""
    b = [int(v) for v in bounds]
    tiles = []
    for k in range(len(b) - 1, 0, -1):
        cap = PACKED_POINTS // k
        tiles += [(r0, min(cap, b[k - 1] - r0), k)
                  for r0 in range(b[k], b[k - 1], cap)]
    return tiles


def fused_render_pass_packed_plain(packed, rays_o, rays_d, viewdirs, z_vals,
                                   dists, live, term_csd: float, stats=None,
                                   *,
                                   mlp_plain=fused_nerf_mlp_from_points_plain):
    """Plain PyTorch version of the packed render pass: each ray composited
    over its filled slots (:func:`filled_counts`) in slot order, from an
    optical depth of 0. The MLP runs on every slot's point, as in
    :func:`fused_render_pass_plain` (the CPU's products round by the batch's
    shape, so both read the same raw). The rays must come in
    non-increasing order of their filled counts (ValueError otherwise).
    ``stats``: a (2,) int64 tensor that receives the filled slots and the
    points the kernel's tiles compute (:func:`packed_plan`). Returns maps
    (R, 5) [rgb, acc, depth]."""
    R, S = z_vals.shape
    counts = filled_counts(dists, live, term_csd)
    if bool((counts[1:] > counts[:-1]).any()):
        raise ValueError("the packed render pass takes rays in "
                         "non-increasing order of their filled slots")
    if stats is not None:
        tiles = packed_plan(packed_bounds(counts, S))
        stats.copy_(torch.tensor([int(counts.sum()),
                                  PACKED_POINTS * len(tiles)]))
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    vd = viewdirs[:, None, :].expand(R, S, 3)
    on = (dists > 0) & (counts > 0)[:, None]
    ray, slot = on.nonzero(as_tuple=True)
    at = (ray, (torch.cumsum(on, dim=1) - 1)[ray, slot])
    z = z_vals[ray, slot]
    raw = mlp_plain(packed, pts.reshape(-1, 3), vd.reshape(-1, 3)) \
        .reshape(R, S, 4)[ray, slot]
    put = lambda v, *shape: z_vals.new_zeros((R, SAMPLE_BLOCK) + shape) \
        .index_put_(at, v)
    sd = put(F.relu(raw[:, 3]) * dists[ray, slot])
    rgb, zs = put(torch.sigmoid(raw[:, :3]), 3), put(z)
    # the exclusive sum taken on the shifted values (fused_render_pass_plain)
    excl = torch.cumsum(F.pad(sd[:, :-1], (1, 0)), dim=-1)
    w = (1.0 - torch.exp(-sd)) * torch.exp(-excl)
    return torch.cat([torch.sum(w[..., None] * rgb, dim=1),
                      torch.sum(w, dim=1, keepdim=True),
                      torch.sum(w * zs, dim=1, keepdim=True)], dim=-1)


def render_pass_packed(packed, rays_o, rays_d, viewdirs, z_vals, dists, live,
                       term_csd: float, stats=None, packed_mma=None):
    """K-B2 wrapper, the packed render pass (float32): as
    :func:`render_pass` on rows of at most ``SAMPLE_BLOCK`` slots whose rays
    come in non-increasing order of their filled counts, without weights.
    ``stats``: None, or a (2,) int64 tensor on the inputs' device that
    receives (filled slots launched, points computed) on the device. Returns
    maps (R, 5).

    CUDA tensors launch ``render_pass_kernel_packed`` on the plan of
    :func:`packed_bounds` (no host synchronisation); CPU tensors take
    :func:`fused_render_pass_packed_plain`."""
    _check("packed", packed, (PARAMS_SIZE,))
    R, S = z_vals.shape
    if not 1 <= S <= SAMPLE_BLOCK:
        raise ValueError(f"the packed render pass takes 1 to {SAMPLE_BLOCK} "
                         f"slots a ray: {S}")
    device = _check_rays("render_pass_packed", packed, rays_o, rays_d,
                         viewdirs, z_vals, dists, live)
    if stats is not None and (stats.dtype != torch.int64
                              or tuple(stats.shape) != (2,)
                              or stats.device != device):
        raise ValueError(f"stats: expected int64 (2,) on {device}")
    if device.type == "cpu":
        return fused_render_pass_packed_plain(
            packed, rays_o, rays_d, viewdirs, z_vals, dists, live, term_csd,
            stats)
    lib = _build.lib()
    kernel_weights = _check_mma(packed, packed_mma)
    bounds = packed_bounds(filled_counts(dists, live, term_csd), S)
    maps = torch.empty((R, 5), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.count_launch("render_pass_packed")
        _build.check(lib.nnc_render_pass_packed(
            kernel_weights.data_ptr(), rays_o.data_ptr(), rays_d.data_ptr(),
            viewdirs.data_ptr(), z_vals.data_ptr(), dists.data_ptr(),
            live.data_ptr(), bounds.data_ptr(), maps.data_ptr(),
            None if stats is None else stats.data_ptr(), R, S, stream),
            "render_pass_packed")
    return maps


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


def fused_render_pass_packed(model: nerf.NeRF, rays_o, rays_d, viewdirs,
                             z_vals, dists, *, early_term_eps: float = 0.0,
                             ray_flags=None, stats=None):
    """The packed render pass on compacted rows: rays_*: (R, 3); z_vals,
    dists: (R, S) with S <= ``SAMPLE_BLOCK`` (entries of dist 0 are empty
    slots), the rays in non-increasing order of their filled slots;
    ``ray_flags``: bool (R,), rays flagged False are culled (outputs 0);
    ``stats``: see :func:`render_pass_packed`. For a float32 model
    (:func:`packs`). Returns the packed per-ray maps (R, 5) [rgb, acc,
    depth], as :func:`fused_render_pass` with ``raw_maps`` gives them."""
    R, S = z_vals.shape
    if not packs(model.config, S):
        raise ValueError(f"the packed render pass takes a float32 model and "
                         f"1 to {SAMPLE_BLOCK} slots a ray: "
                         f"{model.config.compute_dtype}, {S}")
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    live = torch.ones(R, dtype=torch.int32, device=z_vals.device) \
        if ray_flags is None else ray_flags.to(torch.int32)
    term_csd = -math.log(early_term_eps) if early_term_eps > 0 else math.inf
    f32 = lambda t: t.float().contiguous()
    return render_pass_packed(
        PACKS.get(model, "float32", pack_weights), f32(rays_o), f32(rays_d),
        f32(viewdirs), f32(z_vals), f32(dists), live.contiguous(), term_csd,
        stats=stats, packed_mma=packed_mma_for(model, z_vals.device))
