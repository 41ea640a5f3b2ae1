"""Occupancy-grid accelerated rendering (opt-in fast mode).

Counterpart of ``nnc_tpu/render/occupancy.py``. A binary occupancy grid over
the scene's box (sigma > threshold, from a sweep of the density field at the
voxel centres through K-B3) lets each ray sample only occupied voxels under a
fixed per-ray budget, and ride the fused render pass K-B2 (masked samples
carry dist 0 and contribute nothing). It is a separate opt-in mode; the exact
hierarchical render stays the default.

Where the reference's layout tricks were for the TPU, the port takes the
plain form with the same results: ``lookup`` reads a byte grid (the
reference packs 32 voxels a word for its gather), and the renders cull at
K-B2's own ray tile (``render_fused.RAY_TILE``, one ray in bf16) where the
reference passes its TPU tiles ``occ_ray_tile`` / ``occ_sample_block``. A
culled ray has all its dists 0, so the maps are the same either way. In
float32, rows of at most ``render_fused.SAMPLE_BLOCK`` slots take K-B2's
packed render pass (``render_fused.fused_render_pass_packed``: MLP tiles of
filled slots only), whose plan needs the rays in non-increasing order of
their filled counts, the order both renders already give them.

The selection keeps the reference's float32 arithmetic and operand order, so
that on the CPU it equals the reference's exactly; the grid's dilation is
the reference's ``scipy.ndimage.binary_dilation`` (the 6-connected cross,
zero border), done on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import parallel
from ..models import nerf
from ..ops import mlp_fused, render_fused
from ..ops.posenc import positional_encoding
from ..utils import profiling

MAPS = ("rgb_map", "acc_map", "depth_map", "disp_map")


@dataclasses.dataclass(frozen=True)
class OccupancyGrid:
    """``occ``: (res, res, res) bool on the render device over the box
    ``lo`` .. ``hi``. ``occ_lo`` / ``occ_hi``: the tight box of the occupied
    voxels with one voxel's margin, or None (then each ray sweeps
    [near, far]). ``open_boundary``: the grid's outer shell holds density,
    so out-of-box points count as occupied and rays sweep [near, far]."""
    occ: torch.Tensor
    lo: Tuple[float, float, float]
    hi: Tuple[float, float, float]
    occ_lo: Optional[Tuple[float, float, float]] = None
    occ_hi: Optional[Tuple[float, float, float]] = None
    open_boundary: bool = False

    @property
    def res(self) -> int:
        return self.occ.shape[0]

    def to(self, device) -> "OccupancyGrid":
        """The same grid with ``occ`` on ``device``."""
        if self.occ.device == torch.device(device):
            return self
        return dataclasses.replace(self, occ=self.occ.to(device))


def grid_from_arrays(occ, lo, hi, occ_lo=None, occ_hi=None,
                     open_boundary=False, device=None) -> OccupancyGrid:
    """An :class:`OccupancyGrid` from a (res, res, res) array and bounds,
    e.g. those of a grid the JAX package built."""
    tup = lambda b: None if b is None else tuple(float(v) for v in b)
    return OccupancyGrid(
        occ=torch.tensor(np.asarray(occ, bool), device=device),
        lo=tup(lo), hi=tup(hi), occ_lo=tup(occ_lo), occ_hi=tup(occ_hi),
        open_boundary=bool(open_boundary))


def _dilate(occ, iterations: int):
    """``scipy.ndimage.binary_dilation(occ, iterations=iterations)``: each
    step ORs every voxel's six face neighbours in, nothing from beyond the
    border."""
    for _ in range(iterations):
        out = occ.clone()
        for dim in range(3):
            n = occ.shape[dim]
            out.narrow(dim, 1, n - 1).logical_or_(occ.narrow(dim, 0, n - 1))
            out.narrow(dim, 0, n - 1).logical_or_(occ.narrow(dim, 1, n - 1))
        occ = out
    return occ


@torch.no_grad()
def build_occupancy_grid(model: nerf.NeRF, *, lo=(-2.0, -2.0, -2.0),
                         hi=(2.0, 2.0, 2.0), res: int = 128,
                         sigma_threshold: float = 1e-2, dilate: int = 3,
                         use_fused: bool = True,
                         chunk: int = 262144) -> OccupancyGrid:
    """Sweep the density field at the voxel centres (directions (0, 0, 1),
    in chunks of ``chunk`` points: K-B3, or its bf16 variant, when
    ``use_fused`` and the architecture has a kernel, else the plain MLP),
    threshold, test the outer shell for leaking density, then dilate
    ``dilate`` times with the 6-connected cross (reference:
    occupancy.py:84-154). The grid lives on the model's device."""
    device = model.device
    axes = [l + (np.arange(res, dtype=np.float32) + 0.5) * (h - l) / res
            for l, h in zip(lo, hi)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    pts = torch.as_tensor(np.stack([gx, gy, gz], axis=-1).reshape(-1, 3),
                          device=device)
    vd = torch.zeros(min(chunk, pts.shape[0]), 3, device=device)
    vd[:, 2] = 1.0
    fused = use_fused and mlp_fused.supports(model.config)
    sigma = torch.empty(pts.shape[0], device=device)
    for start in range(0, pts.shape[0], chunk):
        p = pts[start:start + chunk]
        v = vd[:p.shape[0]]
        if fused:
            raw = mlp_fused.fused_nerf_mlp_from_points(model, p, v)
        else:
            raw = nerf.apply_mlp(model, positional_encoding(p, 10),
                                 positional_encoding(v, 4))
        sigma[start:start + p.shape[0]] = F.relu(raw[:, 3])
    occ = (sigma > sigma_threshold).reshape(res, res, res)

    # the shell test comes before the dilation, which smears interior
    # occupancy onto the shell (occupancy.py:129-138)
    shell = torch.zeros_like(occ)
    shell[[0, -1], :, :] = True
    shell[:, [0, -1], :] = True
    shell[:, :, [0, -1]] = True
    open_boundary = int(occ[shell].sum()) / int(shell.sum()) > 0.02
    occ = _dilate(occ, dilate)
    occ_lo = occ_hi = None
    if bool(occ.any()):
        occ_lo, occ_hi = [], []
        for ax, (l, h) in enumerate(zip(lo, hi)):
            proj = occ.any(dim=tuple(a for a in range(3) if a != ax))
            nz = torch.nonzero(proj).flatten().tolist()
            vox = (h - l) / res
            occ_lo.append(float(l + (nz[0] - 1) * vox))
            occ_hi.append(float(l + (nz[-1] + 2) * vox))
        occ_lo, occ_hi = tuple(occ_lo), tuple(occ_hi)
    return OccupancyGrid(occ=occ, lo=tuple(lo), hi=tuple(hi), occ_lo=occ_lo,
                         occ_hi=occ_hi, open_boundary=open_boundary)


def lookup(grid: OccupancyGrid, pts):
    """Occupancy of points (..., 3); out-of-box points are unoccupied (or,
    with an open boundary, occupied)."""
    return _lookup_coords(grid, pts[..., 0], pts[..., 1], pts[..., 2])


def _lookup_coords(grid: OccupancyGrid, px, py, pz):
    res = grid.res
    idx = []
    inside = None
    for p, l, h in zip((px, py, pz), grid.lo, grid.hi):
        i = torch.floor((p - l) * (res / (h - l))).to(torch.int32)
        ok = (i >= 0) & (i < res)
        inside = ok if inside is None else (inside & ok)
        idx.append(torch.clamp(i, 0, res - 1).long())
    flat = (idx[0] * res + idx[1]) * res + idx[2]
    hit = grid.occ.reshape(-1)[flat]
    if grid.open_boundary:
        return hit | ~inside
    return hit & inside


def _ray_span(grid: OccupancyGrid, rays_o, rays_d, near, far):
    """Each ray's [t0, t1]: [near, far] cut by the slab test against the
    grid's tight occupied box (rays that miss it get t1 <= t0); [near, far]
    without a tight box or with an open boundary."""
    shape = rays_o.shape[:-1]
    opts = dict(dtype=torch.float32, device=rays_o.device)
    t0 = torch.full(shape, float(near), **opts)
    t1 = torch.full(shape, float(far), **opts)
    if grid.occ_lo is None or grid.open_boundary:
        return t0, t1
    for d in range(3):
        o, dd = rays_o[..., d], rays_d[..., d]
        tiny = torch.where(dd < 0, -1e-9, 1e-9)
        safe = torch.where(torch.abs(dd) < 1e-9, tiny, dd)
        ta = (grid.occ_lo[d] - o) / safe
        tb = (grid.occ_hi[d] - o) / safe
        t0 = torch.maximum(t0, torch.minimum(ta, tb))
        t1 = torch.minimum(t1, torch.maximum(ta, tb))
    return t0, t1


def _candidates(n_candidates: int, device):
    return (torch.arange(n_candidates, dtype=torch.float32, device=device)
            + 0.5) / n_candidates


def _sweep(grid, rays_o, rays_d, t0, span, n_candidates):
    """The occupancy of each ray's ``n_candidates`` candidates spread over
    [t0, t0 + span], empty where span is 0."""
    z = t0 + span * _candidates(n_candidates, rays_o.device)
    coords = [rays_o[:, d:d + 1] + rays_d[:, d:d + 1] * z for d in range(3)]
    return _lookup_coords(grid, *coords) & (span > 0)


def select_occupied_samples(grid: OccupancyGrid, rays_o, rays_d, near, far,
                            n_candidates: int, budget: int):
    """Slab-restricted z candidates filtered by occupancy, compacted per ray
    to ``budget`` (see :func:`_compact_stride`). Returns (z (R, K), dists
    (R, K) with masked entries 0, any_occupied (R,))."""
    t0, t1 = _ray_span(grid, rays_o, rays_d, near, far)
    span = torch.clamp_min(t1 - t0, 0.0)[:, None]
    occ = _sweep(grid, rays_o, rays_d, t0[:, None], span, n_candidates)
    keep, mask, stride = _compact_stride(occ, n_candidates, budget)
    spacing = span / n_candidates
    z_sel = t0[:, None] + (keep.to(torch.float32) + 0.5) * spacing
    dists = torch.where(mask, spacing * stride, 0.0)
    return z_sel, dists, occ.any(dim=-1)


def _compact_stride(occ, n_candidates: int, budget: int):
    """Fixed-budget compaction of each row of the bool (R, C) ``occ``, in
    ray order: a ray with m > budget occupied candidates keeps every
    ceil(m / budget)-th, each then integrating over that stride. The keys
    are unique (occupied 2C - i, empty -i), so ``topk`` orders them as
    ``lax.top_k`` does. Returns (keep (R, B) int64, mask (R, B) bool,
    stride (R, 1) float32)."""
    n = n_candidates
    m = occ.sum(dim=-1, keepdim=True, dtype=torch.int32)
    stride = torch.clamp_min((m + budget - 1) // budget, 1)
    rank = torch.cumsum(occ, dim=-1, dtype=torch.int32) - 1
    kept = occ & (rank % stride == 0)
    ci = torch.arange(occ.shape[-1], dtype=torch.int32,
                      device=occ.device).expand(occ.shape)
    key = torch.where(kept, 2 * n - ci, -ci)
    kv, keep = torch.topk(key, budget, dim=-1, largest=True, sorted=True)
    return keep, kv > 0, stride.to(torch.float32)


def _select_sub(grid: OccupancyGrid, rays_o, rays_d, near, far,
                n_candidates: int, budget: int, layout, factor: int):
    """Selection on a ``factor``-subsampled ray raster (``layout`` = (H, W)
    of the flat rays): each factor x factor pixel block shares the
    selection of its centre ray, the flags dilated by one candidate along
    z, with a roll that wraps round (occupancy.py:300). Returns (z, dists,
    any_occupied) per block, (Hs * Ws, B)."""
    H, W = layout
    if rays_o.shape[0] != H * W or H % factor or W % factor:
        raise ValueError(f"{rays_o.shape[0]} rays in layout {layout} at "
                         f"subsample {factor}")
    Hs, Ws = H // factor, W // factor
    sub = lambda a: a.reshape(H, W, -1)[factor // 2::factor,
                                        factor // 2::factor].reshape(
        Hs * Ws, -1)
    ro_s, rd_s = sub(rays_o), sub(rays_d)
    t0, t1 = _ray_span(grid, ro_s, rd_s, near, far)
    margin = 2.0 * max(h - l for l, h in zip(grid.lo, grid.hi)) / grid.res
    t0 = torch.clamp(t0[:, None] - margin, min=float(near))
    t1 = torch.clamp(t1[:, None] + margin, max=float(far))
    span = torch.clamp_min(t1 - t0, 0.0)
    occ = _sweep(grid, ro_s, rd_s, t0, span, n_candidates)
    occ = occ | torch.roll(occ, 1, 1) | torch.roll(occ, -1, 1)
    keep, mask_s, stride = _compact_stride(occ, n_candidates, budget)
    spacing = span / n_candidates
    z_sel_s = t0 + (keep.to(torch.float32) + 0.5) * spacing
    dists_s = torch.where(mask_s, spacing * stride, 0.0)
    return z_sel_s, dists_s, mask_s[:, 0]


def _upsample(a, Hs, Ws, factor):
    """(Hs * Ws, ...) block values to the (H * W, ...) ray raster."""
    a = a.reshape(Hs, Ws, -1).repeat_interleave(factor, 0) \
        .repeat_interleave(factor, 1)
    return a.reshape(Hs * factor * Ws * factor, -1)


def select_occupied_samples_tiled(grid: OccupancyGrid, rays_o, rays_d, near,
                                  far, n_candidates: int, budget: int,
                                  layout, factor: int = 4):
    """Per-ray view of :func:`_select_sub`: each ray takes its block's
    selection. Returns (z (R, B), dists (R, B), any_occupied (R,))."""
    Hs, Ws = layout[0] // factor, layout[1] // factor
    z_s, dists_s, any_s = _select_sub(grid, rays_o, rays_d, near, far,
                                      n_candidates, budget, layout, factor)
    return (_upsample(z_s, Hs, Ws, factor), _upsample(dists_s, Hs, Ws, factor),
            _upsample(any_s, Hs, Ws, factor)[:, 0])


def render_rays_fast(model: nerf.NeRF, rays_o, rays_d, viewdirs, near, far,
                     grid: OccupancyGrid, rc, *, n_candidates: int = 48,
                     budget: int = 16, layout=None, subsample: int = 4):
    """Occupancy-accelerated render by one network (the fine one; no
    hierarchical resampling) through K-B2. ``layout=(H, W)`` selects on the
    subsampled raster of a camera frame (:func:`_render_tiled_sorted`);
    without it, or where the layout does not divide, each ray selects for
    itself and rays run sorted by their occupied count. Returns
    dict(rgb_map, acc_map, depth_map, disp_map)."""
    n_rays = rays_o.shape[0]
    if layout is not None and (layout[0] % subsample
                               or layout[1] % subsample
                               or layout[0] * layout[1] != n_rays):
        layout = None
    if layout is not None:
        res = _render_tiled_sorted(model, rays_o, rays_d, viewdirs, near,
                                   far, grid, rc, n_candidates, budget,
                                   layout, subsample)
    else:
        z, dists, any_occ = select_occupied_samples(
            grid, rays_o, rays_d, near, far, n_candidates, budget)
        # descending occupied count: the packed pass's runs; else empty
        # rays cluster into tiles the kernel skips, light rays into tiles
        # whose later sample blocks are all masked
        order = torch.argsort(-(dists > 0).sum(dim=-1, dtype=torch.int32),
                              stable=True)
        inv = torch.argsort(order)
        maps = _kb2(model, rays_o[order], rays_d[order], viewdirs[order],
                    z[order], dists[order], any_occ[order], rc)
        res = render_fused.unpack_maps(maps[inv])
    if rc.white_bkgd:
        res["rgb_map"] = res["rgb_map"] + (1.0 - res["acc_map"][..., None])
    return res


def _kb2(model, rays_o, rays_d, viewdirs, z, dists, flags, rc, stats=None):
    """K-B2 on compacted rows whose rays come in non-increasing order of
    their filled slots: the packed render pass where it applies
    (``render_fused.packs``: float32, at most 32 slots), else the render
    pass culled at its ray tile. ``stats``: the packed pass's counts (see
    ``render_fused.render_pass_packed``). Returns the packed maps (R, 5)."""
    if render_fused.packs(model.config, z.shape[1]):
        return render_fused.fused_render_pass_packed(
            model, rays_o, rays_d, viewdirs, z, dists,
            early_term_eps=rc.early_term_eps, ray_flags=flags, stats=stats)
    return render_fused.fused_render_pass(
        model, rays_o, rays_d, viewdirs, z, early_term_eps=rc.early_term_eps,
        ray_flags=flags, dists=dists, r_t=render_fused.ray_tile(model.config),
        return_weights=False, raw_maps=True)["maps"]


def _render_tiled_sorted(model, rays_o, rays_d, viewdirs, near, far, grid,
                         rc, n_candidates, budget, layout, subsample):
    """Frame path: the blocks sorted by descending occupied count (ties in
    raster order), every ray placed at its block's position by arithmetic,
    one gather of the packed rays in and one of the packed maps out."""
    H, W = layout
    fac = subsample
    Hs, Ws = H // fac, W // fac
    nb = fac * fac
    n_rays = H * W
    device = rays_o.device

    with profiling.span("nnc.frame.select"):
        z_s, dists_s, any_s = _select_sub(grid, rays_o, rays_d, near, far,
                                          n_candidates, budget, layout, fac)
    with profiling.span("nnc.frame.sort"):
        counts = (dists_s > 0).sum(dim=-1, dtype=torch.int32)
        order_s = torch.argsort(-counts, stable=True)
        pos_s = torch.argsort(order_s)

        # kernel row k * nb + o holds ray (by * fac + o // fac, bx * fac +
        # o % fac) of block order_s[k]
        by, bx = order_s // Ws, order_s % Ws
        ar = torch.arange(fac, device=device)
        offs = (ar[:, None] * W + ar[None, :]).reshape(-1)
        ray_idx = ((by * fac * W + bx * fac)[:, None] + offs[None, :]) \
            .reshape(-1)
        rays9_s = torch.cat([rays_o, rays_d, viewdirs], dim=1)[ray_idx]
        expand_rows = lambda a: a[order_s].repeat_interleave(nb, dim=0)
        z_k, any_k, dists_k = (expand_rows(a) for a in (z_s, any_s, dists_s))
    with profiling.span("nnc.frame.kb2") as recording:
        stats = None
        if recording is not None and render_fused.packs(model.config,
                                                        budget):
            stats = torch.zeros(2, dtype=torch.int64, device=device)
            profiling.count_later(recording, stats, ("slots", "points"))
        maps = _kb2(model, rays9_s[:, 0:3], rays9_s[:, 3:6], rays9_s[:, 6:9],
                    z_k, dists_k, any_k, rc, stats)

    with profiling.span("nnc.frame.unpack"):
        # inverse: ray r of block b sits at kernel row pos_s[b] * nb +
        # slot(r)
        pos_up = _upsample(pos_s, Hs, Ws, fac)[:, 0]
        iota = torch.arange(n_rays, device=device)
        slot = (iota // W % fac) * fac + iota % W % fac
        return render_fused.unpack_maps(maps[pos_up * nb + slot])


@torch.no_grad()
def render_image_fast(model: nerf.NeRF, rays_o, rays_d, near, far, rc,
                      grid: OccupancyGrid = None, *, n_candidates: int = 48,
                      budget: int = 16, subsample: int = 4, row_chunk=512,
                      outputs=MAPS, mesh: Optional[parallel.Mesh] = None,
                      rgb_uint8=False, viewdirs=None):
    """Render a camera frame in occupancy mode.

    rays_o / rays_d: (H, W, 3), numpy or tensors. The grid is built from
    ``model`` when not given. ``outputs`` names the maps to return;
    ``rgb_uint8`` quantizes rgb_map to uint8 on the device. ``viewdirs``
    (H, W, 3) overrides the view-branch directions (NDC renders pass the
    pre-warp ones). Rows go in chunks of at most ``row_chunk`` that divide
    H and split into blocks of ``subsample`` x the mesh's 'data' size. With
    ``mesh`` each chunk is split into equal row shards over the 'data'
    devices, each rendered (selection and K-B2) on its device by its
    replica of the model and the grid, and joined in row order; without a
    mesh the frame renders on the model's device. Returns a dict of host
    numpy maps shaped (H, W, ...).

    While a torch profiler records, the call is an ``nnc.frame`` request
    span (``utils/profiling``) whose children are each row chunk's
    ``nnc.frame.select``, ``.sort``, ``.kb2`` and ``.unpack``, then
    ``nnc.frame.wait`` (a synchronize of the devices, taken only then: the
    first copy would wait there anyway) and ``nnc.frame.copy`` (the maps to
    the host). Where K-B2 is the packed render pass, each ``.kb2`` span
    counts its ``slots`` (filled sample slots launched) and ``points``
    (points its tiles compute), read from the device at the wait."""
    H, W = rays_o.shape[:2]
    with profiling.request("nnc.frame", rays=H * W):
        return _render_image_fast(model, rays_o, rays_d, near, far, rc, grid,
                                  n_candidates, budget, subsample, row_chunk,
                                  outputs, mesh, rgb_uint8, viewdirs)


def _render_image_fast(model, rays_o, rays_d, near, far, rc, grid,
                       n_candidates, budget, subsample, row_chunk, outputs,
                       mesh, rgb_uint8, viewdirs):
    H, W = rays_o.shape[:2]
    if grid is None:
        grid = build_occupancy_grid(model)
    places = [(model.device, model, grid.to(model.device))]
    if mesh is not None:
        devices = parallel.data_devices(mesh)
        reps = parallel.replicate_params(mesh, model)
        places = [(d, reps[d], grid.to(d)) for d in devices]
    nd = len(places)
    rows = min(row_chunk, H)
    while H % rows or rows % (subsample * nd):
        rows -= 1
        if rows <= 0:
            raise ValueError(
                f"frame rows {H} not divisible into subsample*data-shard "
                f"blocks ({subsample}*{nd})")
    as_t = lambda a: torch.as_tensor(
        a if torch.is_tensor(a) else np.asarray(a, np.float32),
        dtype=torch.float32).reshape(H, W, 3)
    frame = [None if a is None else as_t(a)
             for a in (rays_o, rays_d, viewdirs)]
    part = rows // nd
    outs = []
    for r0 in range(0, H, rows):
        for i, (d, m, g) in enumerate(places):
            cut = [None if a is None else
                   a[r0 + i * part:r0 + (i + 1) * part].reshape(-1, 3).to(d)
                   for a in frame]
            outs.append(_render_frame_rows(m, *cut, near, far, g, rc,
                                           n_candidates, budget, (part, W),
                                           subsample, tuple(outputs),
                                           rgb_uint8))
    with profiling.span("nnc.frame.wait") as recording:
        if recording is not None:
            for d in {torch.device(p[0]) for p in places}:
                if d.type == "cuda":
                    torch.cuda.current_stream(d).synchronize()
            profiling.settle_counts()
    with profiling.span("nnc.frame.copy"):
        outs = [{k: v.cpu().numpy() for k, v in res.items()} for res in outs]
        return {k: np.concatenate([o[k] for o in outs]).reshape(
                    (H, W) + outs[0][k].shape[1:]) for k in outs[0]}


def _render_frame_rows(model, ro, rd, vd, near, far, grid, rc, n_candidates,
                       budget, layout, subsample, outputs, rgb_uint8=False):
    """One row shard of a frame: flat rays (rows * W, 3) in ``layout``."""
    if vd is None:
        vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    out = render_rays_fast(model, ro, rd, vd, near, far, grid, rc,
                           n_candidates=n_candidates, budget=budget,
                           layout=layout, subsample=subsample)
    out = {k: out[k] for k in outputs}
    if rgb_uint8 and "rgb_map" in out:
        out["rgb_map"] = (torch.clamp(out["rgb_map"], 0.0, 1.0)
                          * 255.0).to(torch.uint8)
    return out
