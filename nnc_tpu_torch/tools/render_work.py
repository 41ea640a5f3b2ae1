"""What the render-side tools (``bench_render_v2``, ``tune_fast_mode``,
``profile_fast_frame``) share: their camera frame, their timing, the
deviation of a render from a reference, and K-B2's launches with the work
each one did.

Timing is the host clock around calls that end in ``torch.cuda.synchronize()``
on the card (on the CPU, around the calls alone); the first call of a tool
builds the kernels and is never timed. The work of a K-B2 launch is counted
from its own inputs: a sample is needed when its ray is live, its dist is
not 0 and the ray's transmittance before it is still at least the
termination threshold; the kernel computes every block of
``render_fused.SAMPLE_BLOCK`` samples of a tile of ``ray_tile`` rays that
holds a live ray with a dist that is not 0 while one of the tile's rays is
still below the threshold at the block's start (``render_fused``'s tiling
semantics); the packed render pass computes ``render_fused.PACKED_POINTS``
points a tile of its plan (``render_fused.packed_plan``). The optical depths
come from the plain version of the MLP on the launch's packed weights, so
counting launches no kernel.
"""
from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..data.synthetic import look_at_poses
from ..ops import mlp_fused, render_fused
from ..render.rays import get_rays_np
from ..utils import profiling

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
KB2 = ("render_pass", "render_pass_bf16", "render_pass_packed")
# points of one plain MLP call while counting a launch's work
COUNT_CHUNK = 262_144


def frame_rays(H: int, W: int, device, seed: int = 0, pose=None):
    """Flat rays (H * W, 3) of the bench frame: focal 0.8 W, the principal
    point at the centre, seen from ``pose`` (4x4), by default the first of
    ``look_at_poses(1, seed=seed)``."""
    focal = 0.8 * W
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                 np.float32)
    if pose is None:
        pose = look_at_poses(1, seed=seed)[0]
    ro, rd = get_rays_np(H, W, K, pose[:3, :4])
    return (torch.as_tensor(ro.reshape(-1, 3), device=device),
            torch.as_tensor(rd.reshape(-1, 3), device=device))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def wall_ms(fn, iters: int, device) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` calls, the card waited
    for before and after."""
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync(device)
    return 1e3 * (time.perf_counter() - t0) / iters


def deviation(rgb, ref) -> dict:
    """max and mean |rgb - ref| and the deviation PSNR, -10 log10(mean
    dev^2 + 1e-12), the reference tools' formula (in float64)."""
    d = np.abs(np.asarray(rgb, np.float64) - np.asarray(ref, np.float64))
    return {"maxdev": float(d.max()), "meandev": float(d.mean()),
            "dev_psnr": float(-10 * np.log10(np.mean(d ** 2) + 1e-12))}


@contextlib.contextmanager
def kb2_launches(calls: list, seconds: list = None):
    """Inside the block each call of K-B2's wrappers appends ``(name, args,
    kw)`` to ``calls``; with ``seconds`` also the host clock seconds of each
    launch (of its plain version, on CPU tensors)."""
    real = {name: getattr(render_fused, name) for name in KB2}

    def recorder(name):
        def call(*args, **kw):
            calls.append((name, args, kw))
            t0 = time.perf_counter()
            out = real[name](*args, **kw)
            if seconds is not None:
                seconds.append(time.perf_counter() - t0)
            return out
        return call

    with contextlib.ExitStack() as restore:
        for name in KB2:
            restore.callback(setattr, render_fused, name, real[name])
            setattr(render_fused, name, recorder(name))
        yield calls


def kb2_ms(fn, iters: int, device) -> dict:
    """K-B2's milliseconds a call of ``fn`` over ``iters`` calls, with its
    launches a call: on the card its kernels' device time under
    ``torch.profiler`` (``render_pass_kernel`` / ``render_queue_kernel``)
    and the device's busy time a call ("busy_ms"); on the CPU the host clock
    around each launch of its plain version ("busy_ms" None)."""
    calls, seconds = [], []
    if torch.device(device).type != "cuda":
        with kb2_launches(calls, seconds):
            for _ in range(iters):
                fn()
        return {"kb2_ms": 1e3 * sum(seconds) / iters, "busy_ms": None,
                "launches": len(calls) / iters}
    with kb2_launches(calls), profiling.trace_if(None) as prof:
        for _ in range(iters):
            fn()
    events = [e for e in prof.key_averages() if profiling.device_us(e) > 0]
    kb2 = [e for e in events if "render_pass_kernel" in e.key
           or "render_queue_kernel" in e.key]
    return {"kb2_ms": sum(map(profiling.device_us, kb2)) / 1e3 / iters,
            "busy_ms": sum(map(profiling.device_us, events)) / 1e3 / iters,
            "launches": len(calls) / iters}


def kb2_points(name: str, args) -> tuple:
    """(points the rays of one K-B2 launch need, points its tiles compute),
    from the launch's inputs ``(packed, rays_o, rays_d, viewdirs, z_vals,
    dists, live, term_csd, ...)``."""
    packed, ro, rd, vd, z, dists, live, term = args[:8]
    plain = mlp_fused.fused_nerf_mlp_from_points_bf16_plain \
        if name == "render_pass_bf16" \
        else mlp_fused.fused_nerf_mlp_from_points_plain
    tile = render_fused.RAY_TILE_BF16 if name == "render_pass_bf16" \
        else render_fused.RAY_TILE
    R, S = z.shape
    pts = (ro[:, None, :] + rd[:, None, :] * z[..., None]).reshape(-1, 3)
    dirs = vd[:, None, :].expand(R, S, 3).reshape(-1, 3)
    with torch.no_grad():
        sigma = torch.cat([
            F.relu(plain(packed, pts[i:i + COUNT_CHUNK],
                         dirs[i:i + COUNT_CHUNK])[:, 3])
            for i in range(0, R * S, COUNT_CHUNK)]).reshape(R, S)
    tau = torch.cumsum(sigma * dists, dim=-1)
    before = torch.cat([torch.zeros_like(tau[:, :1]), tau[:, :-1]], -1)
    on = (live[:, None] > 0) & (dists > 0)
    needed = int(((before < term) & on).sum())
    if name == "render_pass_packed":
        tiles = render_fused.packed_plan(render_fused.packed_bounds(
            render_fused.filled_counts(dists, live, term), S))
        return needed, len(tiles) * render_fused.PACKED_POINTS
    sb = render_fused.SAMPLE_BLOCK
    nb, pad = -(-S // sb), -R % tile
    blk = lambda t, v: F.pad(t, (0, nb * sb - S, 0, pad), value=v) \
        .reshape(-1, tile, nb, sb)
    work = (blk(on, False).any(dim=3).any(dim=1)
            & (blk(before, math.inf).amin(dim=3).amin(dim=1) < term))
    return needed, int(work.sum()) * tile * sb
