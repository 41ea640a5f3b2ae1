"""Occupancy-frame cells: ``occupancy.render_image_fast``, a viewer's frames
rendered on the occupancy grid (selection on a subsampled raster, the
compacted samples through K-B2), one frame after the other in a closed
loop, each returned to the host; the grid is built in set-up
(``occupancy.build_occupancy_grid``, K-B3).

The frames cycle over ``views`` poses of the camera rig drawn from the
seed, each rendered once in set-up. A frame's latency runs from its call to
its maps on the host; the window renders until ``--seconds`` have passed
and every pose once. After it the reference builds its own grid, renders
the last frame of ``compare`` poses drawn from the seed and the comparison
takes the root mean square of the rgb difference of each; a traced run also
has the reference count the filled sample slots of every pose.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import harness, scene
from benchmark.counts import kb2, model as model_counts
from benchmark.drivers.render import sized
from benchmark.reference import nerf as ref
from benchmark.trace import Window


def frame_rays(cfg, poses, device):
    cam = cfg["camera"]
    K = scene.intrinsics(cam)
    return [tuple(torch.as_tensor(a, device=device)
                  for a in scene.rays_np(cam["H"], cam["W"], K, p))
            for p in poses]


def run(r: harness.Run) -> harness.Outcome:
    cfg = sized(r.cfg, r.sizes)
    wl, dev = r.wl, r.device
    net, cam, rnd, occ = cfg["net"], cfg["camera"], cfg["render"], wl["occ"]
    grid_cfg = dict(wl["grid"], res=r.size("res", wl["grid"]["res"]))
    n_views = wl["views"]
    (weights,) = scene.networks(net, wl["teacher"], 1, r.seed, dev)
    rays = frame_rays(cfg, scene.poses(cam, n_views, r.seed), dev)
    rng = np.random.default_rng(scene.sub_seed(r.seed, scene.SAMPLE))
    compare = sorted(rng.choice(n_views, size=wl["compare"], replace=False))
    near, far, white = rnd["near"], rnd["far"], rnd["white_bkgd"]
    frames, latencies, window, memory = {}, [], None, 0
    if r.control == "tf32":
        grid = ref.build_grid(net, weights, grid_cfg, dev, tf32=True)
        frames = {v: ref.render_frame(net, weights, grid, *rays[v], near,
                                      far, occ, white, tf32=True)[0]
                  for v in compare}
    else:
        frames, latencies, window, memory = _program(r, cfg, weights, rays,
                                                     compare, grid_cfg)
    grid = ref.build_grid(net, weights, grid_cfg, dev)
    want = {v: ref.render_frame(net, weights, grid, *rays[v], near, far, occ,
                                white) for v in range(n_views)}
    rms = max(harness.rms(frames[v].reshape(-1, 3).to(dev), want[v][0])
              for v in compare)
    done = len(latencies)
    counts = {"requests": done, "latencies_s": latencies}
    summary = window.summary() if window else None
    if summary is not None:
        points = sum(want[i % n_views][2] for i in range(done))
        n_rays = done * cam["H"] * cam["W"]
        counts.update(model_flops=points * model_counts.forward_flops(net),
                      kb2_ops=kb2.operations(net, points),
                      kb2_bytes=kb2.bytes_moved(n_rays,
                                                n_rays * occ["budget"]))
    metrics = {}
    if latencies:
        metrics["frame_ms_p95"] = 1e3 * harness.quantile(latencies, 0.95)
    return harness.Outcome(
        metrics=metrics, attempted=done, failed=0,
        checks={"rgb_rms": (rms, wl["limits"]["rgb_rms"])},
        memory_peak=memory, trace=summary, counts=counts,
        setup_end=window.t_start if window else time.perf_counter())


def _program(r, cfg, weights, rays, compare, grid_cfg):
    from nnc_tpu_torch.render import occupancy

    dev, rnd, occ = r.device, cfg["render"], r.wl["occ"]
    model = harness.port_model(weights, cfg, dev, r.compute_dtype)
    rc = harness.render_config(cfg, r.compute_dtype)
    grid = occupancy.build_occupancy_grid(
        model, lo=tuple(grid_cfg["lo"]), hi=tuple(grid_cfg["hi"]),
        res=grid_cfg["res"], sigma_threshold=grid_cfg["sigma_threshold"],
        dilate=grid_cfg["dilate"])

    def frame(v):
        return occupancy.render_image_fast(
            model, *rays[v], rnd["near"], rnd["far"], rc, grid,
            n_candidates=occ["n_candidates"], budget=occ["budget"],
            subsample=occ["subsample"])["rgb_map"]

    for v in range(len(rays)):
        frame(v)
    last, latencies = {}, []
    with Window(r.trace, dev.type) as window:
        window.start()
        while True:
            v = len(latencies) % len(rays)
            t0 = time.perf_counter()
            last[v] = frame(v)
            latencies.append(time.perf_counter() - t0)
            if len(latencies) >= len(rays) and \
                    time.perf_counter() - window.t_start >= r.seconds:
                break
        window.stop()
    memory = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    frames = {v: torch.as_tensor(last[v]) for v in compare}
    del model, grid
    harness.free_device(dev)
    return frames, latencies, window, memory
