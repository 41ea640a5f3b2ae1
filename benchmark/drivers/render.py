"""Test-view cells: ``renderer.render_image``, the deterministic
hierarchical render of the CLI's test views and IOQ probes (K-B2 with early
termination and empty-ray culling, in chunks), one view after the other in
a closed loop, each image copied to the host.

The views cycle over ``views`` poses of the configuration's camera rig drawn
from the seed, their rays made on the host and moved to the device in
set-up, where every pose is rendered once. The window renders until
``--seconds`` have passed, and every pose once, and ends with the view that
crosses it. After it
the reference renders the last image of ``compare`` poses drawn from the
seed and the comparison takes the root mean square of the rgb difference of
each; a traced run also has the reference count, for every pose, the points
that its rays need (before early termination, on the coarse pass and on the
rays that culling keeps).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import harness, scene
from benchmark.counts import kb2, model as model_counts
from benchmark.reference import nerf as ref
from benchmark.trace import Window


def ref_render(cfg):
    rnd, samp = cfg["render"], cfg["sampling"]
    return dict(rnd, N_samples=samp["N_samples"],
                N_importance=samp["N_importance"])


def view_rays(cfg, poses, device):
    cam = cfg["camera"]
    K = scene.intrinsics(cam)
    out = []
    for p in poses:
        ro, rd = scene.rays_np(cam["H"], cam["W"], K, p)
        out.append((torch.as_tensor(ro.reshape(-1, 3), device=device),
                    torch.as_tensor(rd.reshape(-1, 3), device=device)))
    return out


def sized(cfg, sizes):
    if not sizes:
        return cfg
    cam = dict(cfg["camera"], H=sizes["H"], W=sizes["W"])
    if "focal" not in cam:
        cam["focal"] = scene.focal_of(cfg["camera"]) * sizes["W"] / \
            cfg["camera"]["W"]
    samp = dict(cfg["sampling"], **{k: sizes[k] for k in
                                    ("N_samples", "N_importance")
                                    if k in sizes})
    rnd = dict(cfg["render"], **{k: sizes[k] for k in ("chunk",)
                                 if k in sizes})
    return dict(cfg, camera=cam, sampling=samp, render=rnd)


def run(r: harness.Run) -> harness.Outcome:
    cfg = sized(r.cfg, r.sizes)
    wl, dev = r.wl, r.device
    net, cam, rnd = cfg["net"], cfg["camera"], cfg["render"]
    n_views = wl["views"]
    nets = scene.networks(net, wl["teacher"], 2, r.seed, dev)
    rays = view_rays(cfg, scene.poses(cam, n_views, r.seed), dev)
    rng = np.random.default_rng(scene.sub_seed(r.seed, scene.SAMPLE))
    compare = sorted(rng.choice(n_views, size=wl["compare"], replace=False))
    rcfg = ref_render(cfg)
    images, done, window, memory = {}, 0, None, 0
    if r.control == "tf32":
        images = {v: ref.render_view(net, rcfg, nets, *rays[v], tf32=True)[0]
                  for v in compare}
    else:
        images, done, window, memory = _program(r, cfg, nets, rays, compare)
    rms = max(harness.rms(images[v].reshape(-1, 3).to(dev),
                          ref.render_view(net, rcfg, nets, *rays[v])[0])
              for v in compare)
    counts = {"requests": done}
    summary = window.summary() if window else None
    if summary is not None:
        needed = [ref.render_view(net, rcfg, nets, *rays[v])[2]
                  for v in range(n_views)]
        points = sum(needed[i % n_views] for i in range(done))
        n_rays = done * cam["H"] * cam["W"]
        counts.update(model_flops=points * model_counts.forward_flops(net),
                      kb2_ops=kb2.operations(net, points),
                      kb2_bytes=kb2.bytes_moved(
                          n_rays, n_rays * (2 * cfg["sampling"]["N_samples"]
                                            + cfg["sampling"]["N_importance"])))
    metrics = {}
    if window is not None:
        metrics["render_rays_per_s"] = done * cam["H"] * cam["W"] / \
            window.seconds
    return harness.Outcome(
        metrics=metrics, attempted=done, failed=0,
        checks={"rgb_rms": (rms, wl["limits"]["rgb_rms"])},
        memory_peak=memory, trace=summary, counts=counts,
        setup_end=window.t_start if window else time.perf_counter())


def _program(r, cfg, nets, rays, compare):
    from nnc_tpu_torch.render import renderer

    dev, rnd = r.device, cfg["render"]
    model_c, model_f = (harness.port_model(w, cfg, dev, r.compute_dtype)
                        for w in nets)
    rc = harness.render_config(cfg, r.compute_dtype)

    def view(v):
        out = renderer.render_image(model_c, model_f, *rays[v], rnd["near"],
                                    rnd["far"], rc)
        return out["rgb_map"].cpu().numpy()

    for v in range(len(rays)):
        view(v)
    last, done = {}, 0
    with Window(r.trace, dev.type) as window:
        window.start()
        while True:
            v = done % len(rays)
            last[v] = view(v)
            done += 1
            if done >= len(rays) and \
                    time.perf_counter() - window.t_start >= r.seconds:
                break
        window.stop()
    memory = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    images = {v: torch.as_tensor(last[v]) for v in compare}
    del model_c, model_f
    harness.free_device(dev)
    return images, done, window, memory
