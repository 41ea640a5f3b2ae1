"""Test-view cells of forward-facing scenes: ``renderer.render_image``, the
deterministic hierarchical render of test views (K-B2 with early
termination and empty-ray culling, in chunks), of rays warped to NDC with
their view directions taken before the warp, as the executer renders an
LLFF scene's views, one view after the other in a closed loop, each image
copied to the host.

As ``drivers/render.py`` otherwise: the views cycle over ``views``
forward-facing poses drawn from the seed, their rays made on the host and
moved to the device in set-up, where every pose is rendered once; the
window renders until ``--seconds`` have passed, and every pose once, and
ends with the view that crosses it; the reference
(``reference/render_ndc.py``) renders the last image of ``compare`` poses
drawn from the seed, and the comparison takes the root mean square of the
rgb difference of each; a traced run also has the reference count, for
every pose, the points that its rays need.

The render has no raw noise (nerf-pytorch's ``render_kwargs_test``), so
that it takes K-B2's full fusion. The executer's LLFF configuration keeps
raw noise 1.0 in its test views and IOQ probes for now, which sends them
past K-B2 to K-B3: the CLI does not take this route yet. The solid teacher (``teacher``: radius
and centre in NDC space) is
``scene.solid_networks``' octahedron moved to ``centre`` by the first
layer's biases (its units relu(+-x_i) then measure x - centre).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark import harness, scene
from benchmark.counts import kb2, model as model_counts
from benchmark.drivers import render as plain_render
from benchmark.drivers.render import ref_render
from benchmark.reference import render_ndc as ref
from benchmark.trace import Window


def ndc_view_rays(cfg, poses, device):
    """[(rays_o, rays_d) in NDC, viewdirs before the warp], (H W, 3) each,
    on ``device``, one entry a pose."""
    cam = cfg["camera"]
    K = scene.intrinsics(cam)
    out = []
    for p in poses:
        ro, rd = scene.rays_np(cam["H"], cam["W"], K, p)
        vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
        ro_n, rd_n = scene.ndc_np(cam["H"], cam["W"], scene.focal_of(cam),
                                  1.0, ro, rd)
        out.append(tuple(torch.as_tensor(np.ascontiguousarray(
            a.reshape(-1, 3), dtype=np.float32), device=device)
            for a in (ro_n, rd_n, vd)))
    return out


def sized(cfg, sizes):
    """``drivers/render.py``'s sizes, the focal scaled with the width so
    that a tiny view keeps the scene's field of view."""
    out = plain_render.sized(cfg, sizes)
    if sizes:
        out["camera"]["focal"] = scene.focal_of(cfg["camera"]) * \
            sizes["W"] / cfg["camera"]["W"]
    return out


def teacher_networks(net, teacher, seed, device):
    nets = scene.networks(net, teacher, 2, seed, device)
    centre = teacher.get("centre", [0.0, 0.0, 0.0])
    for w in nets:
        b = w["pts_linears.0"][1]
        for j in range(3):
            b[j] -= float(centre[j])
            b[3 + j] += float(centre[j])
    return nets


def run(r: harness.Run) -> harness.Outcome:
    cfg = sized(r.cfg, r.sizes)
    wl, dev = r.wl, r.device
    net, cam = cfg["net"], cfg["camera"]
    n_views = wl["views"]
    nets = teacher_networks(net, wl["teacher"], r.seed, dev)
    rays = ndc_view_rays(cfg, scene.poses(cam, n_views, r.seed), dev)
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
    # a test view renders without raw noise (nerf-pytorch's
    # render_kwargs_test): with it the renderer would leave K-B2 for K-B3
    rc = dataclasses.replace(harness.render_config(cfg, r.compute_dtype),
                             raw_noise_std=0.0)

    def view(v):
        ro, rd, vd = rays[v]
        out = renderer.render_image(model_c, model_f, ro, rd, rnd["near"],
                                    rnd["far"], rc, viewdirs=vd)
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
